"""mecat2cns on a torch device: single-round pile-consensus correction
(port of the device route of mecat_tpu.pipeline.cns).

1. parse candidates (``-i 0``, from mecat2pw -j 0) or M4 overlaps
   (``-i 1``), symmetrised so every read collects supports from both record
   sides;
2. partition templates into batches (``-p``) and each batch into table
   slices that fit the device;
3. per slice: cap supports per template by score, then per chunk of
   ``extend_batch`` pairs, all on the device: gather the oriented
   seed-centred support windows, align them to their templates with the
   segmented banded aligner (move-writing DP kernel, row traceback), gate
   the pairs, and tally their tags into the slice's tables
   (:mod:`..ops.consensus_banded`); then vote (:mod:`..ops.consensus_device`),
   pull the small emit/coverage arrays, split at low coverage, write FASTA.

Corrected read headers are ``{name}_{k}`` for the k-th segment of a split
template.  Output is independent of the partition size, the table cap and
the input spill mode.

Left for later: correction rounds > 1, the polish mode, and the host route
with its NumPy vote.  Table slices run one after the other.
"""
from __future__ import annotations

import os
import shutil
import time
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from .. import constants as C
from ..io.fasta import format_fasta
from ..io.m4 import read_candidates, read_m4
from ..io.packed_db import PackedDB
from ..ops import dp_kernel
from ..ops.align import (dp_segment_best, dynamic_slice_start,
                         extend_pair_batch_rows)
from ..ops.consensus import VoteParams, default_vote_params
from ..ops.consensus_banded import banded_accumulate_tags
from ..ops.consensus_device import call_tables, split_called
from ..utils.log import get_logger
from ..utils.metrics import Metrics
from .common import bucket_length, max_segs_for, pad_to_batch

log = get_logger("cns")


@dataclass
class CnsOptions:
    """CLI-mirroring options (the reference mecat2cns flags)."""

    input_type: int = 0                      # -i: 0 candidates, 1 M4
    tech: int = C.TECH_PACBIO                # -x
    partition_size: int = C.DEFAULT_PARTITION_BATCH       # -p
    min_mapping_ratio: float = C.DEFAULT_MIN_MAPPING_RATIO  # -r
    min_align_size: int = C.DEFAULT_CNS_MIN_OVERLAP       # -a
    min_coverage: int = C.DEFAULT_MIN_COVERAGE            # -c
    min_length: int = C.DEFAULT_MIN_CORRECTED_LENGTH      # -l
    max_supports: int = C.MAX_SUPPORTS_PER_TEMPLATE
    #: stop recruiting supports once their summed dovetail extents reach
    #: this many template lengths (score-sorted prefix; 0 = off)
    max_est_coverage: int = 25
    #: correction rounds; only 1 is ported
    rounds: int = 1
    align_segment: int = C.ALIGN_SEGMENT
    align_band: int = C.ALIGN_BAND
    extend_batch: int = 128
    min_identity: float = C.MIN_OVERLAP_IDENTITY
    #: pooled vote-rule tuning (None -> builtin defaults); the -x tech
    #: presets carry per-technology values
    del_bias: Optional[float] = None
    ins_bias: Optional[float] = None
    pool_min_cov: Optional[int] = None
    pool_min_cov_ins: Optional[int] = None
    win_radius: Optional[int] = None
    win_mass_frac: Optional[float] = None
    win_peak_frac: Optional[float] = None

    def vote_params(self) -> VoteParams:
        """Resolved VoteParams: the builtin defaults with every field this
        object sets laid over them."""
        pct = lambda x: None if x is None else int(round(x * 100))
        return default_vote_params()._replace(
            **{k: v for k, v in (
                ("del_bias100", pct(self.del_bias)),
                ("ins_bias100", pct(self.ins_bias)),
                ("pool_min_cov", self.pool_min_cov),
                ("pool_min_cov_ins", self.pool_min_cov_ins),
                ("win_radius", self.win_radius),
                ("win_mass_frac100", pct(self.win_mass_frac)),
                ("win_peak_frac100", pct(self.win_peak_frac)),
            ) if v is not None})

    @classmethod
    def for_tech(cls, tech: int, **overrides) -> "CnsOptions":
        """Preset-resolved options: any field not in ``overrides`` (or passed
        as None) takes the per-technology default (CNS_TECH_PRESETS)."""
        base = dict(C.CNS_TECH_PRESETS[tech], tech=tech)
        base.update({k: v for k, v in overrides.items() if v is not None})
        return cls(**base)


@dataclass
class CnsStats:
    templates: int = 0
    supports_aligned: int = 0
    corrected_reads: int = 0
    corrected_bases: int = 0
    seconds: float = 0.0
    table_slices: int = 0
    #: DP lane-segments launched (pairs x segments run, both directions)
    #: and those of them a still-extending lane needed
    dp_lane_segs_issued: int = 0
    dp_lane_segs_useful: int = 0


class SupportTable:
    """Columnar per-template support lists.

    Rows are [support_read, orientation, support_seed, template_seed, score]
    sorted by (template, score desc, input order): ``get(t)`` returns the
    already score-sorted rows.
    """

    def __init__(self, t_ids: np.ndarray, cols: np.ndarray,
                 tiebreak: Optional[np.ndarray] = None):
        if tiebreak is None:
            tiebreak = np.arange(len(t_ids))
        order = np.lexsort((tiebreak, -cols[:, 4], t_ids))
        self._t = t_ids[order]
        self._cols = cols[order]
        self._uniq, starts = np.unique(self._t, return_index=True)
        self._offsets = np.append(starts, len(self._t))
        self._idx = {int(v): i for i, v in enumerate(self._uniq)}

    def __iter__(self):
        return (int(v) for v in self._uniq)

    def __len__(self):
        return len(self._uniq)

    def __contains__(self, t):
        return int(t) in self._idx

    def get(self, t, default=()):
        i = self._idx.get(int(t))
        if i is None:
            return default
        return self._cols[self._offsets[i]:self._offsets[i + 1]]


def _n_columns(input_type: int) -> int:
    return 9 if input_type == 0 else 12


def _support_columns(path: str, input_type: int) -> np.ndarray:
    """Raw numeric columns of a candidate/M4 file, float64 [n, 9] or
    [n, 12] (the -g seed columns are ignored)."""
    if input_type == 0:
        rows = [(r.qid, r.sid, r.score, r.qdir, r.qext, r.qsize, r.sdir,
                 r.sext, r.ssize) for r in read_candidates(path)]
    else:
        rows = [(r.qid, r.sid, r.identity, r.score, r.qstrand, r.qstart,
                 r.qend, r.qsize, r.sstrand, r.sstart, r.send, r.ssize)
                for r in read_m4(path)]
    return np.asarray(rows, dtype=np.float64).reshape(
        -1, _n_columns(input_type))


def _sides_from_columns(a: np.ndarray, input_type: int):
    """Both support sides of parsed records: (t1, c1, t2, c2).

    Seeds are (support position in the oriented support, template position
    on the forward template).
    """
    if input_type == 0:
        qid, sid, score = a[:, 0] - 1, a[:, 1] - 1, a[:, 2]
        qdir, qext, qsize = a[:, 3], a[:, 4], a[:, 5]
        sext, ssize = a[:, 7], a[:, 8]
        # side 1: template s (fwd); qdir-oriented q aligns at (qext, sext)
        t1 = sid
        c1 = np.stack([qid, qdir, qext, sext, score], axis=1)
        # side 2: template q (fwd).  If qdir=1 the relative orientation is
        # reversed: support is rc(s); flip both seeds.
        t2 = qid
        spos2 = np.where(qdir == 0, sext, ssize - 1 - sext)
        tpos2 = np.where(qdir == 0, qext, qsize - 1 - qext)
        c2 = np.stack([sid, qdir, spos2, tpos2, score], axis=1)
    else:
        qid, sid, score = a[:, 0] - 1, a[:, 1] - 1, a[:, 3]
        qmid = (a[:, 5] + a[:, 6]) // 2
        smid = (a[:, 9] + a[:, 10]) // 2
        qsize, sstrand, ssize = a[:, 7], a[:, 8], a[:, 11]
        t1 = sid
        c1 = np.stack([qid, sstrand,
                       np.where(sstrand == 0, qmid, qsize - 1 - qmid),
                       smid, score], axis=1)
        # q fwd aligns rc(s) <=> rc(q) aligns s fwd
        t2 = qid
        c2 = np.stack([sid, sstrand,
                       np.where(sstrand == 0, smid, ssize - 1 - smid),
                       qmid, score], axis=1)
    return t1, c1, t2, c2


def load_supports(path: str, db: PackedDB, input_type: int) -> SupportTable:
    """Parse candidate/M4 records into per-template support lists (both
    sides)."""
    a = _support_columns(path, input_type).astype(np.int64)
    t1, c1, t2, c2 = _sides_from_columns(a, input_type)
    # score ties keep the per-record insertion order (side 1 of record i,
    # then side 2 of record i, then record i+1): interleave
    n = len(t1)
    tb = np.concatenate([2 * np.arange(n), 2 * np.arange(n) + 1])
    return SupportTable(np.concatenate([t1, t2]), np.concatenate([c1, c2]),
                        tiebreak=tb)


def partition_supports(input_path: str, db: PackedDB, input_type: int,
                       part_dir: str, part_size: int):
    """Spill the support records to per-template-range partition files.

    Each file holds the raw rows (plus their input row index) whose template
    sides fall in its id range, so consensus memory is bounded by one
    partition.  Returns [(t_lo, t_hi, path)] for every non-empty partition.
    """
    n_parts = max(1, -(-db.n_reads // part_size))
    os.makedirs(part_dir, exist_ok=True)
    a = _support_columns(input_path, input_type)
    rows = np.concatenate([a, np.arange(len(a), dtype=np.float64)[:, None]],
                          axis=1)
    pid_q = ((a[:, 0].astype(np.int64) - 1) // part_size).clip(0, n_parts - 1)
    pid_s = ((a[:, 1].astype(np.int64) - 1) // part_size).clip(0, n_parts - 1)
    out = []
    for p in range(n_parts):
        sel = rows[(pid_s == p) | (pid_q == p)]
        if len(sel):
            path = os.path.join(part_dir, f"part_{p}.bin")
            sel.tofile(path)
            out.append((p * part_size, min((p + 1) * part_size, db.n_reads),
                        path))
    return out


def load_supports_partition(part_path: str, input_type: int, t_lo: int,
                            t_hi: int) -> SupportTable:
    """One partition file -> SupportTable restricted to [t_lo, t_hi).

    The trailing row-index column restores the global insertion order for
    score tie-breaks, so a partitioned run's support lists equal the
    whole-file loader's.
    """
    ncols = _n_columns(input_type)
    raw = np.fromfile(part_path, dtype=np.float64).reshape(-1, ncols + 1)
    rowidx = raw[:, -1].astype(np.int64)
    a = raw[:, :ncols].astype(np.int64)
    t1, c1, t2, c2 = _sides_from_columns(a, input_type)
    m1 = (t1 >= t_lo) & (t1 < t_hi)
    m2 = (t2 >= t_lo) & (t2 < t_hi)
    return SupportTable(
        np.concatenate([t1[m1], t2[m2]]),
        np.concatenate([c1[m1], c2[m2]]),
        tiebreak=np.concatenate([2 * rowidx[m1], 2 * rowidx[m2] + 1]))


def _capped_supports(by_template, t, cap: int):
    """Top-``cap`` supports of template t, score-sorted (works on both the
    columnar SupportTable and a plain dict of tuple lists)."""
    sups = by_template.get(t, ())
    if not isinstance(sups, np.ndarray):
        sups = sorted(sups, key=lambda x: -x[4])
    return sups[:cap]


def select_supports(db: PackedDB, by_template, t, opts: CnsOptions):
    """Deterministic support selection for one template.

    Score-sorted cap (``max_supports``), then an estimated-coverage cut:
    stop at the first support whose cumulative dovetail extent reaches
    ``max_est_coverage`` template lengths.  The extent formula matches the
    mapping-ratio gate."""
    sups = _capped_supports(by_template, t, opts.max_supports)
    target = opts.max_est_coverage
    if not target or len(sups) == 0:
        return sups
    a = np.asarray(sups, dtype=np.int64).reshape(-1, 5)
    tlen = int(db.lengths[t])
    qlen = db.lengths[a[:, 0]].astype(np.int64)
    spos = np.clip(a[:, 2], 0, np.maximum(qlen - 1, 0))
    tpos = np.clip(a[:, 3], 0, tlen - 1)
    extent = (np.minimum(spos, tpos)
              + np.minimum(qlen - spos, tlen - tpos))
    cum = np.cumsum(extent)
    # index of the first support that reaches the target (inclusive)
    n_keep = int(np.searchsorted(cum, target * tlen, side="left")) + 1
    return sups[:max(n_keep, 1)]


#: device-table row granularity (see plan_table_slices)
TEMPLATE_SLOT_BUCKET = 32
#: table-bytes cap on the CPU
CPU_TABLE_CAP = 1 << 29


def table_cap(device) -> int:
    """Bytes one slice's tag table may take on ``device``.

    On a CUDA device 1/32 of the memory free right now (the chunk's presence
    buffer and the vote's temporaries take several times the table), at
    least 64 MiB and at most 2 GiB; on the CPU 512 MiB.  The corrected
    output does not depend on it.
    """
    device = torch.device(device)
    if device.type != "cuda":
        return CPU_TABLE_CAP
    free, _ = torch.cuda.mem_get_info(device)
    return int(min(max(free // 32, 1 << 26), 1 << 31))


def plan_table_slices(db: PackedDB, templates: List[int],
                      cap: int) -> List[List[int]]:
    """Split a template batch into device-table-sized sub-batches.

    The tag tables cost L_t * D1 * 5 * 4 bytes per template slot.
    Templates are sorted by length and sliced greedily so every sub-batch
    pads to its own L_t bucket and stays under ``cap`` bytes: one very long
    template must not dictate every sub-batch's shape.
    """
    D1 = C.MAX_INS_DELTA + 1
    L_t_all = bucket_length(max(int(db.lengths[t]) for t in templates),
                            pow2=True)
    if len(templates) * L_t_all * D1 * 5 * 4 <= cap:
        return [list(templates)]
    by_len = sorted(templates, key=lambda t: int(db.lengths[t]))
    out = []
    a = 0
    while a < len(by_len):
        b = a + 1
        while b < len(by_len):
            L_t_b = bucket_length(int(db.lengths[by_len[b]]), pow2=True)
            if (b + 1 - a) * L_t_b * D1 * 5 * 4 > cap:
                break
            b += 1
        # floor the slice to a multiple of TEMPLATE_SLOT_BUCKET; leftovers
        # pad up with inert slots at dispatch instead
        if b - a > TEMPLATE_SLOT_BUCKET:
            b = a + ((b - a) // TEMPLATE_SLOT_BUCKET) * TEMPLATE_SLOT_BUCKET
        out.append(by_len[a:b])
        a = b
    return out


def plan_pairs(db: PackedDB, templates: List[int], by_template,
               opts: CnsOptions, L_t: int, msegs: int):
    """Vectorised (template, support) pair metadata for one table slice.

    Returns None when no template has supports; otherwise a dict of arrays
    sorted by per-pair segment budget with keys: pairs [N,5] (t, s, dir,
    spos, tpos), qlen, tlen, qs, ts (int32), segs_r, segs_l (int64
    per-direction budgets), slot (int32 row in the slice's tag table).
    """
    S, W = opts.align_segment, opts.align_band
    sup_list, t_rep = [], []
    for t in templates:
        s = select_supports(db, by_template, t, opts)
        if len(s):
            sup_list.append(np.asarray(s, dtype=np.int64).reshape(-1, 5))
            t_rep.append(np.full(len(s), t, dtype=np.int64))
    if not sup_list:
        return None
    sups_a = np.concatenate(sup_list)
    pairs_a = np.column_stack([np.concatenate(t_rep), sups_a[:, :4]])
    slot_of = {t: i for i, t in enumerate(templates)}

    all_qlen = db.lengths[pairs_a[:, 1]].astype(np.int32)  # FULL lengths
    all_tlen = np.minimum(db.lengths[pairs_a[:, 0]], L_t).astype(np.int32)
    all_qs = np.clip(pairs_a[:, 3], 0, all_qlen - 1).astype(np.int32)
    all_ts = np.clip(pairs_a[:, 4], 0, all_tlen - 1).astype(np.int32)

    # Per-direction segment budgets from host-side metadata: every applied
    # non-final segment advances >= eff = S - S//4 query bases, so the QUERY
    # side bounds segments by (qlen - qs)/eff (+2: one final partial segment
    # plus one crawl-tail margin); the TEMPLATE side consumed right of the
    # seed is <= tlen - ts (left: ts + 1) and band drift bounds q_adv -
    # t_adv by W//2 per segment, giving segs <= (span/eff + 1) * eff/(eff -
    # W//2).  The MIN of the two sides is the budget.  Chunks are grouped by
    # budget so one long one-sided pair cannot widen every chunk.
    eff = S - S // 4
    factor = eff / (eff - W // 2)
    segs_r = np.ceil(factor * ((all_tlen - all_ts) / eff + 1)).astype(np.int64)
    segs_l = np.ceil(factor * ((all_ts + 1) / eff + 1)).astype(np.int64)
    segs_r = np.minimum(segs_r,
                        (np.ceil((all_qlen - all_qs) / eff) + 2).astype(np.int64))
    segs_l = np.minimum(segs_l,
                        (np.ceil((all_qs + 1) / eff) + 2).astype(np.int64))
    segs_r = np.minimum(segs_r, msegs)
    segs_l = np.minimum(segs_l, msegs)
    order = np.argsort(segs_r + segs_l, kind="stable")
    pairs_a = pairs_a[order]
    return dict(pairs=pairs_a,
                qlen=all_qlen[order], tlen=all_tlen[order],
                qs=all_qs[order], ts=all_ts[order],
                segs_r=segs_r[order], segs_l=segs_l[order],
                slot=np.asarray([slot_of[t] for t in pairs_a[:, 0]],
                                np.int32))


def seg_bucket(n: int, msegs: int) -> int:
    """Coarse segment-budget ladder (8, 16, 32, 64, 96, msegs).  The budget
    bounds the segments a chunk may run, so it is part of what is
    computed."""
    for b in (8, 16, 32, 64, 96):
        if n <= b:
            return min(b, msegs)
    return msegs


def _slice_shapes(db: PackedDB, templates: List[int], opts: CnsOptions):
    """Static shape tuple (T, L_t, L_s, msegs, P, D1) of one table slice."""
    T = -(-len(templates) // TEMPLATE_SLOT_BUCKET) * TEMPLATE_SLOT_BUCKET
    L_t = bucket_length(max(int(db.lengths[t]) for t in templates),
                        pow2=True)
    L_s = bucket_length(min(int(db.lengths.max()), 3 * L_t), pow2=True)
    S = opts.align_segment
    msegs = max_segs_for(min(max(L_t, L_s), int(1.4 * L_t) + 2 * S), S)
    return T, L_t, L_s, msegs, opts.extend_batch, C.MAX_INS_DELTA + 1


class DeviceVolume(NamedTuple):
    vol_cat: torch.Tensor     # uint8 [2 * n_bases + slack]: fwd | rc | zeros
    starts: torch.Tensor      # int64 [n_reads] (addressing only)
    lengths: torch.Tensor     # int32 [n_reads]
    n_bases: int              # forward-base count (rc addressing)


def device_volume(db: PackedDB, device) -> DeviceVolume:
    """Put the volume on ``device`` once: [fwd bases | revcomp bases | zero
    slack].

    With the reverse complement resident, an oriented seed-centred support
    window is one contiguous slice from either half: rc(read r)[x] lives at
    vol_cat[2*n_bases - starts[r] - lengths[r] + x].  The slack keeps every
    window slice in bounds.
    """
    device = torch.device(device)
    vol = torch.from_numpy(np.ascontiguousarray(db.codes)).to(device)
    n_bases = int(vol.shape[0])
    slack = int(3 * int(db.lengths.max()) + 1024) if db.n_reads else 1024
    vol_cat = torch.cat([vol, 3 - torch.flip(vol, dims=[0]),
                         torch.zeros(slack, dtype=vol.dtype, device=device)])
    return DeviceVolume(
        vol_cat,
        torch.as_tensor(db.starts.astype(np.int64), device=device),
        torch.as_tensor(np.asarray(db.lengths).astype(np.int32),
                        device=device),
        n_bases)


def _gather_windows(vol_cat: torch.Tensor, start: torch.Tensor, L: int):
    """[B, L] rows vol_cat[start[b] : start[b] + L] (the start wrapped and
    clamped as a dynamic slice's)."""
    start = dynamic_slice_start(start, vol_cat.shape[0], L)
    return vol_cat.unfold(0, L, 1)[start]


def _gather_rows_dev(vol_cat, starts, lengths, ids, L: int):
    """[B, L] forward rows of reads ``ids`` from the device volume, zero
    past each read's end."""
    ids = ids.long()
    rows = _gather_windows(vol_cat, starts[ids], L)
    col = torch.arange(L, dtype=torch.int32, device=vol_cat.device)[None, :]
    return torch.where(col < lengths[ids].clamp(max=L)[:, None], rows, 0)


def _keep_pairs(qbeg, qend, tbeg, tend, identity, real, qs_c, ts, full, tlen,
                *, min_identity, min_align_size, min_mapping_ratio):
    """The pairs whose alignment may vote: identity, aligned template span
    and mapping ratio gates.

    The ratio is measured against the maximal dovetail extent the seed
    allows in full-read coordinates (not the full support length: a long
    support overlapping a short template can never align most of itself).
    Identity and ratio are float32 and compared with the float32 value of
    the threshold, as the reference's int32 / int32 division and weakly
    typed thresholds are.
    """
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=qbeg.device)
    extent = torch.minimum(qs_c, ts) + torch.minimum(full - qs_c, tlen - ts)
    ratio = (qend - qbeg).to(torch.float32) / extent.clamp(min=1).to(
        torch.float32)
    return (real & (identity >= f32(min_identity))
            & ((tend - tbeg) >= min_align_size)
            & (ratio >= f32(min_mapping_ratio)))


def make_cns_chunk(*, L_s, L_t, S, W, max_segs, max_segs_left,
                   min_identity, min_align_size, min_mapping_ratio,
                   dp: Callable = dp_segment_best):
    """Build the device cns-chunk function: gather -> align -> filter -> tags.

    Supports are gathered as seed-centred windows of L_s (callers bound
    L_s ~ 3 * L_t): the aligned span cannot exceed ~1.35x the template, so
    a single very long support read must not inflate the chunk shapes.
    Orientation costs nothing: the window is one contiguous slice from the
    fwd or rc half of vol_cat (see device_volume).  qlen carries the FULL
    support length (for the mapping-ratio filter); window coordinates are
    handled internally.  max_segs / max_segs_left budget the right/left
    extensions.

    The returned ``chunk(counts, cov_diff, has, vol_cat, starts, lengths,
    n_bases, s_ids, t_ids, qlen, tlen, qs, ts, t_slot, sdir, real)`` updates
    counts, cov_diff and has IN PLACE and returns them; with a ``tally``
    list it appends (lane-segments issued, useful lane-segments tensor).
    ``dp`` is the DP segment function; only a comparison against the plain
    version passes another than :func:`..ops.align.dp_segment_best`.
    """
    def chunk(counts, cov_diff, has, vol_cat, starts, lengths, n_bases,
              s_ids, t_ids, qlen, tlen, qs, ts, t_slot, sdir, real,
              tally: Optional[list] = None):
        sid = s_ids.long()
        full = lengths[sid].to(torch.int32)
        qs_c = torch.minimum(qs.clamp(min=0), (full - 1).clamp(min=0))
        w0 = torch.minimum((qs_c - L_s // 2).clamp(min=0),
                           (full - L_s).clamp(min=0))
        # int64 only here, for offsets into vol_cat
        start = torch.where(sdir == 0, starts[sid] + w0,
                            2 * n_bases - starts[sid] - full + w0)
        rows = _gather_windows(vol_cat, start, L_s)
        w_len = (full - w0).clamp(max=L_s).to(torch.int32)
        col = torch.arange(L_s, dtype=torch.int32,
                           device=vol_cat.device)[None, :]
        q = torch.where(col < w_len[:, None], rows, 0)
        qs_w = (qs_c - w0).to(torch.int32)
        t = _gather_rows_dev(vol_cat, starts, lengths, t_ids, L_t)
        pa, right_r, left_r = extend_pair_batch_rows(
            q, t, w_len, tlen, qs_w, ts, S=S, W=W, max_segs=max_segs,
            max_segs_left=max_segs_left, dp=dp)
        keep = _keep_pairs(pa.qbeg, pa.qend, pa.tbeg, pa.tend, pa.identity,
                           real, qs_c, ts, full, tlen,
                           min_identity=min_identity,
                           min_align_size=min_align_size,
                           min_mapping_ratio=min_mapping_ratio)
        slot = t_slot.long()
        has |= torch.zeros_like(has, dtype=torch.int32).index_add_(
            0, slot, keep.to(torch.int32)) > 0
        banded_accumulate_tags(
            counts, cov_diff, right_r, left_r, qs_w, ts, q, tlen, t_slot,
            keep, pa.tbeg, pa.tend, L_t=L_t, S=S, W=W)
        if tally is not None:
            n_run = right_r[0].shape[0] + left_r[0].shape[0]
            tally.append((n_run * int(q.shape[0]), pa.n_segs.sum()))
        return counts, cov_diff, has

    return chunk


def _dispatch_slice_device(db: PackedDB, templates: List[int], by_template,
                           opts: CnsOptions, stats: CnsStats,
                           dev_vol: DeviceVolume,
                           dp: Callable = dp_segment_best):
    """Plan one table slice and run its chunks and its vote on the device.

    Returns (templates, emit, cov_ok, has) device tensors for
    :func:`_collect_slice_device`, or None when no template in the slice
    has supports.  T is padded to the slot bucket: inert slots never
    accumulate tags (no pair references them) and never emit.  L_s is a
    function of L_t and the longest read, and msegs bounds per-direction
    consumption at ~1.4x the template.
    """
    T, L_t, L_s, msegs, P, D1 = _slice_shapes(db, templates, opts)
    plan = plan_pairs(db, templates, by_template, opts, L_t, msegs)
    if plan is None:
        return None
    S, W = opts.align_segment, opts.align_band
    vol_cat, starts_d, lengths_d, n_bases = dev_vol
    dev = vol_cat.device

    counts = torch.zeros((T, L_t, D1, 5), dtype=torch.int32, device=dev)
    cov_diff = torch.zeros((T, L_t + 1), dtype=torch.int32, device=dev)
    has = torch.zeros(T, dtype=torch.bool, device=dev)
    ids_pad = np.asarray(
        list(templates) + [templates[0]] * (T - len(templates)), np.int32)
    tmpl_mat = _gather_rows_dev(vol_cat, starts_d, lengths_d,
                                torch.as_tensor(ids_pad, device=dev), L_t)
    tmpl_len = np.minimum(db.lengths[ids_pad], L_t).astype(np.int32)

    pairs_a = plan["pairs"]
    tally: list = []
    for ofs in range(0, len(pairs_a), P):
        sl = slice(ofs, ofs + P)
        n = len(pairs_a[sl])
        chunk = make_cns_chunk(
            L_s=L_s, L_t=L_t, S=S, W=W,
            max_segs=seg_bucket(int(plan["segs_r"][sl].max()), msegs),
            max_segs_left=seg_bucket(int(plan["segs_l"][sl].max()), msegs),
            min_identity=opts.min_identity,
            min_align_size=opts.min_align_size,
            min_mapping_ratio=opts.min_mapping_ratio, dp=dp)
        args = pad_to_batch(
            [pairs_a[sl, 1].astype(np.int32), pairs_a[sl, 0].astype(np.int32),
             plan["qlen"][sl], plan["tlen"][sl], plan["qs"][sl],
             plan["ts"][sl], plan["slot"][sl],
             pairs_a[sl, 2].astype(np.int32), np.ones(n, dtype=bool)], P)
        chunk(counts, cov_diff, has, vol_cat, starts_d, lengths_d, n_bases,
              *(torch.as_tensor(a, device=dev) for a in args), tally=tally)
        stats.supports_aligned += n
    stats.table_slices += 1
    stats.dp_lane_segs_issued += sum(i for i, _ in tally)
    stats.dp_lane_segs_useful += int(torch.stack([u for _, u in tally]).sum())

    emit, cov_ok = call_tables(counts, cov_diff, tmpl_mat,
                               torch.as_tensor(tmpl_len, device=dev), has,
                               opts.min_coverage, vote=opts.vote_params())
    return templates, emit, cov_ok, has


def _collect_slice_device(db: PackedDB, pending, opts: CnsOptions,
                          stats: CnsStats):
    """Pull one slice's emit arrays and yield its corrected segments.

    Pulls only the delta slots that emitted anything, as int8 (insertion
    runs longer than 1-2 are rare, and the prefix rule makes the truncation
    exact: the dropped slots are all -1), and cov_ok as bool."""
    templates, emit, cov_ok, has = pending
    max_ins = int((emit[:, :, 1:] >= 0).sum(dim=2).max())
    emit = emit[:, :, :max_ins + 1].to(torch.int8).cpu().numpy()
    cov_ok = cov_ok.cpu().numpy()
    has_support = has.cpu().numpy()
    for i, t in enumerate(templates):
        stats.templates += 1
        if not has_support[i]:
            continue
        segs = split_called(emit[i], cov_ok[i], int(db.lengths[t]),
                            opts.min_length)
        for k, seg in enumerate(segs):
            stats.corrected_reads += 1
            stats.corrected_bases += len(seg)
            yield (f"{db.name(t)}_{k}", seg)


def _require_single_round(opts: CnsOptions) -> None:
    if opts.rounds != 1:
        raise NotImplementedError(
            f"correction rounds > 1 are not ported yet (rounds={opts.rounds})")


def correct_batch_device(db: PackedDB, templates: List[int], by_template,
                         opts: CnsOptions, stats: CnsStats, *, device,
                         dev_vol: Optional[DeviceVolume] = None,
                         cap: Optional[int] = None,
                         dp: Callable = dp_segment_best):
    """Align supports and vote consensus for one batch of templates, on
    ``device`` (a GENERATOR of (name, bases)).

    The volume goes to the device once (``dev_vol`` caches it across
    batches); per chunk only pair ids and seeds go up and nothing comes back
    until the final int8 emit and coverage arrays.  Corrected reads are
    yielded per table slice so callers stream them to disk.  ``cap`` is the
    table-bytes cap (default :func:`table_cap` of the device); the output
    does not depend on it.
    """
    _require_single_round(opts)
    if dev_vol is None:
        dev_vol = device_volume(db, device)   # once, not once per slice
    if cap is None:
        cap = table_cap(device)
    slices = plan_table_slices(db, templates, cap)
    for k, sl in enumerate(slices):
        pending = _dispatch_slice_device(db, sl, by_template, opts, stats,
                                         dev_vol, dp=dp)
        if pending is None:
            continue
        yield from _collect_slice_device(db, pending, opts, stats)
        if len(slices) > 1:
            log.info("cns: table slice %d/%d collected (%d corrected)",
                     k + 1, len(slices), stats.corrected_reads)


#: input files above this size are spilled to partitions by default
STREAM_BYTES = 1 << 30


def run_cns(input_path: str, reads_path: str, out_path: str,
            opts: Optional[CnsOptions] = None,
            db: Optional[PackedDB] = None, *, device,
            stream: Optional[bool] = None) -> CnsStats:
    """Full mecat2cns run on ``device``.  Output is independent of both the
    template batching (-p) and the input spill mode: ``stream`` spills the
    support records to per-template-range partition files first (default:
    only for inputs above STREAM_BYTES)."""
    opts = opts or CnsOptions()
    _require_single_round(opts)
    device = torch.device(device)
    t0 = time.time()
    launches0 = dp_kernel.LAUNCHES_MOVES
    if db is None:
        db = PackedDB.from_fasta(reads_path)
    stats = CnsStats()
    met = Metrics("cns")
    dev_vol = device_volume(db, device)
    cap = table_cap(device)

    def emit_batches(fh, by_template):
        templates = sorted(by_template)
        for ofs in range(0, len(templates), opts.partition_size):
            batch = templates[ofs:ofs + opts.partition_size]
            for name, seg in correct_batch_device(
                    db, batch, by_template, opts, stats, device=device,
                    dev_vol=dev_vol, cap=cap):
                fh.write(format_fasta(name, seg))
            log.info("cns: %d/%d templates, %d corrected reads",
                     min(ofs + opts.partition_size, len(templates)),
                     len(templates), stats.corrected_reads)

    if stream is None:
        stream = os.path.getsize(input_path) > STREAM_BYTES
    if stream:
        part_dir = out_path + ".parts"
        parts = partition_supports(input_path, db, opts.input_type,
                                   part_dir, opts.partition_size)
        log.info("cns: %d reads, %d support partitions (streamed), on %s",
                 db.n_reads, len(parts), device)
        with open(out_path, "wb") as fh:
            for t_lo, t_hi, pp in parts:
                emit_batches(fh, load_supports_partition(
                    pp, opts.input_type, t_lo, t_hi))
        shutil.rmtree(part_dir, ignore_errors=True)
    else:
        by_template = load_supports(input_path, db, opts.input_type)
        log.info("cns: %d reads, %d templates with supports, on %s",
                 db.n_reads, len(by_template), device)
        with open(out_path, "wb") as fh:
            emit_batches(fh, by_template)
    stats.seconds = time.time() - t0
    S, W = opts.align_segment, opts.align_band
    for name in ("templates", "supports_aligned", "corrected_reads",
                 "corrected_bases", "table_slices", "dp_lane_segs_issued",
                 "dp_lane_segs_useful"):
        met.set(name, getattr(stats, name))
    met.set("seconds", round(stats.seconds, 3))
    met.set("supports_per_s",
            round(stats.supports_aligned / max(stats.seconds, 1e-9), 1))
    met.set("dp_gcells_issued", round(stats.dp_lane_segs_issued * S * W / 1e9,
                                      3))
    met.set("dp_gcells_useful", round(stats.dp_lane_segs_useful * S * W / 1e9,
                                      3))
    met.set("dp_launches", dp_kernel.LAUNCHES_MOVES - launches0)
    met.emit_summary()
    return stats
