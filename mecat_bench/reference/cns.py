"""Plain reference of mecat2cns's device route on sampled templates.

What ``mecat2cns -i 0`` computes for a template: its supports from both
sides of the candidate records (score-sorted, capped at ``max_supports``,
then cut where their summed dovetail extents reach ``max_est_coverage``
template lengths), the table slice it falls in (templates sorted by
length, sliced so each slice's tag tables fit ``cap`` bytes) and that
slice's shapes, the chunk of ``extend_batch`` pairs each support falls in
(pairs sorted by segment budget) and that chunk's budgets, the seed-centred
support window, the banded alignment of both directions with moves, the
row walks, the identity / span / mapping-ratio gates, the tag planes folded
into the template's tables, the vote and the split at thin coverage.

Only the sampled templates' pairs run: a pair's alignment and tags depend
on its own inputs and its chunk's budgets, and a template's vote on its own
tables.  Every step is a frozen copy of the port's plain version (its
``pipeline/cns.py`` planning, ``ops/align.py`` host loop and row walk,
``ops/consensus_banded.py``, ``ops/consensus_device.call_tables``) or
written from it; no kernel and no import of the program.  The float32
operations (segment and pair identity, mapping ratio) run in ``fdtype``,
which the control lowers to bfloat16.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .cns_align import (direction_lanes, dynamic_slice_start,
                        extend_pair_batch_rows)
from .cns_banded import banded_accumulate_tags
from .cns_vote import VoteParams, call_tables, split_called
from .pw import Tally, _extend_lanes

MAX_INS_DELTA = 15
TEMPLATE_SLOT_BUCKET = 32


def bucket_length(n: int, minimum: int = 1024, pow2: bool = False) -> int:
    """Padded length >= n: powers of two (and, unless ``pow2``, their 3/4
    points), multiples of 1024."""
    n = max(n, minimum)
    p = 1 << max(10, (n - 1).bit_length())
    b = p if (pow2 or n > 3 * p // 4) else 3 * p // 4
    return max(minimum, int(math.ceil(b / 1024)) * 1024)


def max_segs_for(L: int, S: int) -> int:
    return int(math.ceil(L / max(1, S - S // 4))) + 2


def support_table(cols: np.ndarray) -> "SupportTable":
    """Both support sides of candidate records (int columns qid, sid,
    score, qdir, qext, qsize, sdir, sext, ssize): the subject as template
    with the qdir-oriented query as support, and the query as template
    with the subject as support (seeds flipped when qdir is 1).  Score
    ties keep the record order, side 1 before side 2."""
    a = cols.astype(np.int64)
    qid, sid, score = a[:, 0] - 1, a[:, 1] - 1, a[:, 2]
    qdir, qext, qsize = a[:, 3], a[:, 4], a[:, 5]
    sext, ssize = a[:, 7], a[:, 8]
    c1 = np.stack([qid, qdir, qext, sext, score], axis=1)
    spos2 = np.where(qdir == 0, sext, ssize - 1 - sext)
    tpos2 = np.where(qdir == 0, qext, qsize - 1 - qext)
    c2 = np.stack([sid, qdir, spos2, tpos2, score], axis=1)
    n = len(a)
    tb = np.concatenate([2 * np.arange(n), 2 * np.arange(n) + 1])
    return SupportTable(np.concatenate([sid, qid]), np.concatenate([c1, c2]),
                        tiebreak=tb)


def vote_params(opts: dict) -> VoteParams:
    """The vote rules' integers from the options' fractions."""
    pct = lambda x: int(round(x * 100))
    return VoteParams(pct(opts["del_bias"]), pct(opts["ins_bias"]),
                      int(opts["pool_min_cov"]),
                      int(opts["pool_min_cov_ins"]), int(opts["win_radius"]),
                      pct(opts["win_mass_frac"]), pct(opts["win_peak_frac"]))


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


def _capped_supports(by_template, t, cap: int):
    """Top-``cap`` supports of template t, score-sorted (works on both the
    columnar SupportTable and a plain dict of tuple lists)."""
    sups = by_template.get(t, ())
    if not isinstance(sups, np.ndarray):
        sups = sorted(sups, key=lambda x: -x[4])
    return sups[:cap]


def select_supports(db, by_template, t, opts):
    """Deterministic support selection for one template.

    Score-sorted cap (``max_supports``), then an estimated-coverage cut:
    stop at the first support whose cumulative dovetail extent reaches
    ``max_est_coverage`` template lengths.  The extent formula matches the
    mapping-ratio gate."""
    sups = _capped_supports(by_template, t, opts["max_supports"])
    target = opts["max_est_coverage"]
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


def plan_table_slices(db, templates: List[int],
                      cap: int) -> List[List[int]]:
    """Split a template batch into device-table-sized sub-batches.

    The tag tables cost L_t * D1 * 5 * 4 bytes per template slot.
    Templates are sorted by length and sliced greedily so every sub-batch
    pads to its own L_t bucket and stays under ``cap`` bytes: one very long
    template must not dictate every sub-batch's shape.
    """
    D1 = MAX_INS_DELTA + 1
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


def plan_pairs(db, templates: List[int], by_template,
               opts, L_t: int, msegs: int):
    """Vectorised (template, support) pair metadata for one table slice.

    Returns None when no template has supports; otherwise a dict of arrays
    sorted by per-pair segment budget with keys: pairs [N,5] (t, s, dir,
    spos, tpos), qlen, tlen, qs, ts (int32), segs_r, segs_l (int64
    per-direction budgets), slot (int32 row in the slice's tag table).
    """
    S, W = opts["align_segment"], opts["align_band"]
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


def _slice_shapes(db, templates: List[int], opts):
    """Static shape tuple (T, L_t, L_s, msegs, P, D1) of one table slice."""
    T = -(-len(templates) // TEMPLATE_SLOT_BUCKET) * TEMPLATE_SLOT_BUCKET
    L_t = bucket_length(max(int(db.lengths[t]) for t in templates),
                        pow2=True)
    L_s = bucket_length(min(int(db.lengths.max()), 3 * L_t), pow2=True)
    S = opts["align_segment"]
    msegs = max_segs_for(min(max(L_t, L_s), int(1.4 * L_t) + 2 * S), S)
    return T, L_t, L_s, msegs, opts["extend_batch"], MAX_INS_DELTA + 1


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
                *, min_identity, min_align_size, min_mapping_ratio,
                fdtype=torch.float32):
    """The pairs whose alignment may vote: identity, aligned template span
    and mapping ratio gates.

    The ratio is measured against the maximal dovetail extent the seed
    allows in full-read coordinates (not the full support length: a long
    support overlapping a short template can never align most of itself).
    Identity and ratio are float32 and compared with the float32 value of
    the threshold, as the reference's int32 / int32 division and weakly
    typed thresholds are.
    """
    f32 = lambda x: torch.tensor(x, dtype=fdtype, device=qbeg.device)
    extent = torch.minimum(qs_c, ts) + torch.minimum(full - qs_c, tlen - ts)
    ratio = (qend - qbeg).to(fdtype) / extent.clamp(min=1).to(fdtype)
    return (real & (identity.to(fdtype) >= f32(min_identity))
            & ((tend - tbeg) >= min_align_size)
            & (ratio >= f32(min_mapping_ratio)))


class Reads:
    """The read set (NumPy codes, starts, lengths) and its volume on a
    device: forward bases, then their reverse complement, then zeros."""

    def __init__(self, codes, starts, lengths, device):
        self.lengths = np.asarray(lengths)
        self.starts = np.asarray(starts)
        vol = torch.as_tensor(np.ascontiguousarray(codes), device=device)
        self.n_bases = int(vol.shape[0])
        slack = 3 * int(self.lengths.max()) + 1024
        self.vol_cat = torch.cat([vol, 3 - torch.flip(vol, dims=[0]),
                                  torch.zeros(slack, dtype=vol.dtype,
                                              device=device)])
        self.starts_d = torch.as_tensor(self.starts.astype(np.int64),
                                        device=device)
        self.lengths_d = torch.as_tensor(self.lengths.astype(np.int32),
                                         device=device)


def correct_templates(reads: Reads, by_template, opts: dict,
                      slice_templates: List[int], sample: List[int], *,
                      fdtype=torch.float32, block: int = 256
                      ) -> Dict[int, list]:
    """Corrected segments (uint8 arrays) of each template of ``sample``,
    computed as in the table slice ``slice_templates``."""
    dev = reads.vol_cat.device
    S, W = opts["align_segment"], opts["align_band"]
    _, L_t, L_s, msegs, P, D1 = _slice_shapes(reads, slice_templates, opts)
    plan = plan_pairs(reads, slice_templates, by_template, opts, L_t, msegs)
    out = {t: [] for t in sample}
    if plan is None:
        return out
    cap_r, cap_l = _chunk_caps(plan, P, msegs)
    slot_of = {t: i for i, t in enumerate(sample)}
    pick = np.flatnonzero(np.isin(plan["pairs"][:, 0], sample))
    T = len(sample)
    counts = torch.zeros((T, L_t, D1, 5), dtype=torch.int32, device=dev)
    cov_diff = torch.zeros((T, L_t + 1), dtype=torch.int32, device=dev)
    has = torch.zeros(T, dtype=torch.bool, device=dev)
    if len(pick):
        pairs = plan["pairs"][pick]
        q, t, w_len, tlen, qs_w, ts, qs_c, full, sdir = _pair_rows(
            reads, plan, pick, L_s, L_t)
        ten = lambda a: torch.as_tensor(np.asarray(a), device=dev).to(
            torch.int32)
        slot = ten([slot_of[int(t)] for t in pairs[:, 0]])
        pa, right_r, left_r = extend_pair_batch_rows(
            q, t, w_len, tlen, qs_w, ts, ten(cap_r[pick]), ten(cap_l[pick]),
            S=S, W=W, fdtype=fdtype)
        keep = _keep_pairs(pa.qbeg, pa.qend, pa.tbeg, pa.tend, pa.identity,
                           torch.ones_like(sdir, dtype=torch.bool), qs_c, ts,
                           full, tlen, min_identity=opts["min_identity"],
                           min_align_size=opts["min_align_size"],
                           min_mapping_ratio=opts["min_mapping_ratio"],
                           fdtype=fdtype)
        has |= torch.zeros(T, dtype=torch.int32, device=dev).index_add_(
            0, slot.long(), keep.to(torch.int32)) > 0
        for b0 in range(0, len(pick), block):
            b = slice(b0, b0 + block)
            cut = lambda rr: tuple(x[:, b] for x in rr)
            banded_accumulate_tags(
                counts, cov_diff, cut(right_r), cut(left_r), qs_w[b], ts[b],
                q[b], tlen[b], slot[b], keep[b], pa.tbeg[b], pa.tend[b],
                L_t=L_t, S=S, W=W)
    ids = torch.as_tensor(np.asarray(sample, np.int64), device=dev)
    tmpl = _gather_rows_dev(reads.vol_cat, reads.starts_d, reads.lengths_d,
                            ids, L_t)
    tmpl_len = torch.as_tensor(np.minimum(reads.lengths[sample], L_t).astype(
        np.int32), device=dev)
    emit, cov_ok = call_tables(counts, cov_diff, tmpl, tmpl_len, has,
                               opts["min_coverage"], vote=vote_params(opts))
    emit = emit.cpu().numpy()
    cov_ok = cov_ok.cpu().numpy()
    has = has.cpu().numpy()
    for i, t in enumerate(sample):
        if has[i]:
            out[t] = split_called(emit[i], cov_ok[i], int(reads.lengths[t]),
                                  opts["min_length"])
    return out


def _pair_rows(reads: Reads, plan: dict, pick, L_s: int, L_t: int):
    """Device rows of the picked pairs, as a chunk gathers them: the
    oriented seed-centred support window of L_s bases, the template's
    first L_t bases; returns (q, t, w_len, tlen, qs_w, ts, qs_c, full,
    sdir)."""
    dev = reads.vol_cat.device
    pairs = plan["pairs"][pick]
    ten = lambda a, dt=torch.int32: torch.as_tensor(
        np.asarray(a), device=dev).to(dt)
    sid = ten(pairs[:, 1], torch.int64)
    tid = ten(pairs[:, 0], torch.int64)
    qs, ts = ten(plan["qs"][pick]), ten(plan["ts"][pick])
    tlen = ten(plan["tlen"][pick])
    sdir = ten(pairs[:, 2])
    full = reads.lengths_d[sid]
    qs_c = torch.minimum(qs.clamp(min=0), (full - 1).clamp(min=0))
    w0 = torch.minimum((qs_c - L_s // 2).clamp(min=0),
                       (full - L_s).clamp(min=0))
    start = torch.where(sdir == 0, reads.starts_d[sid] + w0,
                        2 * reads.n_bases - reads.starts_d[sid] - full + w0)
    rows = _gather_windows(reads.vol_cat, start, L_s)
    w_len = (full - w0).clamp(max=L_s).to(torch.int32)
    col = torch.arange(L_s, dtype=torch.int32, device=dev)[None, :]
    q = torch.where(col < w_len[:, None], rows, 0)
    t = _gather_rows_dev(reads.vol_cat, reads.starts_d, reads.lengths_d, tid,
                         L_t)
    return q, t, w_len, tlen, (qs_c - w0).to(torch.int32), ts, qs_c, full, \
        sdir


def _chunk_caps(plan: dict, P: int, msegs: int):
    """Each pair's segment budgets (right, left): those of its chunk of P
    pairs."""
    n = len(plan["pairs"])
    cap_r = np.zeros(n, np.int64)
    cap_l = np.zeros(n, np.int64)
    for ofs in range(0, n, P):
        sl = slice(ofs, ofs + P)
        cap_r[sl] = seg_bucket(int(plan["segs_r"][sl].max()), msegs)
        cap_l[sl] = seg_bucket(int(plan["segs_l"][sl].max()), msegs)
    return cap_r, cap_l


def slice_tally(reads: Reads, by_template, opts: dict,
                slice_templates: List[int], block: int = 8192) -> Tally:
    """DP work every pair of a table slice needs: both directions of each
    pair extended (counts only: the segments, and so the rows, are those
    of the move-keeping extension) within its chunk's budgets."""
    S, W = opts["align_segment"], opts["align_band"]
    _, L_t, L_s, msegs, P, _ = _slice_shapes(reads, slice_templates, opts)
    plan = plan_pairs(reads, slice_templates, by_template, opts, L_t, msegs)
    tally = Tally()
    if plan is None:
        return tally
    cap_r, cap_l = _chunk_caps(plan, P, msegs)
    dev = reads.vol_cat.device
    for b0 in range(0, len(plan["pairs"]), block):
        pick = np.arange(b0, min(b0 + block, len(plan["pairs"])))
        q, t, w_len, tlen, qs_w, ts, *_ = _pair_rows(reads, plan, pick, L_s,
                                                      L_t)
        cap = torch.as_tensor(np.concatenate([cap_r[pick], cap_l[pick]]),
                              device=dev)
        _extend_lanes(*direction_lanes(q, t, w_len, tlen, qs_w, ts, S, W),
                      S=S, W=W, max_segs=msegs, fdtype=torch.float32,
                      tally=tally, cap=cap)
    return tally
