"""mecat2pw: all-vs-all pairwise overlap detection on a torch device.

Port of ``mecat_tpu.pipeline.pw.run_pw``.  Volume i's k-mer table is built
on the device; query reads of every volume j >= i are scanned in
length-sorted batches through the DDF filter.  Two routes:

* ``staged`` (``-j 0`` everywhere, ``-j 1`` off the card, or when asked):
  candidates are merged across strands (top n a read), and with ``-j 1``
  the surviving pairs are extended in fixed-size batches built on the
  host.  ``-j 0`` merges on the device
  (``ops.ddf.merge_strand_candidates_device``), pulls the kept prefix and
  emits the candidates with their seed points; ``-j 1`` merges on the
  host (``_merge_strand_candidates``), as the original's staged route
  does.
* ``fused`` (``-j 1`` only; the default for ``-j 1`` on a ``cuda``
  device, as the reference takes it on its accelerator): each batch is
  scanned and every candidate probed by one DP segment on the device
  (``device_step.probe_step``); the survivors (top n per strand) are
  extended against seed-centred target windows gathered on the device
  (``device_step.extend_selected``), and the overlaps are deduplicated and
  sorted per batch.  Batch k + 1 is dispatched before batch k is
  collected.  The sharded driver (``parallel.dist.run_pw_dist``) shares
  its batch plan, survivor filter and M4 columns, so both give the same
  records.

Each volume pair writes an idempotent shard ``<wrk>/pw_v{i}_v{j}.txt``
(atomic rename); a rerun skips the shards that exist.
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .. import constants as C
from .. import native
from ..index.kmer_index import TorchKmerIndex, build_index
from ..io.m4 import (M4Record, format_block, format_block_plain,
                     format_candidate_columns)
from ..io.packed_db import PackedDB
from ..ops import dp_kernel, walk_kernel
from ..ops.align import extend_pair_batch
from ..ops.ddf import merge_strand_candidates_device, scan_candidates
from ..utils.log import get_logger
from ..utils.metrics import Metrics, span
from .common import (bucket_length, gather_rows, max_segs_for,
                     oriented_batch, pad_to_batch)
from .device_step import extend_selected, probe_step

log = get_logger("pw")


@dataclass
class PwOptions:
    """CLI-mirroring options (reference mecat2pw flags)."""

    task: int = 1                      # -j: 0 candidates, 1 M4 overlaps
    num_candidates: int = C.DEFAULT_NUM_CANDIDATES       # -n
    min_align_size: int = C.DEFAULT_MIN_ALIGN_SIZE       # -a
    min_identity: float = C.MIN_OVERLAP_IDENTITY
    kmer_size: int = C.KMER_SIZE
    scan_stride: int = C.KMER_SCAN_STRIDE
    max_occ: int = C.MAX_OCC_PER_KMER                    # ~ -k freq cutoff
    diag_bin: int = C.DDF_DIAG_BIN
    volume_bases: int = C.DEFAULT_VOLUME_BASES
    scan_batch: int = C.DEFAULT_SCAN_BATCH
    extend_batch: int = C.DEFAULT_EXTEND_BATCH
    align_segment: int = C.ALIGN_SEGMENT
    align_band: int = C.ALIGN_BAND
    min_block_score: int = C.MIN_BLOCK_SCORE
    print_ext: int = 0                 # -g: 1 = two extra seed columns
    #: absolute k-mer occurrence cutoff for the index; None = multiple of
    #: the mean occurrence count
    index_cutoff: Optional[int] = None


@dataclass
class PwStats:
    reads: int = 0
    candidates: int = 0
    extended: int = 0
    overlaps: int = 0
    seconds: float = 0.0
    cells: int = 0         # DP cells issued (shape budgets incl. padded lanes)
    cells_useful: int = 0  # DP cells computed by live lanes (n_segs x S x W)
    prep_s: float = 0.0    # host batch preparation
    pull_s: float = 0.0    # strand merge (device for -j 0), sync, pull
    emit_s: float = 0.0    # candidate text emit
    extend_s: float = 0.0  # extension: gather, DP, pull, M4 records


def _merge_strand_candidates(cands_by_strand, n_keep: int, min_score: int):
    """Host merge of per-strand candidates -> top n_keep per query row
    (the staged ``-j 1`` route's, and the plain version of
    ``ops.ddf.merge_strand_candidates_device``).

    Returns int [n_pairs, 6]: (row, strand, target, score, qseed, tseed),
    rows ascending, score descending, ties in (strand, row-major) order.
    """
    rows = []
    for strand, cand in cands_by_strand:
        target, score, qseed, tseed, valid = (
            x.cpu().numpy() for x in (cand.target, cand.score, cand.qseed,
                                      cand.tseed, cand.valid))
        valid = valid & (score >= min_score)
        r, c = np.nonzero(valid)
        rows.append(np.stack([
            r, np.full_like(r, strand), target[r, c], score[r, c],
            qseed[r, c], tseed[r, c]], axis=1))
    allc = np.concatenate(rows, axis=0)
    if len(allc) == 0:
        return allc
    allc = allc[np.lexsort((-allc[:, 3], allc[:, 0]))]
    out = []
    _, starts = np.unique(allc[:, 0], return_index=True)
    ends = list(starts[1:]) + [len(allc)]
    for s, e in zip(starts, ends):
        out.append(allc[s:min(e, s + n_keep)])
    return np.concatenate(out, axis=0)


def process_query_batch(db: PackedDB, vol_base: int, index: TorchKmerIndex,
                        query_ids: List[int], opts: PwOptions,
                        vol_db: PackedDB, stats: PwStats,
                        L_query: int, L_target: int):
    """Scan + (with task 1) extend one batch of query reads against a volume.

    Returns (m4_records, candidate_text); one of them is empty per task.
    """
    device = index.offsets.device
    B = opts.scan_batch
    t_ph = time.time()
    fwd, rev, lens = oriented_batch(db, query_ids, L_query)
    fwd_p, rev_p, lens_p = pad_to_batch([fwd, rev, lens], B)
    # exclude self-hits when the query read lives in the indexed volume
    self_ids = np.array(
        [qid - vol_base if vol_base <= qid < vol_base + vol_db.n_reads else -1
         for qid in query_ids], dtype=np.int32)
    self_p, = pad_to_batch([self_ids], B)
    lens_dev = torch.as_tensor(lens_p.astype(np.int32), device=device)
    self_dev = torch.as_tensor(self_p, device=device)
    stats.prep_s += time.time() - t_ph

    cands_by_strand = []
    for strand, bases in ((0, fwd_p), (1, rev_p)):
        cand = scan_candidates(
            torch.as_tensor(bases, device=device), lens_dev, index.offsets,
            index.pos_rid, index.pos_loc, index.max_occ_cutoff, self_dev,
            k=opts.kmer_size, stride=opts.scan_stride, max_occ=opts.max_occ,
            num_candidates=opts.num_candidates, diag_bin=opts.diag_bin)
        cands_by_strand.append((strand, cand))

    t_ph = time.time()
    if opts.task == 0:
        # merge and top n on the device; pull the count and the kept prefix
        merged, count = merge_strand_candidates_device(
            cands_by_strand[0][1], cands_by_strand[1][1],
            opts.min_block_score, len(query_ids),
            n_keep=opts.num_candidates)
        pairs = merged[:int(count)].cpu().numpy()
    else:
        pairs = _merge_strand_candidates(cands_by_strand,
                                         opts.num_candidates,
                                         opts.min_block_score)
        pairs = pairs[pairs[:, 0] < len(query_ids)]
    stats.pull_s += time.time() - t_ph
    stats.candidates += len(pairs)

    m4_out: List[M4Record] = []
    if len(pairs) == 0:
        return m4_out, ""

    if opts.task == 0:
        t_ph = time.time()
        rows = pairs[:, 0].astype(np.int64)
        qarr = np.asarray(query_ids, dtype=np.int64)
        tgt = pairs[:, 2].astype(np.int64)
        cand_text = format_candidate_columns({
            "qid": qarr[rows] + 1, "sid": vol_base + tgt + 1,
            "score": pairs[:, 3], "qdir": pairs[:, 1],
            "qext": pairs[:, 4], "qsize": lens[rows],
            "sdir": np.zeros(len(pairs), np.int64), "sext": pairs[:, 5],
            "ssize": vol_db.lengths[tgt]})
        stats.emit_s += time.time() - t_ph
        return m4_out, cand_text

    # -- extension batches ----------------------------------------------------
    t_ph = time.time()
    P = opts.extend_batch
    S, W = opts.align_segment, opts.align_band
    msegs = max_segs_for(max(L_query, L_target), S)
    for ofs in range(0, len(pairs), P):
        chunk = pairs[ofs:ofs + P]
        n = len(chunk)
        rowi = chunk[:, 0].astype(np.int64)
        strand = chunk[:, 1]
        tgt = chunk[:, 2].astype(np.int64)
        q_b = np.where(strand[:, None] == 0, fwd[rowi], rev[rowi])
        t_b = gather_rows(vol_db.codes, vol_db.starts, vol_db.lengths,
                          tgt, L_target)
        qlen_b = lens[rowi].astype(np.int32)
        tlen_b = vol_db.lengths[tgt].astype(np.int32)
        qs_b = chunk[:, 4].astype(np.int32)
        ts_b = chunk[:, 5].astype(np.int32)
        batch = pad_to_batch([q_b, t_b, qlen_b, tlen_b, qs_b, ts_b], P)
        res = extend_pair_batch(
            *(torch.as_tensor(a, device=device) for a in batch),
            S=S, W=W, max_segs=msegs)
        stats.extended += n
        stats.cells += 2 * msegs * S * W * P
        qbeg, qend, tbeg, tend, ident, nsegs = (
            x.cpu().numpy()[:n] for x in (res.qbeg, res.qend, res.tbeg,
                                          res.tend, res.identity,
                                          res.n_segs))
        stats.cells_useful += S * W * int(nsegs.sum())

        qspan = qend - qbeg
        tspan = tend - tbeg
        keep = ((ident >= opts.min_identity)
                & (np.minimum(qspan, tspan) >= opts.min_align_size))
        best = {}
        for i in np.nonzero(keep)[0]:
            qid = query_ids[int(chunk[i, 0])]
            sid = vol_base + int(chunk[i, 2])
            key = (qid, sid, int(chunk[i, 1]))
            if key not in best or qspan[i] + tspan[i] > best[key][0]:
                best[key] = (qspan[i] + tspan[i], i)
        for (qid, sid, sdir), (_, i) in sorted(best.items()):
            qsize = int(lens[int(chunk[i, 0])])
            ssize = int(vol_db.lengths[int(chunk[i, 2])])
            if sdir == 0:
                qs, qe = int(qbeg[i]), int(qend[i])
            else:  # query was scanned reverse-complemented; normalise to fwd
                qs, qe = qsize - int(qend[i]), qsize - int(qbeg[i])
            m4_out.append(M4Record(
                qid=qid + 1, sid=sid + 1, identity=float(ident[i]),
                score=int(chunk[i, 3]), qstrand=0, qstart=qs, qend=qe,
                qsize=qsize, sstrand=sdir, sstart=int(tbeg[i]),
                send=int(tend[i]), ssize=ssize,
                qext=int(chunk[i, 4]) if opts.print_ext else None,
                sext=int(chunk[i, 5]) if opts.print_ext else None))
    stats.overlaps += len(m4_out)
    stats.extend_s += time.time() - t_ph
    return m4_out, ""


#: query-batch cap of the fused route: bytes of the flattened probe rows,
#: B * num_candidates * 2 * (L_query + L_target)
FLAT_BYTES = 1 << 30
#: survivor lists longer than this are extended in two score-sorted halves
_SPLIT_MIN = 768
ROUTES = ("staged", "fused")


def default_route(task: int, device) -> str:
    """The route ``run_pw`` takes when the caller names none: ``fused`` for
    ``-j 1`` on a ``cuda`` device, ``staged`` otherwise, as the reference's
    ``_use_fused`` picks it for its accelerator."""
    return ("fused" if task == 1 and torch.device(device).type == "cuda"
            else "staged")


def _bucket_k(n: int, minimum: int = 256) -> int:
    """Survivor batch size: n rounded up on a ladder of powers of two and
    their 3/4 points, at least ``minimum``."""
    n = max(n, minimum)
    p = 1 << (n - 1).bit_length()
    return p if n > 3 * p // 4 else 3 * p // 4


def plan_fused_batches(db: PackedDB, qa: int, qb: int, vol_max: int,
                       opts: PwOptions):
    """Yield (qids, b_eff, L_query, L_target) batches of the fused route.

    Queries qa..qb are sorted by length, so every batch pads to its own
    bucket; target windows of about 3x the query length bound the target
    shape.  The query batch is capped so that its flattened probe rows stay
    under FLAT_BYTES.  Shared by ``run_pw`` (fused) and
    ``parallel.dist.run_pw_dist``: both partition the queries alike.
    """
    order = np.argsort(db.lengths[qa:qb], kind="stable") + qa
    mult = 128 // math.gcd(opts.num_candidates, 128)
    bs = 0
    while bs < len(order):
        tentative = order[bs:bs + opts.scan_batch]
        L_q_b = bucket_length(int(db.lengths[tentative].max()))
        L_t_b = bucket_length(min(vol_max, 3 * L_q_b))
        per_read = opts.num_candidates * 2 * (L_q_b + L_t_b)
        b_eff = max(mult, min(opts.scan_batch,
                              FLAT_BYTES // per_read // mult * mult))
        qids = [int(q) for q in order[bs:bs + b_eff]]
        bs += b_eff
        L_q_b = bucket_length(int(db.lengths[qids].max()))
        L_t_b = bucket_length(min(vol_max, 3 * L_q_b))
        yield qids, b_eff, L_q_b, L_t_b


def dispatch_query_batch_fused(db: PackedDB, vol_base: int,
                               index: TorchKmerIndex, vol_codes,
                               query_ids: List[int], opts: PwOptions,
                               vol_db: PackedDB, stats: PwStats,
                               L_query: int, L_target: int,
                               batch_rows: int = 0):
    """The probe phase of one fused batch, both strands: scan and a
    one-segment probe of every candidate (``device_step.probe_step``).
    Returns the pending batch for :func:`collect_query_batch_fused`.

    Pad rows repeat no read: their length is 0 and their self id 0.
    """
    device = index.offsets.device
    B = batch_rows or opts.scan_batch
    t_ph = time.time()
    with span("pw.prep"):
        fwd, rev, lens = oriented_batch(db, query_ids, L_query)
        fwd_p, rev_p, lens_p = pad_to_batch([fwd, rev, lens], B)
        lens_p = lens_p.copy()
        lens_p[len(query_ids):] = 0
        self_ids = np.array(
            [qid - vol_base if vol_base <= qid < vol_base + vol_db.n_reads
             else -1 for qid in query_ids], dtype=np.int32)
        self_p, = pad_to_batch([self_ids], B)
        lens_dev = torch.as_tensor(lens_p.astype(np.int32), device=device)
        self_dev = torch.as_tensor(self_p, device=device)
    stats.prep_s += time.time() - t_ph

    S, W = opts.align_segment, opts.align_band
    outs = {}
    for strand, bases in ((0, fwd_p), (1, rev_p)):
        with span("pw.probe"):
            bases_dev = torch.as_tensor(bases, device=device)
            cand, survive = probe_step(
                bases_dev, lens_dev, self_dev, vol_codes, index.offsets,
                index.pos_rid, index.pos_loc, index.read_starts,
                index.read_lengths, index.max_occ_cutoff, k=opts.kmer_size,
                stride=opts.scan_stride, max_occ=opts.max_occ,
                num_candidates=opts.num_candidates, diag_bin=opts.diag_bin,
                L_target=L_target, S=S, W=W,
                min_block_score=opts.min_block_score)
        outs[strand] = (cand, survive, bases_dev)
    return (outs, np.asarray(query_ids, dtype=np.int64), lens, lens_dev,
            vol_codes, index, L_target,
            max_segs_for(max(L_query, L_target), S))


_M4_COL_NAMES = ("qid", "sid", "identity", "score", "qstrand", "qstart",
                 "qend", "qsize", "sstrand", "sstart", "send", "ssize",
                 "span", "qext", "sext")


def new_m4_cols() -> dict:
    """Empty columnar M4 accumulator (lists of arrays per field)."""
    return {k: [] for k in _M4_COL_NAMES}


def append_m4_columns(cols: dict, opts: PwOptions, *, strand: int,
                      vol_base: int, qids, qsize, tgt, tlens, ident, score,
                      qbeg, qend, tbeg, tend, qseed, tseed) -> int:
    """Filter one strand block by identity and size and append its fields.

    Inputs are flat NumPy arrays over the block's extended candidates
    (``tgt`` volume-local target ids, ``tlens`` the volume's length table);
    query coordinates are in the scanned orientation and are turned to the
    forward strand here (M4: qstrand is always 0); tbeg / tend are already
    target-read coordinates.  Returns the number of rows kept.  Shared by
    the fused collector and the sharded driver.
    """
    keep = ((ident >= opts.min_identity)
            & (np.minimum(qend - qbeg, tend - tbeg) >= opts.min_align_size))
    if not keep.any():
        return 0
    kk = np.nonzero(keep)[0]
    qsize = qsize[kk].astype(np.int64)
    qbeg, qend, tbeg, tend = qbeg[kk], qend[kk], tbeg[kk], tend[kk]
    cols["qid"].append(qids[kk].astype(np.int64) + 1)
    cols["sid"].append(vol_base + tgt[kk].astype(np.int64) + 1)
    cols["identity"].append(ident[kk])
    cols["score"].append(score[kk])
    cols["qstrand"].append(np.zeros(len(kk), np.int32))
    cols["qstart"].append(np.where(strand == 0, qbeg, qsize - qend))
    cols["qend"].append(np.where(strand == 0, qend, qsize - qbeg))
    cols["qsize"].append(qsize)
    cols["sstrand"].append(np.full(len(kk), strand, np.int32))
    cols["sstart"].append(tbeg)
    cols["send"].append(tend)
    cols["ssize"].append(tlens[tgt[kk]].astype(np.int64))
    cols["span"].append((qend - qbeg) + (tend - tbeg))
    cols["qext"].append(qseed[kk])
    cols["sext"].append(tseed[kk])
    return len(kk)


def finalize_m4_text(cols: dict, opts: PwOptions, stats: PwStats) -> str:
    """Keep the longest span for each (qid, sid, strand), sort by (qid,
    sid, sstrand) and write M4 text (the native columnar writer; ``-g 1``
    takes :func:`m4_text_plain`); adds the records to ``stats.overlaps``.
    This canonical tie-break makes the fused and the sharded runs
    record-identical."""
    if not cols["qid"]:
        return ""
    a = {k: np.concatenate(v) for k, v in cols.items()}
    order = np.lexsort((-a["span"], a["sstrand"], a["sid"], a["qid"]))
    a = {k: v[order] for k, v in a.items()}
    key = np.stack([a["qid"], a["sid"], a["sstrand"]], axis=1)
    first = np.ones(len(key), dtype=bool)
    first[1:] = (key[1:] != key[:-1]).any(axis=1)
    a = {k: v[first] for k, v in a.items()}
    stats.overlaps += int(first.sum())
    if opts.print_ext:
        return m4_text_plain(a, opts)
    return native.get().format_m4(a).decode()


def m4_text_plain(a: dict, opts: PwOptions) -> str:
    """M4 text of the deduplicated columns ``a`` through ``M4Record``."""
    return format_block_plain([M4Record(
        qid=int(a["qid"][i]), sid=int(a["sid"][i]),
        identity=float(a["identity"][i]), score=int(a["score"][i]),
        qstrand=0, qstart=int(a["qstart"][i]), qend=int(a["qend"][i]),
        qsize=int(a["qsize"][i]), sstrand=int(a["sstrand"][i]),
        sstart=int(a["sstart"][i]), send=int(a["send"][i]),
        ssize=int(a["ssize"][i]),
        qext=int(a["qext"][i]) if opts.print_ext else None,
        sext=int(a["sext"][i]) if opts.print_ext else None)
        for i in range(len(a["qid"]))])


def collect_query_batch_fused(pending, vol_base: int, vol_db: PackedDB,
                              opts: PwOptions, stats: PwStats) -> str:
    """Finish one dispatched batch: pull the survive masks, extend the
    survivors (``device_step.extend_selected``), return its M4 text.

    Survivors are sorted by descending DDF score (score tracks how many
    segments a lane lives), padded to :func:`_bucket_k` lanes that are dead
    from segment 0, and lists longer than ``_SPLIT_MIN`` are extended in
    two halves so that the short-lived half's loop ends early.  This only
    reschedules lanes: the per-lane results do not change, and
    :func:`finalize_m4_text` sorts globally.
    """
    (outs, qids, lens, lens_dev, vol_codes, index, L_target,
     msegs) = pending
    t_ph = time.time()
    device = lens_dev.device
    n = len(qids)
    N = opts.num_candidates
    S, W = opts.align_segment, opts.align_band
    cols = new_m4_cols()
    phase2 = {}
    for strand, (cand, survive, bases_dev) in outs.items():
        with span("pw.select"):
            # the probe issued 1 segment x 2 directions for every candidate
            stats.cells += 2 * S * W * survive.numel()
            surv = survive.cpu().numpy().copy()
            surv[n:, :] = False
            sel_np = np.flatnonzero(surv.reshape(-1)).astype(np.int32)
            if len(sel_np) == 0:
                continue
            score_np = cand.score.reshape(-1).cpu().numpy()
            # probe useful cells: 1 segment x 2 directions a valid
            # candidate of the real rows
            n_valid_cand = int(
                (score_np[:n * N] >= opts.min_block_score).sum())
            stats.cells_useful += 2 * S * W * n_valid_cand
            sel_np = sel_np[np.argsort(-score_np[sel_np], kind="stable")]
            parts = ([sel_np] if len(sel_np) <= _SPLIT_MIN else
                     [sel_np[:len(sel_np) // 2], sel_np[len(sel_np) // 2:]])
            padded = []
            for part in parts:
                K = _bucket_k(len(part))
                sel_pad = np.zeros(K, np.int64)
                sel_pad[:len(part)] = part
                valid_pad = np.zeros(K, bool)
                valid_pad[:len(part)] = True
                padded.append((part, K,
                               torch.as_tensor(sel_pad, device=device),
                               torch.as_tensor(valid_pad, device=device)))
        tgt_flat = cand.target.reshape(-1)
        part_out = []
        for part, K, sel_dev, valid_dev in padded:
            with span("pw.extend"):
                res, win0 = extend_selected(
                    bases_dev, lens_dev, vol_codes, index.read_starts,
                    index.read_lengths, tgt_flat, cand.qseed.reshape(-1),
                    cand.tseed.reshape(-1), sel_dev, valid_dev, N=N,
                    L_target=L_target, S=S, W=W, max_segs=msegs)
            part_out.append((part, res, win0))
            stats.cells += 2 * msegs * S * W * K
        phase2[strand] = (cand, part_out)
        stats.candidates += len(sel_np)
        stats.extended += len(sel_np)
        # the segment counts: the host waits for this strand's extension
        with span("pw.extend"):
            for part, res, _ in part_out:
                stats.cells_useful += S * W * int(
                    res.n_segs[:len(part)].sum())

    with span("pw.m4"):
        for strand, (cand, part_out) in phase2.items():
            target, score, qseed, tseed = (
                x.reshape(-1).cpu().numpy()
                for x in (cand.target, cand.score, cand.qseed, cand.tseed))
            for sel_np, res, win0 in part_out:
                m = len(sel_np)
                w0 = win0[:m].cpu().numpy()
                ident, qbeg, qend, tbeg, tend = (
                    x[:m].cpu().numpy() for x in (res.identity, res.qbeg,
                                                  res.qend, res.tbeg,
                                                  res.tend))
                r = sel_np // N
                append_m4_columns(
                    cols, opts, strand=strand, vol_base=vol_base,
                    qids=qids[r], qsize=lens[r], tgt=target[sel_np],
                    tlens=vol_db.lengths, ident=ident, score=score[sel_np],
                    qbeg=qbeg, qend=qend, tbeg=tbeg + w0, tend=tend + w0,
                    qseed=qseed[sel_np], tseed=tseed[sel_np])
        text = finalize_m4_text(cols, opts, stats)
    stats.extend_s += time.time() - t_ph
    return text


def process_query_batch_fused(db: PackedDB, vol_base: int,
                              index: TorchKmerIndex, vol_codes,
                              query_ids: List[int], opts: PwOptions,
                              vol_db: PackedDB, stats: PwStats,
                              L_query: int, L_target: int) -> List[M4Record]:
    """One fused batch -> M4 records (dispatch and collect in one call).

    Candidates are capped top n per strand, not per read as on the staged
    route, so the fused route finds a few more overlaps.
    """
    pending = dispatch_query_batch_fused(db, vol_base, index, vol_codes,
                                         query_ids, opts, vol_db, stats,
                                         L_query, L_target)
    text = collect_query_batch_fused(pending, vol_base, vol_db, opts, stats)
    return [M4Record.parse(ln) for ln in text.splitlines()]


def run_pw(reads_path: str, out_path: str, wrk_dir: str,
           opts: Optional[PwOptions] = None, db: Optional[PackedDB] = None,
           *, device, route: Optional[str] = None) -> PwStats:
    """Full mecat2pw run on ``device``: volumes x volumes, M4/candidates out.

    ``route`` is ``"staged"`` or ``"fused"`` (see the module text), or None
    for :func:`default_route`; the fused route computes ``-j 1`` only and
    raises ValueError for ``-j 0``.
    The summary line names the route and its host phase split:
    ``staged_prep_s``, ``_pull_s``, ``_emit_s``, ``_extend_s``;
    ``fused_prep_s``, ``_extend_s`` (survivors, extension, M4).  The scan's
    launches are asynchronous: its device time is in a profile, under the
    ``ddf.scan`` kernel span.
    """
    opts = opts or PwOptions()
    if route is None:
        route = default_route(opts.task, device)
    if route not in ROUTES:
        raise ValueError(f"unknown pw route {route!r}; one of {ROUTES}")
    if route == "fused" and opts.task != 1:
        raise ValueError("the fused pw route computes -j 1 only")
    device = torch.device(device)
    os.makedirs(wrk_dir, exist_ok=True)
    dp0 = dp_kernel.launches()
    walk0 = walk_kernel.launches()
    t0 = time.time()
    if db is None:
        db = PackedDB.from_fasta(reads_path)
    stats = PwStats(reads=db.n_reads)
    vols = db.split_volumes(opts.volume_bases)
    met = Metrics("pw")
    log.info("pw: %d reads, %d bases, %d volume(s) on %s", db.n_reads,
             db.total_bases, len(vols), device)

    shard_paths = []
    for vi, (va, vb) in enumerate(vols):
        shards = {vj: os.path.join(wrk_dir, f"pw_v{vi}_v{vj}.txt")
                  for vj in range(vi, len(vols))}
        shard_paths += list(shards.values())
        pending = [vj for vj, p in shards.items() if not os.path.exists(p)]
        if not pending:
            continue
        vol_db = db.subset(range(va, vb))
        with met.stage("index_build", volume=vi):
            index = build_index(vol_db.codes, vol_db.starts, vol_db.lengths,
                                k=opts.kmer_size,
                                freq_cutoff_abs=opts.index_cutoff,
                                device=device)
            vol_codes = (torch.as_tensor(vol_db.codes, device=device)
                         if route == "fused" else None)
        L_target = bucket_length(int(vol_db.lengths.max()))
        vol_max = int(vol_db.lengths.max())
        for vj in pending:
            qa, qb = vols[vj]
            shard = shards[vj]
            with met.stage("volume_pair", vi=vi, vj=vj), \
                    open(shard + ".tmp", "w") as fh:
                if route == "fused":
                    # depth one: batch k + 1 is dispatched before batch k
                    # is collected
                    last = None
                    for qids, b_eff, L_q_b, L_t_b in plan_fused_batches(
                            db, qa, qb, vol_max, opts):
                        nxt = dispatch_query_batch_fused(
                            db, va, index, vol_codes, qids, opts, vol_db,
                            stats, L_q_b, L_t_b, batch_rows=b_eff)
                        if last is not None:
                            fh.write(collect_query_batch_fused(
                                last, va, vol_db, opts, stats))
                        last = nxt
                    if last is not None:
                        fh.write(collect_query_batch_fused(
                            last, va, vol_db, opts, stats))
                else:
                    # length-sorted batches: shapes pad to each batch's
                    # bucket
                    order = (np.argsort(db.lengths[qa:qb], kind="stable")
                             + qa)
                    for bs in range(0, len(order), opts.scan_batch):
                        qids = [int(q)
                                for q in order[bs:bs + opts.scan_batch]]
                        L_q_b = bucket_length(int(db.lengths[qids].max()))
                        m4s, cands = process_query_batch(
                            db, va, index, qids, opts, vol_db, stats, L_q_b,
                            L_target)
                        fh.write(format_block(m4s))
                        fh.write(cands)
            os.replace(shard + ".tmp", shard)
            log.info("pw: volume %d vs %d done (%d candidates, %d overlaps)",
                     vi, vj, stats.candidates, stats.overlaps)

    with open(out_path, "wb") as out:
        for p in shard_paths:
            with open(p, "rb") as fh:
                out.write(fh.read())
    stats.seconds = time.time() - t0
    met.set("seconds", stats.seconds)
    met.set("reads", stats.reads)
    met.set("candidates", stats.candidates)
    met.set("overlaps", stats.overlaps)
    met.set("overlaps_per_s", stats.overlaps / max(stats.seconds, 1e-9))
    met.set("dp_gcells_per_s", stats.cells / max(stats.seconds, 1e-9) / 1e9)
    met.set("dp_gcells_per_s_useful",
            stats.cells_useful / max(stats.seconds, 1e-9) / 1e9)
    met.set("dp_gcells_issued", stats.cells / 1e9)
    met.set("dp_gcells_useful", stats.cells_useful / 1e9)
    met.set("route", route)
    phases = (("prep_s", "extend_s") if route == "fused" else
              ("prep_s", "pull_s", "emit_s", "extend_s"))
    for ph in phases:
        met.set(f"{route}_{ph}", round(getattr(stats, ph), 3))
    # DP kernel launches of this run: 0 on CPU; on CUDA pw runs the
    # segment-loop kernel alone (dp_launches_extend), none of the
    # per-segment kernels and none of the walks
    for name, n in dp_kernel.launches_since(dp0).items():
        met.set(name, n)
    for name, n in walk_kernel.launches_since(walk0).items():
        met.set(name, n)
    met.emit_summary()
    return stats
