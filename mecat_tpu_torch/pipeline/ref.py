"""mecat2ref: read-to-reference mapping on a torch device.

Port of ``mecat_tpu.pipeline.ref`` on its host query route.  The genome (all
contigs) is packed and k-mer-indexed once on the device; reads stream
through the same DDF scan as mecat2pw but with a genome-scale diagonal
shift, and the top candidate loci are extended with the banded aligner on a
genome window around each seed (|window| ~ 2|read|), so batch shapes stay
read-sized whatever the genome's size.  Phase A scores every candidate locus
with the counts-only extension; phase B extends only the winners again, with
op tapes, and compacts them into one forward op stream per alignment, so SAM
CIGARs are exact.

Output: SAM (soft clips; FLAG 0/16 primary, 4 unmapped, +256 secondary) or
M4-format lines (``qid`` = read, ``sid`` = contig); up to ``best_n``
distinct loci per read.  MAPQ = round(60 * (m1 - m2) / m1) from the best and
second-best loci's match counts (0 = ambiguous, 60 = uncontested).

The host part of :func:`map_batch` (pair list, survivor sorts, MAPQ, record
emit) is the reference's NumPy, line for line; the output is equal to the
reference's byte for byte.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .. import constants as C
from ..index.kmer_index import TorchKmerIndex, build_index
from ..io.m4 import M4Record
from ..io.packed_db import PackedDB, revcomp
from ..io.sam import cigar_from_ops, sam_header, sam_line, sam_unmapped
from ..ops import dp_kernel, walk_kernel
from ..ops.align import (dp_segment_best, extend_both_directions,
                         extend_pair_batch_with_ops, pair_alignment)
from ..ops.consensus_device import ops_stream
from ..ops.ddf import scan_candidates
from ..utils.log import get_logger
from ..utils.metrics import Metrics
from .common import bucket_length, max_segs_for, oriented_batch, pad_to_batch

log = get_logger("ref")

#: diagonal shift for genome-scale target offsets.  Keeps diagonals of
#: contigs < 128 Mb non-negative; correctness does NOT depend on that:
#: ``ops/ddf.py`` bins diagonals with true floor division, so negative
#: diagonals (contig offsets beyond the shift) stay distinct and ordered.
#: The real ceiling is the int32 position representation: contigs and the
#: packed genome must stay < 2^31 bases (guarded in :func:`run_ref`).
GENOME_DIAG_SHIFT = 1 << 27

#: int32 position ceiling for the packed genome (see GENOME_DIAG_SHIFT)
MAX_GENOME_BASES = (1 << 31) - 1


@dataclass
class RefOptions:
    """CLI-mirroring options (reference mecat2ref flags)."""

    output_format: str = "sam"         # "sam" | "m4"
    num_candidates: int = 12           # candidate loci per strand
    num_extend: int = 4                # loci extended per strand
    #: alignments reported per read.  The best alignment is primary; the
    #: rest are SAM secondaries (FLAG 256) / extra M4 lines, distinct loci
    #: only.
    best_n: int = 1
    min_align_size: int = C.DEFAULT_MIN_ALIGN_SIZE
    min_identity: float = C.MIN_OVERLAP_IDENTITY
    kmer_size: int = C.KMER_SIZE
    scan_stride: int = C.KMER_SCAN_STRIDE
    max_occ: int = C.MAX_OCC_PER_KMER
    diag_bin: int = C.DDF_DIAG_BIN
    scan_batch: int = C.DEFAULT_SCAN_BATCH
    extend_batch: int = C.DEFAULT_EXTEND_BATCH
    align_segment: int = C.ALIGN_SEGMENT
    align_band: int = C.ALIGN_BAND


@dataclass
class RefStats:
    reads: int = 0
    mapped: int = 0
    seconds: float = 0.0
    index_s: float = 0.0     # genome upload + index build
    # phase walls of map_batch, summed over batches
    prep_s: float = 0.0      # host gather/pair assembly
    scan_s: float = 0.0      # DDF scan + candidate pull
    count_s: float = 0.0     # phase A counts-only extension + pulls
    ops_s: float = 0.0       # phase B winner extension + op streams
    emit_s: float = 0.0      # host record formatting
    #: launches of the per-segment counts-only and move-writing DP kernels
    #: and of the counts and the move-writing segment loop (0 on CPU)
    dp_launches: int = 0
    dp_launches_moves: int = 0
    dp_launches_extend: int = 0
    dp_launches_extend_moves: int = 0
    #: DP lane-segments launched (lanes x segments run, both directions and
    #: both phases) and those of them a still-extending lane needed
    dp_lane_segs_issued: int = 0
    dp_lane_segs_useful: int = 0


def _window(tseed: int, qlen: int, contig_len: int, L_win: int):
    """Genome window [start, start+L_win) centred on the seed."""
    start = max(0, min(int(tseed) - L_win // 2, contig_len - L_win))
    start = max(0, start)
    return start, min(L_win, contig_len - start)


def _ref_gather_qt(fwd, rev, ref_codes, rowi, strand, g0, wlen, L_win: int):
    """The chunk's oriented query rows and genome windows, on the device.

    fwd, rev uint8 [B, L_q]; ref_codes uint8 [G]; rowi, strand, g0, wlen
    int32 [P].  Window p is ref_codes[g0[p] : g0[p] + L_win] of the genome
    padded with L_win zeros, with the columns at or past wlen[p] zeroed.
    """
    rows = rowi.long()
    q = torch.where(strand[:, None] == 0, fwd[rows], rev[rows])
    ref_pad = torch.cat([ref_codes, ref_codes.new_zeros(L_win)])
    col = torch.arange(L_win, dtype=torch.int32, device=ref_codes.device)
    win = ref_pad[g0.long()[:, None] + col[None, :]]
    t = torch.where(col[None, :] < wlen[:, None], win, 0)
    return q, t


def _ref_count_chunk(fwd, rev, ref_codes, rowi, strand, g0, wlen, qlen,
                     qs, ts, *, L_win, S, W, max_segs, dp=dp_segment_best):
    """Phase-A device chunk: score every candidate locus, no op tapes.

    Returns (PairAlignment, issued): issued is the lane-segments the plain
    host loop issues for the chunk, 2P lanes times the most segments a lane
    ran (a 0-dim device tensor)."""
    q, t = _ref_gather_qt(fwd, rev, ref_codes, rowi, strand, g0, wlen, L_win)
    both = extend_both_directions(q, t, qlen, wlen, qs, ts, S=S, W=W,
                                  max_segs=max_segs, dp=dp)
    issued = both.n_segs.numel() * both.n_segs.max()
    return pair_alignment(both, qs, ts), issued


def _ref_extend_chunk(fwd, rev, ref_codes, rowi, strand, g0, wlen, qlen,
                      qs, ts, *, L_win, L_q, S, W, max_segs,
                      dp=dp_segment_best):
    """Phase-B device chunk (winners only): extend with ops and compact the
    CIGAR stream.  Returns (PairAlignment, ops int8 [P, CW], n_ops [P],
    issued): issued is the lane-segments the plain host loop issues for the
    chunk, P lanes times the segments each direction ran."""
    q, t = _ref_gather_qt(fwd, rev, ref_codes, rowi, strand, g0, wlen, L_win)
    pa, right_t, left_t = extend_pair_batch_with_ops(
        q, t, qlen, wlen, qs, ts, S=S, W=W, max_segs=max_segs, dp=dp)
    issued = qs.shape[0] * (right_t[0].shape[0] + left_t[0].shape[0])
    CW = -(-(L_q + L_win + 2) // 128) * 128
    ops8 = ops_stream(right_t, left_t, qs, ts, CW=CW)
    n_ops = (ops8 >= 0).sum(dim=1, dtype=torch.int32)
    return pa, ops8, n_ops, issued


def _pull_pa(pa, n: int):
    """The PairAlignment fields the host needs, as the reference pulls
    them: identity float32 (the gate compares in float32), the rest
    integers."""
    ident = pa.identity.cpu().numpy()[:n]
    ints = torch.stack([pa.matches, pa.qbeg, pa.qend, pa.tbeg, pa.tend,
                        pa.n_segs]).cpu().numpy()[:, :n].astype(np.int64)
    return (ident, *ints)


def map_batch(db: PackedDB, read_ids: List[int], ref_db: PackedDB,
              idx: TorchKmerIndex, ref_codes: torch.Tensor,
              opts: RefOptions, out_lines: List[str], stats: RefStats):
    """Map one batch of reads; appends its output lines to ``out_lines``."""
    device = ref_codes.device
    B = opts.scan_batch
    t_ph = time.time()
    L_q = bucket_length(max(int(db.lengths[r]) for r in read_ids))
    fwd, rev, lens = oriented_batch(db, read_ids, L_q)
    fwd_p, rev_p, lens_p = pad_to_batch([fwd, rev, lens], B)
    no_self = np.full(B, -1, dtype=np.int32)
    bases_dev = {0: torch.as_tensor(fwd_p, device=device),
                 1: torch.as_tensor(rev_p, device=device)}
    lens_dev = torch.as_tensor(lens_p.astype(np.int32), device=device)
    self_dev = torch.as_tensor(no_self, device=device)
    stats.prep_s += time.time() - t_ph

    t_ph = time.time()
    ncol = min(opts.num_extend, opts.num_candidates)
    cand_np = []
    for strand in (0, 1):
        c = scan_candidates(
            bases_dev[strand], lens_dev, idx.offsets, idx.pos_rid,
            idx.pos_loc, idx.max_occ_cutoff, self_dev,
            k=opts.kmer_size, stride=opts.scan_stride, max_occ=opts.max_occ,
            num_candidates=opts.num_candidates, diag_bin=opts.diag_bin,
            diag_shift=GENOME_DIAG_SHIFT)
        # one pull per strand: (target, score, qseed, tseed, valid)[:, :ncol]
        cand_np.append(torch.stack(
            [c.target, c.score, c.qseed, c.tseed, c.valid.to(torch.int32)]
        )[:, :, :ncol].cpu().numpy())
    stats.scan_s += time.time() - t_ph

    # build extension pair list: top loci per strand per read
    t_ph = time.time()
    L_win = min(2 * L_q + 1024, bucket_length(int(ref_db.lengths.max())))
    chunks = []  # [n, 8]: row, strand, contig, win0, qseed, tseed_loc, score, wlen
    for strand in (0, 1):
        tgt_a, score_a, qseed_a, tseed_a, valid_a = cand_np[strand]
        valid = valid_a[:len(read_ids)].astype(bool)
        r, j = np.nonzero(valid)
        if len(r) == 0:
            continue
        tgt = tgt_a[:len(read_ids)][r, j].astype(np.int64)
        tseed = tseed_a[:len(read_ids)][r, j].astype(np.int64)
        clen = ref_db.lengths[tgt].astype(np.int64)
        win0 = np.clip(np.minimum(tseed - L_win // 2, clen - L_win), 0, None)
        wlen = np.minimum(L_win, clen - win0)
        chunks.append(np.stack([
            r, np.full_like(tgt, strand), tgt, win0,
            qseed_a[:len(read_ids)][r, j].astype(np.int64),
            tseed - win0,
            score_a[:len(read_ids)][r, j].astype(np.int64),
            wlen], axis=1))
    pairs = (np.concatenate(chunks, axis=0) if chunks
             else np.zeros((0, 8), np.int64))
    stats.prep_s += time.time() - t_ph

    # Phase A: score every candidate locus with the counts-only extension
    # (no op tapes), keep best + runner-up matches per read.  Phase B
    # re-extends ONLY the winners with op collection, and only when the
    # output needs CIGARs (SAM); M4 needs none.  Query rows and genome
    # windows are gathered ON DEVICE (row indices and window offsets are the
    # only per-chunk upload).
    best = {}   # row -> (matches, pair index)
    second = {} # row -> matches of runner-up
    P = opts.extend_batch
    S, W = opts.align_segment, opts.align_band
    msegs = max_segs_for(L_q, S)
    chunk_arr = pairs
    g_start = (ref_db.starts[chunk_arr[:, 2]] + chunk_arr[:, 3]).astype(
        np.int32)

    def chunk_args(ca, g0):
        rowi = ca[:, 0].astype(np.int32)
        wlen = ca[:, 7].astype(np.int32)
        qlen_b = lens[rowi].astype(np.int32)
        qs_b = np.clip(ca[:, 4], 0, np.maximum(qlen_b - 1, 0)).astype(
            np.int32)
        ts_b = np.clip(ca[:, 5], 0, np.maximum(wlen - 1, 0)).astype(np.int32)
        padded = pad_to_batch(
            [rowi, ca[:, 1].astype(np.int32), g0.astype(np.int32), wlen,
             qlen_b, qs_b, ts_b], P)
        return [torch.as_tensor(a, device=device) for a in padded]

    t_ph = time.time()
    surv = []  # per-chunk columnar survivors: [row, m, pi, strand, contig, band]
    for ofs in range(0, len(pairs), P):
        ca = chunk_arr[ofs:ofs + P]
        n = len(ca)
        pa, issued = _ref_count_chunk(
            bases_dev[0], bases_dev[1], ref_codes,
            *chunk_args(ca, g_start[ofs:ofs + P]),
            L_win=L_win, S=S, W=W, max_segs=msegs)
        ident, matches, qbeg, qend, tbeg_a, tend, nsegs = _pull_pa(pa, n)
        stats.dp_lane_segs_useful += int(nsegs.sum())
        stats.dp_lane_segs_issued += int(issued)
        span = np.minimum(qend - qbeg, tend - tbeg_a).astype(np.int64)
        keep = np.nonzero((span >= opts.min_align_size)
                          & (ident >= opts.min_identity))[0]
        if len(keep) == 0:
            continue
        # distinct-locus key: different seeds converging on the same
        # alignment land within a band width of the same genome start
        band = (ca[keep, 3] + tbeg_a[keep]) // max(W, 1)
        surv.append(np.stack([
            ca[keep, 0], matches[keep], ofs + keep,
            ca[keep, 1], ca[keep, 2], band], axis=1))
    stats.count_s += time.time() - t_ph

    # top best_n DISTINCT loci per read; runner-up matches drive MAPQ.
    # Columnar:
    #   1. lexsort by (row, locus key, -m, pi); first entry per (row, key)
    #      group is that locus's best alignment,
    #   2. re-sort survivors by (row, -m, pi); within-row rank < best_n is
    #      reported, rank 1's matches is the MAPQ runner-up.
    if surv:
        sv = np.concatenate(surv, axis=0)
        row_c, m_c, pi_c = sv[:, 0], sv[:, 1], sv[:, 2]
        o1 = np.lexsort((pi_c, -m_c, sv[:, 5], sv[:, 4], sv[:, 3], row_c))
        key_cols = sv[o1][:, [0, 3, 4, 5]]
        first = np.ones(len(o1), dtype=bool)
        first[1:] = (key_cols[1:] != key_cols[:-1]).any(axis=1)
        d = o1[first]
        o2 = d[np.lexsort((pi_c[d], -m_c[d], row_c[d]))]
        row_d = row_c[o2]
        is_start = np.ones(len(o2), dtype=bool)
        is_start[1:] = row_d[1:] != row_d[:-1]
        idx_o = np.arange(len(o2))
        rank = idx_o - np.maximum.accumulate(np.where(is_start, idx_o, 0))
        for j in np.nonzero(rank < opts.best_n)[0]:
            best.setdefault(int(row_d[j]), []).append(
                (int(m_c[o2[j]]), int(pi_c[o2[j]])))
        for j in np.nonzero(rank == 1)[0]:
            second[int(row_d[j])] = int(m_c[o2[j]])

    # Phase B: selected alignments only (primary + up to best_n-1
    # secondary).
    t_ph = time.time()
    payloads = {}  # row -> [payload tuple] in rank order
    sel_pis = []
    for r in sorted(best):
        for _, pi in best[r]:
            sel_pis.append(pi)
    win_idx = np.asarray(sel_pis, dtype=np.int64)
    need_ops = opts.output_format == "sam"
    for ofs in range(0, len(win_idx), P):
        sel = win_idx[ofs:ofs + P]
        n = len(sel)
        args = chunk_args(chunk_arr[sel], g_start[sel])
        if need_ops:
            pa, ops_dev, n_ops_dev, issued = _ref_extend_chunk(
                bases_dev[0], bases_dev[1], ref_codes, *args,
                L_win=L_win, L_q=L_q, S=S, W=W, max_segs=msegs)
            stats.dp_lane_segs_issued += issued
            n_ops = n_ops_dev.cpu().numpy().astype(np.int64)
            # pull only the columns the longest stream of the chunk fills
            ops_np = ops_dev[:n, :int(n_ops[:n].max(initial=0))].cpu().numpy()
        else:
            pa, issued = _ref_count_chunk(
                bases_dev[0], bases_dev[1], ref_codes, *args,
                L_win=L_win, S=S, W=W, max_segs=msegs)
            stats.dp_lane_segs_issued += int(issued)
            ops_np = None
        ident, _, qbeg, qend, tbeg, tend, nsegs = _pull_pa(pa, n)
        stats.dp_lane_segs_useful += int(nsegs.sum())
        for i, pi in enumerate(sel):
            row, strand, contig, win0, qs, ts, score, wlen = chunk_arr[pi]
            if ops_np is not None:
                row_ops = ops_np[i, :n_ops[i]]
            else:
                row_ops = np.zeros(0, np.int8)
            payloads.setdefault(int(row), []).append((
                int(strand), int(contig), int(win0), int(qbeg[i]),
                int(qend[i]), int(tbeg[i]), int(tend[i]), float(ident[i]),
                int(score), row_ops))
    stats.ops_s += time.time() - t_ph

    # emit records: primary first, then secondaries (FLAG 256 / extra lines)
    t_ph = time.time()
    for row, rid in enumerate(read_ids):
        stats.reads += 1
        qsize = int(db.lengths[rid])
        name = db.name(rid)
        if row not in payloads:
            if opts.output_format == "sam":
                out_lines.append(sam_unmapped(name, db.read(rid)))
            continue
        stats.mapped += 1
        m1 = best[row][0][0]
        # MAPQ from best-vs-second matches: 0 when the runner-up ties the
        # winner (ambiguous), scaling linearly to 60 for an uncontested
        # locus: mapq = round(60 * (m1 - m2) / m1).
        m2 = second.get(row, 0)
        mapq = int(round(60.0 * (m1 - m2) / m1)) if m1 > 0 else 0
        mapq = max(0, min(60, mapq))
        for rank, payload in enumerate(payloads[row]):
            strand, contig, win0, qb, qe, tb, te, ident, score, ops = payload
            gstart = win0 + tb
            gend = win0 + te
            if opts.output_format == "sam":
                cigar = cigar_from_ops(np.asarray(ops), qb, qe, qsize)
                seq = db.read(rid) if strand == 0 else revcomp(db.read(rid))
                flag = (0 if strand == 0 else 16) | (256 if rank else 0)
                mm = best[row][rank][0]
                out_lines.append(sam_line(
                    name, flag, ref_db.name(contig), gstart,
                    mapq if rank == 0 else 0, cigar, seq,
                    tags=f"NM:i:{int((qe - qb) - mm)}\tAS:i:{mm}"))
            else:
                if strand == 0:
                    qs0, qe0 = qb, qe
                else:
                    qs0, qe0 = qsize - qe, qsize - qb
                out_lines.append(M4Record(
                    qid=rid + 1, sid=contig + 1, identity=ident, score=score,
                    qstrand=0, qstart=qs0, qend=qe0, qsize=qsize,
                    sstrand=strand, sstart=gstart, send=gend,
                    ssize=int(ref_db.lengths[contig])).format())
    stats.emit_s += time.time() - t_ph


def run_ref(reads_path: str, ref_path: str, out_path: str, wrk_dir: str,
            opts: Optional[RefOptions] = None,
            db: Optional[PackedDB] = None,
            ref_db: Optional[PackedDB] = None, *, device) -> RefStats:
    """Full mecat2ref run on ``device``: index the genome, map every read,
    write SAM or M4 lines to ``out_path``."""
    opts = opts or RefOptions()
    device = torch.device(device)
    os.makedirs(wrk_dir, exist_ok=True)
    t0 = time.time()
    db = db or PackedDB.from_fasta(reads_path)
    ref_db = ref_db or PackedDB.from_fasta(ref_path)
    if int(ref_db.total_bases) > MAX_GENOME_BASES:
        raise ValueError(
            f"reference genome has {ref_db.total_bases} bases; the int32 "
            f"position representation caps a packed genome at "
            f"{MAX_GENOME_BASES} (~2.1 Gb). Split the FASTA into "
            f"< 2^31-base groups of contigs and map against each.")
    stats = RefStats()
    dp0 = dp_kernel.launches()
    walk0 = walk_kernel.launches()
    met = Metrics("ref")
    t_ix = time.time()
    ref_codes = torch.as_tensor(ref_db.codes, device=device)
    idx = build_index(ref_db.codes, ref_db.starts, ref_db.lengths,
                      k=opts.kmer_size, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stats.index_s = time.time() - t_ix
    log.info("ref: %d reads vs %d contigs (%d bases) on %s", db.n_reads,
             ref_db.n_reads, ref_db.total_bases, device)
    with open(out_path, "w") as fh:
        if opts.output_format == "sam":
            fh.write(sam_header(
                [(ref_db.name(i), int(ref_db.lengths[i]))
                 for i in range(ref_db.n_reads)]))
        for bs in range(0, db.n_reads, opts.scan_batch):
            ids = list(range(bs, min(db.n_reads, bs + opts.scan_batch)))
            lines: List[str] = []
            map_batch(db, ids, ref_db, idx, ref_codes, opts, lines, stats)
            for ln in lines:
                fh.write(ln + "\n")
            log.info("ref: %d/%d reads, %d mapped", stats.reads, db.n_reads,
                     stats.mapped)
    stats.seconds = time.time() - t0
    # DP kernel launches of this run: 0 on CPU, > 0 when the DP ran on CUDA
    for name, n in dp_kernel.launches_since(dp0).items():
        setattr(stats, name, n)
    log.info("ref phases: index %.1fs prep %.1fs scan %.1fs count %.1fs "
             "ops %.1fs emit %.1fs (total %.1fs)", stats.index_s,
             stats.prep_s, stats.scan_s, stats.count_s, stats.ops_s,
             stats.emit_s, stats.seconds)
    S, W = opts.align_segment, opts.align_band
    for name in ("reads", "mapped", "dp_launches", "dp_launches_moves",
                 "dp_launches_extend", "dp_launches_extend_moves",
                 "dp_lane_segs_issued",
                 "dp_lane_segs_useful"):
        met.set(name, getattr(stats, name))
    met.set("seconds", round(stats.seconds, 3))
    met.set("reads_per_s", round(stats.reads / max(stats.seconds, 1e-9), 2))
    for ph in ("index_s", "prep_s", "scan_s", "count_s", "ops_s", "emit_s"):
        met.set(ph, round(getattr(stats, ph), 3))
    for name, n in walk_kernel.launches_since(walk0).items():
        met.set(name, n)
    met.set("dp_gcells_issued",
            round(stats.dp_lane_segs_issued * S * W / 1e9, 3))
    met.set("dp_gcells_useful",
            round(stats.dp_lane_segs_useful * S * W / 1e9, 3))
    if device.type == "cuda":
        met.set("peak_device_gb",
                round(torch.cuda.max_memory_allocated(device) / 1e9, 3))
    met.emit_summary()
    return stats
