"""mecat2pw: all-vs-all pairwise overlap detection on a torch device.

Port of ``mecat_tpu.pipeline.pw.run_pw`` on its staged route.  Volume i's
k-mer table is built on the device; query reads of every volume j >= i are
scanned in length-sorted batches through the DDF filter, candidates are
merged across strands on the host, and with ``-j 1`` the surviving pairs
are extended in fixed-size batches through the banded aligner.  ``-j 0``
emits the candidates with their seed points instead.

Each volume pair writes an idempotent shard ``<wrk>/pw_v{i}_v{j}.txt``
(atomic rename); a rerun skips the shards that exist.
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
from ..io.m4 import M4Record, format_block, format_candidate_columns
from ..io.packed_db import PackedDB
from ..ops import dp_kernel
from ..ops.align import extend_pair_batch
from ..ops.ddf import scan_candidates
from ..utils.log import get_logger
from ..utils.metrics import Metrics
from .common import (bucket_length, gather_rows, max_segs_for,
                     oriented_batch, pad_to_batch)

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
    scan_s: float = 0.0    # candidate scan dispatch
    pull_s: float = 0.0    # device sync + pull + host strand merge
    emit_s: float = 0.0    # candidate text emit
    extend_s: float = 0.0  # extension batches: gather, DP, pull, M4 records


def _merge_strand_candidates(cands_by_strand, n_keep: int, min_score: int):
    """Host merge of per-strand candidates -> top n_keep per query row.

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

    t_ph = time.time()
    cands_by_strand = []
    for strand, bases in ((0, fwd_p), (1, rev_p)):
        cand = scan_candidates(
            torch.as_tensor(bases, device=device), lens_dev, index.offsets,
            index.pos_rid, index.pos_loc, index.max_occ_cutoff, self_dev,
            k=opts.kmer_size, stride=opts.scan_stride, max_occ=opts.max_occ,
            num_candidates=opts.num_candidates, diag_bin=opts.diag_bin)
        cands_by_strand.append((strand, cand))
    stats.scan_s += time.time() - t_ph

    t_ph = time.time()
    pairs = _merge_strand_candidates(cands_by_strand, opts.num_candidates,
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


def run_pw(reads_path: str, out_path: str, wrk_dir: str,
           opts: Optional[PwOptions] = None, db: Optional[PackedDB] = None,
           *, device) -> PwStats:
    """Full mecat2pw run on ``device``: volumes x volumes, M4/candidates out."""
    opts = opts or PwOptions()
    device = torch.device(device)
    os.makedirs(wrk_dir, exist_ok=True)
    launches0 = dp_kernel.LAUNCHES
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
        L_target = bucket_length(int(vol_db.lengths.max()))
        for vj in pending:
            qa, qb = vols[vj]
            shard = shards[vj]
            with met.stage("volume_pair", vi=vi, vj=vj), \
                    open(shard + ".tmp", "w") as fh:
                # length-sorted batches: shapes pad to each batch's bucket
                order = np.argsort(db.lengths[qa:qb], kind="stable") + qa
                for bs in range(0, len(order), opts.scan_batch):
                    qids = [int(q) for q in order[bs:bs + opts.scan_batch]]
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
    for ph in ("prep_s", "scan_s", "pull_s", "emit_s", "extend_s"):
        met.set(f"staged_{ph}", round(getattr(stats, ph), 3))
    # DP kernel launches of this run: 0 on CPU, > 0 when the DP ran on CUDA
    met.set("dp_launches", dp_kernel.LAUNCHES - launches0)
    met.emit_summary()
    return stats
