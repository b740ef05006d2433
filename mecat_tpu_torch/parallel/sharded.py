"""Hash-sharded overlap steps: data-parallel reads x a hash-sharded index.

Port of ``mecat_tpu.parallel.sharded`` on ``torch.distributed``.  The ranks
form a (data, hash) grid (``parallel.dist.Grid``, rank = d * n_hash + h):

* ``data``: rank (d, h) takes the query rows of data group d, Bl of them;
* ``hash``: the k-mer index is split into n_hash equal code ranges
  (:func:`shard_index_by_hash`), and rank (d, h) holds range h.

Each rank probes its index shard for all Bl rows of its data group; the
five hit arrays then cross the hash group once each (:func:`exchange`,
``all_to_all_single``), so that rank h ends up with every shard's hits for
its own Bh = Bl / n_hash rows, scores them and extends them against the
volume, which every rank holds whole.  ``ops.ddf.score_hits`` sorts hits
on all four keys, so the candidates equal the single-device scan's.  Every
rank of a hash group must call each step the same number of times.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from .. import constants as C
from ..ops import ddf
from ..ops.align import dp_segment_best
from ..pipeline.device_step import (OverlapStepOut, extend_candidates,
                                    extend_selected, probe_survivors)

#: bytes this process has sent through :func:`exchange`
EXCHANGE_BYTES = 0


class IndexShard(NamedTuple):
    """One hash shard of a CSR k-mer index on a device."""

    offsets: torch.Tensor   # int32 [spp + 1], rebased to the shard's slice
    pos_rid: torch.Tensor   # int32 [P_max] (padded with 0)
    pos_loc: torch.Tensor   # int32 [P_max]
    code_lo: int            # first k-mer code of the range


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def shard_index_by_hash(idx, n_hash: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """Split a CSR k-mer table into n_hash equal code ranges.

    ``idx`` has ``offsets``, ``pos_rid`` and ``pos_loc`` (NumPy arrays or
    tensors, read on the host).  Returns (offsets_sh [n_hash, spp + 1],
    rid_sh [n_hash, P_max], loc_sh [n_hash, P_max], code_lo [n_hash]) with
    each shard's offsets rebased to its occurrence slice, padded to the
    longest shard.
    """
    offsets, pos_rid, pos_loc = (_host(idx.offsets), _host(idx.pos_rid),
                                 _host(idx.pos_loc))
    n_slots = len(offsets) - 1
    if n_slots % n_hash:
        raise ValueError(f"{n_slots} k-mer slots do not split into "
                         f"{n_hash} shards")
    spp = n_slots // n_hash
    off_sh, rid_sh, loc_sh, lo = [], [], [], []
    for h in range(n_hash):
        a, b = h * spp, (h + 1) * spp
        base = int(offsets[a])
        off_sh.append(offsets[a:b + 1].astype(np.int32) - base)
        rid_sh.append(pos_rid[base:int(offsets[b])])
        loc_sh.append(pos_loc[base:int(offsets[b])])
        lo.append(a)
    pmax = max(1, max(len(p) for p in rid_sh))
    rid_pad = np.zeros((n_hash, pmax), dtype=np.int32)
    loc_pad = np.zeros((n_hash, pmax), dtype=np.int32)
    for h in range(n_hash):
        rid_pad[h, :len(rid_sh[h])] = rid_sh[h]
        loc_pad[h, :len(loc_sh[h])] = loc_sh[h]
    return (np.stack(off_sh), rid_pad, loc_pad,
            np.asarray(lo, dtype=np.int32))


def index_shard(idx, grid, device) -> IndexShard:
    """This rank's hash shard of ``idx`` on ``device``."""
    off_sh, rid_sh, loc_sh, lo = shard_index_by_hash(idx, grid.n_hash)
    h = grid.h
    return IndexShard(*(torch.as_tensor(a[h], device=device)
                        for a in (off_sh, rid_sh, loc_sh)), int(lo[h]))


def exchange(x: torch.Tensor, grid) -> torch.Tensor:
    """[Bl, H] hits of the data group's rows -> [Bh, n_hash * H] hits of
    this rank's rows from every shard of its hash group.

    Rank h sends rows [h' * Bh, (h' + 1) * Bh) to rank h' and receives its
    own rows from each; the blocks are laid side by side in hash-rank
    order (``lax.all_to_all(split_axis=0, concat_axis=1, tiled=True)``).
    """
    global EXCHANGE_BYTES
    if grid.hash_group is None:
        return x
    import torch.distributed as dist

    n = grid.n_hash
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=grid.hash_group)
    EXCHANGE_BYTES += x.numel() * x.element_size() * (n - 1) // n
    Bh = x.shape[0] // n
    return out.reshape(n, Bh, -1).permute(1, 0, 2).reshape(Bh, -1)


def own_rows(x: torch.Tensor, grid) -> torch.Tensor:
    """This rank's Bh rows of its data group's Bl rows."""
    Bh = x.shape[0] // grid.n_hash
    return x[grid.h * Bh:(grid.h + 1) * Bh]


def _scan_exchanged(bases, lengths, self_id, shard: IndexShard, cutoff: int,
                    grid, *, k: int, stride: int, max_occ: int,
                    num_candidates: int, diag_bin: int) -> ddf.Candidates:
    """Probe the rank's shard for the data group's rows, exchange the hits
    over the hash group, score this rank's rows: Candidates [Bh, N]."""
    if bases.shape[0] % grid.n_hash:
        raise ValueError(f"{bases.shape[0]} rows do not split over "
                         f"{grid.n_hash} hash ranks")
    spp = shard.offsets.shape[0] - 1
    hits = ddf.probe_hits(
        bases, lengths, shard.offsets, shard.pos_rid, shard.pos_loc, cutoff,
        self_id, k=k, stride=stride, max_occ=max_occ, diag_bin=diag_bin,
        code_lo=shard.code_lo, code_hi=shard.code_lo + spp)
    rid, dbin, hqpos, toff = (exchange(x, grid) for x in hits[:4])
    hvalid = exchange(hits[4].to(torch.int8), grid) != 0
    return ddf.score_hits(rid, dbin, hqpos, toff, hvalid,
                          num_candidates=num_candidates)


def sharded_overlap_step(
    bases, lengths, self_id, vol_codes, shard: IndexShard, read_starts,
    read_lengths, cutoff: int, grid, *,
    k: int = C.KMER_SIZE,
    stride: int = C.KMER_SCAN_STRIDE,
    max_occ: int = C.MAX_OCC_PER_KMER,
    num_candidates: int = 16,
    diag_bin: int = C.DDF_DIAG_BIN,
    L_target: int = 2048,
    S: int = C.ALIGN_SEGMENT,
    W: int = C.ALIGN_BAND,
    max_segs: int = 8,
    min_align_size: int = C.DEFAULT_MIN_ALIGN_SIZE,
    min_identity: float = C.MIN_OVERLAP_IDENTITY,
    dp: Callable = dp_segment_best,
) -> OverlapStepOut:
    """``device_step.overlap_step`` over the grid.

    ``bases`` / ``lengths`` / ``self_id`` are the data group's Bl rows; the
    volume tables are whole.  Returns the OverlapStepOut [Bh, N] of this
    rank's rows (global rows rank * Bh ...).
    """
    cand = _scan_exchanged(bases, lengths, self_id, shard, cutoff, grid,
                           k=k, stride=stride, max_occ=max_occ,
                           num_candidates=num_candidates, diag_bin=diag_bin)
    return extend_candidates(
        cand, own_rows(bases, grid), own_rows(lengths, grid), vol_codes,
        read_starts, read_lengths, L_target=L_target, S=S, W=W,
        max_segs=max_segs, min_align_size=min_align_size,
        min_identity=min_identity, dp=dp)


def sharded_probe_step(
    bases, lengths, self_id, vol_codes, shard: IndexShard, read_starts,
    read_lengths, cutoff: int, grid, *,
    k: int = C.KMER_SIZE,
    stride: int = C.KMER_SCAN_STRIDE,
    max_occ: int = C.MAX_OCC_PER_KMER,
    num_candidates: int = 16,
    diag_bin: int = C.DDF_DIAG_BIN,
    L_target: int = 2048,
    S: int = C.ALIGN_SEGMENT,
    W: int = C.ALIGN_BAND,
    min_block_score: int = C.MIN_BLOCK_SCORE,
    dp: Callable = dp_segment_best,
):
    """Two-phase step, phase 1 over the grid: ``device_step.probe_step``
    for this rank's rows.  Returns flat [Bh * N] (target, score, qseed,
    tseed, survive), survive under the same prune-only filter."""
    cand = _scan_exchanged(bases, lengths, self_id, shard, cutoff, grid,
                           k=k, stride=stride, max_occ=max_occ,
                           num_candidates=num_candidates, diag_bin=diag_bin)
    survive = probe_survivors(
        cand, own_rows(bases, grid), own_rows(lengths, grid), vol_codes,
        read_starts, read_lengths, L_target=L_target, S=S, W=W,
        min_block_score=min_block_score, dp=dp)
    return (cand.target.reshape(-1), cand.score.reshape(-1),
            cand.qseed.reshape(-1), cand.tseed.reshape(-1),
            survive.reshape(-1))


def sharded_extend_step(bases, lengths, vol_codes, read_starts, read_lengths,
                        tgt_flat, qseed_flat, tseed_flat, sel, sel_valid,
                        grid, *, N: int, L_target: int, S: int, W: int,
                        max_segs: int, dp: Callable = dp_segment_best):
    """Two-phase step, phase 2: ``device_step.extend_selected`` of the
    selected candidates (``sel`` indexes this rank's flat [Bh * N]
    candidates) against this rank's rows.  No collective."""
    return extend_selected(
        own_rows(bases, grid), own_rows(lengths, grid), vol_codes,
        read_starts, read_lengths, tgt_flat, qseed_flat, tseed_flat, sel,
        sel_valid, N=N, L_target=L_target, S=S, W=W, max_segs=max_segs,
        dp=dp)
