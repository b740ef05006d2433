"""Fused device overlap step: scan -> candidate select -> gather -> extend.

Port of ``mecat_tpu.pipeline.device_step.overlap_step``: one batch of query
reads against a device-resident volume (flat codes + k-mer table), returning
scored, extended overlaps with no host round trip between the DDF filter and
the aligner (the extension's early exit syncs once per segment).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import constants as C
from ..ops.align import (PairAlignment, dp_segment_best, dynamic_slice_start,
                         extend_pair_batch)
from ..ops.ddf import scan_candidates


class OverlapStepOut(NamedTuple):
    target: torch.Tensor    # int32 [B, N] target read ids (volume-local)
    score: torch.Tensor     # int32 [B, N] DDF scores
    qbeg: torch.Tensor      # int32 [B, N] (scanned-orientation coords)
    qend: torch.Tensor
    tbeg: torch.Tensor
    tend: torch.Tensor
    identity: torch.Tensor  # float32 [B, N]
    valid: torch.Tensor     # bool [B, N] passed score/identity/size filters
    qseed: torch.Tensor     # int32 [B, N] seed point (scanned orientation)
    tseed: torch.Tensor     # int32 [B, N] seed point on the forward target
    n_segs: torch.Tensor    # int32 [B, N] DP segments actually computed


def overlap_step(
    bases: torch.Tensor,          # uint8 [B, L] oriented query bases
    lengths: torch.Tensor,        # int32 [B]
    self_id: torch.Tensor,        # int32 [B]
    vol_codes: torch.Tensor,      # uint8 [total_bases] flat volume
    offsets: torch.Tensor,        # k-mer CSR
    pos_rid: torch.Tensor,        # occurrence read ids
    pos_loc: torch.Tensor,        # occurrence in-read offsets
    read_starts: torch.Tensor,    # int32 [n_reads]
    read_lengths: torch.Tensor,   # int32 [n_reads]
    cutoff: int,
    *,
    k: int = C.KMER_SIZE,
    stride: int = C.KMER_SCAN_STRIDE,
    max_occ: int = C.MAX_OCC_PER_KMER,
    num_candidates: int = 16,
    diag_bin: int = C.DDF_DIAG_BIN,
    L_target: int = 4096,
    S: int = C.ALIGN_SEGMENT,
    W: int = C.ALIGN_BAND,
    max_segs: int = 16,
    min_align_size: int = C.DEFAULT_MIN_ALIGN_SIZE,
    min_identity: float = C.MIN_OVERLAP_IDENTITY,
    dp: Callable = dp_segment_best,
) -> OverlapStepOut:
    """One batch through scan and extension; all tensors on one device."""
    B = bases.shape[0]
    N = num_candidates
    dev = bases.device
    cand = scan_candidates(
        bases, lengths, offsets, pos_rid, pos_loc, cutoff, self_id, k=k,
        stride=stride, max_occ=max_occ, num_candidates=N, diag_bin=diag_bin)

    # rank-major extension batch: lane j*B + b is read b's rank-j candidate
    tgt = cand.target.clamp(0, read_starts.shape[0] - 1).T.reshape(-1).long()
    q_pairs = bases.repeat(N, 1)
    qlen_pairs = lengths.repeat(N)
    # target rows are contiguous volume slices; the start wraps and clamps
    # like lax.dynamic_slice, so no start reads out of bounds
    t_len = read_lengths[tgt]
    vol_pad = torch.cat([vol_codes, torch.zeros(L_target, dtype=vol_codes.dtype,
                                                device=dev)])
    t_start = dynamic_slice_start(read_starts[tgt], vol_pad.shape[0],
                                  L_target)
    rows = vol_pad.unfold(0, L_target, 1)[t_start]
    col = torch.arange(L_target, dtype=torch.int32, device=dev)
    t_pairs = torch.where(col[None, :] < t_len[:, None], rows, 0).to(
        vol_codes.dtype)

    res = extend_pair_batch(
        q_pairs, t_pairs, qlen_pairs, t_len,
        cand.qseed.T.reshape(-1).clamp(min=0),
        torch.minimum(cand.tseed.T.reshape(-1).clamp(min=0),
                      (t_len - 1).clamp(min=0)),
        S=S, W=W, max_segs=max_segs, dp=dp)
    res = PairAlignment(*(x.reshape(N, B).T for x in res))

    qspan = res.qend - res.qbeg
    tspan = res.tend - res.tbeg
    ok = (cand.valid & (res.identity >= min_identity)
          & (torch.minimum(qspan, tspan) >= min_align_size))
    return OverlapStepOut(
        target=cand.target, score=cand.score,
        qbeg=res.qbeg, qend=res.qend, tbeg=res.tbeg, tend=res.tend,
        identity=res.identity, valid=ok, qseed=cand.qseed, tseed=cand.tseed,
        n_segs=res.n_segs)
