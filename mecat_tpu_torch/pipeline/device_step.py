"""Fused device overlap step: scan -> candidate select -> gather -> extend.

Port of ``mecat_tpu.pipeline.device_step``.  :func:`overlap_step` takes one
batch of query reads against a device-resident volume (flat codes + k-mer
table) and returns scored, extended overlaps with no host round trip
between the DDF filter and the aligner (the extension's early exit syncs
once per segment).  The two-phase route splits it: :func:`probe_step` scans
and extends every candidate by one segment, keeping those that still look
like an alignment, and :func:`extend_selected` extends only the kept ones
to full length against seed-centred target windows.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import constants as C
from ..ops.align import (PairAlignment, dp_segment_best, dynamic_slice_start,
                         extend_pair_batch)
from ..ops.ddf import Candidates, scan_candidates
from ..utils.metrics import kernel_span


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
    cand = scan_candidates(
        bases, lengths, offsets, pos_rid, pos_loc, cutoff, self_id, k=k,
        stride=stride, max_occ=max_occ, num_candidates=num_candidates,
        diag_bin=diag_bin)
    return extend_candidates(
        cand, bases, lengths, vol_codes, read_starts, read_lengths,
        L_target=L_target, S=S, W=W, max_segs=max_segs,
        min_align_size=min_align_size, min_identity=min_identity, dp=dp)


def extend_candidates(cand: Candidates, bases, lengths, vol_codes,
                      read_starts, read_lengths, *, L_target: int, S: int,
                      W: int, max_segs: int, min_align_size: int,
                      min_identity: float,
                      dp: Callable = dp_segment_best) -> OverlapStepOut:
    """The extension half of :func:`overlap_step`: every candidate of
    ``cand`` [B, N] extended against its whole target read (the first
    L_target bases) and filtered by identity and span."""
    B, N = cand.target.shape
    dev = bases.device
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


# Two-phase overlap step: a one-segment probe of every candidate, then the
# full extension of the survivors only.  Most candidates of a read are junk
# that dies within one segment; in the one-shot step they still hold lanes
# for the whole segment loop of the longest overlap.  Candidate sets and the
# final filters are those of overlap_step.


def probe_step(bases, lengths, self_id, vol_codes, offsets, pos_rid, pos_loc,
               read_starts, read_lengths, cutoff: int, *, k: int,
               stride: int, max_occ: int, num_candidates: int,
               diag_bin: int, L_target: int, S: int, W: int,
               min_block_score: int, dp: Callable = dp_segment_best):
    """Scan + one-segment probe extension; returns (candidates, survive
    bool [B, N]).

    ``survive`` keeps every candidate whose first segments still look like
    an alignment (or are too short to judge): a prune-only filter, since
    whatever it drops would fail the final identity and size filters.
    """
    cand = scan_candidates(
        bases, lengths, offsets, pos_rid, pos_loc, cutoff, self_id, k=k,
        stride=stride, max_occ=max_occ, num_candidates=num_candidates,
        diag_bin=diag_bin)
    return cand, probe_survivors(
        cand, bases, lengths, vol_codes, read_starts, read_lengths,
        L_target=L_target, S=S, W=W, min_block_score=min_block_score, dp=dp)


def probe_survivors(cand: Candidates, bases, lengths, vol_codes, read_starts,
                    read_lengths, *, L_target: int, S: int, W: int,
                    min_block_score: int, dp: Callable = dp_segment_best):
    """The probe half of :func:`probe_step`: every candidate of ``cand``
    [B, N] extended by one segment each way in its seed-centred window;
    returns survive bool [B, N].  The thresholds are float32 and integer
    comparisons, as the reference's."""
    B, N = cand.target.shape
    with kernel_span("dp.lanes"):
        tgt = cand.target.clamp(0, read_starts.shape[0] - 1).reshape(-1).long()
        t, t_len_w, ts_local, _ = _target_windows(
            vol_codes, read_starts, read_lengths, tgt, cand.tseed.reshape(-1),
            L_target)
        q = bases.repeat_interleave(N, dim=0)
        qlen = lengths.repeat_interleave(N)
        qseed = cand.qseed.reshape(-1).clamp(min=0)
    probe = extend_pair_batch(q, t, qlen, t_len_w, qseed, ts_local,
                              S=S, W=W, max_segs=1, dp=dp)
    short = probe.align_len < 96          # too little evidence: keep
    looks_ok = probe.identity >= 55.0
    survive = (cand.valid.reshape(-1)
               & (cand.score.reshape(-1) >= min_block_score)
               & (short | looks_ok))
    return survive.reshape(B, N)


def _target_windows(vol_codes, read_starts, read_lengths, tgt, tseed,
                    L_win: int):
    """Seed-centred target windows [n, L_win] from the flat volume.

    The seed is clamped into the read and the window start into
    [0, max(t_len - L_win, 0)]; the slice comes from the volume padded with
    L_win zeros (its start wrapped and clamped as ``lax.dynamic_slice``'s)
    and the columns at or past the window length are zeroed.  An alignment
    never consumes much more target than about 1.35x its query span, so a
    window of about 3x the query length around the seed holds the whole
    overlap, and a very long target read does not widen the batch.
    Returns (rows, window_len, seed_local, win0), the last three int32 [n].
    """
    dev = vol_codes.device
    t_start = read_starts[tgt]
    t_len = read_lengths[tgt]
    top = (t_len - 1).clamp(min=0)
    tseed = torch.minimum(tseed.clamp(min=0), top)
    win0 = torch.minimum((tseed - L_win // 2).clamp(min=0),
                         (t_len - L_win).clamp(min=0))
    vol_pad = torch.cat([vol_codes,
                         torch.zeros(L_win, dtype=vol_codes.dtype,
                                     device=dev)])
    start = dynamic_slice_start(t_start + win0, vol_pad.shape[0], L_win)
    rows = vol_pad.unfold(0, L_win, 1)[start]
    t_len_w = torch.minimum(t_len - win0,
                            torch.full_like(t_len, L_win)).to(torch.int32)
    col = torch.arange(L_win, dtype=torch.int32, device=dev)
    rows = torch.where(col[None, :] < t_len_w[:, None], rows, 0).to(
        vol_codes.dtype)
    return rows, t_len_w, (tseed - win0).to(torch.int32), win0.to(torch.int32)


def extend_selected(bases, lengths, vol_codes, read_starts, read_lengths,
                    tgt_flat, qseed_flat, tseed_flat, sel, sel_valid=None, *,
                    N: int, L_target: int, S: int, W: int, max_segs: int,
                    dp: Callable = dp_segment_best):
    """Full extension of the selected candidate pairs only.

    ``sel`` int [K] indexes the flat [B * N] candidates (``tgt_flat``,
    ``qseed_flat``, ``tseed_flat``) of the query batch ``bases`` [B, L].
    Returns (PairAlignment [K], win0 int32 [K]); tbeg / tend are
    window-local and win0 is each window's origin on the target.  With
    ``sel_valid`` the padded tail lanes (False) get qlen = 0, so they are
    dead from segment 0 and the kernel skips them.
    """
    with kernel_span("dp.lanes"):
        sel = sel.long()
        rowi = torch.div(sel, N, rounding_mode="floor")
        tgt = tgt_flat[sel].clamp(0, read_starts.shape[0] - 1).long()
        q = bases[rowi]
        qlen = lengths[rowi]
        if sel_valid is not None:
            qlen = torch.where(sel_valid, qlen, 0)
        t, t_len_w, ts_local, win0 = _target_windows(
            vol_codes, read_starts, read_lengths, tgt, tseed_flat[sel],
            L_target)
        qseed = qseed_flat[sel].clamp(min=0)
    res = extend_pair_batch(q, t, qlen, t_len_w, qseed, ts_local,
                            S=S, W=W, max_segs=max_segs, dp=dp)
    return res, win0
