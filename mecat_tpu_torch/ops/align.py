"""Segmented banded extension aligner, counts-only (port of mecat_tpu.ops.align).

The DP of one segment runs in the hand-written Hopper kernel
(``csrc/dp_segment.cu`` through :mod:`.dp_kernel`) for CUDA tensors, and in
its plain PyTorch version (:func:`banded_dp_segment` + :func:`pick_end_local`)
for CPU tensors.  :func:`dp_segment_best` dispatches on the tensor's device
only: a CUDA tensor launches the kernel or raises.

Everything else mirrors ``mecat_tpu/ops/align.py`` op for op, so results
are bit-equal: packed DP values and coordinates are int32, identities are
float32 in the reference's operation order, and every dynamic slice clamps
its start the way ``lax.dynamic_slice`` does.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import constants as C

INF = 1 << 20
Q_SENTINEL = 255
T_SENTINEL = 254
#: DP values are packed as dist * IND_K + indels (see mecat_tpu.ops.align)
IND_K = 4096
VINF = 1 << 30
_NEG = -(1 << 26)


def banded_dp_segment(q_seg: torch.Tensor, tpad: torch.Tensor,
                      tmax: torch.Tensor, W: int):
    """Banded edit-distance DP rows of one segment per lane.

    q_seg uint8 [B, S]; tpad uint8 [B, S + W], the target window framed
    with W/2 leading sentinels (tpad[:, x] = window[x - W/2]); tmax int32
    [B].  Returns rows int32 [B, S+1, W] (row r = after r query chars):
    packed dist * IND_K + indels, VINF outside the band.
    """
    B, S = q_seg.shape
    half = W // 2
    K1 = IND_K + 1
    dev = q_seg.device
    w_idx = torch.arange(W, dtype=torch.int32, device=dev)
    tmax_c = tmax[:, None]
    j0 = w_idx - half
    row = torch.where((j0[None, :] >= 0) & (j0[None, :] <= tmax_c),
                      (j0.clamp(min=0) * K1)[None, :],
                      torch.tensor(VINF, dtype=torch.int32, device=dev))
    vinf_col = torch.full((B, 1), VINF, dtype=torch.int32, device=dev)
    wk = w_idx[None, :] * K1
    rows = [row]
    for i in range(1, S + 1):
        qc = q_seg[:, i - 1:i]
        td = tpad[:, i - 1:i - 1 + W]
        sub = (qc != td).to(torch.int32)
        diag = row + sub * IND_K
        vert = torch.cat([row[:, 1:], vinf_col], dim=1) + K1
        cand = torch.minimum(diag, vert)
        j = (i - half) + w_idx
        valid = (j[None, :] >= 0) & (j[None, :] <= tmax_c)
        cand = torch.where(valid, cand, VINF)
        cur = torch.cummin(cand - wk, dim=1).values + wk
        row = torch.where(valid, cur.clamp(max=VINF), VINF)
        rows.append(row)
    return torch.stack(rows, dim=1)


def pick_end_local(rows: torch.Tensor, seg_qlen: torch.Tensor,
                   tmax: torch.Tensor, W: int,
                   penalty: int = C.ALIGN_TRIM_PENALTY):
    """Best-scoring cell of the segment: (r_best, w_best, v_best) int32 [B].

    Score of cell (r, j) = r + j - 2 * penalty * dist over valid cells with
    r <= seg_qlen; ties go to the first cell in flat (row, band) order, as
    ``jnp.argmax`` does.
    """
    B, S1, _ = rows.shape
    half = W // 2
    dev = rows.device
    w_idx = torch.arange(W, dtype=torch.int32, device=dev)
    r_idx = torch.arange(S1, dtype=torch.int32, device=dev)
    dist = torch.div(rows, IND_K, rounding_mode="floor")
    j = r_idx[None, :, None] - half + w_idx[None, None, :]
    valid = ((j >= 0) & (j <= tmax[:, None, None])
             & (r_idx[None, :, None] <= seg_qlen[:, None, None]))
    score = torch.where(valid & (rows < VINF),
                        r_idx[None, :, None] + j - 2 * penalty * dist,
                        _NEG)
    flat = score.reshape(B, S1 * W)
    top = flat.max(dim=1, keepdim=True).values
    pos = torch.arange(S1 * W, dtype=torch.int32, device=dev)
    best = torch.where(flat == top, pos, S1 * W).min(dim=1).values
    r_best = torch.div(best, W, rounding_mode="floor")
    w_best = best - r_best * W
    v_best = torch.gather(rows.reshape(B, S1 * W), 1,
                          best.long()[:, None])[:, 0]
    return r_best, w_best, v_best


def _unpack_best(r_best, w_best, v_best, W: int):
    """(r, w, packed v) -> (r, w, j, d, indels), as pallas_dp.py:269-274."""
    vinf = v_best >= VINF
    d_best = torch.where(vinf, INF, torch.div(v_best, IND_K,
                                              rounding_mode="floor"))
    ind_best = torch.where(vinf, 0, torch.remainder(v_best, IND_K))
    j_best = r_best - W // 2 + w_best
    return r_best, w_best, j_best, d_best.to(torch.int32), \
        ind_best.to(torch.int32)


def dp_segment_best_plain(q_seg: torch.Tensor, tpad: torch.Tensor,
                          tmax: torch.Tensor, seg_q: torch.Tensor,
                          active: torch.Tensor, S: int, W: int):
    """Plain PyTorch version of the DP kernel, on any device.

    Returns (r_best, w_best, j_best, d_best, ind_best) int32 [B].  An
    inactive lane gets the kernel's skip record (r=0, w=W/2, v=VINF).
    """
    rows = banded_dp_segment(q_seg, tpad, tmax, W)
    r, w, v = pick_end_local(rows, seg_q, tmax, W)
    r = torch.where(active, r, 0)
    w = torch.where(active, w, W // 2)
    v = torch.where(active, v, VINF)
    return _unpack_best(r, w, v, W)


def dp_segment_best(q_seg: torch.Tensor, tpad: torch.Tensor,
                    tmax: torch.Tensor, seg_q: torch.Tensor,
                    active: torch.Tensor, S: int, W: int):
    """One DP segment + local-best endpoint; the kernel for CUDA tensors.

    tpad is the framed [B, S + W] window, active bool [B].  CPU tensors take
    the plain version; CUDA tensors launch the kernel (which raises on what
    it does not take).  Returns (r_best, w_best, j_best, d_best, ind_best).
    """
    if q_seg.device.type == "cpu":
        return dp_segment_best_plain(q_seg, tpad, tmax, seg_q, active, S, W)
    from .dp_kernel import dp_segment_best_cuda

    r, w, v = dp_segment_best_cuda(q_seg, tpad, tmax, seg_q, active, S, W)
    return _unpack_best(r, w, v, W)


class ExtensionResult(NamedTuple):
    q_adv: torch.Tensor     # query bases consumed from the start point
    t_adv: torch.Tensor     # target bases consumed
    dist: torch.Tensor      # accumulated edit distance
    matches: torch.Tensor   # accumulated exact matches
    align_len: torch.Tensor  # accumulated alignment columns
    n_segs: torch.Tensor    # DP segments this lane actually computed


def dynamic_slice_start(start: torch.Tensor, width: int, size: int):
    """The start ``lax.dynamic_slice`` uses: a negative start first wraps
    (start + width), then the start clamps to [0, width - size]."""
    start = torch.where(start < 0, start + width, start)
    return start.clamp(0, width - size).long()


def _slice_rows(rows: torch.Tensor, start: torch.Tensor, size: int):
    """rows[b, start[b] : start[b] + size] as a vmapped lax.dynamic_slice."""
    start = dynamic_slice_start(start, rows.shape[1], size)
    lane = torch.arange(rows.shape[0], device=rows.device)
    return rows.unfold(1, size, 1)[lane, start]


def _extend_direction_impl(q_pad, t_pad, q0, t0, qlen, tlen, *, S, W,
                           max_segs, min_seg_identity,
                           dp: Callable = dp_segment_best):
    """Segmented banded extension in one direction, counts only.

    Mirrors the counts branch of mecat_tpu.ops.align._extend_direction_impl
    including its early exit: the loop stops once no lane is active, which
    costs one host sync per segment.
    """
    B = q_pad.shape[0]
    half = W // 2
    dev = q_pad.device
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    qoff, toff, dist, matches, alen, nsegs = (zeros.clone() for _ in range(6))
    active = (qlen > 0) & (tlen > 0)
    slack = max(1, S // 4)
    n = 0
    while n < max_segs and bool(active.any()):
        seg_q = (qlen - qoff).clamp(0, S).to(torch.int32)
        rem_t = (tlen - toff).clamp(0, S + half).to(torch.int32)
        q_seg = _slice_rows(q_pad, q0 + qoff, S).contiguous()
        t_seg = _slice_rows(t_pad, t0 + toff, S + W).contiguous()
        r_end, _, j_end, d_seg, ind_seg = dp(q_seg, t_seg, rem_t, seg_q,
                                             active, S, W)
        m_seg = (torch.div(r_end + j_end + ind_seg, 2, rounding_mode="floor")
                 - d_seg).clamp(min=0)
        a_seg = m_seg + d_seg
        ident = m_seg.to(torch.float32) / a_seg.clamp(min=1).to(torch.float32)
        ok = (active & (r_end + j_end > 0) & (d_seg < INF)
              & ((ident >= min_seg_identity) | (a_seg < 32)))
        qoff = torch.where(ok, qoff + r_end, qoff)
        toff = torch.where(ok, toff + j_end, toff)
        dist = torch.where(ok, dist + d_seg, dist)
        matches = torch.where(ok, matches + m_seg, matches)
        alen = torch.where(ok, alen + a_seg, alen)
        nsegs = nsegs + active.to(torch.int32)
        active = (ok & (r_end >= seg_q - slack) & (r_end >= 1)
                  & (qoff < qlen) & (toff < tlen))
        n += 1
    return ExtensionResult(qoff, toff, dist, matches, alen, nsegs)


class PairAlignment(NamedTuple):
    """Both-direction extension of a seed; coords in the scanned orientation."""

    qbeg: torch.Tensor
    qend: torch.Tensor
    tbeg: torch.Tensor
    tend: torch.Tensor
    dist: torch.Tensor
    matches: torch.Tensor
    align_len: torch.Tensor
    identity: torch.Tensor  # float32 percent
    n_segs: torch.Tensor    # int32: DP segments actually computed, both dirs


def _pad(a: torch.Tensor, extra: int, sentinel: int, prefix: int = 0):
    B, n = a.shape
    out = torch.full((B, prefix + n + extra), sentinel, dtype=a.dtype,
                     device=a.device)
    out[:, prefix:prefix + n] = a
    return out


def extend_pair_batch(q: torch.Tensor, t: torch.Tensor,
                      qlen: torch.Tensor, tlen: torch.Tensor,
                      qseed: torch.Tensor, tseed: torch.Tensor,
                      *, S: int = C.ALIGN_SEGMENT, W: int = C.ALIGN_BAND,
                      max_segs: int = 64,
                      min_seg_identity: float = C.MIN_SEGMENT_IDENTITY,
                      dp: Callable = dp_segment_best) -> PairAlignment:
    """Extend candidate seeds in both directions.

    q uint8 [B, Lq] queries in scanned orientation; t uint8 [B, Lt] targets;
    qlen, tlen, qseed, tseed int32 [B].  Both directions run as one 2B-lane
    batch, so the early exit waits for max(left, right) segments.  ``dp`` is
    the segment function; callers leave it at :func:`dp_segment_best`, and
    only a comparison against the plain version passes
    :func:`dp_segment_best_plain`.
    """
    B, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    col = torch.arange(Lq, dtype=torch.int32, device=dev)
    qm = torch.where(col[None, :] < qlen[:, None], q, Q_SENTINEL).to(q.dtype)
    colt = torch.arange(Lt, dtype=torch.int32, device=dev)
    tm = torch.where(colt[None, :] < tlen[:, None], t, T_SENTINEL).to(t.dtype)
    # the reverse direction flips the WHOLE padded row of width Lq/Lt, so
    # its offsets are Lq - qseed and Lt - tseed
    q_both = torch.cat([_pad(qm, S, Q_SENTINEL),
                        _pad(torch.flip(qm, dims=[1]), S, Q_SENTINEL)])
    t_both = torch.cat([_pad(tm, S + W, T_SENTINEL, prefix=W // 2),
                        _pad(torch.flip(tm, dims=[1]), S + W, T_SENTINEL,
                             prefix=W // 2)])
    both = _extend_direction_impl(
        q_both, t_both,
        torch.cat([qseed, Lq - qseed]), torch.cat([tseed, Lt - tseed]),
        torch.cat([qlen - qseed, qseed]), torch.cat([tlen - tseed, tseed]),
        S=S, W=W, max_segs=max_segs, min_seg_identity=min_seg_identity,
        dp=dp)
    right = ExtensionResult(*(x[:B] for x in both))
    left = ExtensionResult(*(x[B:] for x in both))
    matches = left.matches + right.matches
    alen = left.align_len + right.align_len
    identity = 100.0 * matches / alen.clamp(min=1)
    return PairAlignment(
        qbeg=qseed - left.q_adv, qend=qseed + right.q_adv,
        tbeg=tseed - left.t_adv, tend=tseed + right.t_adv,
        dist=left.dist + right.dist, matches=matches, align_len=alen,
        identity=identity.to(torch.float32),
        n_segs=left.n_segs + right.n_segs)
