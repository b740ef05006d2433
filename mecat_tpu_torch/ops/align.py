"""Segmented banded extension aligner (port of mecat_tpu.ops.align).

Three forms: counts only (:func:`extend_pair_batch`, the overlap path and
mapping's scoring pass), with the packed move matrix of every segment
traced back row by row (:func:`extend_pair_batch_rows`, the correction
path), and with it traced back column by column into op tapes
(:func:`extend_pair_batch_with_ops`, mapping's CIGAR pass).  The DP of one
segment runs in the hand-written Hopper kernels (``csrc/dp_segment.cu``
through :mod:`.dp_kernel`) for CUDA tensors, and in their plain PyTorch
version (:func:`banded_dp_segment` + :func:`pick_end_local`) for CPU
tensors.  :func:`dp_segment_best` dispatches on the tensor's device only: a
CUDA tensor launches the kernel or raises.  The counts form's segment loop
does the same: on CUDA tensors :func:`_extend_direction_impl` is one launch
of the segment-loop kernel of the same source, on CPU tensors the host
loop over :func:`dp_segment_best_plain`; so does the move-writing form of
both directions (:func:`_extend_both_with_moves`: one launch of the move
loop, cut by :func:`slots_to_raw` to what the host loop gives).  The two
walks do the same:
:func:`traceback_rows` and :func:`traceback_ops` launch the kernels of
``csrc/cns_walk.cu`` (through :mod:`.walk_kernel`) for CUDA tensors and run
:func:`traceback_rows_plain` / :func:`traceback_ops_plain` for CPU tensors.

Moves are 2-bit codes, 16 per int32 word along the band, laid out
``[lanes, S, W/16]`` (the JAX package keeps ``[S, W/16, lanes]``): the code
of (row i, band cell w) is ``(moves[b, i-1, w//16] >> 2*(w%16)) & 3``.
``traceback_counts`` has no caller in the reference and is not ported.

Everything else mirrors ``mecat_tpu/ops/align.py`` op for op, so results
are bit-equal: packed DP values and coordinates are int32, identities are
float32 in the reference's operation order, and every dynamic slice clamps
its start the way ``lax.dynamic_slice`` does.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import constants as C
from ..utils.metrics import kernel_span, span

INF = 1 << 20
Q_SENTINEL = 255
T_SENTINEL = 254
#: DP values are packed as dist * IND_K + indels (see mecat_tpu.ops.align)
IND_K = 4096
VINF = 1 << 30
_NEG = -(1 << 26)

# move codes
MOVE_MATCH = 0     # diagonal, q char == t char
MOVE_MISMATCH = 1  # diagonal, substitution
MOVE_VERT = 2      # query char vs gap (insertion in query)
MOVE_HORIZ = 3     # target char vs gap (deletion from target)


def banded_dp_segment(q_seg: torch.Tensor, tpad: torch.Tensor,
                      tmax: torch.Tensor, W: int, want_moves: bool = False):
    """Banded edit-distance DP rows of one segment per lane.

    q_seg uint8 [B, S]; tpad uint8 [B, S + W], the target window framed
    with W/2 leading sentinels (tpad[:, x] = window[x - W/2]); tmax int32
    [B].  Returns (rows, moves): rows int32 [B, S+1, W] (row r = after r
    query chars), packed dist * IND_K + indels, VINF outside the band;
    moves int32 [B, S, W/16] for rows 1..S (None unless ``want_moves``),
    attributed with priority diagonal > vertical > horizontal from the same
    integers on every cell, valid or not.
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
    # 2-bit packing weights; the sum runs in int64 and wraps to int32 below
    # (slot 15 reaches the sign bit)
    pack_w = (torch.ones(16, dtype=torch.int64, device=dev)
              << (2 * torch.arange(16, dtype=torch.int64, device=dev)))
    rows = [row]
    moves = []
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
        if want_moves:
            move = torch.where(row == diag, sub,
                               torch.where(row == vert, MOVE_VERT,
                                           MOVE_HORIZ))
            packed = (move.reshape(B, W // 16, 16).long() * pack_w).sum(2)
            packed = torch.where(packed >= 1 << 31, packed - (1 << 32),
                                 packed)
            moves.append(packed.to(torch.int32))
    return (torch.stack(rows, dim=1),
            torch.stack(moves, dim=1) if want_moves else None)


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
                          active: torch.Tensor, S: int, W: int,
                          want_moves: bool = False):
    """Plain PyTorch version of both DP kernels, on any device.

    Returns (r_best, w_best, j_best, d_best, ind_best) int32 [B], preceded
    by the packed moves int32 [B, S, W/16] with ``want_moves``.  An inactive
    lane gets the kernels' skip record (r=0, w=W/2, v=VINF) and zero moves.
    Unlike the kernel it fills the move rows past ``seg_q`` too; no
    traceback reads them.
    """
    rows, moves = banded_dp_segment(q_seg, tpad, tmax, W, want_moves)
    r, w, v = pick_end_local(rows, seg_q, tmax, W)
    r = torch.where(active, r, 0)
    w = torch.where(active, w, W // 2)
    v = torch.where(active, v, VINF)
    best = _unpack_best(r, w, v, W)
    if not want_moves:
        return best
    return (torch.where(active[:, None, None], moves, 0), *best)


def dp_segment_best(q_seg: torch.Tensor, tpad: torch.Tensor,
                    tmax: torch.Tensor, seg_q: torch.Tensor,
                    active: torch.Tensor, S: int, W: int,
                    want_moves: bool = False):
    """One DP segment + local-best endpoint; the kernels for CUDA tensors.

    tpad is the framed [B, S + W] window, active bool [B].  CPU tensors take
    the plain version; CUDA tensors launch the counts-only kernel or, with
    ``want_moves``, the move-writing one (which raise on what they do not
    take).  Returns (r_best, w_best, j_best, d_best, ind_best), preceded by
    the packed moves [B, S, W/16] with ``want_moves``.
    """
    if q_seg.device.type == "cpu":
        return dp_segment_best_plain(q_seg, tpad, tmax, seg_q, active, S, W,
                                     want_moves)
    from .dp_kernel import dp_segment_best_cuda, dp_segment_best_moves_cuda

    if want_moves:
        moves, r, w, v = dp_segment_best_moves_cuda(q_seg, tpad, tmax, seg_q,
                                                    active, S, W)
        return (moves, *_unpack_best(r, w, v, W))
    r, w, v = dp_segment_best_cuda(q_seg, tpad, tmax, seg_q, active, S, W)
    return _unpack_best(r, w, v, W)


def traceback_rows_plain(moves: torch.Tensor, seg_qlen: torch.Tensor,
                         w_end: torch.Tensor, W: int):
    """Row-major traceback: walk DP rows (S steps) from (seg_qlen, w_end);
    the plain version of the row-walk kernel, on any device.

    Within a DP row the backward path is a maximal run of HORIZ cells ending
    at the first non-HORIZ cell at or left of the entry column, so one row
    costs a few ops over [N, W] and no gather along the path.

    moves packed int32 [N, S, W/16].  Returns (mv, h, w_out, w0):
      mv int32 [N, S]: mv[b, r-1] = the diagonal/vertical move that left
        row r (MOVE_MATCH/MISMATCH/VERT), or -1 if the walk never visited
        row r (r > seg_qlen, or the path broke: only on endpoint-gated
        segments, which callers mask out);
      h int32 [N, S]: HORIZ columns emitted at row r before the exit move;
      w_out int32 [N, S]: band column of the exit move (-1 if none);
      w0 int32 [N]: band column at row 0 (leading target deletions =
        max(w0 - W/2, 0)).

    The reference carries the position as a one-hot row; here it is the
    column itself.  An empty one-hot reads as column 0 everywhere, so a
    ``w_end`` outside [0, W) starts at column 0, and a VERT out of the last
    column goes to 0.
    """
    N, S, _ = moves.shape
    dev = moves.device
    w_iota = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    shift16 = 2 * torch.arange(16, dtype=torch.int32, device=dev)
    r_end = seg_qlen.to(torch.int32)
    w = w_end.to(torch.int32)
    w = torch.where((w >= 0) & (w < W), w, 0)
    alive = torch.ones(N, dtype=torch.bool, device=dev)
    minus1 = torch.full((N,), -1, dtype=torch.int32, device=dev)
    mv_s, h_s, wo_s = [], [], []
    for r in range(S, 0, -1):
        # arithmetic >> then & 3 is sign-safe for the top 2-bit slot
        mv = ((moves[:, r - 1, :, None] >> shift16) & 3).reshape(N, W)
        act = alive & (r_end >= r)
        cand = (mv != MOVE_HORIZ) & (w_iota <= w[:, None])
        w_out = torch.where(cand, w_iota, -1).max(dim=1).values
        found = act & (w_out >= 0)
        mv_at = torch.gather(mv, 1, w_out.clamp(min=0).long()[:, None])[:, 0]
        mv_out = torch.where(found, mv_at, minus1)
        h_s.append(torch.where(found, w - w_out, 0))
        # VERT leaves to (r-1, w+1); diagonal to (r-1, w)
        w_vert = torch.where(w_out + 1 < W, w_out + 1, 0)
        w_next = torch.where(mv_out == MOVE_VERT, w_vert, w_out)
        w = torch.where(found, w_next, w)
        alive = alive & (found | ~act)
        mv_s.append(mv_out)
        wo_s.append(torch.where(found, w_out, minus1))
    # steps ran from row S down: reverse into ascending row order
    stack = lambda xs: torch.stack(xs[::-1], dim=1)
    return stack(mv_s), stack(h_s), stack(wo_s), w


def traceback_rows(moves: torch.Tensor, seg_qlen: torch.Tensor,
                   w_end: torch.Tensor, W: int):
    """The row walk of :func:`traceback_rows_plain`; the kernel for CUDA
    tensors.

    CPU tensors take the plain version; CUDA tensors launch the row-walk
    kernel (``csrc/cns_walk.cu`` through :mod:`.walk_kernel`), which raises
    on what it does not take.  Returns (mv, h, w_out, w0).
    """
    if moves.device.type == "cpu":
        return traceback_rows_plain(moves, seg_qlen, w_end, W)
    from .walk_kernel import traceback_rows_cuda

    return traceback_rows_cuda(moves.contiguous(),
                               seg_qlen.to(torch.int32).contiguous(),
                               w_end.to(torch.int32).contiguous(), W)


def _read_move(flat: torch.Tensor, i: torch.Tensor, w: torch.Tensor,
               S: int, W: int):
    """The 2-bit move at (row i, band w) of every lane; flat int32 [N, S*Wp].

    The lane's moves are indexed as ONE flat vector, as the reference does:
    the word index (i-1)*Wp + w//16 is clipped to [0, S*Wp - 1], so i = 0
    reads word 0 (masked by the caller), and w = W or w = -1 (a VERT out of
    the last column, a HORIZ out of column 0) read a neighbour row's word.
    ``w // 16`` and ``w % 16`` floor.
    """
    Wp = W // 16
    idx = ((i - 1) * Wp + torch.div(w, 16, rounding_mode="floor")).clamp(
        0, S * Wp - 1)
    word = torch.gather(flat, 1, idx.long()[:, None])[:, 0]
    # arithmetic >> then & 3 is sign-safe for the top 2-bit slot
    return (word >> (2 * torch.remainder(w, 16))) & 3


def max_tape_cols(S: int, W: int, min_seg_identity: float) -> int:
    """Tape width sufficient for any segment that passes the identity gate.

    A segment's column count a = m + mism + ins + del obeys
    a <= 2*r_end + W/2 - (m + mism), so with the acceptance rule of the
    segment loop (identity m/a >= p, or a < 32) the worst accepted segment
    has a <= (2S + W/2)/(1 + p).  Segments failing the gate keep their tapes
    but are masked to n_cols = 0 by the caller, so truncating their walk is
    harmless.  Rounded up to a multiple of 64.
    """
    bound = int((2 * S + W // 2) / (1.0 + min_seg_identity)) + 1
    return min(2 * S + W, -(-max(bound, 32) // 64) * 64)


def _tape_indices(ops: torch.Tensor):
    """(qi, tj) of a right-aligned op tape: inclusive cumsums of the chars
    each column consumes, -1 where the column consumes none of that side."""
    consumes_q = ((ops == MOVE_MATCH) | (ops == MOVE_MISMATCH)
                  | (ops == MOVE_VERT))
    consumes_t = (ops >= 0) & (ops != MOVE_VERT)
    ct_i = consumes_t.to(torch.int32)
    cq = torch.cumsum(consumes_q.to(torch.int32), dim=1, dtype=torch.int32)
    ct = torch.cumsum(ct_i, dim=1, dtype=torch.int32)
    qi = torch.where(consumes_q, cq - 1, -1)
    tj = torch.where(ops >= 0, ct - ct_i, -1)
    return qi, tj


def traceback_ops_plain(moves: torch.Tensor, seg_qlen: torch.Tensor,
                        w_end: torch.Tensor, W: int, max_cols: int = 0):
    """Column traceback from (seg_qlen, w_end) emitting the full op tape;
    the plain version of the column-walk kernel, on any device.

    moves packed int32 [N, S, W/16].  Returns (ops, qi, tj, n_cols):
      ops int8 [N, MAXC]: move codes in forward order, right-aligned (the
        walk emits backwards from the end state), so column c of lane b is
        ops[b, MAXC - n_cols[b] + c]; -1 in the unused prefix;
      qi int32 [N, MAXC]: query char index of the column (-1 for deletions);
      tj int32 [N, MAXC]: target char index (for insertions: the target
        position the insert precedes);
      n_cols int32 [N].
    MAXC = max_cols if given, else 2*S + W (the unconditional worst case).
    One loop of MAXC steps walks every lane at once; a step is a gather of
    one move word per lane.
    """
    N, S, Wp = moves.shape
    half = W // 2
    MAXC = max_cols if max_cols else 2 * S + W
    flat = moves.reshape(N, S * Wp)
    i = seg_qlen.to(torch.int32)
    w = w_end.to(torch.int32)
    n = torch.zeros_like(i)
    mv_s = []
    for _ in range(MAXC):
        in_dp = i > 0
        # leading target deletions at row 0: i stays 0, j = w - half falls
        tail_del = (i == 0) & (w - half > 0)
        mv = torch.where(in_dp, _read_move(flat, i, w, S, W),
                         torch.where(tail_del, MOVE_HORIZ, -1))
        active = mv >= 0
        di = in_dp & active & (mv != MOVE_HORIZ)
        dw = torch.where(mv == MOVE_VERT, 1,
                         torch.where(mv == MOVE_HORIZ, -1, 0))
        i = i - di.to(torch.int32)
        w = w + dw
        n = n + active.to(torch.int32)
        mv_s.append(mv.to(torch.int8))
    ops = torch.flip(torch.stack(mv_s, dim=1), dims=[1])
    qi, tj = _tape_indices(ops)
    return ops, qi, tj, n


def traceback_ops(moves: torch.Tensor, seg_qlen: torch.Tensor,
                  w_end: torch.Tensor, W: int, max_cols: int = 0):
    """The column walk of :func:`traceback_ops_plain`; the kernel for CUDA
    tensors.

    CPU tensors take the plain version; CUDA tensors launch the
    column-walk kernel (``csrc/cns_walk.cu`` through :mod:`.walk_kernel`),
    which raises on what it does not take, and take qi, tj from its tape.
    Returns (ops, qi, tj, n_cols).
    """
    if moves.device.type == "cpu":
        return traceback_ops_plain(moves, seg_qlen, w_end, W, max_cols)
    from .walk_kernel import traceback_ops_cuda

    maxc = max_cols if max_cols else 2 * moves.shape[1] + W
    ops, n = traceback_ops_cuda(moves.contiguous(),
                                seg_qlen.to(torch.int32).contiguous(),
                                w_end.to(torch.int32).contiguous(), W, maxc)
    qi, tj = _tape_indices(ops)
    return ops, qi, tj, n


def rows_to_tape(mv: torch.Tensor, h: torch.Tensor, w0: torch.Tensor,
                 W: int, max_cols: int):
    """Row-walk outputs -> the right-aligned op tape of :func:`traceback_ops`.

    Forward tape = HORIZ^lead_del, then per visited row r ascending: mv_r
    followed by HORIZ^h_r.  Returns (ops, qi, tj, n_cols) exactly as
    :func:`traceback_ops` for any walk that fits max_cols (longer walks
    differ only in which end is cut; both only occur on endpoint-gated
    segments).
    """
    B, S = mv.shape
    half = W // 2
    MAXC = max_cols
    dev = mv.device
    emitted = mv >= 0
    hc = torch.cumsum(h, dim=1, dtype=torch.int32)
    n_rows = emitted.sum(dim=1, dtype=torch.int32)
    lead = (w0 - half).clamp(min=0)
    n_full = n_rows + hc[:, -1] + lead
    n_cols = n_full.clamp(max=MAXC)
    r_iota = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    p = lead[:, None] + r_iota + (hc - h)        # forward col of mv_r
    slot = p + (MAXC - n_full)[:, None]
    # a slot that is not written goes to a sentinel column that is cut off
    slot = torch.where(emitted & (slot >= 0), slot, MAXC)
    col = torch.arange(MAXC + 1, dtype=torch.int32, device=dev)[None, :]
    ops = torch.where(col >= (MAXC - n_cols)[:, None], MOVE_HORIZ, -1
                      ).to(torch.int8)
    ops.scatter_(1, slot.long(), mv.to(torch.int8))
    ops = ops[:, :MAXC].contiguous()
    qi, tj = _tape_indices(ops)
    return ops, qi, tj, n_cols


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
                           dp: Callable = dp_segment_best,
                           collect_ops: bool = False):
    """Segmented banded extension in one direction.

    Mirrors mecat_tpu.ops.align._extend_direction_impl including the counts
    branch's early exit.  The counts branch (``collect_ops`` False) on CUDA
    tensors with ``dp`` left at :func:`dp_segment_best` is one launch of
    the segment-loop kernel (``csrc/dp_segment.cu`` through
    :func:`.dp_kernel.extend_counts_cuda`), which runs every lane to its own
    end on the card.  Otherwise the loop runs here, one ``dp`` call a
    segment over every lane, and stops once no lane is active, which costs
    one host sync a segment: that is the plain version of the kernel (CPU
    tensors, or ``dp=dp_segment_best_plain`` for a comparison on the card).
    Returns (ExtensionResult, raw); raw is None unless ``collect_ops``.

    With ``collect_ops`` every segment also keeps (moves [B, S, W/16],
    r_end, w_end, qoff_before, toff_before, ok), stacked on a leading
    segment axis G.  The reference always scans ``max_segs`` segments there;
    the segments after the last active lane are all ``ok = False`` and every
    consumer masks by ``ok``, so this loop stops early too (after at least
    one segment): G = max(1, max(n_segs)) <= max_segs.  On CUDA the
    move-writing form runs through :func:`_extend_both_with_moves`, one
    launch of the move loop for both directions.
    """
    B = q_pad.shape[0]
    half = W // 2
    dev = q_pad.device
    if not collect_ops and dp is dp_segment_best and dev.type == "cuda":
        from .dp_kernel import extend_counts_cuda

        res = extend_counts_cuda(
            q_pad.contiguous(), t_pad.contiguous(),
            *(x.to(torch.int32).contiguous() for x in (q0, t0, qlen, tlen)),
            S=S, W=W, max_segs=max_segs, min_seg_identity=min_seg_identity)
        return ExtensionResult(*res), None
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    qoff, toff, dist, matches, alen, nsegs = (zeros.clone() for _ in range(6))
    active = (qlen > 0) & (tlen > 0)
    slack = max(1, S // 4)
    raw = []
    n = 0
    while n < max_segs and ((collect_ops and n == 0) or bool(active.any())):
        seg_q = (qlen - qoff).clamp(0, S).to(torch.int32)
        rem_t = (tlen - toff).clamp(0, S + half).to(torch.int32)
        q_seg = _slice_rows(q_pad, q0 + qoff, S).contiguous()
        t_seg = _slice_rows(t_pad, t0 + toff, S + W).contiguous()
        if collect_ops:
            moves, r_end, w_end, j_end, d_seg, ind_seg = dp(
                q_seg, t_seg, rem_t, seg_q, active, S, W, want_moves=True)
        else:
            r_end, _, j_end, d_seg, ind_seg = dp(q_seg, t_seg, rem_t, seg_q,
                                                 active, S, W)
        m_seg = (torch.div(r_end + j_end + ind_seg, 2, rounding_mode="floor")
                 - d_seg).clamp(min=0)
        a_seg = m_seg + d_seg
        ident = m_seg.to(torch.float32) / a_seg.clamp(min=1).to(torch.float32)
        ok = (active & (r_end + j_end > 0) & (d_seg < INF)
              & ((ident >= min_seg_identity) | (a_seg < 32)))
        if collect_ops:
            raw.append((moves, r_end, w_end, qoff, toff, ok))
        qoff = torch.where(ok, qoff + r_end, qoff)
        toff = torch.where(ok, toff + j_end, toff)
        dist = torch.where(ok, dist + d_seg, dist)
        matches = torch.where(ok, matches + m_seg, matches)
        alen = torch.where(ok, alen + a_seg, alen)
        nsegs = nsegs + active.to(torch.int32)
        active = (ok & (r_end >= seg_q - slack) & (r_end >= 1)
                  & (qoff < qlen) & (toff < tlen))
        n += 1
    res = ExtensionResult(qoff, toff, dist, matches, alen, nsegs)
    if not collect_ops:
        return res, None
    return res, tuple(torch.stack(x) for x in zip(*raw))


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


def _masked(a: torch.Tensor, n: torch.Tensor, sentinel: int):
    """a with every column at or past n[b] replaced by the sentinel."""
    col = torch.arange(a.shape[1], dtype=torch.int32, device=a.device)
    return torch.where(col[None, :] < n[:, None], a, sentinel).to(a.dtype)


def extend_both_directions(q: torch.Tensor, t: torch.Tensor,
                           qlen: torch.Tensor, tlen: torch.Tensor,
                           qseed: torch.Tensor, tseed: torch.Tensor,
                           *, S: int = C.ALIGN_SEGMENT,
                           W: int = C.ALIGN_BAND, max_segs: int = 64,
                           min_seg_identity: float = C.MIN_SEGMENT_IDENTITY,
                           dp: Callable = dp_segment_best) -> ExtensionResult:
    """The counts-only extension of both directions as one 2B-lane batch:
    the ExtensionResult of the B right lanes, then the B left lanes.

    Arguments as :func:`extend_pair_batch`.  The host loop of the plain
    version runs ``max(n_segs)`` segments over all 2B lanes, so it issues
    ``2B * max(n_segs)`` lane-segments.
    """
    with kernel_span("dp.lanes"):
        lanes = direction_lanes(q, t, qlen, tlen, qseed, tseed, S, W)
    both, _ = _extend_direction_impl(
        *lanes, S=S, W=W, max_segs=max_segs,
        min_seg_identity=min_seg_identity, dp=dp)
    return both


def direction_lanes(q, t, qlen, tlen, qseed, tseed, S: int, W: int):
    """The 2B lanes of :func:`extend_both_directions`, as
    :func:`_extend_direction_impl` takes them: (q_pad [2B, Lq + S], t_pad
    [2B, W/2 + Lt + S + W], q0, t0, qlen, tlen [2B]), the B right
    extensions, then the B left ones on the reversed rows."""
    Lq = q.shape[1]
    Lt = t.shape[1]
    qm = _masked(q, qlen, Q_SENTINEL)
    tm = _masked(t, tlen, T_SENTINEL)
    # the reverse direction flips the WHOLE padded row of width Lq/Lt, so
    # its offsets are Lq - qseed and Lt - tseed
    q_both = torch.cat([_pad(qm, S, Q_SENTINEL),
                        _pad(torch.flip(qm, dims=[1]), S, Q_SENTINEL)])
    t_both = torch.cat([_pad(tm, S + W, T_SENTINEL, prefix=W // 2),
                        _pad(torch.flip(tm, dims=[1]), S + W, T_SENTINEL,
                             prefix=W // 2)])
    return (q_both, t_both,
            torch.cat([qseed, Lq - qseed]), torch.cat([tseed, Lt - tseed]),
            torch.cat([qlen - qseed, qseed]), torch.cat([tlen - tseed, tseed]))


def pair_alignment(both: ExtensionResult, qseed: torch.Tensor,
                   tseed: torch.Tensor) -> PairAlignment:
    """The PairAlignment of :func:`extend_both_directions`' lanes."""
    B = qseed.shape[0]
    right = ExtensionResult(*(x[:B] for x in both))
    left = ExtensionResult(*(x[B:] for x in both))
    return _pair_alignment(left, right, qseed, tseed)


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
    batch (:func:`extend_both_directions`): on CUDA tensors one launch of
    the segment-loop kernel, each lane to its own end; in the plain host
    loop the early exit waits for max(left, right) segments.  ``dp`` is
    the segment function; callers leave it at :func:`dp_segment_best`, and
    only a comparison against the plain version passes
    :func:`dp_segment_best_plain`.
    """
    both = extend_both_directions(
        q, t, qlen, tlen, qseed, tseed, S=S, W=W, max_segs=max_segs,
        min_seg_identity=min_seg_identity, dp=dp)
    return pair_alignment(both, qseed, tseed)


def _pair_alignment(left: ExtensionResult, right: ExtensionResult,
                    qseed: torch.Tensor, tseed: torch.Tensor):
    matches = left.matches + right.matches
    alen = left.align_len + right.align_len
    identity = 100.0 * matches / alen.clamp(min=1)
    return PairAlignment(
        qbeg=qseed - left.q_adv, qend=qseed + right.q_adv,
        tbeg=tseed - left.t_adv, tend=tseed + right.t_adv,
        dist=left.dist + right.dist, matches=matches, align_len=alen,
        identity=identity.to(torch.float32),
        n_segs=left.n_segs + right.n_segs)


def extend_moves_plain(q_pad, t_pad, q0, t0, qlen, tlen, *, S: int, W: int,
                       max_segs: int, min_seg_identity: float,
                       split: int | None = None,
                       max_segs_b: int | None = None):
    """The plain version of :func:`.dp_kernel.extend_moves_cuda`, lane by
    lane, on any device.

    Each lane runs alone through the host loop (:func:`_extend_direction_impl`
    with ``collect_ops`` on :func:`dp_segment_best_plain`), to its own end
    as the kernel runs it, and its segments go into the same slots: (final,
    (moves [G, N, S, W/16], r_end, w_end, qoff_before, toff_before, ok
    [G, N])) with G = max(max_segs, max_segs_b).  Lanes below ``split``
    (default N) have ``max_segs`` segments, the others ``max_segs_b``
    (default ``max_segs``).  The slots a lane never reaches, which the
    kernel leaves unwritten, hold -1 here (``ok`` True), so a caller that
    reads them shows.
    """
    N = q_pad.shape[0]
    split = N if split is None else split
    max_segs_b = max_segs if max_segs_b is None else max_segs_b
    G = max(max_segs, max_segs_b, 1)
    dev = q_pad.device
    final = torch.zeros((6, N), dtype=torch.int32, device=dev)
    slots = (torch.full((G, N, S, W // 16), -1, dtype=torch.int32,
                        device=dev),
             *(torch.full((G, N), -1, dtype=torch.int32, device=dev)
               for _ in range(4)),
             torch.ones((G, N), dtype=torch.bool, device=dev))
    for b in range(N):
        res, raw = _extend_direction_impl(
            *(x[b:b + 1] for x in (q_pad, t_pad, q0, t0, qlen, tlen)),
            S=S, W=W, max_segs=max_segs if b < split else max_segs_b,
            min_seg_identity=min_seg_identity, dp=dp_segment_best_plain,
            collect_ops=True)
        final[:, b] = torch.stack([x[0] for x in res])
        n = int(res.n_segs[0])
        for dst, src in zip(slots, raw):
            dst[:n, b] = src[:n, 0]
    return tuple(final.unbind(0)), slots


def slots_to_raw(final, slots, B: int, W: int):
    """The move loop's slots -> what the host loop of both directions
    gives: (left, right, raw2, G) as :func:`_extend_both_with_moves`
    returns them.

    ``final`` and ``slots`` as :func:`.dp_kernel.extend_moves_cuda` returns
    them for the 2B lanes of :func:`direction_lanes` (right first).  Each
    direction keeps G = max(1, max(nsegs)) slots over its lanes (pulled in
    one ``.tolist()``), exactly as many segments as its host loop runs, and
    a slot past a lane's own end becomes the host loop's record of an
    inactive lane: zero moves, r_end 0, w_end W/2, the lane's final qoff /
    toff, ok False.  So every slot < G equals the host loop's, however the
    unwritten slots were filled.
    """
    moves, r_end, w_end, qo, to, ok = slots
    qoff, toff, nsegs = final[0], final[1], final[5]
    dev = nsegs.device
    N = nsegs.shape[0]
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    halves = (slice(0, B), slice(B, N))
    Gs = [max(1, int(g)) for g in torch.stack(
        [torch.cat([nsegs[h], zero]).max() for h in halves]).tolist()]
    G2 = sum(Gs)
    moves2 = torch.empty((G2, B) + tuple(moves.shape[2:]), dtype=torch.int32,
                         device=dev)
    r2, w2, qo2, to2 = (torch.empty((G2, B), dtype=torch.int32, device=dev)
                        for _ in range(4))
    ok2 = torch.empty((G2, B), dtype=torch.bool, device=dev)
    at = 0
    for G, h in zip(Gs, halves):
        live = (torch.arange(G, dtype=torch.int32, device=dev)[:, None]
                < nsegs[None, h])
        out = slice(at, at + G)
        torch.where(live[:, :, None, None], moves[:G, h], zero[0],
                    out=moves2[out])
        r2[out] = torch.where(live, r_end[:G, h], 0)
        w2[out] = torch.where(live, w_end[:G, h], W // 2)
        qo2[out] = torch.where(live, qo[:G, h], qoff[None, h])
        to2[out] = torch.where(live, to[:G, h], toff[None, h])
        ok2[out] = live & ok[:G, h]
        at += G
    right = ExtensionResult(*(x[:B] for x in final))
    left = ExtensionResult(*(x[B:] for x in final))
    return left, right, (moves2, r2, w2, qo2, to2, ok2), Gs[0]


def _extend_both_with_moves(q, t, qlen, tlen, qseed, tseed, *, S, W,
                             max_segs, min_seg_identity, max_segs_left, dp):
    """Both directions, each with its own segment budget and its moves kept.

    Returns (left, right, raw2, G): the two ExtensionResults, the raw
    per-segment outputs (moves, r_end, w_end, qoff, toff, ok) of both
    directions concatenated on the segment axis (right first), and the
    number of right segments G.  On CUDA tensors with ``dp`` left at
    :func:`dp_segment_best` both directions are one launch of the
    move-writing segment loop over the 2B lanes of :func:`direction_lanes`
    (:func:`.dp_kernel.extend_moves_cuda`), cut to the host loop's segments
    by :func:`slots_to_raw`; otherwise each direction runs the host loop,
    the plain version.
    """
    B = q.shape[0]
    # a host span: correction opens this once a chunk, hundreds a slice
    with span("dp.lanes"):
        lanes = direction_lanes(q, t, qlen, tlen, qseed, tseed, S, W)
    max_left = max_segs_left or max_segs
    if dp is dp_segment_best and q.device.type == "cuda":
        from .dp_kernel import extend_moves_cuda

        loop = extend_moves_cuda(
            *(x.contiguous() for x in lanes[:2]),
            *(x.to(torch.int32).contiguous() for x in lanes[2:]),
            S=S, W=W, max_segs=max_segs, min_seg_identity=min_seg_identity,
            split=B, max_segs_b=max_left)
        return slots_to_raw(*loop, B, W)
    kw = dict(S=S, W=W, min_seg_identity=min_seg_identity, dp=dp,
              collect_ops=True)
    right, right_raw = _extend_direction_impl(
        *(x[:B] for x in lanes), max_segs=max_segs, **kw)
    left, left_raw = _extend_direction_impl(
        *(x[B:] for x in lanes), max_segs=max_left, **kw)
    raw2 = tuple(torch.cat([r, l]) for r, l in zip(right_raw, left_raw))
    return left, right, raw2, right_raw[0].shape[0]


def extend_pair_batch_rows(q: torch.Tensor, t: torch.Tensor,
                           qlen: torch.Tensor, tlen: torch.Tensor,
                           qseed: torch.Tensor, tseed: torch.Tensor,
                           *, S: int = C.ALIGN_SEGMENT,
                           W: int = C.ALIGN_BAND, max_segs: int = 64,
                           min_seg_identity: float = C.MIN_SEGMENT_IDENTITY,
                           max_segs_left: int = 0,
                           dp: Callable = dp_segment_best):
    """Extend both directions and trace every segment back row by row.

    The two directions run with their own segment budgets (``max_segs``
    right, ``max_segs_left`` left, 0 = the same), then ONE
    :func:`traceback_rows` walks every (segment, pair) lane of both.
    Returns (pa, right_rows, left_rows); each rows tuple is (mv, h, wo
    [G, B, S], w0 [G, B], qoff, toff, ok [G, B]) in the direction's local
    coordinates, the raw material of ops/consensus_banded.  G is the number
    of segments the direction ran (see :func:`_extend_direction_impl`);
    entries where ``ok`` is False are unspecified.
    """
    return rows_from_moves(qseed, tseed, S, W, *_extend_both_with_moves(
        q, t, qlen, tlen, qseed, tseed, S=S, W=W, max_segs=max_segs,
        min_seg_identity=min_seg_identity, max_segs_left=max_segs_left,
        dp=dp))


def rows_from_moves(qseed, tseed, S: int, W: int, left, right, raw2, G):
    """The results of :func:`extend_pair_batch_rows` from those of
    :func:`_extend_both_with_moves`."""
    B = qseed.shape[0]
    moves2, r2, w2, qo2, to2, ok2 = raw2
    G2 = moves2.shape[0]
    mv2, h2, wo2, w02 = traceback_rows(
        moves2.reshape(G2 * B, S, -1), r2.reshape(-1), w2.reshape(-1), W)
    mv2, h2, wo2 = (a.reshape(G2, B, S) for a in (mv2, h2, wo2))
    w02 = w02.reshape(G2, B)
    right_rows = (mv2[:G], h2[:G], wo2[:G], w02[:G], qo2[:G], to2[:G],
                  ok2[:G])
    left_rows = (mv2[G:], h2[G:], wo2[G:], w02[G:], qo2[G:], to2[G:],
                 ok2[G:])
    return _pair_alignment(left, right, qseed, tseed), right_rows, left_rows


def extend_pair_batch_with_ops(q: torch.Tensor, t: torch.Tensor,
                               qlen: torch.Tensor, tlen: torch.Tensor,
                               qseed: torch.Tensor, tseed: torch.Tensor,
                               *, S: int = C.ALIGN_SEGMENT,
                               W: int = C.ALIGN_BAND, max_segs: int = 64,
                               min_seg_identity: float
                               = C.MIN_SEGMENT_IDENTITY,
                               max_segs_left: int = 0,
                               dp: Callable = dp_segment_best):
    """Extend both directions and trace every segment back into op tapes.

    Returns (pa, right_tapes, left_tapes); each tapes tuple is (ops
    [G, B, MAXC] int8, qi, tj [G, B, MAXC], n_cols [G, B], qoff_before,
    toff_before, applied [G, B]) in the direction's local coordinates (left:
    positions in the REVERSED prefixes), with MAXC =
    :func:`max_tape_cols`.  ONE :func:`traceback_ops` walks every
    (segment, pair) lane of both directions.  ``n_cols`` is 0 where the
    segment was not applied.  G is the number of segments the direction ran
    (the reference always scans its whole budget; the segments it scans
    past that are all unapplied, with ``n_cols`` 0).
    """
    return ops_from_moves(
        qseed, tseed, S, W, min_seg_identity, *_extend_both_with_moves(
            q, t, qlen, tlen, qseed, tseed, S=S, W=W, max_segs=max_segs,
            min_seg_identity=min_seg_identity, max_segs_left=max_segs_left,
            dp=dp))


def ops_from_moves(qseed, tseed, S: int, W: int, min_seg_identity: float,
                   left, right, raw2, G):
    """The results of :func:`extend_pair_batch_with_ops` from those of
    :func:`_extend_both_with_moves`."""
    B = qseed.shape[0]
    moves2, r2, w2, qo2, to2, ok2 = raw2
    G2 = moves2.shape[0]
    TC = max_tape_cols(S, W, min_seg_identity)
    ops2, qi2, tj2, nc2 = traceback_ops(
        moves2.reshape(G2 * B, S, -1), r2.reshape(-1), w2.reshape(-1), W,
        max_cols=TC)
    ops2, qi2, tj2 = (a.reshape(G2, B, TC) for a in (ops2, qi2, tj2))
    nc2 = torch.where(ok2, nc2.reshape(G2, B), 0)
    right_t = (ops2[:G], qi2[:G], tj2[:G], nc2[:G], qo2[:G], to2[:G],
               ok2[:G])
    left_t = (ops2[G:], qi2[G:], tj2[G:], nc2[G:], qo2[G:], to2[G:], ok2[G:])
    return _pair_alignment(left, right, qseed, tseed), right_t, left_t
