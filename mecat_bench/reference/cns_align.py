"""Plain segmented banded extension with moves and the row walk.

Frozen copy of the plain (host-loop) versions of the port's
``ops/align.py`` functions that correction runs: the banded DP segment
with its packed moves, the local best endpoint, the segment loop of each
direction, the row walk and the pair alignment.  Plain PyTorch on any
device; no kernel and no import of the program.  Moves are 2-bit codes, 16
per int32 word along the band, ``[lanes, S, W/16]``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

INF = 1 << 20
Q_SENTINEL = 255
T_SENTINEL = 254
IND_K = 4096
VINF = 1 << 30
_NEG = -(1 << 26)
MIN_SEGMENT_IDENTITY = 0.65
TRIM_PENALTY = 2

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
                   penalty: int = TRIM_PENALTY):
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
    """One banded DP segment and its local best endpoint, on any device.

    Returns (r_best, w_best, j_best, d_best, ind_best) int32 [B], preceded
    by the packed moves int32 [B, S, W/16] with ``want_moves``.  An inactive
    lane gets the skip record (r=0, w=W/2, v=VINF) and zero moves.  The
    move rows past ``seg_q`` are filled too; no walk reads them.
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


def traceback_rows_plain(moves: torch.Tensor, seg_qlen: torch.Tensor,
                         w_end: torch.Tensor, W: int):
    """Row-major traceback: walk DP rows (S steps) from (seg_qlen, w_end);
    on any device.

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


def extend_moves(q_pad, t_pad, q0, t0, qlen, tlen, cap, *, S, W,
                 fdtype=torch.float32,
                 min_seg_identity: float = MIN_SEGMENT_IDENTITY):
    """Segmented banded extension of every lane, moves kept: one DP
    segment of every live lane at a time until none is live, lane b for at
    most ``cap[b]`` segments (at least one segment runs).

    A lane stops when a segment fails the identity rule (float in
    ``fdtype``), ends short of its query rows, or runs out of query or
    target.  Returns (ExtensionResult, raw): raw is (moves [B, S, W/16],
    r_end, w_end, qoff_before, toff_before, ok) of every segment, stacked
    on a leading axis G; entries where ``ok`` is False are unspecified.
    """
    B = q_pad.shape[0]
    half = W // 2
    dev = q_pad.device
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    qoff, toff, dist, matches, alen, nsegs = (zeros.clone() for _ in range(6))
    active = (qlen > 0) & (tlen > 0)
    slack = max(1, S // 4)
    raw = []
    n = 0
    while True:
        active = active & (n < cap)
        if n and not bool(active.any()):
            break
        seg_q = (qlen - qoff).clamp(0, S).to(torch.int32)
        rem_t = (tlen - toff).clamp(0, S + half).to(torch.int32)
        q_seg = _slice_rows(q_pad, q0 + qoff, S).contiguous()
        t_seg = _slice_rows(t_pad, t0 + toff, S + W).contiguous()
        moves, r_end, w_end, j_end, d_seg, ind_seg = dp_segment_best_plain(
            q_seg, t_seg, rem_t, seg_q, active, S, W, want_moves=True)
        m_seg = (torch.div(r_end + j_end + ind_seg, 2, rounding_mode="floor")
                 - d_seg).clamp(min=0)
        a_seg = m_seg + d_seg
        ident = m_seg.to(fdtype) / a_seg.clamp(min=1).to(fdtype)
        ok = (active & (r_end + j_end > 0) & (d_seg < INF)
              & ((ident >= min_seg_identity) | (a_seg < 32)))
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


def _pair_alignment(left: ExtensionResult, right: ExtensionResult,
                    qseed: torch.Tensor, tseed: torch.Tensor,
                    fdtype=torch.float32):
    matches = left.matches + right.matches
    alen = left.align_len + right.align_len
    identity = 100.0 * matches.to(fdtype) / alen.clamp(min=1).to(fdtype)
    return PairAlignment(
        qbeg=qseed - left.q_adv, qend=qseed + right.q_adv,
        tbeg=tseed - left.t_adv, tend=tseed + right.t_adv,
        dist=left.dist + right.dist, matches=matches, align_len=alen,
        identity=identity.to(torch.float32),
        n_segs=left.n_segs + right.n_segs)


def extend_pair_batch_rows(q, t, qlen, tlen, qseed, tseed, cap_r, cap_l, *,
                           S: int, W: int, fdtype=torch.float32):
    """Extend both directions of every pair (right lanes at most
    ``cap_r`` segments, left ones ``cap_l``) as one loop over the 2B lanes,
    then walk every (segment, pair) lane back row by row.

    Returns (pa, right_rows, left_rows); each rows tuple is (mv, h, wo
    [G, B, S], w0 [G, B], qoff, toff, ok [G, B]) in the direction's local
    coordinates.  Segments in which a lane is no longer live have
    ``ok`` False, and every consumer masks by ``ok``.
    """
    B = q.shape[0]
    res, raw = extend_moves(
        *direction_lanes(q, t, qlen, tlen, qseed, tseed, S, W),
        torch.cat([cap_r, cap_l]), S=S, W=W, fdtype=fdtype)
    right = ExtensionResult(*(x[:B] for x in res))
    left = ExtensionResult(*(x[B:] for x in res))
    G = raw[0].shape[0]
    moves2, r2, w2, qo2, to2, ok2 = (torch.cat([x[:, :B], x[:, B:]])
                                     for x in raw)
    G2 = 2 * G
    mv2, h2, wo2, w02 = traceback_rows_plain(
        moves2.reshape(G2 * B, S, -1), r2.reshape(-1), w2.reshape(-1), W)
    mv2, h2, wo2 = (a.reshape(G2, B, S) for a in (mv2, h2, wo2))
    w02 = w02.reshape(G2, B)
    right_rows = (mv2[:G], h2[:G], wo2[:G], w02[:G], qo2[:G], to2[:G],
                  ok2[:G])
    left_rows = (mv2[G:], h2[G:], wo2[G:], w02[G:], qo2[G:], to2[G:],
                 ok2[G:])
    return (_pair_alignment(left, right, qseed, tseed, fdtype), right_rows,
            left_rows)
