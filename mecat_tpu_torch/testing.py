"""Inputs and option sets shared by the port's tests and ``chip_smoke.py``.

``dp_inputs`` makes DP-segment lanes as the kernel takes them,
``pair_inputs`` query/target pairs with seeds for the segmented extension,
``roll_micro_inputs`` lanes for the row-update micro-benchmark family;
``dp_segment_best_wavefront`` evaluates a DP segment in the order of the
Hopper kernel (``csrc/dp_segment.cu``), so the CPU tests can hold that order
against the plain version;
``GOLDEN_J1`` / ``GOLDEN_J0`` are the ``PwOptions`` that produced
``tests/golden/overlaps.m4`` and ``tests/golden/candidates.txt``, and
``GOLDEN_CNS`` the ``CnsOptions`` of ``tests/golden/corrected.fasta``.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.align import IND_K, VINF, _NEG, _unpack_best
from .tools.roll_micro import make_inputs as roll_micro_tool_inputs
from .utils.sim import mutate

GOLDEN_J1 = dict(task=1, kmer_size=9, scan_stride=4, min_align_size=400,
                 num_candidates=12, scan_batch=8, extend_batch=32,
                 align_segment=128, align_band=64, min_block_score=2)
GOLDEN_J0 = dict(task=0, kmer_size=9, scan_stride=4, num_candidates=12,
                 scan_batch=8, min_block_score=2)
#: the CnsOptions that made tests/golden/corrected.fasta from candidates.txt
GOLDEN_CNS = dict(min_align_size=300, min_length=500, extend_batch=32,
                  align_segment=128, align_band=64)


def dp_inputs(S: int, W: int, n: int, seed: int):
    """Mutated query/target segment pairs (4/4/4 % sub/ins/del) as the
    kernel takes them, with edge lanes: tmax=0 and seg_q=0 (one valid
    cell), tmax=-1 or seg_q=-1 (no valid cell), and inactive lanes.

    Returns numpy (q u8 [n,S], tpad u8 [n,S+W], tmax i32 [n],
    seg_q i32 [n], active bool [n]).
    """
    rng = np.random.default_rng(seed)
    half = W // 2
    q = np.full((n, S), 255, np.uint8)
    tpad = np.full((n, S + W), 254, np.uint8)
    seg_q = np.zeros(n, np.int32)
    tmax = np.zeros(n, np.int32)
    for b in range(n):
        m = int(rng.integers(40, S + 1))
        src = rng.integers(0, 4, m, dtype=np.uint8)
        dst = mutate(src, rng, 0.04, 0.04, 0.04)[:S + half]
        q[b, :m] = src
        tpad[b, half:half + len(dst)] = dst
        seg_q[b] = m
        tmax[b] = len(dst)
    tmax[7::97] = 0
    seg_q[7::97] = 0
    tmax[11::89] = -1
    seg_q[13::83] = -1
    active = np.ones(n, bool)
    active[5::61] = False
    return q, tpad, tmax, seg_q, active


def dp_inputs_full(S: int, W: int, n: int, seed: int):
    """Full-length lanes, the shape the segment loops launch mid-read: an
    S-base query, its 4/4/4 % mutation as the target (``seg_q = S``, tmax up
    to S + W/2).  Returns numpy (q, tpad, tmax, seg_q) as
    :func:`dp_inputs`; the caller chooses the active lanes."""
    rng = np.random.default_rng(seed)
    half = W // 2
    q = rng.integers(0, 4, (n, S), dtype=np.uint8)
    tpad = np.full((n, S + W), 254, np.uint8)
    tmax = np.zeros(n, np.int32)
    for b in range(n):
        ext = np.concatenate([q[b], rng.integers(0, 4, W, dtype=np.uint8)])
        dst = mutate(ext, rng, 0.04, 0.04, 0.04)[:S + half]
        tpad[b, half:half + len(dst)] = dst
        tmax[b] = len(dst)
    return q, tpad, tmax, np.full(n, S, np.int32)


def pair_inputs(n, L, seed):
    """Query/target pairs around a shared source with seeds near the true
    diagonal, plus edge lanes: seed at 0 and at the end, empty query, a
    seed far off the diagonal, a random (junk) target, and a target longer
    than its row."""
    rng = np.random.default_rng(seed)
    q = np.zeros((n, L), np.uint8)
    t = np.zeros((n, L), np.uint8)
    qlen = np.zeros(n, np.int32)
    tlen = np.zeros(n, np.int32)
    qseed = np.zeros(n, np.int32)
    tseed = np.zeros(n, np.int32)
    for b in range(n):
        m = int(rng.integers(L // 3, L * 3 // 4))
        src = rng.integers(0, 4, m, dtype=np.uint8)
        a = mutate(src, rng, 0.03, 0.06, 0.03)[:L]
        c = mutate(src, rng, 0.03, 0.06, 0.03)[:L]
        if b == 5:
            c = rng.integers(0, 4, len(c), dtype=np.uint8)
        q[b, :len(a)], t[b, :len(c)] = a, c
        qlen[b], tlen[b] = len(a), len(c)
        s = int(rng.integers(0, len(a)))
        qseed[b] = s
        tseed[b] = min(int(s * len(c) / len(a)), len(c) - 1)
    qseed[1], tseed[1] = 0, 0
    qseed[2], tseed[2] = qlen[2], tlen[2] - 1
    qlen[3] = 0
    qseed[3] = 0
    tseed[4] = (tseed[4] + tlen[4] // 2) % tlen[4]
    # a target longer than its row (a truncated target window): the seed
    # lies past the row, so the reverse direction starts at a negative
    # offset, which lax.dynamic_slice wraps before it clamps
    tlen[6] = L + 300
    tseed[6] = L + 100
    return q, t, qlen, tlen, qseed, tseed


def roll_micro_inputs(S: int, W: int, n: int, seed: int):
    """Lanes for the row-update micro-benchmark family.

    The first half are the tool's own lanes (one source, seed 7, as the
    query; its 1/1/1 % mutation, seed 11, as the target; tmax = S + W/2,
    segq = S).  The second half have their own 4/4/4 % mutated sequences
    and varied tmax and segq, with edge lanes: no valid cell (tmax = -1,
    where every ``elem`` key is the wrapped masked one), segq = 0 and a
    2-base target.  Returns numpy (q u8 [n,S], t u8 [n,S+W], tmax i32 [n],
    segq i32 [n]).
    """
    q, t, tmax, segq = roll_micro_tool_inputs(n, S, W)
    rng = np.random.default_rng(seed)
    for b in range(n // 2, n):
        own = rng.integers(0, 4, S + W, dtype=np.uint8)
        dst = mutate(own, rng, 0.04, 0.04, 0.04)[:S + W]
        q[b] = own[:S]
        t[b] = 0
        t[b, :len(dst)] = dst
        tmax[b] = rng.integers(0, S + W // 2 + 1)
        segq[b] = rng.integers(0, S + 1)
    tmax[n // 2 + 1] = -1
    segq[n // 2 + 2] = 0
    tmax[n // 2 + 3] = 2
    return q, t, tmax, segq


def dp_segment_best_wavefront(q_seg: torch.Tensor, tpad: torch.Tensor,
                              tmax: torch.Tensor, seg_q: torch.Tensor,
                              active: torch.Tensor, S: int, W: int,
                              want_moves: bool = False):
    """One DP segment evaluated as ``csrc/dp_segment.cu`` evaluates it.

    Cell (row i, band cell w) is made at step tau = 2*i + w: on an even
    step the even band cells advance one row, on an odd step the odd ones.
    Its diagonal input is the cell's own value (made at tau - 2), the
    vertical and the horizontal input are the right and the left neighbour
    as they stand (made at tau - 1), and the horizontal closure is the
    sequential ``min(cand, left + 4097)``: no scan.  Moves are attributed
    from the values, the best cell is kept per band cell with a strict
    ``>`` and reduced once on (score desc, r*W + w asc).  The steps whose
    cells all lie inside the target skip the validity select and the clamp,
    as the kernel's fast iterations do.  Rows run to
    ``min(seg_q, S, tmax + W/2)`` (0 for a negative tmax): no later row
    holds a cell that can score.  Same arguments and results as
    ``ops.align.dp_segment_best_plain``, except that the move rows past the
    last row are zero, as the kernel leaves them.
    """
    B = q_seg.shape[0]
    half = W // 2
    K1 = IND_K + 1
    w_all = torch.arange(W, dtype=torch.int32)
    tm = tmax[:, None]
    j0 = w_all - half
    ok0 = (j0[None, :] >= 0) & (j0[None, :] <= tm)
    val = torch.where(ok0, (j0.clamp(min=0) * K1)[None, :], VINF).to(
        torch.int32)
    last_row = torch.minimum(seg_q.clamp(max=S), tmax + half)
    last_row = torch.where(tmax < 0, 0, last_row).clamp(min=0)[:, None]
    best_s = torch.where(ok0 & (seg_q[:, None] >= 0),
                         j0[None, :] - 4 * (val >> 12), _NEG)
    best_r = torch.zeros((B, W), dtype=torch.int32)
    best_v = val.clone()
    codes = torch.zeros((B, S, W), dtype=torch.int64)
    vinf_col = torch.full((B, 1), VINF, dtype=torch.int32)
    for tau in range(2, 2 * S + W):
        ws = torch.arange(tau & 1, W, 2)
        i = (tau - ws) // 2                           # the row of each cell
        in_range = (i[None, :] >= 1) & (i[None, :] <= last_row)
        ic = i.clamp(1, S)
        sub = (q_seg[:, ic - 1] != tpad[:, ic - 1 + ws]).to(torch.int32)
        padded = torch.cat([vinf_col, val, vinf_col], dim=1)
        diag = val[:, ws] + sub * IND_K
        vert = padded[:, ws + 2] + K1                 # cell w + 1, row i - 1
        hor = padded[:, ws] + K1                      # cell w - 1, row i
        j = (i - half + ws).to(torch.int32)[None, :]
        valid = (j >= 0) & (j <= tm)
        cur = torch.minimum(torch.minimum(diag, vert), hor)
        # iterations k = tau // 2 in [W - 1, min(tmax - W/2 + 1, last)] hold
        # valid cells only, and those are finite: the kernel drops the
        # validity select, the clamp and the VINF test there
        k = tau // 2
        fast = (k >= W - 1) & (k <= torch.minimum(tm - half + 1, last_row))
        cur = torch.where(fast, cur,
                          torch.where(valid, cur.clamp(max=VINF), VINF))
        move = torch.where(cur == diag, sub,
                           torch.where(cur == vert, 2, 3)).long()
        val[:, ws] = torch.where(in_range, cur, val[:, ws])
        codes[:, ic - 1, ws] = torch.where(in_range, move,
                                           codes[:, ic - 1, ws])
        score = i.to(torch.int32)[None, :] + j - 4 * (cur >> 12)
        better = (in_range & (fast | (cur < VINF))
                  & (score > best_s[:, ws]))
        best_s[:, ws] = torch.where(better, score, best_s[:, ws])
        best_r[:, ws] = torch.where(better, i.to(torch.int32)[None, :],
                                    best_r[:, ws])
        best_v[:, ws] = torch.where(better, cur, best_v[:, ws])
    flat = best_r * W + w_all[None, :]
    top = best_s.max(dim=1, keepdim=True).values
    f = torch.where(best_s == top, flat, (S + 1) * W).min(dim=1).values
    v = torch.gather(best_v, 1, (f % W).long()[:, None])[:, 0]
    r = torch.where(active, torch.div(f, W, rounding_mode="floor"), 0)
    w = torch.where(active, f % W, half)
    v = torch.where(active, v, VINF)
    best = _unpack_best(r.to(torch.int32), w.to(torch.int32), v, W)
    if not want_moves:
        return best
    pack_w = torch.ones(16, dtype=torch.int64) << (
        2 * torch.arange(16, dtype=torch.int64))
    packed = (codes.reshape(B, S, W // 16, 16) * pack_w).sum(3)
    packed = torch.where(packed >= 1 << 31, packed - (1 << 32), packed)
    packed = torch.where(active[:, None, None], packed, 0)
    return (packed.to(torch.int32), *best)
