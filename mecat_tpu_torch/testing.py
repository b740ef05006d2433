"""Inputs and option sets shared by the port's tests and ``chip_smoke.py``.

``dp_inputs`` makes DP-segment lanes as the kernel takes them,
``pair_inputs`` query/target pairs with seeds for the segmented extension,
``roll_micro_inputs`` lanes for the row-update micro-benchmark family;
``GOLDEN_J1`` / ``GOLDEN_J0`` are the ``PwOptions`` that produced
``tests/golden/overlaps.m4`` and ``tests/golden/candidates.txt``, and
``GOLDEN_CNS`` the ``CnsOptions`` of ``tests/golden/corrected.fasta``.
"""
from __future__ import annotations

import numpy as np

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
