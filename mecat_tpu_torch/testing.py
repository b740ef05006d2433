"""Inputs and option sets shared by the port's tests and ``chip_smoke.py``.

``dp_inputs`` makes DP-segment lanes as the kernel takes them;
``GOLDEN_J1`` / ``GOLDEN_J0`` are the ``PwOptions`` that produced
``tests/golden/overlaps.m4`` and ``tests/golden/candidates.txt``.
"""
from __future__ import annotations

import numpy as np

from .utils.sim import mutate

GOLDEN_J1 = dict(task=1, kmer_size=9, scan_stride=4, min_align_size=400,
                 num_candidates=12, scan_batch=8, extend_batch=32,
                 align_segment=128, align_band=64, min_block_score=2)
GOLDEN_J0 = dict(task=0, kmer_size=9, scan_stride=4, num_candidates=12,
                 scan_batch=8, min_block_score=2)


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
