"""Overlap error adjustment (overlapErrorAdjustment role; NumPy copy of
``mecat_tpu.assembly.erate``, operation for operation: the float64 Jacobi
sweeps are bit-equal only in this order).

For true overlaps the aligned divergence decomposes additively,

    d_ab  =  1 - identity_ab/100  ~  e_a + e_b  (+ sampling noise),

where e_r is read r's intrinsic error rate, so the per-read rates are the
weighted-least-squares solution of one sparse linear system over the overlap
graph.  It is solved with a damped Jacobi iteration over the symmetrised
overlap store (two ``np.bincount`` calls per sweep, no per-read Python), and
each overlap's ADJUSTED error is the residual

    resid_ab = d_ab - e_a - e_b ,

which is ~0 for true overlaps however noisy the two reads are and large for
false (repeat-induced) overlaps.  ``build_unitigs`` then ranks best edges by
adjusted identity and drops overlaps whose residual exceeds the
``max_adj_erate`` budget.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .ovstore import OverlapStore


@dataclass
class ErateResult:
    e: np.ndarray              # float32 [n_reads] per-read error-rate estimate
    residual: np.ndarray       # float32 [n_overlaps] d_ab - e_a - e_b
    adj_identity: np.ndarray   # float32 [n_overlaps] 100*(1 - max(resid, 0))


def estimate_read_erates(store: OverlapStore, iters: int = 25,
                         cap: float = 0.5) -> ErateResult:
    """Per-read error rates + adjusted per-overlap erates from the ovStore.

    Solves ``min_e  sum_ab w_ab (d_ab - e_a - e_b)^2`` (w = overlap span, so
    long overlaps: tighter binomial noise: count more) by damped Jacobi:

        e_a <- 1/2  e_a + 1/2  clip( sum_b w_ab (d_ab - e_b) / sum_b w_ab , 0, cap)

    The store is symmetrised (every overlap appears once per a-read), so one
    ``bincount`` over ``store.a`` per sweep touches every (read, partner)
    incidence.  Reads with no overlaps keep the global mean rate.
    """
    n = store.n_reads
    if len(store) == 0:
        z = np.zeros(0, dtype=np.float32)
        return ErateResult(np.zeros(n, dtype=np.float32), z, z)
    d = np.maximum(1.0 - store.identity.astype(np.float64) / 100.0, 0.0)
    w = np.maximum((store.aend - store.abeg).astype(np.float64), 1.0)
    sw = np.bincount(store.a, weights=w, minlength=n)
    swd = np.bincount(store.a, weights=w * d, minlength=n)
    has = sw > 0
    glob = float(swd.sum() / sw.sum()) if sw.sum() > 0 else 0.0
    e = np.full(n, 0.5 * glob, dtype=np.float64)
    e[has] = 0.5 * swd[has] / sw[has]
    for _ in range(iters):
        num = swd - np.bincount(store.a, weights=w * e[store.b], minlength=n)
        upd = np.clip(np.divide(num, sw, out=np.zeros_like(num),
                                where=has), 0.0, cap)
        e[has] = 0.5 * e[has] + 0.5 * upd[has]
    resid = d - e[store.a] - e[store.b]
    adj = 100.0 * (1.0 - np.maximum(resid, 0.0))
    return ErateResult(e.astype(np.float32), resid.astype(np.float32),
                       adj.astype(np.float32))
