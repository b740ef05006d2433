"""``mecat2pw -j 0`` candidate records derived from the simulation's truth.

The correction cell's input, made without the program: every ordered pair
(q, s) of distinct reads whose true genome intervals overlap by at least
``min_overlap`` bases gives one record, as a ``-j 0`` run lists each pair
once from either side's query.  The record holds the query's strand
relative to the subject (``qdir``: the two reads' strands differ), a seed
on the true diagonal (the genome position in the middle of the overlap,
placed in both reads through their truth maps; ``qext`` in the
``qdir``-oriented query, ``sext`` on the forward subject) and a score that
grows with the overlap (``overlap // 64``, at least 2), so the supports a
template keeps under its caps are its longest overlaps.

Columns are those of candidate text: qid, sid (1-based), score, qdir,
qext, qsize, sdir (0), sext, ssize; rows sorted by query, then subject.
"""
from __future__ import annotations

import numpy as np

from .reads import SimReads


def _read_pos(sim: SimReads, r: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Read positions (read orientation) of genome positions g in reads r,
    clamped into the read."""
    k = np.where(sim.strand[r] == 0, g - sim.g_start[r],
                 sim.g_start[r] + sim.g_len[r] - 1 - g)
    pos = sim.map_out[sim.map_starts[r] + k].astype(np.int64)
    return np.minimum(pos, sim.lengths[r].astype(np.int64) - 1)


def overlapping_pairs(sim: SimReads, min_overlap: int):
    """Unordered pairs (a, b) whose true intervals overlap by at least
    ``min_overlap``, with the overlap [lo, hi) on the genome."""
    order = np.argsort(sim.g_start, kind="stable")
    st = sim.g_start[order]
    en = st + sim.g_len[order]
    # b after a in start order overlaps a by min(en_a, en_b) - st_b
    hi_idx = np.searchsorted(st, en - min_overlap, side="right")
    lo_idx = np.arange(len(st)) + 1
    cnt = np.maximum(hi_idx - lo_idx, 0)
    a = np.repeat(np.arange(len(st)), cnt)
    first = np.repeat(lo_idx, cnt)
    b = first + (np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt))
    lo = st[b]
    hi = np.minimum(en[a], en[b])
    keep = hi - lo >= min_overlap
    return order[a[keep]], order[b[keep]], lo[keep], hi[keep]


def truth_candidates(sim: SimReads, min_overlap: int) -> np.ndarray:
    """int64 [n, 9] candidate columns of every overlapping ordered pair."""
    a, b, lo, hi = overlapping_pairs(sim, min_overlap)
    q = np.concatenate([a, b])
    s = np.concatenate([b, a])
    g = np.concatenate([(lo + hi) // 2] * 2)
    ovl = np.concatenate([hi - lo] * 2)
    qdir = (sim.strand[q] != sim.strand[s]).astype(np.int64)
    qsize = sim.lengths[q].astype(np.int64)
    qpos = _read_pos(sim, q, g)
    qext = np.where(qdir == 0, qpos, qsize - 1 - qpos)
    sext = _read_pos(sim, s, g)
    cols = np.stack([q + 1, s + 1, np.maximum(ovl // 64, 2), qdir, qext,
                     qsize, np.zeros_like(q), sext,
                     sim.lengths[s].astype(np.int64)], axis=1)
    return cols[np.lexsort((s, q))]
