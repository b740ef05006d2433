"""Truth-based accuracy of corrected reads (simulated data).

Copy of ``mecat_tpu.utils.accuracy``: with simulated reads the truth locus
of every read is known (``utils.sim.ReadTruth``), so identity comes from a
banded alignment to it, computed by the native C++ layer
(``native.get().edit_stats``; ``edit_stats_plain`` is the NumPy version).

identity% = 100 * matches / alignment_columns (columns = matches + subs +
ins + dels).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import native


def edit_stats(a: np.ndarray, b: np.ndarray, band: int = 256,
               mode: int = 0) -> Tuple[int, int, int, int]:
    """Banded edit distance a -> b: (dist, subs, ins, dels).

    mode 0 = global; mode 1 = infix (global in ``a``, FREE end gaps in
    ``b`` — the corrected-read-vs-truth-window shape).  ins = extra bases
    in ``a`` relative to ``b``; dels = bases of ``b`` missing from ``a``
    (aligned span only in mode 1).  The band doubles until the distance
    proves exact.
    """
    return native.get().edit_stats(a, b, band, mode)


def edit_stats_plain(a: np.ndarray, b: np.ndarray, band: int = 256,
                     mode: int = 0) -> Tuple[int, int, int, int]:
    """NumPy version of :func:`edit_stats`: banded DP with stored cost
    rows, traceback from costs, on the same band-widening schedule."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    la, lb = len(a), len(b)
    limit = max(la, lb, 1)
    while True:
        bw = min(band, limit)
        res = _edit_once_numpy(a, b, bw, mode)
        if res is not None:
            dist, subs, ins, dels, _ = res
            # dist < band proves exactness: leaving the band's diagonal
            # envelope costs at least the band width
            if dist < bw or bw >= limit:
                return dist, subs, ins, dels
        band *= 2


def _edit_once_numpy(a, b, band, mode):
    la, lb = len(a), len(b)
    if lb == 0:
        return la, 0, la, 0, 0
    if la == 0:
        return (0, 0, 0, 0, 0) if mode == 1 else (lb, 0, 0, lb, 0)
    lo_off = min(0, lb - la) - band
    hi_off = max(0, lb - la) + band
    Wb = hi_off - lo_off + 1
    INF = np.int32(1 << 28)
    cost = np.full((la + 1, Wb), INF, dtype=np.int32)
    j0 = np.arange(0, min(lb, hi_off) + 1)
    cost[0, j0 - lo_off] = 0 if mode == 1 else j0
    for i in range(1, la + 1):
        c0 = i + lo_off                       # column at band slot 0
        jlo, jhi = max(0, c0), min(lb, i + hi_off)
        if jlo > jhi:
            continue
        s = np.arange(jlo - c0, jhi - c0 + 1)
        jj = s + c0
        diag = cost[i - 1, s].astype(np.int64)
        valid = jj >= 1
        sub = np.where(valid & (a[i - 1] == b[np.clip(jj - 1, 0, lb - 1)]),
                       0, 1)
        diag = np.where(valid, diag + sub, INF)
        up = np.where(s + 1 < Wb, cost[i - 1, np.clip(s + 1, 0, Wb - 1)],
                      INF).astype(np.int64) + 1
        best = np.minimum(diag, up)
        # left moves, closed form: a chain of (s - s') deletions from slot
        # s' costs best[s'] + (s - s'); min over s' <= s via a running min
        # of (best - slot_index)
        run = np.minimum.accumulate(best - np.arange(len(best)))
        best = np.minimum(best, run + np.arange(len(best)))
        cost[i, s] = np.minimum(best, INF).astype(np.int32)
    if mode == 1:
        c0_la = la + lo_off
        jlo, jhi = max(0, c0_la), min(lb, la + hi_off)
        srange = np.arange(jlo - c0_la, jhi - c0_la + 1)
        end_s = int(srange[np.argmin(cost[la, srange])])
        end_j = end_s + c0_la
    else:
        end_j = lb
        end_s = lb - (la + lo_off)
    if not (0 <= end_s < Wb) or cost[la, end_s] >= INF:
        return None
    dist = int(cost[la, end_s])
    # traceback from costs (mode 1 stops at the free row 0)
    subs = ins = dels = edge = 0
    i, j = la, end_j
    while i > 0 or (mode == 0 and j > 0):
        s = j - (i + lo_off)
        if s == 0 or s == Wb - 1:
            edge = 1
        here = int(cost[i, s])
        if i > 0 and j > 0 and s < Wb and cost[i - 1, s] < INF and \
                here == int(cost[i - 1, s]) + (0 if a[i - 1] == b[j - 1]
                                               else 1):
            subs += 0 if a[i - 1] == b[j - 1] else 1
            i -= 1
            j -= 1
        elif i > 0 and s + 1 < Wb and cost[i - 1, s + 1] < INF and \
                here == int(cost[i - 1, s + 1]) + 1:
            ins += 1
            i -= 1
        else:
            dels += 1
            j -= 1
    return dist, subs, ins, dels, edge


@dataclass
class ReadAccuracy:
    read: int
    identity: float
    subs: int
    ins: int
    dels: int
    length: int


@dataclass
class AccuracyReport:
    per_read: List[ReadAccuracy] = field(default_factory=list)
    split_reads: int = 0            # multi-segment outputs (not scored)
    missing_reads: int = 0          # templates with no corrected output

    @property
    def identities(self) -> np.ndarray:
        return np.asarray([r.identity for r in self.per_read])

    def summary(self) -> Dict[str, float]:
        idents = self.identities
        if len(idents) == 0:
            return {"n": 0}
        tot_cols = sum(r.length + r.dels for r in self.per_read)
        return {
            "n": len(idents),
            "median_identity": float(np.median(idents)),
            "mean_identity": float(np.mean(idents)),
            "p5_identity": float(np.percentile(idents, 5)),
            "sub_pct": 100.0 * sum(r.subs for r in self.per_read) / tot_cols,
            "ins_pct": 100.0 * sum(r.ins for r in self.per_read) / tot_cols,
            "del_pct": 100.0 * sum(r.dels for r in self.per_read) / tot_cols,
            "split_reads": self.split_reads,
            "missing_reads": self.missing_reads,
        }


def identity_pct(dist_stats: Tuple[int, int, int, int], la: int) -> float:
    _, subs, ins, dels = dist_stats
    matches = la - subs - ins
    cols = matches + subs + ins + dels
    return 100.0 * matches / max(cols, 1)


def corrected_accuracy(corrected_path: str, genome: np.ndarray, truths,
                       band: int = 512,
                       max_reads: Optional[int] = None) -> AccuracyReport:
    """Score a corrected FASTA (headers ``sim_{i}_{k}``) against truth loci.

    Single-segment reads are scored with a banded global alignment against
    the read's oriented truth slice; multi-segment (split) reads are counted
    but not scored (a split read has no single truth interval).
    """
    from ..io.fasta import iter_fasta
    from ..io.packed_db import revcomp

    segs: Dict[int, List[np.ndarray]] = {}
    pat = re.compile(r"sim_(\d+)_(\d+)$")
    for rec in iter_fasta(corrected_path):
        m = pat.search(rec.name)
        if not m:
            continue
        segs.setdefault(int(m.group(1)), []).append(rec.codes)

    rep = AccuracyReport()
    scored = 0
    for i, t in enumerate(truths):
        lst = segs.get(i)
        if lst is None:
            rep.missing_reads += 1
            continue
        if len(lst) > 1:
            rep.split_reads += 1
            continue
        if max_reads is not None and scored >= max_reads:
            continue
        truth_seq = genome[t.start:t.end]
        if t.strand:
            truth_seq = revcomp(truth_seq)
        cor = lst[0]
        st = edit_stats(cor, truth_seq, band=band, mode=1)
        rep.per_read.append(ReadAccuracy(
            read=i, identity=identity_pct(st, len(cor)), subs=st[1],
            ins=st[2], dels=st[3], length=len(cor)))
        scored += 1
    return rep
