"""Best-overlap-graph unitigger (bogart role; NumPy copy of
``mecat_tpu.assembly.unitig``).  The classic BOG construction:

1. classify every overlap (containment vs dovetail, which ends it joins)
   with an end-slack tolerance, vectorised over the overlap store columns;
2. drop contained reads; per read END pick the best (longest-span) dovetail
   edge to a non-contained read;
3. unitigs = maximal paths of MUTUAL best edges (greedy paths break where
   best edges disagree: the "best overlap graph" invariant);
4. lay out reads with contig offsets from overlap hangs; re-attach contained
   reads to their best container for consensus coverage.

Everything here is host-side graph bookkeeping over NumPy columns: the
O(reads) part of assembly.  The compute-heavy parts (overlaps, consensus)
run on the device in their own stages.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .ovstore import OverlapStore
from ..utils.log import get_logger

log = get_logger("unitig")


@dataclass
class LayoutRow:
    read: int
    orient: int        # 0 fwd, 1 rev in contig coords
    offset: int        # contig coordinate of the read's first oriented base
    contained: bool = False


@dataclass
class Unitig:
    rows: List[LayoutRow] = field(default_factory=list)
    length: int = 0
    circular: bool = False


@dataclass
class BogResult:
    unitigs: List[Unitig]
    contained: np.ndarray     # bool [n_reads]
    n_dovetail: int = 0


def _oriented_b(flip, bbeg, bend, blen):
    """Overlap coords on b oriented relative to forward a."""
    ob = np.where(flip == 1, blen - bend, bbeg)
    oe = np.where(flip == 1, blen - bbeg, bend)
    return ob, oe


def classify(store: OverlapStore, end_slack: int = 100,
             min_identity: float = 0.0,
             identity: Optional[np.ndarray] = None):
    """Vectorised overlap classification.

    Returns dict of bool arrays: contained (a in b), container (b in a),
    dove_right / dove_left (dovetail out of a's right/left end).
    `identity` overrides the store column (e.g. erate-adjusted identities
    from :mod:`.erate`) for the min_identity gate.
    """
    ident = store.identity if identity is None else identity
    ob, oe = _oriented_b(store.flip, store.bbeg, store.bend, store.blen)
    alh = store.abeg                      # a left hang
    arh = store.alen - store.aend         # a right hang
    blh = ob                              # oriented-b left hang
    brh = store.blen - oe                 # oriented-b right hang
    ok = (ident >= min_identity) & (store.a != store.b)

    a_cov = (alh <= end_slack) & (arh <= end_slack)
    b_cov = (blh <= end_slack) & (brh <= end_slack)
    # ties (mutual cover) broken by length then id: the shorter/later read
    # is the contained one, so every pair has a deterministic orientation.
    a_smaller = (store.alen < store.blen) | (
        (store.alen == store.blen) & (store.a > store.b))
    contained = ok & a_cov & (~b_cov | a_smaller)
    container = ok & b_cov & ~contained
    dove_right = ok & ~a_cov & ~b_cov & (arh <= end_slack) & (blh <= end_slack)
    dove_left = ok & ~a_cov & ~b_cov & (alh <= end_slack) & (brh <= end_slack)
    return dict(contained=contained, container=container,
                dove_right=dove_right, dove_left=dove_left)


def _best_edges(store: OverlapStore, use: np.ndarray, n_reads: int,
                identity: Optional[np.ndarray] = None):
    """Best (max a-span, then identity, then min b) edge per a-read.

    Returns int64 row index per read (-1 = none).
    """
    ident = store.identity if identity is None else identity
    best = np.full(n_reads, -1, dtype=np.int64)
    rows = np.nonzero(use)[0]
    if len(rows) == 0:
        return best
    span = (store.aend[rows] - store.abeg[rows]).astype(np.int64)
    # lexicographic max by (span, identity, -b): sort rows so the best for
    # each a-read comes LAST, then store sequentially
    order = np.lexsort((-store.b[rows], ident[rows], span))
    rows = rows[order]
    best[store.a[rows]] = rows
    return best


def build_unitigs(store: OverlapStore, end_slack: int = 100,
                  min_identity: float = 0.0,
                  identity: Optional[np.ndarray] = None) -> BogResult:
    """`identity` (optional) replaces the store's raw identities for both
    the min_identity gate and best-edge ranking: the erate-adjusted
    identities of :mod:`.erate` plug in here (the unitigger consumes
    ADJUSTED error rates, not raw ones)."""
    n = store.n_reads
    cls = classify(store, end_slack, min_identity, identity)

    contained = np.zeros(n, dtype=bool)
    np.logical_or.at(contained, store.a[cls["contained"]], True)

    # dovetail edges to non-contained partners only
    live = ~contained[store.a] & ~contained[store.b]
    best_r = _best_edges(store, cls["dove_right"] & live, n, identity)
    best_l = _best_edges(store, cls["dove_left"] & live, n, identity)
    n_dove = int(np.count_nonzero(cls["dove_right"] & live)
                 + np.count_nonzero(cls["dove_left"] & live))

    def edge(rid: int, end: int) -> Optional[int]:
        row = best_r[rid] if end == 1 else best_l[rid]
        return int(row) if row >= 0 else None

    def partner_end(row: int) -> int:
        """Which end of b the edge enters: walking OUT of a through this
        overlap continues INTO b; with flip=0 right-exit enters b's left."""
        # exit end of a for this row:
        arh = int(store.alen[row] - store.aend[row])
        exits_right = arh <= end_slack and int(store.abeg[row]) > end_slack
        # entry end of oriented b is opposite the travel direction; on
        # FORWARD b it depends on flip
        if exits_right:
            return 0 if int(store.flip[row]) == 0 else 1  # enters b left/right
        return 1 if int(store.flip[row]) == 0 else 0

    def mutual(row: int) -> bool:
        # mutuality: b's best edge AT the shared end points back at a :
        # entering b's left end means the shared overlap sits at b's left,
        # so b's LEFT best edge must be this same pair.
        a, b = int(store.a[row]), int(store.b[row])
        pe = partner_end(row)
        back = edge(b, 0) if pe == 0 else edge(b, 1)
        return back is not None and int(store.b[back]) == a

    visited = np.zeros(n, dtype=bool)
    unitigs: List[Unitig] = []

    def walk(start: int, start_orient: int) -> Tuple[List[LayoutRow], bool]:
        rows: List[LayoutRow] = [LayoutRow(start, start_orient, 0)]
        visited[start] = True
        cur, orient, off = start, start_orient, 0
        circular = False
        while True:
            # walk out of the contig-forward end of cur
            end = 1 if orient == 0 else 0
            row = edge(cur, end)
            if row is None or not mutual(row):
                break
            b = int(store.b[row])
            if visited[b]:
                circular = b == start
                break
            flip = int(store.flip[row])
            # oriented overlap coords on cur (contig orientation)
            alen = int(store.alen[row])
            if orient == 0:
                rbeg = int(store.abeg[row])
            else:
                rbeg = alen - int(store.aend[row])
            b_orient = orient ^ flip
            blen = int(store.blen[row])
            if b_orient == 0:
                bbeg = int(store.bbeg[row])
            else:
                bbeg = blen - int(store.bend[row])
            off = off + rbeg - bbeg
            rows.append(LayoutRow(b, b_orient, off))
            visited[b] = True
            cur, orient = b, b_orient
        return rows, circular

    # pass 1: path endpoints: start oriented so the free end faces the
    # contig start and the walk covers the whole path
    for r in range(n):
        if visited[r] or contained[r]:
            continue
        lrow, rrow = edge(r, 0), edge(r, 1)
        if lrow is None or not mutual(lrow):
            rows, circ = walk(r, 0)
            unitigs.append(Unitig(rows=rows, circular=circ))
        elif rrow is None or not mutual(rrow):
            rows, circ = walk(r, 1)
            unitigs.append(Unitig(rows=rows, circular=circ))
    # pass 2: leftovers are circular components
    for r in range(n):
        if not visited[r] and not contained[r]:
            rows, circ = walk(r, 0)
            unitigs.append(Unitig(rows=rows, circular=circ))

    # re-attach contained reads to their best container for consensus coverage
    place: Dict[int, Tuple[int, int]] = {}  # read -> (unitig idx, row idx)
    for ui, u in enumerate(unitigs):
        for ri, lr in enumerate(u.rows):
            place[lr.read] = (ui, ri)
    best_cont = _best_edges(store, cls["contained"], n, identity)
    for c in np.nonzero(contained)[0]:
        row = int(best_cont[c])
        if row < 0:
            continue
        b = int(store.b[row])
        if b not in place:
            continue
        ui, ri = place[b]
        host = unitigs[ui].rows[ri]
        flip = int(store.flip[row])        # c (A side) vs forward b
        blen = int(store.blen[row])
        alen = int(store.alen[row])
        # overlap start on contig-oriented container b
        if host.orient == 0:
            bbeg = int(store.bbeg[row])
        else:
            bbeg = blen - int(store.bend[row])
        c_orient = host.orient ^ flip
        # overlap start on contig-oriented contained read c
        if c_orient == 0:
            cbeg = int(store.abeg[row])
        else:
            cbeg = alen - int(store.aend[row])
        off = host.offset + bbeg - cbeg
        unitigs[ui].rows.append(LayoutRow(int(c), c_orient, off,
                                          contained=True))

    # finalise: normalise offsets to start at 0, sort rows, compute length
    for u in unitigs:
        mn = min(r.offset for r in u.rows)
        for r in u.rows:
            r.offset -= mn
        u.rows.sort(key=lambda r: (r.offset, r.read))
        u.length = 0
    return BogResult(unitigs=unitigs, contained=contained, n_dovetail=n_dove)


def layouts_to_arrays(unitigs: List[Unitig]):
    """Flatten layouts to columnar arrays + CSR offsets (for persistence)."""
    reads = np.array([r.read for u in unitigs for r in u.rows], dtype=np.int32)
    orient = np.array([r.orient for u in unitigs for r in u.rows],
                      dtype=np.int32)
    offset = np.array([r.offset for u in unitigs for r in u.rows],
                      dtype=np.int64)
    cont = np.array([r.contained for u in unitigs for r in u.rows],
                    dtype=bool)
    counts = np.array([len(u.rows) for u in unitigs], dtype=np.int64)
    offsets = np.zeros(len(unitigs) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    circular = np.array([u.circular for u in unitigs], dtype=bool)
    return dict(reads=reads, orient=orient, offset=offset, contained=cont,
                tig_offsets=offsets, circular=circular)


def arrays_to_layouts(d) -> List[Unitig]:
    out = []
    to = d["tig_offsets"]
    for i in range(len(to) - 1):
        rows = [LayoutRow(int(d["reads"][j]), int(d["orient"][j]),
                          int(d["offset"][j]), bool(d["contained"][j]))
                for j in range(int(to[i]), int(to[i + 1]))]
        out.append(Unitig(rows=rows, circular=bool(d["circular"][i])))
    return out
