"""Pile consensus on the host: alignment op tapes -> per-position tags ->
corrected read (NumPy copy of ``mecat_tpu.ops.consensus``).

The alignments come from :func:`..ops.align.extend_pair_batch_with_ops`;
this module turns the op tapes into (position, delta, base) tags, with delta
indexing inserted bases after a template position, and votes with vectorised
bincount/argmax.  Base code 4 = deletion (gap vote).

The product votes on the device (:mod:`.consensus_device`); ``CnsTable`` is
the host route of the contig polish for reads too long for its tile
geometry, and the exact oracle the device vote is tested against.
:func:`emit_to_draft` is shared by ``CnsTable.call_draft`` and the device
draft collector of correction rounds > 1.  The vote parameters are the
builtin defaults, with no environment overrides.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from .. import constants as C
from .align import MOVE_HORIZ, MOVE_VERT

GAP = 4  # vote code for deletion


def _np(x) -> np.ndarray:
    """A tape field as a NumPy array (torch tensors come off their device)."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def tapes_to_columns(right_tapes, left_tapes, qseed, tseed, n_pairs=None):
    """Device op tapes (both directions) → forward-ordered column lists.

    Returns a list (one per pair) of (ops, qpos, tpos) int32 arrays in
    template-forward order.  qpos/tpos are absolute positions in the oriented
    support / forward template.  For insertions (MOVE_VERT) tpos is a
    placeholder (the anchor is recomputed positionally by columns_to_tags).
    """
    out = []
    r_ops, r_qi, r_tj, r_n, r_qo, r_to, r_ok = [_np(x) for x in right_tapes]
    l_ops, l_qi, l_tj, l_n, l_qo, l_to, l_ok = [_np(x) for x in left_tapes]
    G, B, MAXC = r_ops.shape
    GL = l_ops.shape[0]    # per-direction segment budgets may differ
    qseed = _np(qseed)
    tseed = _np(tseed)
    n_pairs = B if n_pairs is None else n_pairs
    for b in range(n_pairs):
        chunks = []
        # left direction: reversed-prefix coords; later segments are further
        # left on the template, and within a segment the tape is reversed.
        for g in range(GL - 1, -1, -1):
            if not l_ok[g, b] or l_n[g, b] <= 0:
                continue
            n = int(l_n[g, b])
            sl = slice(MAXC - n, MAXC)
            ops = l_ops[g, b, sl][::-1].astype(np.int32)
            qi = l_qi[g, b, sl][::-1]
            tj = l_tj[g, b, sl][::-1]
            qpos = np.where(qi >= 0,
                            int(qseed[b]) - 1 - (int(l_qo[g, b]) + qi), -1)
            tpos = int(tseed[b]) - 1 - (int(l_to[g, b]) + tj)
            chunks.append((ops, qpos, tpos))
        for g in range(G):
            if not r_ok[g, b] or r_n[g, b] <= 0:
                continue
            n = int(r_n[g, b])
            sl = slice(MAXC - n, MAXC)
            ops = r_ops[g, b, sl].astype(np.int32)
            qi = r_qi[g, b, sl]
            tj = r_tj[g, b, sl]
            qpos = np.where(qi >= 0,
                            int(qseed[b]) + int(r_qo[g, b]) + qi, -1)
            tpos = int(tseed[b]) + int(r_to[g, b]) + tj
            chunks.append((ops, qpos, tpos))
        if chunks:
            ops = np.concatenate([c[0] for c in chunks])
            qpos = np.concatenate([c[1] for c in chunks])
            tpos = np.concatenate([c[2] for c in chunks])
        else:
            ops = qpos = tpos = np.zeros(0, np.int32)
        out.append((ops, qpos, tpos))
    return out


def columns_to_tags(ops: np.ndarray, qpos: np.ndarray, tpos: np.ndarray,
                    support: np.ndarray, tlen: int,
                    max_delta: int = C.MAX_INS_DELTA):
    """One support's forward-ordered columns → (pos, delta, base) tag arrays.

    support: oriented support bases (uint8 codes) for base lookup.
    Tags: M/X → (tpos, 0, q base); deletion → (tpos, 0, GAP);
    insertion run after template position p → (p, 1..max_delta, q base).
    """
    n = len(ops)
    if n == 0:
        z = np.zeros(0, np.int32)
        return z, z, z
    is_ins = ops == MOVE_VERT
    arange = np.arange(n)
    last_t = np.maximum.accumulate(np.where(~is_ins, arange, -1))
    anchor_idx = np.where(is_ins, last_t, arange)
    pos = np.where(is_ins & (last_t >= 0), tpos[anchor_idx], tpos)
    delta = np.where(is_ins, arange - anchor_idx, 0)
    base = np.where(ops == MOVE_HORIZ, GAP,
                    support[np.clip(qpos, 0, len(support) - 1)])
    keep = ((pos >= 0) & (pos < tlen) & (delta <= max_delta)
            & ~(is_ins & (last_t < 0)))
    return (pos[keep].astype(np.int32), delta[keep].astype(np.int32),
            base[keep].astype(np.int32))


class VoteParams(NamedTuple):
    """Pooled-rule tuning, per technology; biases in 1/100ths so every rule
    is integer arithmetic.

    ``win_radius`` > 0 enables the window-pooled single-insertion rule: it
    pools insertion votes over +-win_radius positions; at a strict local
    peak with no emitted insertion nearby, window mass above
    ``win_mass_frac100``/100 of coverage and a peak slot above
    ``win_peak_frac100``/100 of coverage emit one insertion of the peak
    slot's letter.
    """

    del_bias100: int
    ins_bias100: int
    pool_min_cov: int
    pool_min_cov_ins: int
    win_radius: int = 0
    win_mass_frac100: int = 50
    win_peak_frac100: int = 25


def default_vote_params() -> VoteParams:
    """Pooled-deletion bias 0.65, pooled-insertion bias 0.6, pooled top-ups
    from mean coverage 5 (deletions) and 8 (insertions)."""
    return VoteParams(65, 60, 5, 8)


def _run_pooled_deletions(template: np.ndarray, counts: np.ndarray,
                          coverage: np.ndarray, self_vote: int,
                          vote: Optional["VoteParams"] = None) -> np.ndarray:
    """Homopolymer-aware deletion mask (hybrid plurality + run pooling).

    Positions where GAP wins the per-position plurality are deleted as
    before.  On top of that: when the template carries an extra base inside
    an equal-letter run, each support deletes a DIFFERENT (noise-dependent)
    run position, so GAP votes split ~1/run_length ways and never win a
    plurality.  Pool the run's GAP votes; if
    round(G / mean_coverage) exceeds the plurality deletions, delete that
    many extra positions (the first non-plurality-deleted ones — which
    positions is immaterial, the run letters are equal).
    """
    gap_votes = counts[:, 0, GAP]
    deleted = gap_votes > np.max(counts[:, 0, :4], axis=1)
    L = len(template)
    if L == 0:
        return np.zeros(0, dtype=bool)
    pos = np.arange(L, dtype=np.int64)
    brk = np.ones(L, dtype=bool)
    brk[1:] = template[1:] != template[:-1]
    run_start = np.maximum.accumulate(np.where(brk, pos, 0))
    cg = np.concatenate([[0], np.cumsum(gap_votes, dtype=np.int64)])
    cc = np.concatenate([[0], np.cumsum(coverage, dtype=np.int64)])
    cd = np.concatenate([[0], np.cumsum(deleted, dtype=np.int64)])
    cn = np.concatenate([[0], np.cumsum(~deleted, dtype=np.int64)])
    starts = pos[brk]
    ends = np.concatenate([starts[1:], [L]])
    G = cg[ends] - cg[starts]
    run_len = np.maximum(ends - starts, 1)
    # integer arithmetic (exact; the device path computes the IDENTICAL
    # formula in int32, so it saturates first and uses the floored integer
    # mean coverage m): k = floor(G/m + bias), bias in 1/100ths
    vote = vote or default_vote_params()
    m = np.maximum((cc[ends] - cc[starts]) // run_len + self_vote, 1)
    b100 = vote.del_bias100
    sat = G >= m * (run_len + 1)
    G_c = np.minimum(G, m * (run_len + 1))
    k_pool = np.where(sat, run_len,
                      np.minimum((100 * G_c + b100 * m) // (100 * m),
                                 run_len)).astype(np.int64)
    k_extra = np.where(m >= vote.pool_min_cov,
                       np.maximum(k_pool - (cd[ends] - cd[starts]), 0), 0)
    karr = np.zeros(L, dtype=np.int64)
    karr[starts] = k_extra
    # rank of each non-plurality-deleted position within its run
    nd_rank = cn[pos] - cn[run_start]
    return deleted | (~deleted & (nd_rank < karr[run_start]))


def _run_pooled_insertions(template: np.ndarray, counts: np.ndarray,
                           coverage: np.ndarray, ins_emit: np.ndarray,
                           ins_win: np.ndarray, self_vote: int,
                           vote: Optional["VoteParams"] = None) -> np.ndarray:
    """Extra run-letter insertions per template homopolymer run (pooled).

    Mirror image of _run_pooled_deletions: when the template MISSES a base
    of an equal-letter run, supports insert the letter at noise-dependent
    anchors across the run (and at the anchor just before it), splitting
    the per-slot votes below the emit majority.  Pool the run-letter
    insertion votes over those anchors; the excess over already-emitted
    run-letter insertions is returned per RUN START as a count of extra
    letters to emit (position within the run is immaterial).
    """
    L = len(template)
    if L == 0:
        return np.zeros(0, dtype=np.int64)
    pos = np.arange(L, dtype=np.int64)
    brk = np.ones(L, dtype=bool)
    brk[1:] = template[1:] != template[:-1]
    starts = pos[brk]
    ends = np.concatenate([starts[1:], [L]])
    letters = template[starts].astype(np.int64)
    # per-anchor votes for (a) its own run letter, (b) the NEXT run's letter
    ins_by_letter = counts[:, 1:, :4].sum(axis=1)            # [L, 4]
    v_own = ins_by_letter[pos, template.astype(np.int64)]
    emitted_own = ((ins_emit & (ins_win == template[:, None].astype(
        np.int64))).sum(axis=1))
    cv = np.concatenate([[0], np.cumsum(v_own, dtype=np.int64)])
    ce = np.concatenate([[0], np.cumsum(emitted_own, dtype=np.int64)])
    cc = np.concatenate([[0], np.cumsum(coverage, dtype=np.int64)])
    I = cv[ends] - cv[starts]
    E = ce[ends] - ce[starts]
    # boundary anchor: the position just before the run voting for the
    # run's letter (insertions extending the run leftward)
    left = starts - 1
    has_left = starts > 0
    lw = np.where(has_left, left, 0)
    I = I + np.where(has_left, ins_by_letter[lw, letters], 0)
    E = E + np.where(
        has_left,
        (ins_emit[lw] & (ins_win[lw] == letters[:, None])).sum(axis=1), 0)
    vote = vote or default_vote_params()
    run_len = np.maximum(ends - starts, 1)
    m = np.maximum((cc[ends] - cc[starts]) // run_len + self_vote, 1)
    b100 = vote.ins_bias100
    sat = I >= m * (run_len + 1)
    I_c = np.minimum(I, m * (run_len + 1))
    k_pool = np.where(sat, run_len,
                      (100 * I_c + b100 * m) // (100 * m))
    k_extra = np.where(m >= vote.pool_min_cov_ins,
                       np.maximum(k_pool - E, 0), 0)
    out = np.zeros(L, dtype=np.int64)
    out[starts] = k_extra
    return out


def emit_to_draft(emit: np.ndarray):
    """emit [L, D1] (-1 = empty) → (draft bases uint8, pos_map int32 [L+1]).

    pos_map[p] = number of emitted bases at template positions < p, i.e.
    the draft coordinate where old position p's content begins.  Shared by
    the host call_draft and the device draft collector so pass-2 seed
    remapping is one code path.
    """
    mask = emit >= 0
    rows = mask.sum(axis=1)
    pos_map = np.zeros(len(rows) + 1, dtype=np.int32)
    pos_map[1:] = np.cumsum(rows).astype(np.int32)
    flat = emit.reshape(-1)
    return flat[flat >= 0].astype(np.uint8), pos_map


def _window_pooled_insertions(counts: np.ndarray, coverage: np.ndarray,
                              emit: np.ndarray, gate: np.ndarray,
                              vote: "VoteParams") -> None:
    """Window-pooled single-insertion rule (see VoteParams docstring).

    Pools insertion votes over +-win_radius; at a strict-left/weak-right
    local peak with no emitted insertion in the window, sufficient window
    mass, and a sufficiently strong single peak slot, emits ONE insertion
    of the peak slot's letter into the first free slot (in place).
    Integer arithmetic; the device path computes the IDENTICAL rule
    (:func:`.consensus_device._window_pooled_insertions_dev`).
    """
    R = vote.win_radius
    if R <= 0:
        return
    L, D1, _ = counts.shape
    if L == 0:
        return
    sv = counts[:, 1:, :4].astype(np.int32)                 # [L, D-1, 4]
    v_pos = sv.sum(axis=(1, 2), dtype=np.int32)             # [L]
    already = (emit[:, 1:] >= 0).any(axis=1)
    mass = v_pos.copy()
    near = already.copy()
    lmax = np.zeros(L, np.int32)            # max over [p-R, p-1]
    rmax = np.zeros(L, np.int32)            # max over [p+1, p+R]
    for s in range(1, R + 1):
        mass[s:] += v_pos[:-s]
        mass[:-s] += v_pos[s:]
        near[s:] |= already[:-s]
        near[:-s] |= already[s:]
        lmax[s:] = np.maximum(lmax[s:], v_pos[:-s])
        rmax[:-s] = np.maximum(rmax[:-s], v_pos[s:])
    flat = sv.reshape(L, -1)
    best = flat.max(axis=1)
    bbase = (flat.argmax(axis=1) % 4).astype(np.int32)      # first-max tie
    cov = np.maximum(coverage.astype(np.int32), 1)
    fire = (gate & ~near & (v_pos > lmax) & (v_pos >= rmax)
            & (100 * mass > vote.win_mass_frac100 * cov)
            & (100 * best >= vote.win_peak_frac100 * cov)
            & (best >= 2))
    for p in np.nonzero(fire)[0]:
        for d in range(1, D1):
            if emit[p, d] < 0:
                emit[p, d] = int(bbase[p])
                break


def _apply_extra_insertions(emit: np.ndarray, extra: np.ndarray,
                            template: np.ndarray, gate: np.ndarray) -> None:
    """Fill up to `extra[s]` free insertion slots at each run start s with
    the run letter (in place).  gate: per-position eligibility (cov_ok)."""
    starts = np.nonzero(extra > 0)[0]
    D1 = emit.shape[1]
    for s in starts:
        if not gate[s]:
            continue
        k = int(extra[s])
        for d in range(1, D1):
            if k == 0:
                break
            if emit[s, d] < 0:
                emit[s, d] = int(template[s])
                k -= 1


class CnsTable:
    """Per-template tag accumulator: counts[L, max_delta+1, 5] + coverage."""

    def __init__(self, template: np.ndarray,
                 max_delta: int = C.MAX_INS_DELTA):
        self.template = template
        self.L = len(template)
        self.max_delta = max_delta
        self.counts = np.zeros((self.L, max_delta + 1, 5), dtype=np.int32)
        self.coverage = np.zeros(self.L, dtype=np.int32)

    def add_tags(self, pos, delta, base, span: Tuple[int, int]):
        np.add.at(self.counts, (pos, delta, base), 1)
        a, b = max(0, span[0]), min(self.L, span[1])
        if b > a:
            self.coverage[a:b] += 1

    def add_template_votes(self):
        """The template read votes for itself at every position."""
        self.counts[np.arange(self.L), 0, self.template] += 1

    def call(self, min_coverage: int = C.DEFAULT_MIN_COVERAGE,
             min_length: int = C.DEFAULT_MIN_CORRECTED_LENGTH,
             vote: Optional[VoteParams] = None) -> List[np.ndarray]:
        """Majority-vote a corrected sequence; split at low-coverage points.

        Coverage counts supports only (not the template's self-vote).
        """
        cov_ok = self.coverage >= min_coverage
        base_win = np.argmax(self.counts[:, 0, :4], axis=1)      # [L] no GAP
        deleted = _run_pooled_deletions(self.template, self.counts,
                                        self.coverage, self_vote=1,
                                        vote=vote)
        # insertion slots: emitted when the majority of spanning supports
        # have an inserted base there; a run stops at the first non-emitted
        # delta (prefix rule)
        ins_tot = self.counts[:, 1:, :4].sum(axis=2)             # [L, D]
        ins_win = np.argmax(self.counts[:, 1:, :4], axis=2)      # [L, D]
        ins_emit = np.cumprod(
            ins_tot * 2 > np.maximum(self.coverage, 1)[:, None],
            axis=1).astype(bool)

        D1 = self.counts.shape[1]
        emit = np.full((self.L, D1), -1, dtype=np.int32)
        emit[:, 0] = np.where(cov_ok & ~deleted, base_win, -1)
        emit[:, 1:] = np.where(cov_ok[:, None] & ins_emit, ins_win, -1)
        extra = _run_pooled_insertions(self.template, self.counts,
                                       self.coverage, ins_emit, ins_win,
                                       self_vote=1, vote=vote)
        _apply_extra_insertions(emit, extra, self.template, cov_ok)
        _window_pooled_insertions(self.counts, self.coverage, emit, cov_ok,
                                  vote or default_vote_params())

        # split at low-coverage positions: segment id = running count of gaps
        seg_id = np.repeat(np.cumsum(~cov_ok), D1)
        flat = emit.reshape(-1)
        mask = flat >= 0
        bases = flat[mask].astype(np.uint8)
        segs = seg_id[mask]
        if len(bases) == 0:
            return []
        cut = np.nonzero(np.diff(segs))[0] + 1
        return [s for s in np.split(bases, cut) if len(s) >= min_length]

    def call_draft(self, min_coverage: int = C.DEFAULT_MIN_COVERAGE,
                   vote: Optional[VoteParams] = None):
        """Full-length draft for iterative correction (rounds > 1).

        Same vote rules as :meth:`call` (self-votes, pooled + window rules)
        but NEVER splits: below-min-coverage positions keep the template
        base verbatim, so pass-2 seed coordinates can be mapped through and
        supports re-anchored.  Returns (draft uint8, pos_map int32 [L+1])
        where pos_map[p] = draft index where old template position p's
        content begins (cumulative emitted bases before p).
        """
        cov_ok = self.coverage >= min_coverage
        base_win = np.argmax(self.counts[:, 0, :4], axis=1)
        deleted = _run_pooled_deletions(self.template, self.counts,
                                        self.coverage, self_vote=1,
                                        vote=vote)
        ins_tot = self.counts[:, 1:, :4].sum(axis=2)
        ins_win = np.argmax(self.counts[:, 1:, :4], axis=2)
        ins_emit = np.cumprod(
            ins_tot * 2 > np.maximum(self.coverage, 1)[:, None],
            axis=1).astype(bool)
        D1 = self.counts.shape[1]
        emit = np.full((self.L, D1), -1, dtype=np.int32)
        emit[:, 0] = np.where(cov_ok,
                              np.where(~deleted, base_win, -1),
                              self.template)
        emit[:, 1:] = np.where(cov_ok[:, None] & ins_emit, ins_win, -1)
        extra = _run_pooled_insertions(self.template, self.counts,
                                       self.coverage, ins_emit, ins_win,
                                       self_vote=1, vote=vote)
        _apply_extra_insertions(emit, extra, self.template, cov_ok)
        _window_pooled_insertions(self.counts, self.coverage, emit, cov_ok,
                                  vote or default_vote_params())
        return emit_to_draft(emit)

    def call_polished(self, min_coverage: int = 2) -> np.ndarray:
        """Single polished sequence (contig-consensus / utgcns role).

        Unlike :meth:`call`, never splits: where support coverage is below
        ``min_coverage`` the template base is kept verbatim (a draft contig
        backbone is trusted outside well-covered windows), elsewhere the
        majority vote applies including deletions and insertion slots.
        """
        use = self.coverage >= min_coverage
        base_win = np.argmax(self.counts[:, 0, :4], axis=1)
        deleted = _run_pooled_deletions(self.template, self.counts,
                                        self.coverage, self_vote=0)
        ins_tot = self.counts[:, 1:, :4].sum(axis=2)
        ins_win = np.argmax(self.counts[:, 1:, :4], axis=2)
        ins_emit = np.cumprod(
            ins_tot * 2 > np.maximum(self.coverage, 1)[:, None],
            axis=1).astype(bool)

        D1 = self.counts.shape[1]
        emit = np.full((self.L, D1), -1, dtype=np.int32)
        emit[:, 0] = np.where(use,
                              np.where(~deleted, base_win, -1),
                              self.template)
        emit[:, 1:] = np.where(use[:, None] & ins_emit, ins_win, -1)
        extra = _run_pooled_insertions(self.template, self.counts,
                                       self.coverage, ins_emit, ins_win,
                                       self_vote=0)
        _apply_extra_insertions(emit, extra, self.template, use)
        flat = emit.reshape(-1)
        return flat[flat >= 0].astype(np.uint8)
