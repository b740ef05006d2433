"""Device-resident pile-consensus vote and op-tape stream compaction (port of
mecat_tpu.ops.consensus_device): tag counts -> emitted bases, and
per-segment op tapes -> one forward column stream per pair, on the device.

:func:`call_tables` is the single-round call of the reference
(``keep_template=False, draft_mode=False``): template self-votes, the
plurality base, homopolymer-run-pooled deletions and insertions, the
window-pooled insertion rule, all in int32 with the reference's exact
integer formulas.  Only the small emit/coverage arrays go to the host, where
:func:`split_called` cuts the corrected read at thin coverage.

:func:`ops_stream` compacts the tapes of
:func:`..ops.align.extend_pair_batch_with_ops` into the forward op codes
mapping turns into CIGARs.

Not ported: the op-tape tag route (``accumulate_tags``; the banded route of
:mod:`.consensus_banded` replaces it), the polish and draft modes, and the
nibble packing of the emit pull.
"""
from __future__ import annotations

import numpy as np
import torch

from .consensus import GAP, VoteParams, default_vote_params


def _stream_one_direction(tapes, qseed, tseed, reverse: bool):
    """One direction's tapes -> (ops, qpos, tpos, slot, n_total) flat views.

    Per-column tensors shaped [B, G*MAXC] (stored layout order), the
    in-stream slot of every column (template-forward compaction, -1 for an
    unused column) and the per-pair total column count.
    """
    ops, qi, tj, n, qo, to, ok = tapes
    G, B, MAXC = ops.shape
    n = n.to(torch.int32)                                     # [G, B]
    c_idx = torch.arange(MAXC, dtype=torch.int32, device=ops.device)
    col_valid = c_idx >= (MAXC - n[:, :, None])
    csum = torch.cumsum(n, dim=0, dtype=torch.int32)
    if not reverse:
        # forward order: segments ascending, stored order within segment
        f = c_idx - (MAXC - n[:, :, None])
        seg_base = csum - n                                   # [G, B]
        qpos = torch.where(qi >= 0,
                           qseed[None, :, None] + qo[:, :, None] + qi, -1)
        tpos = tseed[None, :, None] + to[:, :, None] + tj
    else:
        # left tapes: template-forward = reversed segment order, reversed
        # within segment
        f = (MAXC - 1 - c_idx).expand(G, B, MAXC)
        seg_base = csum[-1][None, :] - csum                   # [G, B]
        qpos = torch.where(qi >= 0,
                           qseed[None, :, None] - 1
                           - (qo[:, :, None] + qi), -1)
        tpos = tseed[None, :, None] - 1 - (to[:, :, None] + tj)
    slot = torch.where(col_valid, seg_base[:, :, None] + f, -1)

    def flat(a):
        return a.transpose(0, 1).reshape(B, G * MAXC)

    return (flat(ops.to(torch.int32)), flat(qpos), flat(tpos), flat(slot),
            csum[-1])


def _build_streams(right_t, left_t, qseed, tseed, CW: int):
    """Both directions -> template-forward column streams int32 [B, CW]:
    (ops, qpos, tpos), -1 beyond the alignment.

    (ops, qpos) travel as one scattered word, (qpos + 1) * 4 + ops.  The
    reference scatters in drop mode: an unused column goes to slot CW and a
    slot past CW falls out too.  Here every such column goes to a sentinel
    column CW that is cut off at the end; real slots are unique.
    """
    l_ops, l_qpos, l_tpos, l_slot, l_n = _stream_one_direction(
        left_t, qseed, tseed, reverse=True)
    r_ops, r_qpos, r_tpos, r_slot, _ = _stream_one_direction(
        right_t, qseed, tseed, reverse=False)
    B = l_ops.shape[0]
    dev = l_ops.device
    oq_s = torch.full((B, CW + 1), -1, dtype=torch.int32, device=dev)
    tpos_s = torch.full((B, CW + 1), -1, dtype=torch.int32, device=dev)

    def pack(ops, qpos):
        return torch.where(ops >= 0, (qpos + 1) * 4 + ops, -1)

    def scat(dst, src, slot):
        slot = torch.where(slot >= 0, slot, CW).clamp(max=CW)
        dst.scatter_(1, slot.long(), src)

    # left stream occupies [0, l_n); right follows at l_n
    scat(oq_s, pack(l_ops, l_qpos), l_slot)
    scat(tpos_s, l_tpos, l_slot)
    r_slot_g = torch.where(r_slot >= 0, r_slot + l_n[:, None], -1)
    scat(oq_s, pack(r_ops, r_qpos), r_slot_g)
    scat(tpos_s, r_tpos, r_slot_g)
    oq_s, tpos_s = oq_s[:, :CW], tpos_s[:, :CW]

    ops_s = torch.where(oq_s >= 0, oq_s & 3, -1)
    qpos_s = torch.where(oq_s >= 0, (oq_s >> 2) - 1, -1)
    return ops_s, qpos_s, tpos_s


def ops_stream(right_t, left_t, qseed, tseed, CW: int) -> torch.Tensor:
    """Forward-ordered alignment op codes per pair, compacted on the device.

    int8 [B, CW]: ops (0..3) in template-forward order starting at slot 0,
    -1 beyond the alignment; all mapping needs for exact CIGARs.
    """
    o, _, _ = _build_streams(right_t, left_t, qseed, tseed, CW)
    return o.to(torch.int8)


def _first_argmax(x: torch.Tensor):
    """Index of the first maximum along the last axis (``jnp.argmax``'s tie
    rule; ``torch.argmax`` promises none)."""
    n = x.shape[-1]
    top = x.max(dim=-1, keepdim=True).values
    pos = torch.arange(n, dtype=torch.int32, device=x.device)
    return torch.where(x == top, pos, n).min(dim=-1).values


def _prefix(x: torch.Tensor):
    """Exclusive-start prefix sums along axis 1, int32 [T, L + 1]."""
    c = torch.cumsum(x.to(torch.int32), dim=1, dtype=torch.int32)
    return torch.cat([torch.zeros_like(c[:, :1]), c], dim=1)


def _runs(template: torch.Tensor, tlen: torch.Tensor):
    """Homopolymer runs of the padded template rows: (run_start, run_end)
    int32 [T, L], end exclusive; the padding past tlen is its own run."""
    T, L = template.shape
    dev = template.device
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    brk = torch.cat([torch.ones((T, 1), dtype=torch.bool, device=dev),
                     template[:, 1:] != template[:, :-1]], dim=1)
    brk = brk | (pos == tlen[:, None])
    run_start = torch.cummax(torch.where(brk, pos, 0), dim=1).values
    # next-break index via a suffix min of the break positions
    nxt = torch.where(brk, pos, L)
    nxt = torch.cat([nxt[:, 1:], torch.full((T, 1), L, dtype=torch.int32,
                                            device=dev)], dim=1)
    run_end = torch.flip(torch.cummin(torch.flip(nxt, dims=[1]),
                                      dim=1).values, dims=[1])
    return pos, run_start, run_end


def call_tables(counts: torch.Tensor,        # int32 [T, L, D1, 5]
                cov_diff: torch.Tensor,      # int32 [T, L + 1]
                template: torch.Tensor,      # uint8 [T, L] padded bases
                tlen: torch.Tensor,          # int32 [T]
                has_support: torch.Tensor,   # bool [T]
                min_coverage: int,
                vote: VoteParams | None = None):
    """The vote over one slice's tag tables.

    Returns (emit int32 [T, L, D1] base code or -1, cov_ok bool [T, L]).
    The template self-votes are added to ``counts`` IN PLACE (the table is
    spent after its vote), so call it once per table.
    """
    vote = vote or default_vote_params()
    T, L, D1, _ = counts.shape
    dev = counts.device
    tmpl = template.to(torch.int32)
    l_idx = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    in_read = l_idx < tlen[:, None]
    # template self-votes, only where a support produced a table
    counts[:, :, 0, :].scatter_add_(
        2, tmpl.long()[:, :, None],
        (in_read & has_support[:, None]).to(torch.int32)[:, :, None])

    coverage = torch.cumsum(cov_diff[:, :L], dim=1, dtype=torch.int32)
    cov_ok = (coverage >= min_coverage) & in_read & has_support[:, None]
    base_win = _first_argmax(counts[:, :, 0, :4])             # [T, L] no GAP
    deleted = _run_pooled_deletions_dev(tmpl, counts, coverage, tlen,
                                        self_vote=1, vote=vote)
    ins = counts[:, :, 1:, :4]
    ins_tot = ins.sum(dim=3, dtype=torch.int32)               # [T, L, D1-1]
    ins_win = _first_argmax(ins)
    ins_emit = torch.cumprod(
        (ins_tot * 2 > coverage.clamp(min=1)[:, :, None]).to(torch.int32),
        dim=2).bool()

    base0 = torch.where(cov_ok & ~deleted, base_win, -1)
    ins_slots = torch.where(cov_ok[:, :, None] & ins_emit, ins_win, -1)
    extra = _run_pooled_insertions_dev(tmpl, counts, coverage, ins_emit,
                                       ins_win, tlen, self_vote=1, vote=vote)
    extra = torch.where(cov_ok, extra, 0)
    # fill the first `extra` free slots at each run start with the run letter
    free = ins_slots < 0
    frank = torch.cumsum(free.to(torch.int32), dim=2, dtype=torch.int32)
    fill = free & (frank <= extra[:, :, None])
    ins_slots = torch.where(fill, tmpl[:, :, None], ins_slots)
    ins_slots = _window_pooled_insertions_dev(counts, coverage, ins_slots,
                                              cov_ok, vote)
    emit = torch.cat([base0[:, :, None], ins_slots], dim=2)
    return emit, cov_ok


def _window_pooled_insertions_dev(counts, coverage, ins_slots, gate,
                                  vote: VoteParams):
    """Emit the peak slot's letter into the first free slot at strict local
    peaks of windowed insertion mass (``vote.win_radius`` > 0).

    counts [T, L, D1, 5], coverage/gate [T, L], ins_slots [T, L, D1-1]
    (after the run-pool fill).
    """
    R = int(vote.win_radius)
    if R <= 0:
        return ins_slots
    T, L, D1, _ = counts.shape
    sv = counts[:, :, 1:, :4]
    v_pos = sv.sum(dim=(2, 3), dtype=torch.int32)             # [T, L]
    already = (ins_slots >= 0).any(dim=2)
    mass, near = v_pos, already
    lmax = torch.zeros_like(v_pos)
    rmax = torch.zeros_like(v_pos)

    def sl(x, s):  # x shifted right by s (left-neighbour view), zero pad
        return torch.cat([torch.zeros_like(x[:, :s]), x[:, :-s]], dim=1)

    def sr(x, s):  # x shifted left by s (right-neighbour view)
        return torch.cat([x[:, s:], torch.zeros_like(x[:, :s])], dim=1)

    for s in range(1, R + 1):
        mass = mass + sl(v_pos, s) + sr(v_pos, s)
        near = near | sl(already, s) | sr(already, s)
        lmax = torch.maximum(lmax, sl(v_pos, s))
        rmax = torch.maximum(rmax, sr(v_pos, s))
    flat = sv.reshape(T, L, -1)
    best = flat.max(dim=2).values
    bbase = _first_argmax(flat) % 4
    cov = coverage.clamp(min=1)
    fire = (gate & ~near & (v_pos > lmax) & (v_pos >= rmax)
            & (100 * mass > vote.win_mass_frac100 * cov)
            & (100 * best >= vote.win_peak_frac100 * cov)
            & (best >= 2))
    free = ins_slots < 0
    first_free = free & (torch.cumsum(free.to(torch.int32), dim=2) == 1)
    return torch.where(fire[:, :, None] & first_free, bbase[:, :, None],
                       ins_slots)


def _at(prefix: torch.Tensor, idx: torch.Tensor):
    return torch.gather(prefix, 1, idx.long())


def _run_pooled_insertions_dev(template, counts, coverage, ins_emit,
                               ins_win, tlen, self_vote: int,
                               vote: VoteParams):
    """Per-position count of EXTRA run-letter insertions, nonzero only at
    run starts (homopolymer-run pooling of insertion votes)."""
    T, L = template.shape
    pos, run_start, run_end = _runs(template, tlen)
    tl = template.long()

    ins_by_letter = counts[:, :, 1:, :4].sum(dim=2, dtype=torch.int32)
    v_own = torch.gather(ins_by_letter, 2, tl[:, :, None])[:, :, 0]
    emitted_own = (ins_emit & (ins_win == template[:, :, None])).sum(
        dim=2, dtype=torch.int32)

    cv, ce, cc = _prefix(v_own), _prefix(emitted_own), _prefix(coverage)
    I = _at(cv, run_end) - _at(cv, run_start)
    E = _at(ce, run_end) - _at(ce, run_start)
    # left-boundary anchor (the position just before the run) voting for
    # THIS run's letter
    letter = torch.gather(template, 1, run_start.long())
    ls = (run_start - 1).clamp(min=0).long()
    g1 = torch.gather(ins_by_letter, 1, ls[:, :, None].expand(T, L, 4))
    v_left = torch.gather(g1, 2, letter.long()[:, :, None])[:, :, 0]
    K = ins_emit.shape[2]
    e1 = torch.gather(ins_emit, 1, ls[:, :, None].expand(T, L, K))
    w1 = torch.gather(ins_win, 1, ls[:, :, None].expand(T, L, K))
    e_left = (e1 & (w1 == letter[:, :, None])).sum(dim=2, dtype=torch.int32)
    has_left = run_start > 0
    I = I + torch.where(has_left, v_left, 0)
    E = E + torch.where(has_left, e_left, 0)

    run_len = (run_end - run_start).clamp(min=1)
    m = (torch.div(_at(cc, run_end) - _at(cc, run_start), run_len,
                   rounding_mode="floor") + self_vote).clamp(min=1)
    b100 = vote.ins_bias100
    sat = I >= m * (run_len + 1)
    I_c = torch.minimum(I, m * (run_len + 1))
    # floor((100*I + b*m)/(100*m)) == I//m + (100*(I%m) >= (100-b)*m):
    # exact, and never forms 100*I_c, which can pass 2^31 on deep piles
    k_pool = torch.where(
        sat, run_len,
        torch.div(I_c, m, rounding_mode="floor")
        + (100 * torch.remainder(I_c, m) >= (100 - b100) * m).to(torch.int32))
    k_extra = torch.where(m >= vote.pool_min_cov_ins,
                          (k_pool - E).clamp(min=0), 0)
    return torch.where(pos == run_start, k_extra, 0)


def _run_pooled_deletions_dev(template, counts, coverage, tlen,
                              self_vote: int, vote: VoteParams):
    """Deletion mask: plurality GAP wins plus homopolymer-run-pooled GAP
    votes.  All run quantities are prefix sums gathered at run starts/ends."""
    pos, run_start, run_end = _runs(template, tlen)
    gap_votes = counts[:, :, 0, GAP]
    deleted = gap_votes > counts[:, :, 0, :4].max(dim=2).values
    cg, cc = _prefix(gap_votes), _prefix(coverage)
    cd, cn = _prefix(deleted), _prefix(~deleted)
    G = _at(cg, run_end) - _at(cg, run_start)
    run_len = (run_end - run_start).clamp(min=1)
    m = (torch.div(_at(cc, run_end) - _at(cc, run_start), run_len,
                   rounding_mode="floor") + self_vote).clamp(min=1)
    b100 = vote.del_bias100
    sat = G >= m * (run_len + 1)
    G_c = torch.minimum(G, m * (run_len + 1))
    # floor((100*G + b*m)/(100*m)) == G//m + (100*(G%m) >= (100-b)*m)
    k_pool = torch.where(
        sat, run_len,
        torch.minimum(
            torch.div(G_c, m, rounding_mode="floor")
            + (100 * torch.remainder(G_c, m)
               >= (100 - b100) * m).to(torch.int32), run_len))
    k_extra = torch.where(
        m >= vote.pool_min_cov,
        (k_pool - (_at(cd, run_end) - _at(cd, run_start))).clamp(min=0), 0)
    nd_rank = _at(cn, pos.expand_as(run_start)) - _at(cn, run_start)
    return deleted | (~deleted & (nd_rank < k_extra))


def split_called(emit_row, cov_ok_row, tlen: int, min_length: int):
    """Host tail of the call: split the emitted bases at low-coverage
    template positions.  emit_row [L, k] integers (-1 = nothing emitted),
    cov_ok_row [L] bool; returns the uint8 segments of >= min_length."""
    emit_row = np.asarray(emit_row)[:tlen]
    cov_ok_row = np.asarray(cov_ok_row)[:tlen]
    D1 = emit_row.shape[1]
    seg_id = np.repeat(np.cumsum(~cov_ok_row), D1)
    flat = emit_row.reshape(-1)
    mask = flat >= 0
    bases = flat[mask].astype(np.uint8)
    segs = seg_id[mask]
    if len(bases) == 0:
        return []
    cut = np.nonzero(np.diff(segs))[0] + 1
    return [s for s in np.split(bases, cut) if len(s) >= min_length]
