"""Banded consensus tag emission: row walks -> dense sliding-band planes
(port of mecat_tpu.ops.consensus_banded, op for op, all integers).

Every tag a DP row produces lands within that row's band, so an S-step scan
deposits tags into a [lanes, W] accumulator that slides with the band and
emits one finished template-char column per step.  Planes per direction
(segment-local target char coordinates c, 0-based at the segment's toff):

  val0  int8  : delta-0 channel: base code consumed at c, GAP if deleted,
                -1 if not consumed;
  ipack int32 : insertion bases anchored at c, 2 bits per delta, delta d at
                bits 2(d-1), d = 1..15 (larger deltas drop);
  icnt  int32 : total insertion-run length anchored at c (unclamped).

Anchor conventions: in the right direction a VERT at row r, band column w
sits at target count j = r - W/2 + w and anchors at char j-1; runs with
j == 0 anchor in the previous segment (side band).  In the left direction
global order reverses the local walk: a run anchors at char j, per-run
deltas reverse, and runs with j == j_end anchor in the next local segment.

Every tensor that the reference keeps in int32 is int32 here, so its shifts
wrap the same way; ``torch.arange`` and Python scalars are never allowed to
promote a plane to int64.  Computed slice starts go through
:func:`..ops.align.dynamic_slice_start`.  Both directions' row
information and the S-step deposit scan run as one kernel launch for CUDA
tensors (:func:`plane_inputs`, ``csrc/cns_walk.cu``) and as small torch ops
and a Python loop of them, :func:`plane_inputs_plain`
(:func:`direction_rowinfo`, then :func:`deposit_scan_plain`), for CPU
tensors; so do
the global planes (:func:`global_planes`, plain version
:func:`banded_global_planes_plain`) and the fold of the planes into the
tables (:func:`fold_tags`, plain version :func:`fold_tags_plain`), both in
``csrc/cns_fold.cu``.
"""
from __future__ import annotations

import torch

from .. import constants as C
from ..utils.metrics import span
from .align import (MOVE_MATCH, MOVE_MISMATCH, MOVE_VERT,
                    dynamic_slice_start)
from .consensus import GAP

MAXD = C.MAX_INS_DELTA  # 15: 2-bit bases for deltas 1..15 fit one int32


def _iota(n: int, dev, dtype=torch.int32):
    return torch.arange(n, dtype=dtype, device=dev)


def _shift_right(a: torch.Tensor, fill):
    """a moved one place up its last axis, ``fill`` entering at index 0."""
    return torch.cat([torch.full_like(a[..., :1], fill), a[..., :-1]], dim=-1)


def run_deltas(mv: torch.Tensor, h: torch.Tensor, left: bool):
    """Per-row insertion-run positions from row-walk outputs.

    mv, h: int32 [..., S] ascending-row arrays (index i = row r-1).  A VERT
    run is a maximal set of consecutive VERT rows with h == 0 between them.
    Returns delta int32 [..., S]: for VERT rows the global-order run
    position (right: ascending rows; left: descending), else 0.
    """
    S = mv.shape[-1]
    isv = mv == MOVE_VERT
    prev_v = _shift_right(isv, False)
    prev_h0 = _shift_right(h, 0) == 0
    start = isv & ~(prev_v & prev_h0)
    i_idx = _iota(S, mv.device).expand(mv.shape)
    start_idx = torch.cummax(torch.where(start, i_idx, -1), dim=-1).values
    d_fwd = torch.where(isv, i_idx - start_idx + 1, 0)
    if not left:
        return d_fwd
    # row e ends its run iff row e+1 does not continue it
    nxt_v = torch.cat([isv[..., 1:], torch.zeros_like(isv[..., :1])], dim=-1)
    run_end = isv & ~(nxt_v & (h == 0))
    end_idx = torch.flip(torch.cummin(
        torch.flip(torch.where(run_end, i_idx, S), dims=[-1]),
        dim=-1).values, dims=[-1])
    run_len = end_idx - start_idx + 1
    return torch.where(isv, run_len - d_fwd + 1, 0)


def deposit_scan_plain(wo, aw, h, mv, vbase, delta, keep_ins, W: int):
    """Sliding-band deposit: per-row tags -> per-segment local planes; the
    plain version of the deposit kernel, on any device.

    All row arrays are [N, S] (ascending rows).  Scans rows descending (the
    direction the band slides); at row r the accumulator column w holds
    target char c = (r-1) + w - W/2: a diagonal's consumed char is column
    wo, its h trailing deletions are columns wo+1..wo+h, and an insertion
    deposits at column aw.  Each step emits the exiting top column; chars
    below the final window come from the end state.  Returns (val0, ipack,
    icnt) planes [N, S + W/2 - 1] in ascending-char order.
    """
    N, S = wo.shape
    half = W // 2
    dev = wo.device
    w_iota = _iota(W, dev)[None, :]
    a0 = torch.full((N, W), -1, dtype=torch.int8, device=dev)
    ap = torch.zeros((N, W), dtype=torch.int32, device=dev)
    ac = torch.zeros((N, W), dtype=torch.int32, device=dev)
    gap8 = torch.tensor(GAP, dtype=torch.int8, device=dev)
    isd = (mv == MOVE_MATCH) | (mv == MOVE_MISMATCH)
    visited = mv >= 0
    vb8 = vbase.to(torch.int8)
    # vbase << 2(d-1) in int32 as the reference shifts it; only d <= MAXD
    # is ever kept, so the clamp just keeps the unused shifts defined
    shifted = vbase << (2 * (delta - 1).clamp(0, MAXD - 1))
    dep_ok = keep_ins & (delta >= 1) & (delta <= MAXD)
    cnt_ok = keep_ins & (delta >= 1)
    y0, yp, yc = [], [], []
    for r in range(S - 1, -1, -1):
        wo_r = wo[:, r, None]
        at_aw = w_iota == aw[:, r, None]
        a0 = torch.where(isd[:, r, None] & (w_iota == wo_r),
                         vb8[:, r, None], a0)
        gap = ((w_iota > wo_r) & (w_iota <= wo_r + h[:, r, None])
               & visited[:, r, None])
        a0 = torch.where(gap, gap8, a0)
        ap = torch.where(dep_ok[:, r, None] & at_aw,
                         ap | shifted[:, r, None], ap)
        ac = torch.where(cnt_ok[:, r, None] & at_aw,
                         torch.maximum(ac, delta[:, r, None]), ac)
        y0.append(a0[:, -1])
        yp.append(ap[:, -1])
        yc.append(ac[:, -1])
        a0 = _shift_right(a0, -1)
        ap = _shift_right(ap, 0)
        ac = _shift_right(ac, 0)
    # the step of row r emitted char r + half - 2, so ascending char order
    # is reversed steps; chars [0, half-1) sit in the end state at columns
    # [half+1, W)
    out = lambda f, ys: torch.cat(
        [f[:, half + 1:], torch.stack(ys[::-1], dim=1)], dim=1)
    return out(a0, y0), out(ap, yp), out(ac, yc)


#: the reference's name for the deposit; the card runs it together with
#: the row information, in :func:`plane_inputs`
_deposit_scan = deposit_scan_plain


def direction_rowinfo(rows, q: torch.Tensor, qseed: torch.Tensor, S: int,
                      W: int, left: bool):
    """One direction's row-walk outputs -> deposit-scan row arrays.

    rows: (mv, h, wo [G, B, S], w0 [G, B], qoff, toff, ok) from
    ops/align.extend_pair_batch_rows, in the direction's local coordinates.
    q: uint8 [B, Lq] support chars in the scanned (forward) orientation.

    Returns (row arrays dict, bnd_pack, bnd_cnt [G, B] side-band runs,
    toff, j_end, lead [G, B], ok).  The row arrays are direction-agnostic
    once built, so both directions share one deposit scan.
    """
    mv, h, wo, w0, qoff, toff, ok = rows
    G, B, _ = mv.shape
    half = W // 2
    dev = mv.device
    i_idx = _iota(S, dev)[None, None, :]
    j = (i_idx + 1) - half + wo                   # target count at the move
    j_end = torch.where(mv >= 0, j + h, -1).max(dim=2).values  # [G, B]

    # per-row consumed query char: right q[qseed+qoff+i]; left the reversed
    # prefix q[qseed-1-qoff-i]: both one contiguous slice per segment
    pad = torch.zeros((B, S), dtype=q.dtype, device=dev)
    qp = torch.cat([pad, q, pad], dim=1)
    offs = (qseed[None, :] - qoff if left
            else S + qseed[None, :] + qoff).to(torch.int32)
    start = dynamic_slice_start(offs, qp.shape[1], S)
    qrows = qp.unfold(1, S, 1)[_iota(B, dev, torch.int64)[None, :], start]
    if left:
        qrows = torch.flip(qrows, dims=[2])
    vbase = qrows.to(torch.int32)

    delta = run_deltas(mv, h, left=left)
    isv = mv == MOVE_VERT
    if left:
        sideband = isv & (j == j_end[:, :, None])
        aw = wo + 1                               # anchor char j -> col wo+1
    else:
        sideband = isv & (j == 0)
        aw = wo
    okx = ok[:, :, None]
    keep_ins = isv & ~sideband & okx

    sb = sideband & okx
    sb_d = torch.where(sb, delta, 0)
    bnd_cnt = sb_d.max(dim=2).values
    bits = torch.where(sb & (sb_d <= MAXD),
                       vbase << (2 * (sb_d - 1).clamp(0, MAXD - 1)), 0)
    bnd_pack = _or_reduce(bits, dim=2)

    info = dict(wo=wo, aw=aw, h=torch.where(okx, h, 0),
                mv=torch.where(okx, mv, -1), vbase=vbase, delta=delta,
                keep_ins=keep_ins)
    lead = (w0 - half).clamp(min=0)
    return info, bnd_pack, bnd_cnt, toff, j_end, lead, ok


def _or_reduce(x: torch.Tensor, dim: int):
    """Bitwise OR of int32 ``x`` along ``dim`` (torch has no OR reduction):
    halve the axis until one entry is left."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > 1:
        n = x.shape[-1]
        if n % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
            n += 1
        x = x[..., :n // 2] | x[..., n // 2:]
    return x[..., 0]


def plane_inputs_plain(right_rows, left_rows, q: torch.Tensor,
                       qseed: torch.Tensor, S: int, W: int):
    """Both directions' row walks -> the inputs of the global planes: each
    direction's row information (:func:`direction_rowinfo`), then ONE
    deposit scan over every direction's segments, cut into each direction's
    local planes (val0, ipack, icnt) [G, B, LP] (views of the scan's
    output), and each direction's side arrays (toff, ok, lead, bnd_pack,
    bnd_cnt) [G, B], with the left direction's j_end [G_l, B]; the plain
    version of the deposit kernel, on any device.

    Returns (planes_r, planes_l, side_r, side_l, lj_end), the first five
    arguments of :func:`banded_global_planes_plain`.
    """
    ri, rbp, rbc, rtoff, _, rlead, rok = direction_rowinfo(
        right_rows, q, qseed, S, W, left=False)
    li, lbp, lbc, ltoff, lj_end, llead, lok = direction_rowinfo(
        left_rows, q, qseed, S, W, left=True)
    LP = S + W // 2 - 1
    flat = lambda k: torch.cat([ri[k].reshape(-1, S), li[k].reshape(-1, S)],
                               dim=0)
    dep = deposit_scan_plain(flat("wo"), flat("aw"), flat("h"), flat("mv"),
                             flat("vbase"), flat("delta"), flat("keep_ins"),
                             W)
    n = rok.numel()
    planes_r = tuple(a[:n].view(*rok.shape, LP) for a in dep)
    planes_l = tuple(a[n:].view(*lok.shape, LP) for a in dep)
    return (planes_r, planes_l, (rtoff, rok, rlead, rbp, rbc),
            (ltoff, lok, llead, lbp, lbc), lj_end)


def plane_inputs(right_rows, left_rows, q: torch.Tensor, qseed: torch.Tensor,
                 S: int, W: int):
    """The inputs of the global planes, as :func:`plane_inputs_plain`
    returns them; the deposit kernel for CUDA tensors.

    CPU tensors take the plain version; CUDA tensors launch the deposit
    kernel (``csrc/cns_walk.cu`` through :mod:`.walk_kernel`), which makes
    the row information inside it and raises on what it does not take: one
    launch, and its outputs' allocations.
    """
    if q.device.type == "cpu":
        return plane_inputs_plain(right_rows, left_rows, q, qseed, S, W)
    from .walk_kernel import deposit_rows_cuda

    return deposit_rows_cuda(right_rows, left_rows, q, qseed, S=S, W=W)


def _update_rows(dst: torch.Tensor, src: torch.Tensor, start: torch.Tensor):
    """dst[b, start[b] : start[b] + n] = src[b] in place, the start clamped
    to [0, width - n] as ``lax.dynamic_update_slice`` clamps it."""
    n = src.shape[1]
    start = start.clamp(0, dst.shape[1] - n).long()
    idx = start[:, None] + _iota(n, dst.device, torch.int64)[None, :]
    return dst.scatter_(1, idx, src)


def _window_write(planes, toff, ok, lead, LG: int):
    """Forward pass of per-segment window writes into [B, LG] planes, the
    leading-deletion GAP marks (chars below ``lead``) put on first.

    Clobber-safe: every true cell of segment g sits below segment g+1's
    window start, so later windows only overwrite empty tails.  Non-applied
    segments are masked empty here.
    """
    v0, ip, ic = planes
    G, B, LP = v0.shape
    dev = v0.device
    okx = ok[:, :, None]
    c_iota = _iota(LP, dev)[None, None, :]
    v0 = torch.where(okx & (c_iota < lead[:, :, None]),
                     torch.tensor(GAP, dtype=torch.int8, device=dev), v0)
    g0 = torch.full((B, LG), -1, dtype=torch.int8, device=dev)
    gp = torch.zeros((B, LG), dtype=torch.int32, device=dev)
    gc = torch.zeros((B, LG), dtype=torch.int32, device=dev)
    s0 = torch.where(okx, v0, torch.tensor(-1, dtype=torch.int8, device=dev))
    sp = torch.where(okx, ip, 0)
    sc = torch.where(okx, ic, 0)
    o = toff.clamp(0, LG - LP)
    for g in range(G):
        _update_rows(g0, s0[g], o[g])
        _update_rows(gp, sp[g], o[g])
        _update_rows(gc, sc[g], o[g])
    return g0, gp, gc


def _segmented(vals: torch.Tensor, same: torch.Tensor, comb):
    """Within-group inclusive scan over axis 0 (groups = runs of same)."""
    out = [vals[0]]
    for i in range(1, vals.shape[0]):
        out.append(torch.where(same[i], comb(out[-1], vals[i]), vals[i]))
    return torch.stack(out)


def banded_global_planes_plain(planes_r, planes_l, side_r, side_l, lj_end,
                               tseed, *, L_t: int, S: int, W: int):
    """Both directions' local planes -> global template-coordinate planes
    (g0 int8, gpack int32, gcnt int32) [B, L_t]; the plain version of the
    planes kernel, on any device.

    planes_r / planes_l: (val0 int8, ipack, icnt int32) [G, B, LP] from the
    deposit; side_r / side_l: (toff, ok, lead, bnd_pack, bnd_cnt) [G, B];
    lj_end int32 [G_l, B]; tseed int32 [B] (:func:`plane_inputs`).  Marks
    each segment's leading deletions, writes the segments' windows in
    order, places both directions around the seed (left flipped: local char
    c <-> global tseed-1-c; right at tseed+c), then applies the side-band
    insertion continuations in global column order (left descending
    segments, then right ascending) with live delta offsets: base = the
    assembled plane's run count at the target cell, plus a segmented prefix
    over same-cell side-band chains.
    """
    rtoff, rok, rlead, rbp, rbc = side_r
    ltoff, lok, llead, lbp, lbc = side_l
    B = tseed.shape[0]
    LP = S + W // 2 - 1
    LG = L_t + LP + S
    dev = tseed.device
    r0, rp, rc = _window_write(planes_r, rtoff, rok, rlead, LG)
    l0, lp, lc = _window_write(planes_l, ltoff, lok, llead, LG)

    Lb = LG + L_t + LG  # buffer origin LG: left placement never underflows

    def build(lv, rv, fill):
        # one more column than the reference's Lb: the sentinel column that
        # takes the masked side-band writes below
        g = torch.full((B, Lb + 1), fill, dtype=lv.dtype, device=dev)
        _update_rows(g, torch.flip(lv, dims=[1]), tseed)  # [tseed-LG, tseed)
        return _update_rows(g, rv, LG + tseed)            # [tseed, tseed+LG)

    g0 = build(l0, r0, -1)
    gp = build(lp, rp, 0)
    gc = build(lc, rc, 0)

    # ---- side-band application (global column order) ----
    l_cell = LG + tseed[None, :] - 1 - (ltoff + lj_end.clamp(min=0))
    r_cell = LG + tseed[None, :] + rtoff - 1
    rev = lambda a: torch.flip(a, dims=[0])
    cells = torch.cat([rev(l_cell), r_cell], dim=0)
    packs = torch.cat([rev(lbp), rbp], dim=0)
    cnts = torch.cat([rev(lbc), rbc], dim=0)
    oks = torch.cat([rev(lok), rok], dim=0)
    cnts = torch.where(oks, cnts, 0)

    cells_c = cells.clamp(0, Lb - 1).long()
    b_iota = _iota(B, dev, torch.int64)[None, :].expand(cells.shape)
    base_cnt = gc[b_iota, cells_c]
    live = (cnts > 0) & (g0[b_iota, cells_c] >= 0)  # unconsumed anchor: drop
    cnts = torch.where(live, cnts, 0)

    first = torch.zeros((1, B), dtype=torch.bool, device=dev)
    same = torch.cat([first, cells[1:] == cells[:-1]], dim=0)
    chain_off = _segmented(cnts, same, torch.add) - cnts
    off = base_cnt + chain_off
    # only bits below 2*MAXD survive, and off < MAXD bounds the shift at
    # 2*(MAXD-1) = 28 < 31; the int32 shift wraps as the reference's does
    shift = (2 * off).clamp(0, 2 * MAXD)
    shifted = torch.where(live & (off < MAXD),
                          (packs << shift) & ((1 << (2 * MAXD)) - 1), 0)
    pack_acc = _segmented(shifted, same, torch.bitwise_or)
    cnt_acc = _segmented(cnts, same, torch.add)
    is_last = torch.cat([cells[1:] != cells[:-1], ~first], dim=0)
    write = is_last & (cnt_acc > 0)
    # the reference drops the masked writes at the out-of-range column Lb;
    # here column Lb exists and is cut off below.  The new values read the
    # planes before any write, as a functional update does.
    wcell = torch.where(write, cells_c, Lb)
    new_p = gp[b_iota, cells_c] | pack_acc
    gp[b_iota, wcell] = new_p
    gc[b_iota, wcell] = base_cnt + cnt_acc

    o = LG
    return g0[:, o:o + L_t], gp[:, o:o + L_t], gc[:, o:o + L_t]


def global_planes(planes_r, planes_l, side_r, side_l, lj_end, tseed, *,
                  L_t: int, S: int, W: int):
    """The global planes of :func:`banded_global_planes_plain`; the planes
    kernel for CUDA tensors.

    CPU tensors take the plain version; CUDA tensors launch the planes
    kernel (``csrc/cns_fold.cu`` through :mod:`.walk_kernel`), which
    raises on what it does not take.
    """
    if tseed.device.type == "cpu":
        return banded_global_planes_plain(planes_r, planes_l, side_r, side_l,
                                          lj_end, tseed, L_t=L_t, S=S, W=W)
    from .walk_kernel import global_planes_cuda

    dense = lambda ts: tuple(t.contiguous() for t in ts)
    return global_planes_cuda(planes_r, planes_l, dense(side_r),
                              dense(side_l), lj_end.contiguous(),
                              tseed.contiguous(), L_t=L_t, S=S, W=W)


def banded_global_planes(right_rows, left_rows, q, qseed, tseed,
                         *, L_t: int, S: int, W: int):
    """Both directions -> global template-coordinate planes [B, L_t]: the
    deposit (:func:`plane_inputs`), then :func:`global_planes`."""
    return global_planes(*plane_inputs(right_rows, left_rows, q, qseed, S, W),
                         tseed, L_t=L_t, S=S, W=W)


def banded_presence(g0, gpack, gcnt, tlen, pair_ok, L_t: int,
                    max_delta: int = C.MAX_INS_DELTA):
    """Global planes -> the per-pair tag presence buffer int8
    [B, L_t, D1, 5]."""
    B = g0.shape[0]
    D1 = max_delta + 1
    dev = g0.device
    l_idx = _iota(L_t, dev)[None, :]
    ok = pair_ok[:, None] & (l_idx < tlen[:, None])
    pres = torch.zeros((B, L_t, D1, 5), dtype=torch.int8, device=dev)
    pres[:, :, 0, :] = ((g0[:, :, None] == _iota(5, dev, torch.int8))
                        & ok[:, :, None])
    d = _iota(D1, dev)[None, None, 1:]
    based = (gpack[:, :, None] >> (2 * (d - 1))) & 3
    pres[:, :, 1:, :4] = ((d <= gcnt[:, :, None])[:, :, :, None]
                          & ok[:, :, None, None]
                          & (based[:, :, :, None] == _iota(4, dev)))
    return pres


def fold_tags_plain(counts, cov_diff, g0, gpack, gcnt, tlen, t_slot,
                    pair_ok, tbeg, tend, L_t: int):
    """Fold one chunk's global planes into the per-template tables, IN
    PLACE; the plain version of the fold kernel, on any device.

    The reference folds the presence buffer with an int8 x int8 -> int32
    one-hot matmul; torch has no integer matmul on CUDA, so this is an
    exact ``index_add_`` of the presence buffer, cast to int32, over the
    pairs' table slots (a masked pair's presence is all zero).
    """
    pres = banded_presence(g0, gpack, gcnt, tlen, pair_ok, L_t)
    B = pres.shape[0]
    T = counts.shape[0]
    slot = t_slot.long()
    counts.view(T, -1).index_add_(0, slot,
                                  pres.view(B, -1).to(torch.int32))

    a = tbeg.clamp(0, L_t).long()
    b = torch.minimum(tend, tlen).clamp(0, L_t).long()
    span = (pair_ok & (b > a)).to(torch.int32)
    # the reference drops masked pairs at a sentinel row; adding 0 is the same
    cov_diff.index_put_((slot, a), span, accumulate=True)
    cov_diff.index_put_((slot, b), -span, accumulate=True)
    return counts, cov_diff


def fold_tags(counts, cov_diff, g0, gpack, gcnt, tlen, t_slot, pair_ok,
              tbeg, tend, L_t: int):
    """The fold of :func:`fold_tags_plain`; the fold kernel for CUDA
    tensors (``csrc/cns_fold.cu`` through :mod:`.walk_kernel`): atomic adds
    on the present cells only, no presence buffer."""
    if counts.device.type == "cpu":
        return fold_tags_plain(counts, cov_diff, g0, gpack, gcnt, tlen,
                               t_slot, pair_ok, tbeg, tend, L_t)
    from .walk_kernel import fold_tags_cuda

    return fold_tags_cuda(counts, cov_diff, g0, gpack, gcnt,
                          *(t.contiguous() for t in (tlen, t_slot, pair_ok,
                                                     tbeg, tend)), L_t)


def banded_accumulate_tags(counts, cov_diff, right_rows, left_rows,
                           qseed, tseed, support, tlen, t_slot, pair_ok,
                           tbeg, tend, *, L_t: int, S: int, W: int):
    """Tally one chunk's tags into the per-template tables, IN PLACE.

    counts int32 [T, L_t, D1, 5] and cov_diff int32 [T, L_t + 1] are
    updated in place and returned.  On CUDA tensors the deposit, the
    planes and the fold are one kernel launch each.
    """
    with span("cns.tags"):
        g0, gpk, gcn = banded_global_planes(
            right_rows, left_rows, support, qseed, tseed, L_t=L_t, S=S, W=W)
        return fold_tags(counts, cov_diff, g0, gpk, gcn, tlen, t_slot,
                         pair_ok, tbeg, tend, L_t)
