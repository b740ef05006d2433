"""Plain reference of mecat2pw's two routes, one query batch at a time.

What ``mecat2pw`` computes for a batch of query reads against a volume of
the read set: the direct-address k-mer index of the volume, the sampled
k-mer probe and the DDF score (hits sorted by target, diagonal bin, query
and target position, scored by run length, top n a strand), and then

* ``-j 1`` (:func:`batch_m4`): a one-segment probe extension of every
  candidate in a seed-centred target window, the full segmented banded
  extension of the survivors, the identity and size filters, the longest
  record of each (query, subject, strand) and the M4 text;
* ``-j 0`` (:func:`batch_candidates`): the two strands' candidates merged,
  top n a query read, as candidate text.

Plain PyTorch and NumPy on any device, written from the published algorithm
(MECAT, Xiao et al., Nat Methods 2017) as the port states it: no kernel, no
import of the program.  Integers are exact; the float32 operations
(segment identity, overlap identity) run in ``fdtype``, which the control
lowers to bfloat16.  Extension lanes run in blocks of ``block`` lanes: a
lane's result depends on its own inputs alone, so the blocking changes no
result.

``Tally`` counts what the extensions need: DP cells (rows a segment
consumes x band width) and query and target bytes, over the lanes that are
live in each segment.  The benchmark's rooflines divide those counts, not
the program's own counters.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np
import torch

KMER_FREQ_CUTOFF_MULTIPLE = 128.0
#: a candidate run needs this many hits to count as a candidate at all
MIN_RUN_SCORE = 2
MIN_SEGMENT_IDENTITY = 0.65
TRIM_PENALTY = 2
#: query-batch cap of the -j 1 route: bytes of the flattened probe rows
FLAT_BYTES = 1 << 30

INF = 1 << 20
IND_K = 4096
VINF = 1 << 30
NEG = -(1 << 26)
Q_SENTINEL = 255
T_SENTINEL = 254
DIAG_SHIFT = 1 << 20
INVALID_RID = 2 ** 31 - 1
REVCOMP = np.array([3, 2, 1, 0], dtype=np.uint8)


@dataclass
class Tally:
    """Work the extensions need, summed over live lane-segments."""

    cells: int = 0
    q_bytes: int = 0
    t_bytes: int = 0
    lane_segments: int = 0


@dataclass
class Reads:
    """The read set: flat codes, starts, lengths (NumPy)."""

    codes: np.ndarray
    starts: np.ndarray
    lengths: np.ndarray


# -- batch plan -------------------------------------------------------------


def bucket_length(n: int, minimum: int = 1024) -> int:
    """Padded length >= n: powers of two and their 3/4 points, multiples of
    1024."""
    n = max(n, minimum)
    p = 1 << max(10, (n - 1).bit_length())
    b = p if n > 3 * p // 4 else 3 * p // 4
    return max(minimum, int(math.ceil(b / 1024)) * 1024)


def volumes(lengths: np.ndarray, max_bases: int):
    """Reads in id order cut into volumes of at most ``max_bases``."""
    vols, begin, acc = [], 0, 0
    for i, ln in enumerate(lengths.tolist()):
        if acc and acc + ln > max_bases:
            vols.append((begin, i))
            begin, acc = i, 0
        acc += ln
    if begin < len(lengths) or not vols:
        vols.append((begin, len(lengths)))
    return vols


def plan_m4_batches(lengths: np.ndarray, qa: int, qb: int, vol_max: int,
                    opts: dict) -> List[tuple]:
    """(query ids, rows, L_query, L_target) of every -j 1 batch: queries
    sorted by length, rows capped so that the flattened probe rows stay
    under FLAT_BYTES, target windows of about 3x the query bucket."""
    order = np.argsort(lengths[qa:qb], kind="stable") + qa
    n_cand = opts["num_candidates"]
    mult = 128 // math.gcd(n_cand, 128)
    out, bs = [], 0
    while bs < len(order):
        tentative = order[bs:bs + opts["scan_batch"]]
        lq = bucket_length(int(lengths[tentative].max()))
        lt = bucket_length(min(vol_max, 3 * lq))
        per_read = n_cand * 2 * (lq + lt)
        rows = max(mult, min(opts["scan_batch"],
                             FLAT_BYTES // per_read // mult * mult))
        qids = [int(q) for q in order[bs:bs + rows]]
        bs += rows
        lq = bucket_length(int(lengths[qids].max()))
        lt = bucket_length(min(vol_max, 3 * lq))
        out.append((qids, rows, lq, lt))
    return out


def plan_candidate_batches(lengths: np.ndarray, qa: int, qb: int,
                           vol_max: int, opts: dict) -> List[tuple]:
    """(query ids, rows, L_query, L_target) of every -j 0 batch: queries
    sorted by length in batches of ``scan_batch``."""
    order = np.argsort(lengths[qa:qb], kind="stable") + qa
    lt = bucket_length(vol_max)
    out = []
    for bs in range(0, len(order), opts["scan_batch"]):
        qids = [int(q) for q in order[bs:bs + opts["scan_batch"]]]
        out.append((qids, opts["scan_batch"],
                    bucket_length(int(lengths[qids].max())), lt))
    return out


def plan(lengths: np.ndarray, opts: dict) -> List[tuple]:
    """Every batch of the volume pairs (0, j), j over all volumes, in
    order: the queries of every read against volume 0's index."""
    vols = volumes(lengths, opts["volume_bases"])
    va, vb = vols[0]
    vol_max = int(lengths[va:vb].max())
    fn = plan_m4_batches if opts["task"] == 1 else plan_candidate_batches
    return [b for qa, qb in vols for b in fn(lengths, qa, qb, vol_max, opts)]


def oriented(reads: Reads, qids: Sequence[int], L: int):
    """Query rows in both orientations, 0-padded to L, and their lengths."""
    ids = np.asarray(qids, dtype=np.int64)
    lens = reads.lengths[ids].astype(np.int64)
    col = np.arange(L, dtype=np.int64)[None, :]
    inside = col < lens[:, None]
    fwd = np.where(inside, reads.codes[np.where(
        inside, reads.starts[ids][:, None] + col, 0)], 0).astype(np.uint8)
    back = lens[:, None] - 1 - col
    rev = np.where(back >= 0, REVCOMP[np.take_along_axis(
        fwd, np.maximum(back, 0), axis=1)], 0).astype(np.uint8)
    return fwd, rev, lens


# -- index and candidate scan ------------------------------------------------


def kmer_codes(bases: torch.Tensor, k: int) -> torch.Tensor:
    """int32 code of bases[..., p:p+k] at every p, first base most
    significant; the last k-1 positions read zeros past the row."""
    L = bases.shape[-1]
    b = bases.to(torch.int32)
    out = torch.zeros_like(b)
    for j in range(k):
        shifted = torch.zeros_like(b)
        shifted[..., :L - j] = b[..., j:]
        out = (out << 2) | shifted
    return out


@dataclass
class Index:
    offsets: torch.Tensor
    pos_rid: torch.Tensor
    pos_loc: torch.Tensor
    read_starts: torch.Tensor
    read_lengths: torch.Tensor
    cutoff: int
    codes: torch.Tensor = field(repr=False, default=None)


def build_index(reads: Reads, va: int, vb: int, k: int, cutoff_abs,
                device) -> Index:
    """CSR table of every k-mer that lies inside a read of volume
    [va, vb): occurrences ordered by code, then by position; k-mers more
    frequent than 128x the mean count (or ``cutoff_abs``) are dropped at
    probe time."""
    s0 = int(reads.starts[va])
    lens = reads.lengths[va:vb].astype(np.int64)
    starts = reads.starts[va:vb].astype(np.int64) - s0
    flat = reads.codes[s0:s0 + int(lens.sum())]
    codes = torch.as_tensor(flat, device=device)
    n = codes.shape[0]
    st = torch.as_tensor(starts, device=device)
    ln = torch.as_tensor(lens, device=device)
    all_codes = kmer_codes(codes, k)
    rid = torch.repeat_interleave(torch.arange(len(lens), device=device), ln,
                                  output_size=n)
    local = torch.arange(n, device=device) - st[rid]
    vpos = torch.nonzero(local <= ln[rid] - k).squeeze(1)
    vcodes = all_codes[vpos]
    counts = torch.bincount(vcodes, minlength=1 << (2 * k))
    offsets = torch.zeros((1 << (2 * k)) + 1, dtype=torch.int32,
                          device=device)
    offsets[1:] = torch.cumsum(counts, 0).to(torch.int32)
    vpos = vpos[torch.sort(vcodes, stable=True).indices]
    mean = max(1.0, int(vpos.shape[0]) / max(1, int(
        torch.count_nonzero(counts))))
    cutoff = (int(cutoff_abs) if cutoff_abs is not None else
              max(int(mean * KMER_FREQ_CUTOFF_MULTIPLE), 32))
    return Index(offsets=offsets, pos_rid=rid[vpos].to(torch.int32),
                 pos_loc=local[vpos].to(torch.int32),
                 read_starts=st.to(torch.int32),
                 read_lengths=ln.to(torch.int32), cutoff=cutoff, codes=codes)


def _pair_key(hi, lo):
    return hi.to(torch.int64) * (1 << 32) + (lo.to(torch.int64) + (1 << 31))


def scan(bases, lengths, self_id, index: Index, opts: dict):
    """Top n candidate runs of each query row: (target, score, qseed,
    tseed, valid), each [B, n]."""
    k, stride, max_occ = (opts["kmer_size"], opts["scan_stride"],
                          opts["max_occ"])
    B, L = bases.shape
    dev = bases.device
    Q = (L + stride - 1) // stride
    H = Q * max_occ
    codes = kmer_codes(bases, k)[:, ::stride][:, :Q]
    qpos = torch.arange(Q, dtype=torch.int32, device=dev) * stride
    qvalid = qpos[None, :] + k <= lengths[:, None]
    c = torch.where(qvalid, codes, 0).long()
    off = index.offsets[c]
    cnt = index.offsets[c + 1] - off
    keep = qvalid & (cnt <= index.cutoff)
    cnt = torch.where(keep, cnt.clamp(max=max_occ), 0)
    j = torch.arange(max_occ, dtype=torch.int32, device=dev)
    hit = j < cnt[..., None]
    idx = torch.where(hit, off[..., None] + j, 0).long()
    rid = index.pos_rid[idx].reshape(B, H)
    toff = index.pos_loc[idx].reshape(B, H)
    hq = qpos[None, :, None].expand(B, Q, max_occ).reshape(B, H)
    hvalid = hit.reshape(B, H) & (rid != self_id[:, None])
    dbin = torch.div(hq - toff + DIAG_SHIFT, opts["diag_bin"],
                     rounding_mode="floor").to(torch.int32)

    n = min(opts["num_candidates"], H)
    rid_key = torch.where(hvalid, rid, INVALID_RID)
    order = torch.sort(_pair_key(hq, toff), dim=1, stable=True).indices
    key1 = torch.gather(_pair_key(rid_key, dbin), 1, order)
    order = torch.gather(order, 1,
                         torch.sort(key1, dim=1, stable=True).indices)
    rid_s = torch.gather(rid_key, 1, order)
    dbin_s = torch.gather(dbin, 1, order)
    q_s = torch.gather(hq, 1, order)
    t_s = torch.gather(toff, 1, order)
    svalid = rid_s != INVALID_RID
    same = torch.zeros((B, H), dtype=torch.bool, device=dev)
    same[:, 1:] = (rid_s[:, 1:] == rid_s[:, :-1]) & (
        dbin_s[:, 1:] == dbin_s[:, :-1])
    start = svalid & ~same
    h = torch.arange(H, dtype=torch.int32, device=dev)[None, :]
    nxt = torch.flip(torch.cummin(torch.flip(torch.where(start, h, H),
                                             dims=[1]), dim=1).values,
                     dims=[1])
    nxt = torch.cat([nxt[:, 1:], torch.full((B, 1), H, dtype=torch.int32,
                                            device=dev)], dim=1)
    nval = svalid.sum(dim=1, keepdim=True).to(torch.int32)
    score = torch.where(start, torch.minimum(nxt, nval) - h, 0)
    top = torch.sort(score, dim=1, descending=True, stable=True)
    ts, ti = top.values[:, :n], top.indices[:, :n]
    seed = (ti + torch.div(ts, 2, rounding_mode="floor")).clamp(max=H - 1)
    return (torch.gather(rid_s, 1, ti), ts, torch.gather(q_s, 1, seed),
            torch.gather(t_s, 1, seed), ts >= MIN_RUN_SCORE)


# -- segmented banded extension ----------------------------------------------


def _dp_best(q_seg, tpad, tmax, seg_q, active, W: int):
    """One banded segment: the best local endpoint (r, j, dist, indels) of
    every lane; an inactive lane reads (0, 0, INF, 0).

    DP values are packed dist * IND_K + indels, VINF outside the band; the
    endpoint is the cell of highest r + j - 2 * TRIM_PENALTY * dist among
    the valid cells with r <= seg_q, the first in (row, band) order on a
    tie, kept as the rows go so no row is stored.
    """
    B, S = q_seg.shape
    half = W // 2
    K1 = IND_K + 1
    dev = q_seg.device
    w = torch.arange(W, dtype=torch.int32, device=dev)
    tm = tmax[:, None]
    j0 = w - half
    row = torch.where((j0[None, :] >= 0) & (j0[None, :] <= tm),
                      (j0.clamp(min=0) * K1)[None, :],
                      torch.full((), VINF, dtype=torch.int32, device=dev))
    vcol = torch.full((B, 1), VINF, dtype=torch.int32, device=dev)
    wk = w[None, :] * K1
    big = torch.full((), W, dtype=torch.int32, device=dev)

    def row_best(r, row):
        jj = (r - half) + w
        ok = ((jj[None, :] >= 0) & (jj[None, :] <= tm) & (r <= seg_q[:, None])
              & (row < VINF))
        sc = torch.where(ok, r + jj[None, :] - 2 * TRIM_PENALTY * torch.div(
            row, IND_K, rounding_mode="floor"), NEG)
        top = sc.max(dim=1).values
        first = torch.where(sc == top[:, None], w[None, :], big).min(
            dim=1).values
        return top, first, torch.gather(row, 1, first.long()[:, None])[:, 0]

    b_sc, b_w, b_v = row_best(0, row)
    b_r = torch.zeros(B, dtype=torch.int32, device=dev)
    for i in range(1, S + 1):
        sub = (q_seg[:, i - 1:i] != tpad[:, i - 1:i - 1 + W]).to(torch.int32)
        diag = row + sub * IND_K
        vert = torch.cat([row[:, 1:], vcol], dim=1) + K1
        jj = (i - half) + w
        valid = (jj[None, :] >= 0) & (jj[None, :] <= tm)
        cand = torch.where(valid, torch.minimum(diag, vert), VINF)
        cur = torch.cummin(cand - wk, dim=1).values + wk
        row = torch.where(valid, cur.clamp(max=VINF), VINF)
        sc, wb, v = row_best(i, row)
        up = sc > b_sc
        b_sc = torch.where(up, sc, b_sc)
        b_r = torch.where(up, i, b_r)
        b_w = torch.where(up, wb, b_w)
        b_v = torch.where(up, v, b_v)
    r = torch.where(active, b_r, 0)
    wb = torch.where(active, b_w, half)
    v = torch.where(active, b_v, VINF)
    vinf = v >= VINF
    d = torch.where(vinf, INF, torch.div(v, IND_K, rounding_mode="floor"))
    ind = torch.where(vinf, 0, torch.remainder(v, IND_K))
    return r, r - half + wb, d.to(torch.int32), ind.to(torch.int32)


class _SegmentGraph:
    """:func:`_dp_best` over a fixed lane count, captured once as a CUDA
    graph and replayed for every later segment: the same operations
    without a host launch each (a segment is some 19,000 small kernels)."""

    def __init__(self):
        self.graph = None

    def __call__(self, q_seg, tpad, tmax, seg_q, active, W: int):
        args = (q_seg, tpad, tmax, seg_q, active)
        if self.graph is None:
            self.inputs = tuple(a.clone() for a in args)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                _dp_best(*self.inputs, W)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.outputs = _dp_best(*self.inputs, W)
        for dst, src in zip(self.inputs, args):
            dst.copy_(src)
        self.graph.replay()
        return tuple(o.clone() for o in self.outputs)


def _window(rows, start, size: int):
    """rows[b, start[b]:start[b]+size]; a negative start wraps once, then
    the start clamps into the row."""
    width = rows.shape[1]
    start = torch.where(start < 0, start + width, start)
    start = start.clamp(0, width - size).long()
    lane = torch.arange(rows.shape[0], device=rows.device)
    return rows.unfold(1, size, 1)[lane, start]


def _extend_lanes(q_pad, t_pad, q0, t0, qlen, tlen, *, S, W, max_segs,
                  fdtype, tally: Tally, cap=None):
    """Segments of one direction until no lane is live; a lane stops when
    a segment fails the identity rule, ends short of its query rows, or
    runs out of query or target, or (with ``cap``) after cap[b]
    segments.  Returns (q_adv, t_adv, matches, alen, n_segs)."""
    B = q_pad.shape[0]
    half = W // 2
    dev = q_pad.device
    z = torch.zeros(B, dtype=torch.int32, device=dev)
    qoff, toff, dist, matches, alen, nsegs = (z.clone() for _ in range(6))
    active = (qlen > 0) & (tlen > 0)
    slack = max(1, S // 4)
    seg = _SegmentGraph() if dev.type == "cuda" else (
        lambda *a: _dp_best(*a))
    n = 0
    while n < max_segs:
        if cap is not None:
            active = active & (n < cap)
        if not bool(active.any()):
            break
        seg_q = (qlen - qoff).clamp(0, S).to(torch.int32)
        rem_t = (tlen - toff).clamp(0, S + half).to(torch.int32)
        live_rows = int(torch.where(active, seg_q, 0).sum())
        tally.cells += live_rows * W
        tally.q_bytes += live_rows
        tally.t_bytes += int(torch.where(active, torch.minimum(
            rem_t, seg_q + half), 0).sum())
        tally.lane_segments += int(active.sum())
        r, j, d, ind = seg(_window(q_pad, q0 + qoff, S).contiguous(),
                           _window(t_pad, t0 + toff, S + W).contiguous(),
                           rem_t, seg_q, active, W)
        m = (torch.div(r + j + ind, 2, rounding_mode="floor") - d).clamp(
            min=0)
        a = m + d
        ident = m.to(fdtype) / a.clamp(min=1).to(fdtype)
        ok = (active & (r + j > 0) & (d < INF)
              & ((ident >= MIN_SEGMENT_IDENTITY) | (a < 32)))
        qoff = torch.where(ok, qoff + r, qoff)
        toff = torch.where(ok, toff + j, toff)
        dist = torch.where(ok, dist + d, dist)
        matches = torch.where(ok, matches + m, matches)
        alen = torch.where(ok, alen + a, alen)
        nsegs = nsegs + active.to(torch.int32)
        active = (ok & (r >= seg_q - slack) & (r >= 1) & (qoff < qlen)
                  & (toff < tlen))
        n += 1
    return qoff, toff, matches, alen, nsegs


def _framed(a, n, sentinel, extra, prefix=0):
    """Rows of ``a`` with columns at or past n[b] set to the sentinel,
    framed by ``prefix`` and ``extra`` sentinel columns."""
    B, L = a.shape
    col = torch.arange(L, dtype=torch.int32, device=a.device)
    body = torch.where(col[None, :] < n[:, None], a, sentinel).to(a.dtype)
    out = torch.full((B, prefix + L + extra), sentinel, dtype=a.dtype,
                     device=a.device)
    out[:, prefix:prefix + L] = body
    return out


def extend_pairs(q, t, qlen, tlen, qseed, tseed, *, S, W, max_segs,
                 fdtype=torch.float32, tally: Tally, block: int = 1 << 16):
    """Both-direction extension of each seed (q, t rows in the scanned
    orientation); returns (qbeg, qend, tbeg, tend, identity percent,
    align_len), pairs processed ``block`` at a time."""
    outs = []
    for b0 in range(0, q.shape[0], block):
        sl = slice(b0, b0 + block)
        qb, tb = q[sl], t[sl]
        ql, tl, qs, ts = qlen[sl], tlen[sl], qseed[sl], tseed[sl]
        Lq, Lt = qb.shape[1], tb.shape[1]
        qm = _framed(qb, ql, Q_SENTINEL, S)
        qr = _framed(torch.flip(_framed(qb, ql, Q_SENTINEL, 0), dims=[1]),
                     torch.full_like(ql, Lq), Q_SENTINEL, S)
        tm = _framed(tb, tl, T_SENTINEL, S + W, W // 2)
        tr = _framed(torch.flip(_framed(tb, tl, T_SENTINEL, 0), dims=[1]),
                     torch.full_like(tl, Lt), T_SENTINEL, S + W, W // 2)
        n = qb.shape[0]
        qa, ta, m, a, _ = _extend_lanes(
            torch.cat([qm, qr]), torch.cat([tm, tr]),
            torch.cat([qs, Lq - qs]), torch.cat([ts, Lt - ts]),
            torch.cat([ql - qs, qs]), torch.cat([tl - ts, ts]),
            S=S, W=W, max_segs=max_segs, fdtype=fdtype, tally=tally)
        matches = m[:n] + m[n:]
        alen = a[:n] + a[n:]
        ident = (100.0 * matches.to(fdtype) / alen.clamp(min=1).to(fdtype)
                 ).to(torch.float32)
        outs.append((qs - qa[n:], qs + qa[:n], ts - ta[n:], ts + ta[:n],
                     ident, alen))
    return tuple(torch.cat(x) for x in zip(*outs))


def target_windows(index: Index, tgt, tseed, L_win: int):
    """Seed-centred windows of L_win target bases: (rows, window length,
    seed in the window, window origin)."""
    dev = index.codes.device
    t_start = index.read_starts[tgt]
    t_len = index.read_lengths[tgt]
    tseed = torch.minimum(tseed.clamp(min=0), (t_len - 1).clamp(min=0))
    win0 = torch.minimum((tseed - L_win // 2).clamp(min=0),
                         (t_len - L_win).clamp(min=0))
    pad = torch.cat([index.codes, torch.zeros(L_win, dtype=torch.uint8,
                                              device=dev)])
    start = t_start + win0
    start = torch.where(start < 0, start + pad.shape[0], start)
    start = start.clamp(0, pad.shape[0] - L_win).long()
    rows = pad.unfold(0, L_win, 1)[start]
    wlen = torch.minimum(t_len - win0, torch.full_like(t_len, L_win)).to(
        torch.int32)
    col = torch.arange(L_win, dtype=torch.int32, device=dev)
    rows = torch.where(col[None, :] < wlen[:, None], rows, 0).to(torch.uint8)
    return rows, wlen, (tseed - win0).to(torch.int32), win0.to(torch.int32)


def max_segs_for(L: int, S: int) -> int:
    return int(math.ceil(L / max(1, S - S // 4))) + 2


# -- one batch ---------------------------------------------------------------


def _batch_rows(reads: Reads, index: Index, va: int, vb: int, qids, L_q):
    dev = index.codes.device
    fwd, rev, lens = oriented(reads, qids, L_q)
    self_id = np.array([q - va if va <= q < vb else -1 for q in qids],
                       dtype=np.int32)
    return (fwd, rev, lens,
            torch.as_tensor(lens.astype(np.int32), device=dev),
            torch.as_tensor(self_id, device=dev))


def batch_m4(reads: Reads, index: Index, va: int, vb: int, qids, L_q: int,
             L_t: int, opts: dict, *, fdtype=torch.float32,
             tally: Tally | None = None) -> str:
    """M4 text of one -j 1 batch: queries ``qids`` (padded to L_q) against
    volume [va, vb), target windows of L_t bases."""
    tally = tally if tally is not None else Tally()
    dev = index.codes.device
    S, W = opts["align_segment"], opts["align_band"]
    N = opts["num_candidates"]
    fwd, rev, lens, lens_dev, self_dev = _batch_rows(reads, index, va, vb,
                                                     qids, L_q)
    msegs = max_segs_for(max(L_q, L_t), S)
    qarr = np.asarray(qids, dtype=np.int64)
    cols: Dict[str, list] = {}
    for strand, rows in ((0, fwd), (1, rev)):
        bases = torch.as_tensor(rows, device=dev)
        target, score, qseed, tseed, valid = scan(bases, lens_dev, self_dev,
                                                  index, opts)
        B = bases.shape[0]
        tgt = target.clamp(0, index.read_starts.shape[0] - 1).reshape(-1)
        tgt = tgt.long()
        # probe: one segment each way in the seed-centred window
        t, wlen, ts_loc, _ = target_windows(index, tgt, tseed.reshape(-1),
                                            L_t)
        probe = extend_pairs(bases.repeat_interleave(N, dim=0), t,
                             lens_dev.repeat_interleave(N), wlen,
                             qseed.reshape(-1).clamp(min=0), ts_loc, S=S,
                             W=W, max_segs=1, fdtype=fdtype, tally=tally)
        p_ident, p_alen = probe[4], probe[5]
        survive = (valid.reshape(-1)
                   & (score.reshape(-1) >= opts["min_block_score"])
                   & ((p_alen < 96) | (p_ident >= 55.0)))
        sel = np.flatnonzero(survive.cpu().numpy())
        if len(sel) == 0:
            continue
        score_np = score.reshape(-1).cpu().numpy()
        sel = sel[np.argsort(-score_np[sel], kind="stable")]
        sel_t = torch.as_tensor(sel, device=dev)
        rowi = torch.div(sel_t, N, rounding_mode="floor")
        t, wlen, ts_loc, win0 = target_windows(
            index, tgt[sel_t], tseed.reshape(-1)[sel_t], L_t)
        qbeg, qend, tbeg, tend, ident, _ = (x.cpu().numpy() for x in
                                            extend_pairs(
            bases[rowi], t, lens_dev[rowi], wlen,
            qseed.reshape(-1)[sel_t].clamp(min=0), ts_loc, S=S, W=W,
            max_segs=msegs, fdtype=fdtype, tally=tally))
        tbeg = tbeg + win0.cpu().numpy()
        tend = tend + win0.cpu().numpy()
        keep = ((ident >= opts["min_identity"])
                & (np.minimum(qend - qbeg, tend - tbeg)
                   >= opts["min_align_size"]))
        kk = np.flatnonzero(keep)
        if len(kk) == 0:
            continue
        r = (sel // N)[kk]
        qsize = lens[r].astype(np.int64)
        tg = target.reshape(-1).cpu().numpy()[sel][kk].astype(np.int64)
        qb_, qe_, tb_, te_ = qbeg[kk], qend[kk], tbeg[kk], tend[kk]
        part = {
            "qid": qarr[r] + 1, "sid": va + tg + 1, "identity": ident[kk],
            "score": score_np[sel][kk], "qstart": np.where(
                strand == 0, qb_, qsize - qe_),
            "qend": np.where(strand == 0, qe_, qsize - qb_), "qsize": qsize,
            "sstrand": np.full(len(kk), strand), "sstart": tb_, "send": te_,
            "ssize": reads.lengths[va + tg].astype(np.int64),
            "span": (qe_ - qb_) + (te_ - tb_)}
        for key, v in part.items():
            cols.setdefault(key, []).append(v)
    if not cols:
        return ""
    a = {k: np.concatenate(v) for k, v in cols.items()}
    order = np.lexsort((-a["span"], a["sstrand"], a["sid"], a["qid"]))
    a = {k: v[order] for k, v in a.items()}
    key = np.stack([a["qid"], a["sid"], a["sstrand"]], axis=1)
    first = np.ones(len(key), dtype=bool)
    first[1:] = (key[1:] != key[:-1]).any(axis=1)
    lines = []
    for i in np.flatnonzero(first):
        lines.append(
            f"{a['qid'][i]}\t{a['sid'][i]}\t{float(a['identity'][i]):.2f}\t"
            f"{a['score'][i]}\t0\t{a['qstart'][i]}\t{a['qend'][i]}\t"
            f"{a['qsize'][i]}\t{a['sstrand'][i]}\t{a['sstart'][i]}\t"
            f"{a['send'][i]}\t{a['ssize'][i]}\n")
    return "".join(lines)


def batch_candidates(reads: Reads, index: Index, va: int, vb: int, qids,
                     L_q: int, opts: dict) -> str:
    """Candidate text of one -j 0 batch: each query row's candidates of
    both strands with score >= min_block_score, strand 0 first, stably
    sorted by descending score, the first num_candidates kept."""
    dev = index.codes.device
    fwd, rev, lens, lens_dev, self_dev = _batch_rows(reads, index, va, vb,
                                                     qids, L_q)
    parts = []
    for strand, rows in ((0, fwd), (1, rev)):
        target, score, qseed, tseed, valid = scan(
            torch.as_tensor(rows, device=dev), lens_dev, self_dev, index,
            opts)
        target, score, qseed, tseed, valid = (
            x.cpu().numpy() for x in (target, score, qseed, tseed, valid))
        ok = valid & (score >= opts["min_block_score"])
        r, c = np.nonzero(ok)
        parts.append(np.stack([r, np.full_like(r, strand), target[r, c],
                               score[r, c], qseed[r, c], tseed[r, c]], 1))
    allc = np.concatenate(parts).astype(np.int64)
    allc = allc[np.lexsort((-allc[:, 3], allc[:, 0]))]
    rank = np.zeros(len(allc), dtype=np.int64)
    if len(allc):
        new = np.ones(len(allc), dtype=bool)
        new[1:] = allc[1:, 0] != allc[:-1, 0]
        grp = np.cumsum(new) - 1
        rank = np.arange(len(allc)) - np.flatnonzero(new)[grp]
    allc = allc[rank < opts["num_candidates"]]
    qarr = np.asarray(qids, dtype=np.int64)
    lines = []
    for row, strand, tg, sc, qs, ts in allc.tolist():
        lines.append(f"{qarr[row] + 1}\t{va + tg + 1}\t{sc}\t{strand}\t{qs}"
                     f"\t{lens[row]}\t0\t{ts}\t{reads.lengths[va + tg]}\n")
    return "".join(lines)
