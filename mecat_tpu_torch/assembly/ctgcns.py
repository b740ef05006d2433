"""Contig consensus (utgcns role): layout -> backbone -> polished contig
(port of ``mecat_tpu.assembly.ctgcns``).

1. **stitch**: walk the unitig layout left to right appending each read's
   non-overlapped suffix: a draft backbone whose error rate equals the
   (already corrected) read error rate;
2. **polish**: align every layout read (dovetail + re-attached contained)
   back to the backbone with the segmented banded aligner on the device,
   batched across reads, tally tag votes, and emit the majority-vote
   sequence, keeping backbone bases where support coverage is thin (no
   splitting at this stage).

The polish runs in bounded contig TILES on the device
(:func:`_polish_contig_device`: the cns chunk and the ``keep_template`` vote
of :func:`..ops.consensus_device.call_tables`); reads too long for the tile
geometry take the host route (:func:`_polish_contig_host`: op tapes pulled,
``CnsTable.call_polished``), which is also the device route's exact oracle.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import constants as C
from ..io.packed_db import PackedDB, revcomp
from ..ops.align import dp_segment_best, extend_pair_batch_with_ops
from ..ops.consensus import CnsTable, columns_to_tags, tapes_to_columns
from ..ops.consensus_device import call_tables
from ..pipeline.cns import _gather_rows_dev, make_cns_chunk, table_cap
from ..pipeline.common import bucket_length, max_segs_for, pad_to_batch
from ..utils.log import get_logger
from .unitig import Unitig

log = get_logger("ctgcns")


@dataclass
class CtgCnsOptions:
    polish: bool = True
    min_coverage: int = 2          # below this, keep backbone base
    extend_batch: int = 64
    align_segment: int = 512
    align_band: int = 128
    min_identity: float = 70.0


@dataclass
class PolishStats:
    """What the polish of one or more contigs ran."""

    contigs_device: int = 0        # contigs polished in device tiles
    contigs_host: int = 0          # contigs polished through the host route
    tiles: int = 0                 # device tiles voted
    alignments: int = 0            # (read, tile) or (read, window) pairs


def _oriented(db: PackedDB, row) -> np.ndarray:
    r = db.read(row.read)
    return revcomp(r) if row.orient else r


def stitch_backbone(db: PackedDB, tig: Unitig) -> np.ndarray:
    """Draft contig from the dovetail layout (offsets are overlap-derived)."""
    rows = sorted((r for r in tig.rows if not r.contained),
                  key=lambda r: (r.offset, r.read))
    if not rows:
        return np.zeros(0, dtype=np.uint8)
    parts: List[np.ndarray] = []
    end = 0
    for row in rows:
        bases = _oriented(db, row)
        start = row.offset
        if not parts:
            parts.append(bases)
            end = start + len(bases)
            continue
        if start + len(bases) <= end:
            continue  # fully covered by previous reads
        # overlap-hang offsets drift by a few bases vs the true alignment;
        # clamp so a positive gap (should not happen inside a unitig)
        # degrades to plain concatenation rather than a hole
        skip = max(0, min(end - start, len(bases)))
        parts.append(bases[skip:])
        end = max(end, start + len(bases))
    return np.concatenate(parts)


def polish_contig(db: PackedDB, tig: Unitig, backbone: np.ndarray,
                  opts: CtgCnsOptions, *, device,
                  cap: Optional[int] = None,
                  dp: Callable = dp_segment_best,
                  stats: Optional[PolishStats] = None) -> np.ndarray:
    """Batched realign of layout reads to the backbone + tag vote.

    Tags are tallied and voted on the device in bounded contig TILES
    (:func:`_polish_contig_device`): a megabase contig must not materialise
    a whole-contig count table.  Reads too long for the tile geometry (twice
    their margin does not fit a tile) go through the host ``CnsTable``
    route; the geometry alone decides.
    """
    max_rl = max((int(db.lengths[r.read]) for r in tig.rows), default=0)
    margin = _polish_margin(max_rl, opts.align_segment)
    if 2 * margin < _TILE_L_MAX:
        return _polish_contig_device(db, tig, backbone, opts, device=device,
                                     cap=cap, dp=dp, stats=stats)
    return _polish_contig_host(db, tig, backbone, opts, device=device, dp=dp,
                               stats=stats)


def _polish_margin(max_rl: int, S: int) -> int:
    """Tile overlap margin: must contain any assigned read's full alignment
    span (read length + band/segment drift) on either side of its seed."""
    return bucket_length(int(1.5 * max_rl) + 4 * S) if max_rl else 1024


#: largest tile: keeps the chunk's presence buffer [P, L_tile * D1 * 5]
#: int32-indexable and about 2 GB at P = 128
_TILE_L_MAX = 196608


def _polish_contig_device(db: PackedDB, tig: Unitig, backbone: np.ndarray,
                          opts: CtgCnsOptions, *, device,
                          cap: Optional[int] = None,
                          dp: Callable = dp_segment_best,
                          stats: Optional[PolishStats] = None) -> np.ndarray:
    """Tiled device polish: contig tiles become pseudo-template reads.

    The backbone is appended to the read volume, so every tile is addressable
    exactly like a read and the cns device chunk (gather -> align -> tag
    fold) is reused verbatim.  Tiles overlap by ``margin`` (> any read's
    possible alignment span around its seed, :func:`_polish_margin`) and each
    read is assigned to EVERY tile whose core its span can touch AND whose
    bounds contain its span: its center tile always qualifies, the seed
    stays consistent, and every vote a position's core tile should see lands
    there, so per-position votes equal the whole-contig table's.  Work
    duplication is ~read_span/core per read.

    ``cap`` bounds the bytes of one tile group's tag table (default
    :func:`..pipeline.cns.table_cap` of the device); the output does not
    depend on it.  Tile starts are addressed in int64, so a volume with
    ``2 * n_bases + len(backbone)`` past 2^31 is still addressed correctly
    (the reference wraps its int32 starts there).
    """
    if len(backbone) == 0 or len(tig.rows) == 0:
        return backbone
    device = torch.device(device)
    rows = sorted(tig.rows, key=lambda r: (r.offset, r.read))
    max_rl = max(int(db.lengths[r.read]) for r in rows)
    margin = _polish_margin(max_rl, opts.align_segment)
    L_tile = min(_TILE_L_MAX, bucket_length(len(backbone) + 2 * margin))
    core = L_tile - 2 * margin
    assert core > 0, (L_tile, margin)
    n_tiles = max(1, -(-len(backbone) // core))
    S, W = opts.align_segment, opts.align_band
    P = opts.extend_batch
    D1 = C.MAX_INS_DELTA + 1
    L_s = bucket_length(min(max_rl, 3 * L_tile))
    msegs = max_segs_for(min(max(L_tile, L_s), int(1.4 * L_tile) + 2 * S), S)
    eff = S - S // 4

    # volume with the backbone appended: [fwd | rc | backbone | slack]
    N = len(db.codes)
    rc = np.ascontiguousarray((3 - db.codes[::-1]).astype(np.uint8))
    slack = L_s + L_tile + 1024
    vol_cat = torch.from_numpy(np.concatenate(
        [db.codes, rc, backbone.astype(np.uint8),
         np.zeros(slack, np.uint8)])).to(device)
    tile0 = np.minimum(np.arange(n_tiles, dtype=np.int64) * core,
                       max(0, len(backbone) - 1))
    tile0 = np.maximum(tile0 - margin, 0)
    tile_len = np.minimum(len(backbone) - tile0, L_tile)
    starts2 = np.concatenate([db.starts.astype(np.int64),
                              2 * N + tile0]).astype(np.int64)
    lengths2 = np.concatenate([db.lengths.astype(np.int64), tile_len])
    starts_d = torch.as_tensor(starts2, device=device)
    lengths_d = torch.as_tensor(lengths2.astype(np.int32), device=device)

    # layout midpoints (scaled by the stitch compression ratio, as the host
    # path does), then expand each read to every qualifying tile
    scale = len(backbone) / max(1, max(r.offset + int(db.lengths[r.read])
                                       for r in rows))
    r_read0 = np.array([r.read for r in rows], np.int64)
    r_orient0 = np.array([r.orient for r in rows], np.int64)
    r_len0 = db.lengths[r_read0].astype(np.int64)
    center0 = np.clip(((np.array([r.offset for r in rows], np.int64)
                        + r_len0 // 2) * scale).astype(np.int64),
                      0, len(backbone) - 1)
    # a read's alignment span is within center +- (rl/2 + pad); assign to
    # tiles whose bounds contain the span (seed consistency): by the
    # margin bound this covers every tile whose core the span touches
    pad = r_len0 // 4 + 2 * S
    k_lo = np.clip(-(-(center0 + r_len0 // 2 + pad - L_tile + margin)
                     // core), 0, n_tiles - 1)
    k_hi = np.clip((center0 - r_len0 // 2 - pad + margin) // core,
                   0, n_tiles - 1)
    k_hi = np.maximum(k_hi, k_lo)
    reps = (k_hi - k_lo + 1).astype(np.int64)
    idx = np.repeat(np.arange(len(rows), dtype=np.int64), reps)
    cum = np.cumsum(reps)
    offs = np.arange(int(cum[-1]), dtype=np.int64) - np.repeat(
        cum - reps, reps)
    tile_of = (k_lo[idx] + offs).astype(np.int64)
    r_read = r_read0[idx]
    r_orient = r_orient0[idx]
    r_len = r_len0[idx]
    center = center0[idx]
    ts_local = center - tile0[tile_of]
    qs_local = r_len // 2

    if cap is None:
        cap = table_cap(device)
    group = max(1, cap // (L_tile * D1 * 5 * 4))
    pieces: List[np.ndarray] = []
    for g0 in range(0, n_tiles, group):
        g1 = min(n_tiles, g0 + group)
        T = g1 - g0
        sel = np.nonzero((tile_of >= g0) & (tile_of < g1))[0]
        counts = torch.zeros((T, L_tile, D1, 5), dtype=torch.int32,
                             device=device)
        cov_diff = torch.zeros((T, L_tile + 1), dtype=torch.int32,
                               device=device)
        has = torch.zeros(T, dtype=torch.bool, device=device)
        # length-sorted chunks with per-direction budgets from read length
        sel = sel[np.argsort(r_len[sel], kind="stable")]
        for ofs in range(0, len(sel), P):
            sl = sel[ofs:ofs + P]
            n = len(sl)
            qlen_c = r_len[sl].astype(np.int32)
            seg_q = int(np.ceil(qlen_c.max() / (2 * eff))) + 1
            # the budget bounds the segments a chunk may run, so it is part
            # of what is computed
            budget = next((b for b in (8, 16, 32, 64, 96)
                           if seg_q <= b), msegs)
            budget = min(budget, msegs)
            arrs = pad_to_batch(
                [r_read[sl].astype(np.int32),
                 (db.n_reads + tile_of[sl]).astype(np.int32),
                 qlen_c,
                 np.minimum(tile_len[tile_of[sl]], L_tile).astype(np.int32),
                 qs_local[sl].astype(np.int32),
                 np.clip(ts_local[sl], 0,
                         tile_len[tile_of[sl]] - 1).astype(np.int32),
                 (tile_of[sl] - g0).astype(np.int32),
                 r_orient[sl].astype(np.int32), np.ones(n, dtype=bool)], P)
            chunk = make_cns_chunk(
                L_s=L_s, L_t=L_tile, S=S, W=W, max_segs=budget,
                max_segs_left=budget, min_identity=opts.min_identity,
                min_align_size=0, min_mapping_ratio=0.0, dp=dp)
            chunk(counts, cov_diff, has, vol_cat, starts_d, lengths_d, N,
                  *(torch.as_tensor(a, device=device) for a in arrs))
        tiles_mat = _gather_rows_dev(
            vol_cat, starts_d, lengths_d,
            torch.as_tensor((db.n_reads + np.arange(g0, g1)).astype(np.int32),
                            device=device), L_tile)
        emit, _ = call_tables(
            counts, cov_diff, tiles_mat,
            torch.as_tensor(tile_len[g0:g1].astype(np.int32), device=device),
            torch.ones(T, dtype=torch.bool, device=device),
            opts.min_coverage, keep_template=True)
        emit = emit.to(torch.int8).cpu().numpy()
        for k in range(g0, g1):
            c0 = (k * core) - tile0[k]            # core start, tile-local
            c1 = min((k + 1) * core, len(backbone)) - tile0[k]
            if c1 <= c0:
                continue
            flat = emit[k - g0, c0:c1].reshape(-1)
            pieces.append(flat[flat >= 0].astype(np.uint8))
    if stats is not None:
        stats.contigs_device += 1
        stats.tiles += n_tiles
        stats.alignments += len(tile_of)
    return (np.concatenate(pieces) if pieces
            else backbone.astype(np.uint8))


def _polish_contig_host(db: PackedDB, tig: Unitig, backbone: np.ndarray,
                        opts: CtgCnsOptions, *, device,
                        dp: Callable = dp_segment_best,
                        stats: Optional[PolishStats] = None) -> np.ndarray:
    """Host ``CnsTable`` route (the exact oracle of the device route).

    The table spans the whole backbone, but the alignment (on ``device``)
    works on a per-read backbone WINDOW around the layout-predicted
    midpoint; tags are shifted by the window origin."""
    if len(backbone) == 0 or len(tig.rows) == 0:
        return backbone
    L_s = bucket_length(max(int(db.lengths[r.read]) for r in tig.rows))
    L_w = bucket_length(min(len(backbone), 3 * L_s))
    S, W = opts.align_segment, opts.align_band
    msegs = max_segs_for(L_s, S) + 2
    P = opts.extend_batch
    table = CnsTable(backbone)

    rows = sorted(tig.rows, key=lambda r: (r.offset, r.read))
    scale = len(backbone) / max(1, max(r.offset + int(db.lengths[r.read])
                                       for r in rows))
    f32 = np.float32
    for ofs in range(0, len(rows), P):
        chunk = rows[ofs:ofs + P]
        n = len(chunk)
        q_b = np.zeros((n, L_s), dtype=np.uint8)
        t_b = np.zeros((n, L_w), dtype=np.uint8)
        qlen, tlen, qs, ts = (np.zeros(n, np.int32) for _ in range(4))
        w0s = np.zeros(n, np.int64)
        sup = []
        for i, row in enumerate(chunk):
            sb = _oriented(db, row)[:L_s]
            q_b[i, :len(sb)] = sb
            qlen[i] = len(sb)
            qs[i] = len(sb) // 2
            # seed the template side at the layout-predicted position of the
            # read midpoint, shrunk by the stitch compression ratio
            c = int(np.clip((row.offset + len(sb) // 2) * scale, 0,
                            len(backbone) - 1))
            w0 = int(np.clip(c - L_w // 2, 0,
                             max(0, len(backbone) - L_w)))
            win = backbone[w0:w0 + L_w]
            t_b[i, :len(win)] = win
            tlen[i] = len(win)
            ts[i] = c - w0
            w0s[i] = w0
            sup.append(sb)
        padded = pad_to_batch([q_b, t_b, qlen, tlen, qs, ts], P)
        pa, right_t, left_t = extend_pair_batch_with_ops(
            *(torch.as_tensor(a, device=device) for a in padded),
            S=S, W=W, max_segs=msegs, dp=dp)
        cols = tapes_to_columns(right_t, left_t, padded[4], padded[5],
                                n_pairs=n)
        ident, tbeg, tend = (x.cpu().numpy()[:n]
                             for x in (pa.identity, pa.tbeg, pa.tend))
        for i in range(n):
            if ident[i] < f32(opts.min_identity):
                continue
            pos, delta, base = columns_to_tags(
                *cols[i], support=sup[i], tlen=int(tlen[i]))
            w0 = int(w0s[i])
            table.add_tags(pos + w0, delta, base,
                           (int(tbeg[i]) + w0, int(tend[i]) + w0))
    if stats is not None:
        stats.contigs_host += 1
        stats.alignments += len(rows)
    return table.call_polished(min_coverage=opts.min_coverage)


def contig_consensus(db: PackedDB, tigs: List[Unitig],
                     opts: Optional[CtgCnsOptions] = None,
                     min_length: int = 0, *, device,
                     stats: Optional[PolishStats] = None
                     ) -> List[Tuple[str, np.ndarray]]:
    """All contigs: stitch (+ polish on ``device``).  Returns [(name, codes)]
    sorted long to short."""
    opts = opts or CtgCnsOptions()
    out = []
    for tig in tigs:
        backbone = stitch_backbone(db, tig)
        if len(backbone) == 0:
            continue
        seq = (polish_contig(db, tig, backbone, opts, device=device,
                             stats=stats) if opts.polish else backbone)
        if len(seq) >= min_length:
            out.append((len(tig.rows), seq, tig.circular))
    out.sort(key=lambda x: -len(x[1]))
    return [(f"ctg{i:05d} reads={nr} len={len(s)}"
             + (" circular=yes" if circ else ""), s)
            for i, (nr, s, circ) in enumerate(out)]
