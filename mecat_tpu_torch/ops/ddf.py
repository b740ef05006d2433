"""DDF candidate filter, sort-based (port of mecat_tpu.ops.ddf).

Sampled query k-mers probe the CSR index; hits are sorted by
(target, diagonal bin, qpos, tpos), scored by run length, and the top n runs
become candidates with a seed hit from the middle of the run.  Two places
where torch differs from XLA are pinned here:

* torch has no multi-key sort: the four keys are packed into two int64
  keys, (rid, dbin) and (qpos, toff), and sorted stably by the second key,
  then by the first.  Rows tied on all four keys are identical, so the
  result equals ``lax.sort`` on the tuple.
* ``lax.top_k`` puts the lower index first among equal scores;
  ``torch.topk`` promises no tie order, so top-n is a stable descending
  sort cut to n.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as C

from ..index.kmer_index import kmer_codes, probe_index
from ..utils.metrics import kernel_span

#: diagonals are shifted by this before binning so they are non-negative
_DIAG_SHIFT = 1 << 20
_INVALID_RID = 2 ** 31 - 1


class Candidates(NamedTuple):
    """Top-n overlap candidates per query (fixed shape [B, N])."""

    target: torch.Tensor   # int32 target read id within the index
    score: torch.Tensor    # int32 DDF block score (k-mer hits in the bin)
    qseed: torch.Tensor    # int32 query position of the seed hit
    tseed: torch.Tensor    # int32 target (local) position of the seed hit
    valid: torch.Tensor    # bool


def probe_hits(bases, lengths, offsets, pos_rid, pos_loc, cutoff: int,
               self_id, *, k: int = C.KMER_SIZE,
               stride: int = C.KMER_SCAN_STRIDE,
               max_occ: int = C.MAX_OCC_PER_KMER,
               diag_bin: int = C.DDF_DIAG_BIN,
               diag_shift: int = _DIAG_SHIFT,
               code_lo: int = 0, code_hi: int = 1 << 30):
    """Sampled k-mer probe -> flat (rid, dbin, qpos, toff, valid) hits [B, H].

    bases uint8 [B, L] (oriented), lengths and self_id int32 [B] (self_id -1:
    no self read).  H = ceil(L / stride) * max_occ.  ``diag_shift`` is added
    to the diagonal before binning; the sum stays int32 and the bin is a
    floor division, so target offsets past the shift (negative sums) keep
    distinct, ordered bins.  ``code_lo`` / ``code_hi`` restrict the probe to
    the k-mer codes in [code_lo, code_hi): a hash shard's CSR slice holds
    that range, indexed from ``code_lo``.
    """
    B, L = bases.shape
    Q = (L + stride - 1) // stride
    H = Q * max_occ
    codes = kmer_codes(bases, k)[:, ::stride][:, :Q]
    qpos = torch.arange(Q, dtype=torch.int32, device=bases.device) * stride
    qvalid = ((qpos[None, :] + k <= lengths[:, None])
              & (codes >= code_lo) & (codes < code_hi))
    hit_rid, hit_loc, hit_valid = probe_index(
        offsets, pos_rid, pos_loc, codes - code_lo, qvalid, cutoff,
        max_occ=max_occ)
    rid = hit_rid.reshape(B, H)
    toff = hit_loc.reshape(B, H)
    hqpos = qpos[None, :, None].expand(B, Q, max_occ).reshape(B, H)
    hvalid = hit_valid.reshape(B, H) & (rid != self_id[:, None])
    dbin = torch.div(hqpos - toff + diag_shift, diag_bin,
                     rounding_mode="floor").to(torch.int32)
    return rid, dbin, hqpos, toff, hvalid


def _pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 key ordering like the int32 pair (hi, lo), for any signs."""
    return hi.to(torch.int64) * (1 << 32) + (lo.to(torch.int64) + (1 << 31))


def score_hits(rid, dbin, hqpos, toff, hvalid, *, num_candidates: int
               ) -> Candidates:
    """Sort hits by (target, bin, qpos, tpos), run-length score, top-n."""
    B, H = rid.shape
    dev = rid.device
    n = min(num_candidates, H)
    rid_key = torch.where(hvalid, rid, _INVALID_RID)
    order = torch.sort(_pair_key(hqpos, toff), dim=1, stable=True).indices
    key1 = torch.gather(_pair_key(rid_key, dbin), 1, order)
    order = torch.gather(order, 1,
                         torch.sort(key1, dim=1, stable=True).indices)
    rid_s = torch.gather(rid_key, 1, order)
    dbin_s = torch.gather(dbin, 1, order)
    qpos_s = torch.gather(hqpos, 1, order)
    toff_s = torch.gather(toff, 1, order)
    svalid = rid_s != _INVALID_RID

    # run length at each run start = next start - own index, clipped to the
    # valid prefix (invalid hits sort to the tail); a reverse cummin gives
    # the next start
    same_prev = torch.zeros((B, H), dtype=torch.bool, device=dev)
    same_prev[:, 1:] = ((rid_s[:, 1:] == rid_s[:, :-1])
                        & (dbin_s[:, 1:] == dbin_s[:, :-1]))
    is_start = svalid & ~same_prev
    h_idx = torch.arange(H, dtype=torch.int32, device=dev)[None, :]
    start_pos = torch.where(is_start, h_idx, H)
    next_geq = torch.flip(
        torch.cummin(torch.flip(start_pos, dims=[1]), dim=1).values, dims=[1])
    next_start = torch.cat(
        [next_geq[:, 1:], torch.full((B, 1), H, dtype=torch.int32,
                                     device=dev)], dim=1)
    n_valid = svalid.sum(dim=1, keepdim=True).to(torch.int32)
    score_at_start = torch.where(
        is_start, torch.minimum(next_start, n_valid) - h_idx, 0)

    top = torch.sort(score_at_start, dim=1, descending=True, stable=True)
    top_score = top.values[:, :n]
    top_idx = top.indices[:, :n]
    seed_idx = (top_idx + torch.div(top_score, 2, rounding_mode="floor")
                ).clamp(max=H - 1)
    return Candidates(
        target=torch.gather(rid_s, 1, top_idx),
        score=top_score,
        qseed=torch.gather(qpos_s, 1, seed_idx),
        tseed=torch.gather(toff_s, 1, seed_idx),
        valid=top_score >= C.MIN_BLOCK_SCORE)


def scan_candidates(bases, lengths, offsets, pos_rid, pos_loc, cutoff: int,
                    self_id, *, k: int = C.KMER_SIZE,
                    stride: int = C.KMER_SCAN_STRIDE,
                    max_occ: int = C.MAX_OCC_PER_KMER,
                    num_candidates: int = C.DEFAULT_NUM_CANDIDATES,
                    diag_bin: int = C.DDF_DIAG_BIN,
                    diag_shift: int = _DIAG_SHIFT, code_lo: int = 0,
                    code_hi: int = 1 << 30) -> Candidates:
    """Single-device candidate scan: probe_hits -> score_hits."""
    with kernel_span("ddf.scan"):
        hits = probe_hits(bases, lengths, offsets, pos_rid, pos_loc, cutoff,
                          self_id, k=k, stride=stride, max_occ=max_occ,
                          diag_bin=diag_bin, diag_shift=diag_shift,
                          code_lo=code_lo, code_hi=code_hi)
        return score_hits(*hits, num_candidates=num_candidates)


def merge_strand_candidates_device(c0: Candidates, c1: Candidates,
                                   min_score: int,
                                   n_valid: int | None = None, *,
                                   n_keep: int):
    """Merge the two strands' candidates on the device: top ``n_keep`` per
    query row (port of ``mecat_tpu.ops.ddf.merge_strand_candidates_device``,
    the device twin of ``pipeline.pw._merge_strand_candidates``).

    Returns (merged int32 [2 * B * N, 6], count): the kept candidates
    (row, strand, target, score, qseed, tseed) in the first ``count`` rows
    of ``merged``, rows ascending, score descending; ``count`` is a 0-d
    tensor.  Rows at or past ``n_valid`` (pad rows) are dropped.  The
    order equals the host merge's: strand 0 then strand 1, each row-major,
    stably sorted by (row, -score) packed into one int64 key; invalid
    candidates carry row B and sort last.  Each row's rank comes from a
    ``cummax`` of its first index; the kept rows move to the front with a
    stable sort on a keep flag.
    """
    parts = []
    for strand, c in ((0, c0), (1, c1)):
        B, N = c.target.shape
        dev = c.target.device
        row = torch.arange(B, dtype=torch.int32,
                           device=dev).repeat_interleave(N)
        ok = (c.valid & (c.score >= min_score)).reshape(-1)
        parts.append((torch.where(ok, row, B),
                      torch.full((B * N,), strand, dtype=torch.int32,
                                 device=dev),
                      *(x.reshape(-1).to(torch.int32)
                        for x in (c.target, c.score, c.qseed, c.tseed))))
    cols = torch.stack([torch.cat([p[i] for p in parts]) for i in range(6)],
                       dim=1)
    order = torch.sort(_pair_key(cols[:, 0], -cols[:, 3]),
                       stable=True).indices
    cols = cols[order]
    row = cols[:, 0]
    M = row.shape[0]
    idx = torch.arange(M, dtype=torch.int64, device=row.device)
    is_new = torch.ones(M, dtype=torch.bool, device=row.device)
    is_new[1:] = row[1:] != row[:-1]
    seg_start = torch.cummax(torch.where(is_new, idx, 0), dim=0).values
    B = c0.target.shape[0]
    row_cap = B if n_valid is None else min(B, int(n_valid))
    keep = ((idx - seg_start) < n_keep) & (row < row_cap)
    sink = torch.sort((~keep).to(torch.int32), stable=True).indices
    return cols[sink], keep.sum()
