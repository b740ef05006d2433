"""Direct-address CSR k-mer index on a torch device (port of mecat_tpu.index).

``offsets`` int32 [4^k + 1] holds the prefix sums of per-k-mer occurrence
counts; the occurrences are stored pre-resolved as (read id, in-read offset)
pairs sorted by k-mer code, in original position order within a code.  The
build is a counting sort on the device: one stable ``torch.sort`` by code,
then ``bincount`` and ``cumsum``.  The NumPy build of
``mecat_tpu.index.kmer_index.build_index`` is the specification; the arrays
are equal element by element.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import constants as C


def kmer_codes(bases: torch.Tensor, k: int) -> torch.Tensor:
    """int32 k-mer codes at every start position over [..., L] bases.

    out[..., p] encodes bases[p:p+k] big-endian (base p is the most
    significant 2 bits); the last k-1 positions hold zero-padded codes that
    callers mask by read bounds.
    """
    if 2 * k > 31:
        raise ValueError(f"k={k} too large for int32 codes")
    L = bases.shape[-1]
    b = bases.to(torch.int32)
    out = torch.zeros_like(b)
    for j in range(k):
        if j:
            shifted = torch.zeros_like(b)
            shifted[..., :L - j] = b[..., j:]
        else:
            shifted = b
        out = (out << 2) | shifted
    return out


@dataclass
class TorchKmerIndex:
    """CSR k-mer table over one volume, every array on one device."""

    k: int
    offsets: torch.Tensor       # int32 [4^k + 1]
    pos_rid: torch.Tensor       # int32 [M] read id of each occurrence
    pos_loc: torch.Tensor       # int32 [M] offset within the read
    read_starts: torch.Tensor   # int32 [n_reads]
    read_lengths: torch.Tensor  # int32 [n_reads]
    max_occ_cutoff: int         # k-mers with more occurrences are dropped


def build_index(codes: np.ndarray, starts: np.ndarray, lengths: np.ndarray,
                k: int = C.KMER_SIZE,
                freq_cutoff_multiple: float = C.KMER_FREQ_CUTOFF_MULTIPLE,
                freq_cutoff_abs: int | None = None,
                *, device) -> TorchKmerIndex:
    """Build the CSR table over a volume's flat code array on ``device``.

    Every position of every read contributes its k-mer; k-mers that cross a
    read boundary are excluded.  Equal to the reference's NumPy build.
    """
    device = torch.device(device)
    n_slots = 1 << (2 * k)
    codes_t = torch.as_tensor(np.asarray(codes, dtype=np.uint8),
                              device=device)
    starts_t = torch.as_tensor(np.asarray(starts, dtype=np.int64),
                               device=device)
    lengths_t = torch.as_tensor(np.asarray(lengths, dtype=np.int64),
                                device=device)
    n = codes_t.shape[0]
    all_codes = kmer_codes(codes_t, k)
    read_ids = torch.repeat_interleave(
        torch.arange(len(starts_t), device=device), lengths_t,
        output_size=n)
    local = torch.arange(n, device=device) - starts_t[read_ids]
    valid = local <= lengths_t[read_ids] - k
    vpos = torch.nonzero(valid).squeeze(1)
    vcodes = all_codes[vpos]
    counts = torch.bincount(vcodes, minlength=n_slots)
    offsets = torch.zeros(n_slots + 1, dtype=torch.int32, device=device)
    offsets[1:] = torch.cumsum(counts, 0).to(torch.int32)
    order = torch.sort(vcodes, stable=True).indices
    vpos = vpos[order]
    n_valid = int(vpos.shape[0])
    n_distinct = int(torch.count_nonzero(counts))
    mean_occ = max(1.0, n_valid / max(1, n_distinct))
    cutoff = (int(freq_cutoff_abs) if freq_cutoff_abs is not None
              else max(int(mean_occ * freq_cutoff_multiple),
                       C.MAX_OCC_PER_KMER))
    return TorchKmerIndex(
        k=k, offsets=offsets,
        pos_rid=read_ids[vpos].to(torch.int32),
        pos_loc=local[vpos].to(torch.int32),
        read_starts=starts_t.to(torch.int32),
        read_lengths=lengths_t.to(torch.int32), max_occ_cutoff=cutoff)


def index_from_numpy(idx, device) -> TorchKmerIndex:
    """Carry a host index (``mecat_tpu`` ``KmerIndex`` or alike) to a device."""
    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)

    return TorchKmerIndex(
        k=idx.k, offsets=t(idx.offsets),
        pos_rid=t(idx.pos_rid), pos_loc=t(idx.pos_loc),
        read_starts=t(idx.read_starts), read_lengths=t(idx.read_lengths),
        max_occ_cutoff=int(idx.max_occ_cutoff))


def probe_index(offsets: torch.Tensor, pos_rid: torch.Tensor,
                pos_loc: torch.Tensor, query_codes: torch.Tensor,
                query_valid: torch.Tensor, cutoff: int,
                max_occ: int = C.MAX_OCC_PER_KMER):
    """Vectorised index probe.

    query_codes int32 [..., Q], query_valid bool [..., Q].  K-mers with more
    than ``cutoff`` occurrences are dropped; at most ``max_occ`` occurrences
    are gathered per k-mer.  Returns (hit_rid, hit_loc, hit_valid), each
    [..., Q, max_occ]; invalid slots read occurrence 0.
    """
    codes = torch.where(query_valid, query_codes, 0).long()
    off = offsets[codes]
    cnt = offsets[codes + 1] - off
    keep = query_valid & (cnt <= cutoff)
    cnt = torch.where(keep, cnt.clamp(max=max_occ), 0)
    j = torch.arange(max_occ, dtype=torch.int32, device=offsets.device)
    hit_valid = j < cnt[..., None]
    idx = torch.where(hit_valid, off[..., None] + j, 0).long()
    return pos_rid[idx], pos_loc[idx], hit_valid
