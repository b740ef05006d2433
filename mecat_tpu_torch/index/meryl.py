"""k-mer counting / spectrum (meryl role; NumPy copy of
``mecat_tpu.index.meryl``).

The assembler derives the overlap-seeding frequency threshold from the k-mer
spectrum.  The count is one sort over the volume's k-mer codes, so there is
no separate k-mer database on disk, just the spectrum histogram and the
derived cutoff.
"""
from __future__ import annotations

import numpy as np

from ..io.packed_db import PackedDB


def kmer_codes_np(codes: np.ndarray, k: int) -> np.ndarray:
    """k-mer integer codes at every start position, int64 [N]: out[p]
    encodes codes[p:p+k] big-endian (base p is the most significant 2 bits).
    Positions closer than k to the end of the array hold zero-padded codes;
    the caller masks them by read bounds."""
    n = len(codes)
    out = np.zeros(n, dtype=np.int64)
    c = codes.astype(np.int64)
    for j in range(k):
        shifted = np.zeros(n, dtype=np.int64)
        shifted[: n - j] = c[j:]
        out = (out << 2) | shifted
    return out


def kmer_counts(db: PackedDB, k: int = 16) -> np.ndarray:
    """Occurrence count per distinct k-mer (int64 [n_distinct], unordered)."""
    codes = kmer_codes_np(np.asarray(db.codes, dtype=np.uint8), k)
    starts = db.starts.astype(np.int64)
    lengths = db.lengths.astype(np.int64)
    read_ids = np.repeat(np.arange(db.n_reads, dtype=np.int64), lengths)
    local = np.arange(len(codes), dtype=np.int64) - starts[read_ids]
    valid = local <= (lengths[read_ids] - k)
    vcodes = codes[valid]
    if len(vcodes) == 0:
        return np.zeros(0, dtype=np.int64)
    # counting per distinct k-mer without a 4^k table: sort + run lengths
    vcodes = np.sort(vcodes)
    edges = np.flatnonzero(np.diff(vcodes)) + 1
    bounds = np.concatenate([[0], edges, [len(vcodes)]])
    return np.diff(bounds).astype(np.int64)


def kmer_histogram(db: PackedDB, k: int = 16, max_count: int = 1000
                   ) -> np.ndarray:
    """Spectrum: hist[c] = number of distinct k-mers occurring c times."""
    counts = kmer_counts(db, k)
    if len(counts) == 0:
        return np.zeros(max_count + 1, dtype=np.int64)
    return np.bincount(np.minimum(counts, max_count),
                       minlength=max_count + 1).astype(np.int64)


def pick_freq_cutoff(hist: np.ndarray, tail_frac: float = 0.0001,
                     min_cutoff: int = 16) -> int:
    """Seeding-frequency cutoff: drop the heaviest ``tail_frac`` of k-mer
    OCCURRENCES (repeat k-mers), canu-style 'distinct=...' threshold logic."""
    occ = hist * np.arange(len(hist), dtype=np.int64)
    total = occ.sum()
    if total == 0:
        return min_cutoff
    tail = np.cumsum(occ[::-1])[::-1]
    ok = np.nonzero(tail <= total * tail_frac)[0]
    cutoff = int(ok[0]) if len(ok) else len(hist) - 1
    return max(cutoff, min_cutoff)
