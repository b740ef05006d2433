"""Synthetic long-read simulator (NumPy).

Copy of ``mecat_tpu.utils.sim``: the same seeds give the same reads, so the
port's tests and ``chip_smoke.py`` run the JAX package's workloads without
importing it.  Reads are sampled at uniform loci on both strands with a
PacBio- or ONT-like error profile.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..io.fasta import FastaRecord
from ..io.packed_db import PackedDB, revcomp


@dataclass
class ReadTruth:
    """Where a simulated read came from (genome forward-strand coords)."""
    start: int
    end: int
    strand: int  # 0 = forward, 1 = reverse-complement

#: per-technology error-profile presets (sub, ins, del fractions of the
#: total error rate)
PROFILE_PACBIO: Tuple[float, float, float] = (0.2, 0.55, 0.25)
PROFILE_NANOPORE: Tuple[float, float, float] = (0.4, 0.2, 0.4)


def random_genome(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=n, dtype=np.uint8)


def mutate(read: np.ndarray, rng: np.random.Generator, sub: float,
           ins: float, dele: float) -> np.ndarray:
    """Apply per-base substitution/insertion/deletion noise."""
    out: List[np.ndarray] = []
    n = len(read)
    r = rng.random(n)
    # substitutions: add 1..3 mod 4 so the base always changes
    subs_mask = r < sub
    shifted = (read + rng.integers(1, 4, size=n, dtype=np.uint8)) % 4
    bases = np.where(subs_mask, shifted, read).astype(np.uint8)
    r2 = rng.random(n)
    del_mask = (r2 >= sub) & (r2 < sub + dele) & ~subs_mask
    ins_mask = (r2 >= sub + dele) & (r2 < sub + dele + ins)
    # one draw per inserted base, in read order, as the reference draws them
    for i in range(n):
        if del_mask[i]:
            continue
        out.append(bases[i:i + 1])
        if ins_mask[i]:
            out.append(rng.integers(0, 4, size=1, dtype=np.uint8))
    return np.concatenate(out) if out else np.zeros(0, dtype=np.uint8)


def simulate_reads(genome: np.ndarray, n_reads: int, mean_len: int = 8000,
                   min_len: int = 1000, seed: int = 0,
                   error_rate: float = 0.12,
                   profile: Tuple[float, float, float] = PROFILE_PACBIO
                   ) -> Tuple[PackedDB, List[ReadTruth]]:
    """Sample ``n_reads`` noisy reads from a linear ``genome``."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    sub, ins, dele = (error_rate * f for f in profile)
    recs: List[FastaRecord] = []
    truths: List[ReadTruth] = []
    for i in range(n_reads):
        ln = int(np.clip(rng.exponential(mean_len - min_len) + min_len,
                         min_len, max(min_len, G)))
        start = int(rng.integers(0, max(1, G - ln + 1)))
        true_seq = genome[start:start + ln]
        strand = int(rng.integers(0, 2))
        seq = revcomp(true_seq) if strand else true_seq
        recs.append(FastaRecord(f"sim_{i}", mutate(seq, rng, sub, ins, dele)))
        truths.append(ReadTruth(start=start, end=start + ln, strand=strand))
    return PackedDB.from_records(recs), truths
