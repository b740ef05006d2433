"""Host-side batching helpers for the pipeline drivers (NumPy).

Copies of ``mecat_tpu/pipeline/common.py:14-62`` and ``:146-161``: that
module imports the JAX aligner at its top, so the port cannot import it on a
machine without JAX.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from ..io.packed_db import _REVCOMP, PackedDB


def bucket_length(n: int, minimum: int = 1024, pow2: bool = False) -> int:
    """Padded length >= n from a ladder of powers of two and their 1.5x
    midpoints, multiples of 1024; ``pow2`` drops the midpoints (the cns
    table shapes)."""
    n = max(n, minimum)
    p = 1 << max(10, (n - 1).bit_length())
    b = p if (pow2 or n > 3 * p // 4) else 3 * p // 4
    return max(minimum, int(math.ceil(b / 1024)) * 1024)


def oriented_batch(db: PackedDB, read_ids: Sequence[int], L: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reads in both orientations, padded to L with 0.

    Returns (fwd[B, L], rev[B, L], lengths[B]); rev is the reverse
    complement of each read, left-aligned.
    """
    fwd, lens = db.padded_batch(read_ids, pad_to=L)
    idx = lens[:, None].astype(np.int64) - 1 - np.arange(L, dtype=np.int64)
    valid = idx >= 0
    comp = _REVCOMP[np.take_along_axis(fwd, np.maximum(idx, 0), axis=1)]
    rev = np.where(valid, comp, 0).astype(np.uint8)
    return fwd, rev, lens


def gather_rows(flat: np.ndarray, starts: np.ndarray, lengths: np.ndarray,
                ids: np.ndarray, L: int) -> np.ndarray:
    """Ragged gather: rows[i] = flat[starts[ids[i]] : +lengths], 0-padded."""
    ids = np.asarray(ids, dtype=np.int64)
    lens = lengths[ids].astype(np.int64)
    idx = starts[ids][:, None] + np.arange(L, dtype=np.int64)[None, :]
    mask = np.arange(L, dtype=np.int64)[None, :] < lens[:, None]
    idx = np.where(mask, idx, 0)
    out = flat[idx]
    out[~mask] = 0
    return out


def pad_to_batch(arrays: List[np.ndarray], batch: int) -> List[np.ndarray]:
    """Pad the leading dim of every array to ``batch`` with zeros."""
    out = []
    for a in arrays:
        n = a.shape[0]
        if n == batch:
            out.append(a)
        else:
            pad = np.zeros((batch - n,) + a.shape[1:], dtype=a.dtype)
            out.append(np.concatenate([a, pad], axis=0))
    return out


def max_segs_for(L: int, S: int) -> int:
    """Segments covering L query bases when each may re-align S//4."""
    return int(math.ceil(L / max(1, S - S // 4))) + 2
