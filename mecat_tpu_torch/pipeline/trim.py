"""Overlap-based trimming of corrected reads (the correct+trim pipeline;
port of ``mecat_tpu.pipeline.trim``).

Overlaps among corrected reads are computed with the pw machinery on the
device, per-read evidence coverage is accumulated from overlap spans on the
host, and each read is cut back to its intervals with at least
``min_evidence`` overlapping supports, splitting at uncovered interior gaps
(chimera/junction suspects).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..io.fasta import format_fasta
from ..io.m4 import m4_columns, m4_columns_plain
from ..io.packed_db import PackedDB
from ..utils.log import get_logger
from .pw import PwOptions, run_pw

log = get_logger("trim")


@dataclass
class TrimOptions:
    min_evidence: int = 2          # overlaps covering a base to keep it
    min_trimmed_length: int = 1000
    pw: Optional[PwOptions] = None  # overlap detection settings


@dataclass
class TrimStats:
    reads_in: int = 0
    reads_out: int = 0
    bases_in: int = 0
    bases_out: int = 0
    seconds: float = 0.0


def coverage_intervals(L: int, spans, min_evidence: int, min_len: int
                       ) -> List[Tuple[int, int]]:
    """Maximal intervals of length >= min_len with coverage >= min_evidence.

    ``spans``: list of (a, b) pairs, or a pair of arrays (a_vec, b_vec).
    """
    if isinstance(spans, tuple):
        a_v, b_v = spans
    else:
        a_v = np.asarray([a for a, _ in spans], dtype=np.int64)
        b_v = np.asarray([b for _, b in spans], dtype=np.int64)
    a_v = np.clip(a_v, 0, L)
    b_v = np.clip(b_v, 0, L)
    keep = b_v > a_v
    diff = np.zeros(L + 1, dtype=np.int32)
    np.add.at(diff, a_v[keep], 1)
    np.add.at(diff, b_v[keep], -1)
    cov = np.cumsum(diff[:-1])
    ok = cov >= min_evidence
    if not ok.any():
        return []
    edges = np.flatnonzero(np.diff(ok.astype(np.int8)))
    bounds = np.concatenate([[0], edges + 1, [L]])
    out = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        if ok[a] and b - a >= min_len:
            out.append((int(a), int(b)))
    return out


def _m4_span_columns(path: str) -> np.ndarray:
    """M4 file -> float64 [n, 12] numeric columns: the native table
    parser; a file it refuses (a short row) takes the record parser."""
    try:
        return m4_columns(path)
    except ValueError:
        return m4_columns_plain(path)


def run_trim(corrected_path: str, out_path: str, wrk_dir: str,
             opts: Optional[TrimOptions] = None,
             overlaps_path: Optional[str] = None, *, device) -> TrimStats:
    """Trim corrected reads; optionally reuse an existing M4 overlap file
    (then nothing runs on ``device``)."""
    opts = opts or TrimOptions()
    os.makedirs(wrk_dir, exist_ok=True)
    t0 = time.time()
    db = PackedDB.from_fasta(corrected_path)
    stats = TrimStats(reads_in=db.n_reads, bases_in=db.total_bases)

    if overlaps_path is None:
        overlaps_path = os.path.join(wrk_dir, "trim_overlaps.m4")
        pw_opts = opts.pw or PwOptions(task=1)
        run_pw(corrected_path, overlaps_path, os.path.join(wrk_dir, "pw"),
               pw_opts, db=db, device=device)

    # columnar span load, sorted by read id so each read's spans are one
    # contiguous slice
    cols = _m4_span_columns(overlaps_path)
    rid = np.concatenate([cols[:, 0], cols[:, 1]]).astype(np.int64) - 1
    sa = np.concatenate([cols[:, 5], cols[:, 9]]).astype(np.int64)
    sb = np.concatenate([cols[:, 6], cols[:, 10]]).astype(np.int64)
    order = np.argsort(rid, kind="stable")
    rid, sa, sb = rid[order], sa[order], sb[order]
    uniq, starts = np.unique(rid, return_index=True)
    bounds = np.append(starts, len(rid))
    slice_of = {int(r): (int(a), int(b))
                for r, a, b in zip(uniq, bounds[:-1], bounds[1:])}

    with open(out_path, "wb") as fh:
        for i in range(db.n_reads):
            L = int(db.lengths[i])
            lo, hi = slice_of.get(i, (0, 0))
            for k, (a, b) in enumerate(coverage_intervals(
                    L, (sa[lo:hi], sb[lo:hi]), opts.min_evidence,
                    opts.min_trimmed_length)):
                fh.write(format_fasta(f"{db.name(i)}_trim{k}",
                                      db.read(i)[a:b]))
                stats.reads_out += 1
                stats.bases_out += b - a
    stats.seconds = time.time() - t0
    log.info("trim: %d reads (%d bases) -> %d reads (%d bases)",
             stats.reads_in, stats.bases_in, stats.reads_out, stats.bases_out)
    return stats
