"""Columnar overlap store (Canu ovStore role; copy of
``mecat_tpu.assembly.ovstore``: the M4 file is read by the native table
parser, ``io.m4.m4_columns``).

Overlaps live as columnar NumPy arrays symmetrised so every overlap is
visible from both reads, sorted by (a-read, b-read) with CSR offsets per
a-read: one ``np.lexsort`` instead of an external merge sort.  The files
(``.ovs.npz`` + ``.ovs.json``) are the original's.

Columns (all int32 except identity float32), coordinates 0-based half-open on
the FORWARD strand of each read (M4 convention, :mod:`..io.m4`):

    a, b, flip, abeg, aend, alen, bbeg, bend, blen, identity, score
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..io.m4 import m4_columns

_COLS = ("a", "b", "flip", "abeg", "aend", "alen", "bbeg", "bend", "blen",
         "score")


@dataclass
class OverlapStore:
    a: np.ndarray          # int32 a-read id (0-based)
    b: np.ndarray          # int32 b-read id (0-based)
    flip: np.ndarray       # int32 1 if b is reverse-complemented relative to a
    abeg: np.ndarray       # int32 overlap begin on forward a
    aend: np.ndarray
    alen: np.ndarray
    bbeg: np.ndarray       # int32 overlap begin on forward b
    bend: np.ndarray
    blen: np.ndarray
    identity: np.ndarray   # float32 percent
    score: np.ndarray      # int32
    offsets: np.ndarray    # int64 [n_reads + 1] CSR offsets by a-read
    n_reads: int

    def __len__(self) -> int:
        return len(self.a)

    def for_read(self, rid: int) -> slice:
        """Row range of overlaps whose a-read is `rid`."""
        return slice(int(self.offsets[rid]), int(self.offsets[rid + 1]))

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_m4(cls, m4_path: str, n_reads: int) -> "OverlapStore":
        """Load + symmetrise an M4 overlap file (an M4 file is a 12-column
        numeric table)."""
        t = m4_columns(m4_path)
        qid = t[:, 0].astype(np.int32) - 1
        sid = t[:, 1].astype(np.int32) - 1
        ident = t[:, 2].astype(np.float32)
        score = t[:, 3].astype(np.int32)
        qs, qe, qz = (t[:, 5].astype(np.int32), t[:, 6].astype(np.int32),
                      t[:, 7].astype(np.int32))
        ss = t[:, 8].astype(np.int32)
        sb, se, sz = (t[:, 9].astype(np.int32), t[:, 10].astype(np.int32),
                      t[:, 11].astype(np.int32))
        # both symmetric views; coordinates are already forward-strand on
        # each read, and the relative-orientation flag is symmetric
        cols = dict(
            a=np.concatenate([qid, sid]),
            b=np.concatenate([sid, qid]),
            flip=np.concatenate([ss, ss]),
            abeg=np.concatenate([qs, sb]),
            aend=np.concatenate([qe, se]),
            alen=np.concatenate([qz, sz]),
            bbeg=np.concatenate([sb, qs]),
            bend=np.concatenate([se, qe]),
            blen=np.concatenate([sz, qz]),
            identity=np.concatenate([ident, ident]),
            score=np.concatenate([score, score]),
        )
        return cls._finish(cols, n_reads)

    @classmethod
    def _finish(cls, cols: dict, n_reads: int) -> "OverlapStore":
        order = np.lexsort((cols["b"], cols["a"]))
        cols = {k: v[order] for k, v in cols.items()}
        counts = np.bincount(cols["a"], minlength=n_reads)
        offsets = np.zeros(n_reads + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return cls(offsets=offsets, n_reads=n_reads, **cols)

    # -- persistence ----------------------------------------------------------
    def save(self, prefix: str) -> None:
        np.savez(prefix + ".ovs.npz", identity=self.identity,
                 offsets=self.offsets,
                 **{k: getattr(self, k) for k in _COLS})
        with open(prefix + ".ovs.json", "w") as fh:
            json.dump({"n_reads": self.n_reads, "n_overlaps": len(self)}, fh)

    @classmethod
    def load(cls, prefix: str) -> "OverlapStore":
        z = np.load(prefix + ".ovs.npz")
        with open(prefix + ".ovs.json") as fh:
            meta = json.load(fh)
        return cls(identity=z["identity"], offsets=z["offsets"],
                   n_reads=meta["n_reads"],
                   **{k: z[k] for k in _COLS})
