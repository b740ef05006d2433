"""PackedDB: the read database as one flat uint8 code array (NumPy).

Copy of the parts of ``mecat_tpu.io.packed_db`` the overlap path uses,
without its native C++ fast path and its 2-bit disk form.  Reads are
concatenated in input order (read id = input index); ``starts`` and
``lengths`` address them, which is the layout the device index consumes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from .. import constants as C
from .fasta import FastaRecord, iter_fasta

_REVCOMP = np.array([3, 2, 1, 0], dtype=np.uint8)  # A<->T, C<->G in 2-bit codes


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a uint8 code array."""
    return _REVCOMP[codes][::-1]


@dataclass
class PackedDB:
    """Flat read database: all reads concatenated as uint8 codes."""

    codes: np.ndarray                 # uint8 [total_bases], values 0..3
    starts: np.ndarray                # int64 [n_reads] start offset of each read
    lengths: np.ndarray               # int32 [n_reads]
    names: List[str] = field(default_factory=list)

    @classmethod
    def from_records(cls, records: Iterable[FastaRecord]) -> "PackedDB":
        names: List[str] = []
        chunks: List[np.ndarray] = []
        for rec in records:
            names.append(rec.name)
            chunks.append(np.asarray(rec.codes, dtype=np.uint8))
        lengths = np.asarray([len(c) for c in chunks], dtype=np.int32)
        starts = np.zeros(len(lengths), dtype=np.int64)
        if len(lengths):
            np.cumsum(lengths[:-1], out=starts[1:])
        codes = (np.concatenate(chunks) if chunks
                 else np.zeros(0, dtype=np.uint8))
        return cls(codes=codes, starts=starts, lengths=lengths, names=names)

    @classmethod
    def from_fasta(cls, path: str) -> "PackedDB":
        return cls.from_records(iter_fasta(path))

    @property
    def n_reads(self) -> int:
        return len(self.lengths)

    @property
    def total_bases(self) -> int:
        return int(self.codes.shape[0])

    def read(self, i: int) -> np.ndarray:
        s = int(self.starts[i])
        return self.codes[s:s + int(self.lengths[i])]

    def name(self, i: int) -> str:
        return self.names[i] if self.names else str(i)

    def subset(self, idx: Sequence[int]) -> "PackedDB":
        idx = np.asarray(idx, dtype=np.int64)
        return PackedDB.from_records(
            FastaRecord(self.name(int(i)), self.read(int(i))) for i in idx)

    def split_volumes(self, max_bases: int = C.DEFAULT_VOLUME_BASES
                      ) -> List[Tuple[int, int]]:
        """Split reads (in id order) into volumes of <= max_bases.

        Returns [(read_id_begin, read_id_end), ...).  A single read longer
        than max_bases still gets its own volume.
        """
        vols: List[Tuple[int, int]] = []
        begin, acc = 0, 0
        for i, ln in enumerate(self.lengths):
            if acc and acc + int(ln) > max_bases:
                vols.append((begin, i))
                begin, acc = i, 0
            acc += int(ln)
        if begin < self.n_reads or not vols:
            vols.append((begin, self.n_reads))
        return vols

    def padded_batch(self, read_ids: Sequence[int], pad_to: int | None = None,
                     multiple: int = 128) -> Tuple[np.ndarray, np.ndarray]:
        """Gather reads into a dense [B, L] uint8 array (padded with 0).

        Returns (bases[B, L], lengths[B]).  L is the longest read rounded up
        to ``multiple``, or ``pad_to`` if given; longer reads are cut to L.
        """
        read_ids = np.asarray(read_ids, dtype=np.int64)
        lens = self.lengths[read_ids].astype(np.int32)
        maxlen = int(lens.max()) if len(lens) else multiple
        L = pad_to if pad_to is not None else -(-maxlen // multiple) * multiple
        out = np.zeros((len(read_ids), L), dtype=np.uint8)
        for row, rid in enumerate(read_ids):
            r = self.read(int(rid))[:L]
            out[row, :len(r)] = r
        return out, np.minimum(lens, L)
