"""PackedDB: the read database as one flat uint8 code array (NumPy).

Copy of ``mecat_tpu.io.packed_db``; parsing, 2-bit packing and the padded
batch gather run in the native C++ layer (``native.get()``), and the
``*_plain`` functions are the NumPy versions the tests hold it to.  Reads
are concatenated in input order (read id = input index); ``starts`` and
``lengths`` address them, which is the layout the device index consumes.
The disk form is 2-bit packed (4 bases a byte, A=0 C=1 G=2 T=3, base i of
the stream in bits ``2*(i%4)`` of byte ``i//4``) with a ``.npz`` index and a
JSON name list: the same three files the original writes, so a store saved
by one package loads in the other.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from .. import constants as C
from .. import native
from .fasta import FastaRecord, iter_fasta

_REVCOMP = np.array([3, 2, 1, 0], dtype=np.uint8)  # A<->T, C<->G in 2-bit codes


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a uint8 code array."""
    return _REVCOMP[codes][::-1]


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """uint8 codes {0..3} -> 2-bit packed bytes (4 bases a byte, LSB first)."""
    return native.get().pack_2bit(np.asarray(codes, dtype=np.uint8))


def pack_2bit_plain(codes: np.ndarray) -> np.ndarray:
    """NumPy version of :func:`pack_2bit`."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes)
    padded = np.zeros((n + 3) // 4 * 4, dtype=np.uint8)
    padded[:n] = codes
    quads = padded.reshape(-1, 4)
    return (quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4)
            | (quads[:, 3] << 6)).astype(np.uint8)


def unpack_2bit(packed: np.ndarray, n_bases: int) -> np.ndarray:
    """2-bit packed bytes -> uint8 codes {0..3} of length n_bases."""
    return native.get().unpack_2bit(packed, n_bases)


def unpack_2bit_plain(packed: np.ndarray, n_bases: int) -> np.ndarray:
    """NumPy version of :func:`unpack_2bit`."""
    packed = np.asarray(packed, dtype=np.uint8)
    out = np.empty((len(packed), 4), dtype=np.uint8)
    for k in range(4):
        out[:, k] = (packed >> (2 * k)) & 3
    return out.reshape(-1)[:n_bases]


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
        """The reads of a FASTA/FASTQ file: a plain file straight from the
        native parser's arrays, ``.gz`` through the Python reader."""
        if str(path).endswith(".gz"):
            return cls.from_records(iter_fasta(path))
        p = native.get().parse_path(str(path))
        return cls(codes=p.codes, starts=p.starts, lengths=p.lengths,
                   names=p.names)

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

    def append(self, records: Iterable[FastaRecord]) -> "PackedDB":
        """New PackedDB with ``records`` appended after the existing reads.

        Existing read ids keep their offsets (a device volume built from
        the old db stays valid as a prefix); appended read i gets id
        n_reads + i.  Correction rounds > 1 add each round's drafts this
        way, as template reads, without touching support ids.
        """
        recs = list(records)
        if not recs:
            return self
        tail_lengths = np.asarray([len(r.codes) for r in recs],
                                  dtype=np.int32)
        tail_starts = (self.total_bases
                       + np.concatenate([[0], np.cumsum(
                           tail_lengths[:-1], dtype=np.int64)]))
        codes = np.concatenate(
            [self.codes] + [np.asarray(r.codes, dtype=np.uint8)
                            for r in recs])
        names = ((list(self.names) if self.names
                  else [str(i) for i in range(self.n_reads)])
                 + [r.name for r in recs])
        return PackedDB(codes=codes,
                        starts=np.concatenate([self.starts, tail_starts]),
                        lengths=np.concatenate([self.lengths, tail_lengths]),
                        names=names)

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

    def save(self, prefix: str) -> None:
        """Write ``prefix``.pac.npy (2-bit packed bases), .idx.npz and
        .names.json."""
        np.save(prefix + ".pac.npy", pack_2bit(self.codes))
        np.savez(prefix + ".idx.npz", starts=self.starts, lengths=self.lengths,
                 total_bases=np.int64(self.total_bases))
        with open(prefix + ".names.json", "w") as fh:
            json.dump(self.names, fh)

    @classmethod
    def load(cls, prefix: str) -> "PackedDB":
        packed = np.load(prefix + ".pac.npy")
        idx = np.load(prefix + ".idx.npz")
        codes = unpack_2bit(packed, int(idx["total_bases"]))
        names: List[str] = []
        if os.path.exists(prefix + ".names.json"):
            with open(prefix + ".names.json") as fh:
                names = json.load(fh)
        return cls(codes=codes, starts=idx["starts"].astype(np.int64),
                   lengths=idx["lengths"].astype(np.int32), names=names)

    def padded_batch(self, read_ids: Sequence[int], pad_to: int | None = None,
                     multiple: int = 128) -> Tuple[np.ndarray, np.ndarray]:
        """Gather reads into a dense [B, L] uint8 array (padded with 0).

        Returns (bases[B, L], lengths[B]).  L is the longest read rounded up
        to ``multiple``, or ``pad_to`` if given; longer reads are cut to L.
        The gather runs in the native layer.
        """
        read_ids = np.asarray(read_ids, dtype=np.int64)
        if len(read_ids) and (read_ids.min() < 0
                              or read_ids.max() >= self.n_reads):
            raise IndexError(f"read ids outside [0, {self.n_reads})")
        return native.get().padded_batch(
            self.codes, self.starts, self.lengths, read_ids,
            self._batch_width(read_ids, pad_to, multiple))

    def _batch_width(self, read_ids: np.ndarray, pad_to: int | None,
                     multiple: int) -> int:
        lens = self.lengths[read_ids]
        maxlen = int(lens.max()) if len(lens) else multiple
        return (pad_to if pad_to is not None
                else -(-maxlen // multiple) * multiple)

    def padded_batch_plain(self, read_ids: Sequence[int],
                           pad_to: int | None = None, multiple: int = 128
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """NumPy version of :meth:`padded_batch`."""
        read_ids = np.asarray(read_ids, dtype=np.int64)
        lens = self.lengths[read_ids].astype(np.int32)
        L = self._batch_width(read_ids, pad_to, multiple)
        out = np.zeros((len(read_ids), L), dtype=np.uint8)
        for row, rid in enumerate(read_ids):
            r = self.read(int(rid))[:L]
            out[row, :len(r)] = r
        return out, np.minimum(lens, L)
