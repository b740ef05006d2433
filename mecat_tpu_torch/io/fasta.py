"""FASTA/FASTQ reader and FASTA writer.

Copy of the parts of ``mecat_tpu.io.fasta`` the port uses.  A plain file is
parsed and written by the native C++ layer (``native.get()``); ``.gz``
input is streamed by the Python reader.  ``iter_fasta_plain`` and
``write_fasta_plain`` are the pure-Python versions the tests hold the
native layer to.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from .. import native
from ..constants import INVALID_BASE_CODE

# char -> 2-bit code lookup (A=0 C=1 G=2 T=3, case-insensitive, else INVALID)
_CODE_LUT = np.full(256, INVALID_BASE_CODE, dtype=np.uint8)
for _c, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _CODE_LUT[ord(_c)] = _v
    _CODE_LUT[ord(_c.lower())] = _v

_DECODE_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def encode_bases(seq: bytes | np.ndarray) -> np.ndarray:
    """ASCII bases -> uint8 codes in {0..3} (non-ACGT -> INVALID_BASE_CODE)."""
    if isinstance(seq, (bytes, bytearray, memoryview)):
        seq = np.frombuffer(seq, dtype=np.uint8)
    return _CODE_LUT[seq]


def decode_bases(codes: np.ndarray) -> bytes:
    """uint8 codes in {0..3} -> ASCII bytes."""
    return _DECODE_LUT[codes].tobytes()


@dataclass
class FastaRecord:
    name: str
    codes: np.ndarray  # uint8 in {0..3}


def _open(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def iter_fasta(path: str) -> Iterator[FastaRecord]:
    """Records of a FASTA or FASTQ file (auto-detected on the first byte):
    a plain file through the native parser, ``.gz`` through
    :func:`iter_fasta_plain`."""
    if str(path).endswith(".gz"):
        yield from iter_fasta_plain(path)
        return
    p = native.get().parse_path(str(path))
    for name, s, n in zip(p.names, p.starts.tolist(), p.lengths.tolist()):
        yield FastaRecord(name, p.codes[s:s + n])


def iter_fasta_plain(path: str) -> Iterator[FastaRecord]:
    """Stream records from FASTA or FASTQ (auto-detected on the first byte)."""
    with _open(path) as fh:
        first = fh.peek(1)[:1]
        if first == b">":
            yield from _iter_fasta_fh(fh)
        elif first == b"@":
            yield from _iter_fastq_fh(fh)
        elif first != b"":
            raise ValueError(f"{path}: not FASTA/FASTQ (first byte {first!r})")


def _iter_fasta_fh(fh) -> Iterator[FastaRecord]:
    name = None
    chunks: List[bytes] = []
    for raw in fh:
        line = raw.strip()
        if not line:
            continue
        if line.startswith(b">"):
            if name is not None:
                yield FastaRecord(name, encode_bases(b"".join(chunks)))
            name = line[1:].split()[0].decode() if len(line) > 1 else ""
            chunks = []
        else:
            chunks.append(line)
    if name is not None:
        yield FastaRecord(name, encode_bases(b"".join(chunks)))


def _iter_fastq_fh(fh) -> Iterator[FastaRecord]:
    while True:
        hdr = fh.readline()
        if not hdr:
            return
        hdr = hdr.strip()
        if not hdr:
            continue
        if not hdr.startswith(b"@"):
            raise ValueError(f"bad FASTQ header line: {hdr[:40]!r}")
        seq = fh.readline().strip()
        fh.readline()                     # '+' line
        if not fh.readline():             # quality line
            raise ValueError("truncated FASTQ record")
        name = hdr[1:].split()[0].decode() if len(hdr) > 1 else ""
        yield FastaRecord(name, encode_bases(seq))


def format_fasta(name: str, codes: np.ndarray, width: int = 80) -> bytes:
    """One (name, codes) record as FASTA bytes with a fixed line width."""
    seq = decode_bases(np.asarray(codes, dtype=np.uint8))
    lines = [seq[i:i + width] + b"\n" for i in range(0, len(seq), width)]
    return b">" + name.encode() + b"\n" + b"".join(lines)


def write_fasta(path: str, records: Sequence[Tuple[str, np.ndarray]],
                width: int = 80) -> None:
    """Write (name, codes) records as FASTA with a fixed line width (the
    native writer)."""
    records = list(records)
    chunks = [np.asarray(c, dtype=np.uint8) for _, c in records]
    lengths = np.array([len(c) for c in chunks], dtype=np.int32)
    starts = np.zeros(len(chunks), dtype=np.int64)
    if len(chunks):
        np.cumsum(lengths[:-1].astype(np.int64), out=starts[1:])
    codes = (np.concatenate(chunks) if chunks
             else np.zeros(0, dtype=np.uint8))
    blob = native.get().format_fasta(codes, starts, lengths,
                                     [name for name, _ in records], width)
    with open(path, "wb") as fh:
        fh.write(blob)


def write_fasta_plain(path: str, records: Sequence[Tuple[str, np.ndarray]],
                      width: int = 80) -> None:
    """Write (name, codes) records as FASTA with a fixed line width."""
    with open(path, "wb") as fh:
        for name, codes in records:
            fh.write(format_fasta(name, codes, width))
