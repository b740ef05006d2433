"""ctypes bindings of the native data layer (``src/mecat_native.cpp``).

Copy of ``mecat_tpu.native.api``.  The ABI is plain C and every array
crosses as a NumPy buffer.  The library is built with ``g++ -O3
-march=native`` at its first use into ``mecat_tpu_torch/_build/`` (see
``ops.cuda_build.compile_library``); a failed build raises with the
compiler's message: there is no Python fallback on a path.
"""
from __future__ import annotations

import ctypes as ct
import functools
import os
import shutil
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..ops.cuda_build import BUILD_DIR, compile_library

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "src", "mecat_native.cpp")
LIBRARY = os.path.join(BUILD_DIR, "libmecat_native.so")
GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]

_c_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_c_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_c_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_c_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


def gxx() -> str:
    """Path of the host C++ compiler; RuntimeError without one."""
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the native libraries cannot be "
                           "built")
    return path


def build() -> float:
    """Compile the library unless an up-to-date one exists; returns the
    seconds spent compiling."""
    return compile_library(gxx(), GXX_FLAGS, SOURCE, LIBRARY)


@dataclass
class ParsedDB:
    codes: np.ndarray      # uint8 [total_bases]
    starts: np.ndarray     # int64 [n]
    lengths: np.ndarray    # int32 [n]
    names: List[str]


class NativeLib:
    def __init__(self, path: str):
        lib = ct.CDLL(path)
        self._lib = lib
        lib.mt_error.restype = ct.c_char_p

        lib.mt_parse_path.restype = ct.c_void_p
        lib.mt_parse_path.argtypes = [ct.c_char_p]
        lib.mt_db_n_reads.restype = ct.c_int64
        lib.mt_db_n_reads.argtypes = [ct.c_void_p]
        lib.mt_db_total_bases.restype = ct.c_int64
        lib.mt_db_total_bases.argtypes = [ct.c_void_p]
        lib.mt_db_names_size.restype = ct.c_int64
        lib.mt_db_names_size.argtypes = [ct.c_void_p]
        lib.mt_db_fill.argtypes = [ct.c_void_p, _c_u8p, _c_i64p, _c_i32p,
                                   ct.c_char_p]
        lib.mt_db_free.argtypes = [ct.c_void_p]

        lib.mt_pack_2bit.argtypes = [_c_u8p, ct.c_int64, _c_u8p]
        lib.mt_unpack_2bit.argtypes = [_c_u8p, ct.c_int64, _c_u8p]
        lib.mt_padded_batch.argtypes = [_c_u8p, _c_i64p, _c_i32p, _c_i64p,
                                        ct.c_int64, ct.c_int64, _c_u8p,
                                        _c_i32p]

        lib.mt_format_m4.restype = ct.c_int64
        lib.mt_format_m4.argtypes = ([ct.c_int64] + [_c_i32p] * 2 + [_c_f64p]
                                     + [_c_i32p] * 9
                                     + [ct.c_char_p, ct.c_int64])
        lib.mt_format_candidates.restype = ct.c_int64
        lib.mt_format_candidates.argtypes = ([ct.c_int64] + [_c_i32p] * 9
                                             + [ct.c_char_p, ct.c_int64])
        lib.mt_parse_table.restype = ct.c_void_p
        lib.mt_parse_table.argtypes = [ct.c_char_p, ct.c_int32]
        lib.mt_table_rows.restype = ct.c_int64
        lib.mt_table_rows.argtypes = [ct.c_void_p]
        lib.mt_table_fill.argtypes = [ct.c_void_p, _c_f64p]
        lib.mt_table_free.argtypes = [ct.c_void_p]
        lib.mt_partition_table.restype = ct.c_int64
        lib.mt_partition_table.argtypes = [ct.c_char_p, ct.c_int32,
                                           ct.c_int64, ct.c_int64,
                                           ct.c_char_p]

        lib.mt_format_fasta.restype = ct.c_int64
        lib.mt_format_fasta.argtypes = [_c_u8p, _c_i64p, _c_i32p, ct.c_int64,
                                        ct.c_char_p, ct.c_int32, ct.c_char_p,
                                        ct.c_int64]

        lib.mt_edit_stats.restype = ct.c_int64
        lib.mt_edit_stats.argtypes = [_c_u8p, ct.c_int64, _c_u8p, ct.c_int64,
                                      ct.c_int32, ct.c_int32, _c_i64p]

    # -- parsing --------------------------------------------------------------
    def parse_path(self, path: str) -> ParsedDB:
        h = self._lib.mt_parse_path(path.encode())
        if not h:
            raise ValueError(self._lib.mt_error().decode())
        try:
            n = self._lib.mt_db_n_reads(h)
            tb = self._lib.mt_db_total_bases(h)
            ns = self._lib.mt_db_names_size(h)
            codes = np.empty(tb, dtype=np.uint8)
            starts = np.empty(n, dtype=np.int64)
            lengths = np.empty(n, dtype=np.int32)
            names_buf = ct.create_string_buffer(int(ns) + 1)
            self._lib.mt_db_fill(h, codes, starts, lengths, names_buf)
            names = (names_buf.raw[:ns].decode().split("\n") if ns else
                     [""] * n if n else [])
            if len(names) != n:  # all-empty names edge case
                names = (names + [""] * n)[:n]
            return ParsedDB(codes, starts, lengths, names)
        finally:
            self._lib.mt_db_free(h)

    def parse_table(self, path: str, ncols: int) -> np.ndarray:
        """Whitespace numeric table -> float64 [rows, ncols]."""
        h = self._lib.mt_parse_table(path.encode(), ncols)
        if not h:
            raise ValueError(self._lib.mt_error().decode())
        try:
            rows = self._lib.mt_table_rows(h)
            out = np.empty((rows, ncols), dtype=np.float64)
            if rows:
                self._lib.mt_table_fill(h, out)
            return out
        finally:
            self._lib.mt_table_free(h)

    def partition_table(self, path: str, ncols: int, part_size: int,
                        n_parts: int, out_dir: str) -> int:
        """Stream-partition a support table by template-id range.

        Writes ``out_dir/part_<pid>.bin`` — raw float64 rows of (ncols + 1)
        values, the extra column being the original row index (global
        insertion order for score tie-breaks).  Peak memory is IO buffers,
        never the file.  Returns the number of input rows."""
        n = self._lib.mt_partition_table(path.encode(), ncols, part_size,
                                         n_parts, out_dir.encode())
        if n < 0:
            raise ValueError(self._lib.mt_error().decode())
        return int(n)

    def edit_stats(self, a: np.ndarray, b: np.ndarray, band: int = 256,
                   mode: int = 0) -> Tuple[int, int, int, int]:
        """Banded edit distance a -> b: (dist, subs, ins, dels).

        mode 0 = global, 1 = infix (free end gaps in b).  The band
        auto-widens (x2, up to max(len)) until dist < band — any optimal
        path leaving the band's diagonal envelope costs at least the band
        width, so dist < band proves the result exact."""
        a = np.ascontiguousarray(a, dtype=np.uint8)
        b = np.ascontiguousarray(b, dtype=np.uint8)
        stats = np.zeros(4, dtype=np.int64)
        limit = max(len(a), len(b), 1)
        while True:
            bw = min(band, limit)
            d = self._lib.mt_edit_stats(a, len(a), b, len(b),
                                        np.int32(bw), np.int32(mode), stats)
            if d < 0:
                raise ValueError(self._lib.mt_error().decode())
            if d < bw or bw >= limit:
                return int(d), int(stats[0]), int(stats[1]), int(stats[2])
            band *= 2

    # -- packing / batching -------------------------------------------------
    def pack_2bit(self, codes: np.ndarray) -> np.ndarray:
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        out = np.empty((len(codes) + 3) // 4, dtype=np.uint8)
        self._lib.mt_pack_2bit(codes, len(codes), out)
        return out

    def unpack_2bit(self, packed: np.ndarray, n_bases: int) -> np.ndarray:
        packed = np.ascontiguousarray(packed, dtype=np.uint8)
        out = np.empty(n_bases, dtype=np.uint8)
        self._lib.mt_unpack_2bit(packed, n_bases, out)
        return out

    def padded_batch(self, codes, starts, lengths, ids,
                     L: int) -> Tuple[np.ndarray, np.ndarray]:
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        starts = np.ascontiguousarray(starts, dtype=np.int64)
        lengths = np.ascontiguousarray(lengths, dtype=np.int32)
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        out = np.empty((len(ids), L), dtype=np.uint8)
        out_lens = np.empty(len(ids), dtype=np.int32)
        self._lib.mt_padded_batch(codes, starts, lengths, ids, len(ids), L,
                                  out, out_lens)
        return out, out_lens

    # -- serialisation -----------------------------------------------------
    def format_m4(self, cols: dict) -> bytes:
        """cols: qid sid identity score qstrand qstart qend qsize sstrand
        sstart send ssize (identity float64, rest int32)."""
        n = len(cols["qid"])
        i32 = {k: np.ascontiguousarray(cols[k], dtype=np.int32)
               for k in ("qid", "sid", "score", "qstrand", "qstart", "qend",
                         "qsize", "sstrand", "sstart", "send", "ssize")}
        ident = np.ascontiguousarray(cols["identity"], dtype=np.float64)
        cap = max(n * 160, 1024)
        buf = ct.create_string_buffer(cap)
        w = self._lib.mt_format_m4(
            n, i32["qid"], i32["sid"], ident, i32["score"], i32["qstrand"],
            i32["qstart"], i32["qend"], i32["qsize"], i32["sstrand"],
            i32["sstart"], i32["send"], i32["ssize"], buf, cap)
        if w < 0:
            raise RuntimeError(f"native writer needs {-w} bytes")
        return buf.raw[:w]

    def format_candidates(self, cols: dict) -> bytes:
        n = len(cols["qid"])
        i32 = {k: np.ascontiguousarray(cols[k], dtype=np.int32)
               for k in ("qid", "sid", "score", "qdir", "qext", "qsize",
                         "sdir", "sext", "ssize")}
        cap = max(n * 120, 1024)
        buf = ct.create_string_buffer(cap)
        w = self._lib.mt_format_candidates(
            n, i32["qid"], i32["sid"], i32["score"], i32["qdir"], i32["qext"],
            i32["qsize"], i32["sdir"], i32["sext"], i32["ssize"], buf, cap)
        if w < 0:
            raise RuntimeError(f"native writer needs {-w} bytes")
        return buf.raw[:w]

    def format_fasta(self, codes, starts, lengths, names: List[str],
                     width: int = 80) -> bytes:
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        starts = np.ascontiguousarray(starts, dtype=np.int64)
        lengths = np.ascontiguousarray(lengths, dtype=np.int32)
        blob = "\n".join(names).encode()
        n = len(starts)
        cap = int(codes.size + codes.size // max(width, 1) + len(blob)
                  + 8 * n + 64)
        buf = ct.create_string_buffer(cap)
        w = self._lib.mt_format_fasta(codes, starts, lengths, n, blob, width,
                                      buf, cap)
        if w < 0:
            buf = ct.create_string_buffer(-w)
            w = self._lib.mt_format_fasta(codes, starts, lengths, n, blob,
                                          width, buf, -w)
        if w < 0:
            raise RuntimeError(f"native writer needs {-w} bytes")
        return buf.raw[:w]


@functools.cache
def get() -> NativeLib:
    """The native library, built at the first call of the process."""
    build()
    return NativeLib(LIBRARY)
