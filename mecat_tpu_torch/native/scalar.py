"""ctypes binding of the scalar single-thread C++ overlapper
(``src/scalar_baseline.cpp``).

Copy of ``mecat_tpu.native.scalar``.  The engine is an overlapper in the
style of the reference C++ with the framework's exact algorithm semantics,
used (a) as the one-core denominator of the bench
(``python -m mecat_tpu_torch.bench --scalar``) and (b) as an
algorithm-level differential oracle for the index, the candidates and the
extensions (``tests/test_torch_scalar_baseline.py``).  It is built at its
first use with plain ``g++ -O2`` and no ``-march=native``: it models a
portable release build of the reference, not an autovectorised one, so
the measured rate does not flatter the ratio it divides.
"""
from __future__ import annotations

import ctypes as ct
import functools
import os

import numpy as np

from .. import constants as C
from ..ops.cuda_build import BUILD_DIR, compile_library
from .api import gxx

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "src", "scalar_baseline.cpp")
LIBRARY = os.path.join(BUILD_DIR, "libmecat_scalar.so")
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


@functools.cache
def _load() -> ct.CDLL:
    compile_library(gxx(), GXX_FLAGS, SOURCE, LIBRARY)
    lib = ct.CDLL(LIBRARY)
    lib.sb_build.restype = ct.c_void_p
    lib.sb_build.argtypes = [_u8p, _i64p, _i32p, ct.c_int64, ct.c_int]
    lib.sb_free.argtypes = [ct.c_void_p]
    lib.sb_n_valid.restype = ct.c_int64
    lib.sb_n_valid.argtypes = [ct.c_void_p]
    lib.sb_n_distinct.restype = ct.c_int64
    lib.sb_n_distinct.argtypes = [ct.c_void_p]
    lib.sb_scan_read.restype = ct.c_int32
    lib.sb_scan_read.argtypes = [
        ct.c_void_p, _u8p, ct.c_int32, ct.c_int32, ct.c_int32,
        ct.c_int32, ct.c_int64, ct.c_int32, ct.c_int32,
        _i32p, _i32p, _i32p, _i32p]
    lib.sb_extend_pair.argtypes = [
        ct.c_void_p, _u8p, ct.c_int32, _u8p, ct.c_int32, ct.c_int32,
        ct.c_int32, ct.c_int32, ct.c_int32, ct.c_int32, ct.c_int32,
        ct.c_float, _i32p, np.ctypeslib.ndpointer(dtype=np.float32)]
    lib.sb_overlap_range.argtypes = [
        ct.c_void_p, ct.c_int64, ct.c_int64, ct.c_int32, ct.c_int32,
        ct.c_int32, ct.c_int64, ct.c_int32, ct.c_int32, ct.c_int32,
        ct.c_int32, ct.c_int32, ct.c_int32, ct.c_float, ct.c_float,
        ct.c_int32, ct.c_int32, _i64p, _f64p]
    return lib


class ScalarEngine:
    """One built index + scan/extend entry points (single-threaded)."""

    def __init__(self, codes: np.ndarray, starts: np.ndarray,
                 lengths: np.ndarray, k: int):
        lib = _load()
        self._lib = lib
        # keep buffers alive: the engine stores raw pointers into them
        self._codes = np.ascontiguousarray(codes, dtype=np.uint8)
        self._starts = np.ascontiguousarray(starts, dtype=np.int64)
        self._lengths = np.ascontiguousarray(lengths, dtype=np.int32)
        self._h = lib.sb_build(self._codes, self._starts, self._lengths,
                               len(self._starts), k)
        # mean-occurrence cutoff rule, mirrored from index/kmer_index
        self.n_valid = lib.sb_n_valid(self._h)
        self.n_distinct = lib.sb_n_distinct(self._h)
        self.mean_occ = max(1.0, self.n_valid / max(1, self.n_distinct))

    def cutoff(self, multiple: float | None = None,
               absolute: int | None = None) -> int:
        if absolute is not None:
            return int(absolute)
        mult = C.KMER_FREQ_CUTOFF_MULTIPLE if multiple is None else multiple
        return max(int(self.mean_occ * mult), C.MAX_OCC_PER_KMER)

    def __del__(self):
        try:
            self._lib.sb_free(self._h)
        except Exception:
            pass

    def scan_read(self, bases: np.ndarray, self_id: int, *, stride: int,
                  max_occ: int, cutoff: int, diag_bin: int, n_cand: int):
        """Top-n DDF candidates of one oriented read.

        Returns (target, score, qseed, tseed) int32 arrays (top_k order).
        """
        bases = np.ascontiguousarray(bases, dtype=np.uint8)
        out = [np.zeros(n_cand, np.int32) for _ in range(4)]
        n = self._lib.sb_scan_read(
            self._h, bases, len(bases), self_id, stride, max_occ, cutoff,
            diag_bin, n_cand, *out)
        return tuple(o[:n] for o in out)

    def extend_pair(self, q: np.ndarray, t: np.ndarray, qseed: int,
                    tseed: int, *, S: int, W: int, max_segs: int,
                    penalty: int, min_seg_identity: float):
        """Both-direction banded extension; mirrors ops/align.py exactly.

        Returns dict(qbeg, qend, tbeg, tend, dist, matches, alen, n_segs,
        identity)."""
        q = np.ascontiguousarray(q, dtype=np.uint8)
        t = np.ascontiguousarray(t, dtype=np.uint8)
        out = np.zeros(8, np.int32)
        ident = np.zeros(1, np.float32)
        self._lib.sb_extend_pair(
            self._h, q, len(q), t, len(t), qseed, tseed, S, W, max_segs,
            penalty, min_seg_identity, out, ident)
        keys = ("qbeg", "qend", "tbeg", "tend", "dist", "matches", "alen",
                "n_segs")
        d = dict(zip(keys, (int(v) for v in out)))
        d["identity"] = float(ident[0])
        return d

    def overlap_range(self, q_lo: int, q_hi: int, *, task: int, stride: int,
                      max_occ: int, cutoff: int, diag_bin: int, n_cand: int,
                      min_block_score: int, S: int, W: int, penalty: int,
                      min_seg_identity: float, min_identity: float,
                      min_align_size: int, strands: int = 2):
        """Timed all-vs-all driver over query reads [q_lo, q_hi).

        Returns dict with candidate/extension/overlap counts, total DP
        segments, and the scan/extend wall-time split."""
        counts = np.zeros(5, np.int64)
        secs = np.zeros(2, np.float64)
        self._lib.sb_overlap_range(
            self._h, q_lo, q_hi, task, stride, max_occ, cutoff, diag_bin,
            n_cand, min_block_score, S, W, penalty, min_seg_identity,
            min_identity, min_align_size, strands, counts, secs)
        return dict(candidates=int(counts[0]), extended=int(counts[1]),
                    overlaps=int(counts[2]), dp_segments=int(counts[3]),
                    passed=int(counts[4]),
                    scan_s=float(secs[0]), extend_s=float(secs[1]))
