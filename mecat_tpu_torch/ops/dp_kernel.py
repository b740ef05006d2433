"""Build, bind and launch the Hopper DP-segment kernels (csrc/dp_segment.cu).

The source replaces ``mecat_tpu/ops/pallas_dp.py:_dp_kernel`` in both forms:
counts only (:func:`dp_segment_best_cuda`) and move-writing
(:func:`dp_segment_best_moves_cuda`).  :mod:`.cuda_build` compiles it with
``nvcc`` for ``sm_90a`` into a shared library with plain C entry points at
first CUDA use, and it is called through ``ctypes`` on PyTorch's current
stream.  Nothing here runs at import: CPU-only machines import this module
freely.

``LAUNCHES`` and ``LAUNCHES_MOVES`` count the launches of the two kernels,
so a run can show that its DP went through them.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cuda_build import check_tensor as _check

LIBRARY = "mecat_dp"
#: the C entry point's answer to a shape the kernel does not take
#: (cudaErrorInvalidValue); the geometry checks live in the .cu file
_INVALID_VALUE = 1

#: launches of the counts-only kernel since process start (or the caller's
#: reset)
LAUNCHES = 0
#: launches of the move-writing kernel
LAUNCHES_MOVES = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        cuda_build.build(LIBRARY)
        lib = ctypes.CDLL(cuda_build.lib_path(LIBRARY))
        for fn, n_ptr in ((lib.mecat_dp_segment_best, 9),
                          (lib.mecat_dp_segment_best_moves, 10)):
            fn.argtypes = ([ctypes.c_void_p] * n_ptr
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(q_seg, tpad, tmax, seg_q, active, S: int, W: int,
            with_moves: bool):
    """Check the inputs, allocate the outputs and launch one of the two
    kernels.  Returns (r, w, v, moves or None); no counter is touched."""
    if q_seg.device.type != "cuda":
        raise ValueError(f"DP kernel needs CUDA tensors, got {q_seg.device}")
    B = q_seg.shape[0]
    dev = q_seg.device
    _check("q_seg", q_seg, torch.uint8, (B, S), dev)
    _check("tpad", tpad, torch.uint8, (B, S + W), dev)
    _check("tmax", tmax, torch.int32, (B,), dev)
    _check("seg_q", seg_q, torch.int32, (B,), dev)
    _check("active", active, torch.bool, (B,), dev)
    lib = _load()
    r = torch.empty(B, dtype=torch.int32, device=dev)
    w = torch.empty(B, dtype=torch.int32, device=dev)
    v = torch.empty(B, dtype=torch.int32, device=dev)
    # the kernel writes every word: zeros in the rows it does not compute
    moves = (torch.empty((B, S, max(W // 16, 1)), dtype=torch.int32,
                         device=dev) if with_moves else None)
    if B == 0:
        return r, w, v, moves
    # scratch: the kernel's warps count the lanes they have taken in it
    next_lane = torch.empty(1, dtype=torch.int32, device=dev)
    ptrs = [q_seg.data_ptr(), tpad.data_ptr(), tmax.data_ptr(),
            seg_q.data_ptr(), active.data_ptr(), r.data_ptr(), w.data_ptr(),
            v.data_ptr()]
    fn = lib.mecat_dp_segment_best
    if with_moves:
        ptrs.append(moves.data_ptr())
        fn = lib.mecat_dp_segment_best_moves
    ptrs.append(next_lane.data_ptr())
    with torch.cuda.device(dev):
        rc = fn(*ptrs, B, S, W, torch.cuda.current_stream().cuda_stream)
    if rc == _INVALID_VALUE:
        raise ValueError(f"the DP kernel does not take S={S}, W={W} "
                         "(see mecat_tpu_torch/csrc/dp_segment.cu)")
    if rc != 0:
        raise RuntimeError(f"DP kernel launch failed: CUDA error {rc}")
    return r, w, v, moves


def dp_segment_best_cuda(q_seg: torch.Tensor, tpad: torch.Tensor,
                         tmax: torch.Tensor, seg_q: torch.Tensor,
                         active: torch.Tensor, S: int, W: int):
    """Launch the counts-only kernel; returns (r_best, w_best, v_best)
    int32 [B].

    q_seg uint8 [B, S]; tpad uint8 [B, S+W] framed window; tmax, seg_q int32
    [B]; active bool [B].  Raises on anything the kernel does not take.
    """
    global LAUNCHES
    r, w, v, _ = _launch(q_seg, tpad, tmax, seg_q, active, S, W, False)
    if q_seg.shape[0]:
        LAUNCHES += 1
    return r, w, v


def dp_segment_best_moves_cuda(q_seg: torch.Tensor, tpad: torch.Tensor,
                               tmax: torch.Tensor, seg_q: torch.Tensor,
                               active: torch.Tensor, S: int, W: int):
    """Launch the move-writing kernel; returns (moves, r_best, w_best,
    v_best): moves int32 [B, S, W/16], 16 2-bit codes per word, zero in the
    rows the kernel did not compute (past ``min(seg_q, tmax + W/2)``) and in
    inactive lanes; the rest as :func:`dp_segment_best_cuda`.
    """
    global LAUNCHES_MOVES
    r, w, v, moves = _launch(q_seg, tpad, tmax, seg_q, active, S, W, True)
    if q_seg.shape[0]:
        LAUNCHES_MOVES += 1
    return moves, r, w, v
