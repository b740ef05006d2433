"""Build, bind and launch the Hopper DP-segment kernels (csrc/dp_segment.cu).

The source replaces ``mecat_tpu/ops/pallas_dp.py:_dp_kernel`` in both forms:
counts only (:func:`dp_segment_best_cuda`) and move-writing
(:func:`dp_segment_best_moves_cuda`), and the reference's device loops
around them in ``mecat_tpu/ops/align.py:_extend_direction_impl``: the
counts ``while_loop`` (:func:`extend_counts_cuda`) and the move-writing
``scan`` (:func:`extend_moves_cuda`), each lane's whole segment loop in one
launch.  Their plain version is the host loop of
:func:`..ops.align._extend_direction_impl` on
:func:`..ops.align.dp_segment_best_plain`;
:func:`..ops.align.extend_moves_plain` fills the move loop's slots lane by
lane as the kernel does.  Every kernel
takes the band widths of :func:`check_band`.  :mod:`.cuda_build` compiles
the source with ``nvcc`` for ``sm_90a`` into a shared library with plain C
entry points at first CUDA use, and it is called through ``ctypes`` on
PyTorch's current stream.  Nothing here runs at import: CPU-only machines
import this module freely.

``LAUNCHES``, ``LAUNCHES_MOVES``, ``LAUNCHES_EXTEND`` and
``LAUNCHES_EXTEND_MOVES`` count the launches of the four kernels, so a run
can show that its DP went through them; :func:`launches` reads them under
the keys the metrics summaries print.  ``LAUNCHES_CLUSTER`` counts those of
them made at a band past ``BAND_BLOCK_MAX``, where a lane is a thread-block
cluster (the cluster route).
"""
from __future__ import annotations

import ctypes

import numpy as np
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
#: launches of the counts-only segment-loop kernel
LAUNCHES_EXTEND = 0
#: launches of the move-writing segment-loop kernel
LAUNCHES_EXTEND_MOVES = 0
#: launches of any of the four at a band past BAND_BLOCK_MAX (the cluster
#: route), not among :func:`launches`' keys
LAUNCHES_CLUSTER = 0

#: the band widths the kernels take: multiples of 16 in [BAND_MIN, BAND_MAX].
#: Past 512 a lane of the DP kernels is a block of W/512 warps (rounded up),
#: each with a ring of move rows of 36 KB in shared memory; six rings fit
#: the 227 KB a block can have, seven do not, so past BAND_BLOCK_MAX a lane
#: is a thread-block cluster of up to eight such blocks (see
#: :func:`check_band`)
BAND_MIN = 16
BAND_BLOCK_MAX = 3072
BAND_MAX = 8 * BAND_BLOCK_MAX

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
        lib.mecat_extend_counts.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_void_p])
        lib.mecat_extend_counts.restype = ctypes.c_int
        lib.mecat_extend_moves.argtypes = (
            [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p])
        lib.mecat_extend_moves.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_band(W: int) -> None:
    """Raise ValueError unless the kernels take band width ``W``: every
    multiple of 16 from BAND_MIN to BAND_MAX.

    The reference computes any multiple of 16.  What sets the ceiling, for
    each kernel at S = 512:

    - the DP kernels (both per-segment kernels and both loops): shared
      memory and the cluster size.  Up to 512 a warp holds the band; past
      it a lane takes a warp for each 512 cells, and each warp of the
      move-writing kernels keeps its own ring of 288 move rows of 128 bytes
      (36 KB).  Six rings and the lane's staging fit the 227 KB of shared
      memory a block of an H100 can have, seven (252 KB) do not, so a block
      holds a lane up to BAND_BLOCK_MAX = 6 * 512.  Past it a lane is a
      thread-block cluster of up to 8 such blocks, the portable cluster
      size, their border values crossing through distributed shared
      memory: W <= 8 * 3072.  Further, a lane would need more than 8 SMs.
      S limits too, through the staging beside the rings: a block lane
      stages 2 (S + 512 n) bytes (S <= 2,560 at W = 3072), a cluster
      lane's block 2 S + 512 p for its p slices (S <= 4,000 at p = 6);
      past that the C side refuses the shape (ValueError);
    - the row and the column walk: a lane's ring of 32 rows of W/4 bytes
      in shared memory, fewer lanes a block as W grows, one from 14,528 on
      (192 KB at 24,576; one lane would fit up to about 29,000);
    - the deposit scan: three accumulators of S + W/2 - 1 words a lane in
      shared memory, 150 KB at (512, 24,576); they fit while S + W/2 stays
      below about 19,300 (W about 37,000 at S = 512), and the C side
      refuses beyond;
    - the tag fold's two kernels: no limit of their own but int32
      addressing (deposit planes below 2^31 cells, which their C side
      checks).

    Checked before anything is built or launched."""
    if W % 16 or not BAND_MIN <= W <= BAND_MAX:
        raise ValueError(f"the CUDA kernels take band widths W that are "
                         f"multiples of 16 in [{BAND_MIN}, {BAND_MAX}], "
                         f"got W={W}")


def launches() -> dict:
    """The four launch counters, by the keys of the metrics summaries."""
    return {"dp_launches": LAUNCHES, "dp_launches_moves": LAUNCHES_MOVES,
            "dp_launches_extend": LAUNCHES_EXTEND,
            "dp_launches_extend_moves": LAUNCHES_EXTEND_MOVES}


def launches_since(before: dict) -> dict:
    """Launches of each kernel since ``before`` (a :func:`launches`)."""
    return {k: v - before[k] for k, v in launches().items()}


def _counted(W: int) -> None:
    """Count a launch at band W on the cluster route, if it takes it."""
    global LAUNCHES_CLUSTER
    if W > BAND_BLOCK_MAX:
        LAUNCHES_CLUSTER += 1


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
    check_band(W)
    lib = _load()
    r = torch.empty(B, dtype=torch.int32, device=dev)
    w = torch.empty(B, dtype=torch.int32, device=dev)
    v = torch.empty(B, dtype=torch.int32, device=dev)
    # the kernel writes every word: zeros in the rows it does not compute
    moves = (torch.empty((B, S, W // 16), dtype=torch.int32,
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
        _counted(W)
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
        _counted(W)
    return moves, r, w, v


def _extend_inputs(q_pad, t_pad, q0, t0, qlen, tlen, W: int, what: str):
    """Check the segment-loop kernels' inputs; returns (device, N, Lq, Lt)."""
    if q_pad.device.type != "cuda":
        raise ValueError(f"the {what} kernel needs CUDA tensors, got "
                         f"{q_pad.device}")
    if q_pad.dim() != 2 or t_pad.dim() != 2:
        raise ValueError(f"q_pad and t_pad must be [N, L], got "
                         f"{tuple(q_pad.shape)} and {tuple(t_pad.shape)}")
    N, Lq = q_pad.shape
    Lt = t_pad.shape[1]
    dev = q_pad.device
    _check("q_pad", q_pad, torch.uint8, (N, Lq), dev)
    _check("t_pad", t_pad, torch.uint8, (N, Lt), dev)
    for name, t in (("q0", q0), ("t0", t0), ("qlen", qlen), ("tlen", tlen)):
        _check(name, t, torch.int32, (N,), dev)
    check_band(W)
    return dev, N, Lq, Lt


def _extend_rc(rc: int, what: str, S: int, W: int, Lq: int, Lt: int):
    if rc == _INVALID_VALUE:
        raise ValueError(f"the {what} kernel does not take S={S}, W={W}, "
                         f"rows of {Lq} and {Lt} bytes (see "
                         "mecat_tpu_torch/csrc/dp_segment.cu)")
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def extend_counts_cuda(q_pad: torch.Tensor, t_pad: torch.Tensor,
                       q0: torch.Tensor, t0: torch.Tensor,
                       qlen: torch.Tensor, tlen: torch.Tensor, *, S: int,
                       W: int, max_segs: int, min_seg_identity: float):
    """Launch the counts-only segment loop of one direction; returns
    (qoff, toff, dist, matches, alen, nsegs) int32 [N], the fields of
    :class:`..ops.align.ExtensionResult` (views of one [6, N] buffer).

    q_pad uint8 [N, Lq] query rows padded for the last window; t_pad uint8
    [N, Lt] target rows with W/2 leading sentinels; q0, t0, qlen, tlen int32
    [N] as :func:`..ops.align._extend_direction_impl` takes them.  The
    identity threshold is rounded to float32 here, as the plain version's
    comparison rounds it.  Raises ValueError on CPU tensors and on a band
    the kernel does not take (before anything is built) and on what else
    the kernel does not take, RuntimeError on a CUDA error.
    """
    global LAUNCHES_EXTEND
    dev, N, Lq, Lt = _extend_inputs(q_pad, t_pad, q0, t0, qlen, tlen, W,
                                    "segment-loop")
    out = torch.empty((6, N), dtype=torch.int32, device=dev)
    if N:
        lib = _load()
        # scratch: the kernel's warps count the lanes they have taken in it
        next_lane = torch.empty(1, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.mecat_extend_counts(
                *(t.data_ptr() for t in (q_pad, t_pad, q0, t0, qlen, tlen,
                                         out, next_lane)),
                N, S, W, Lq, Lt, max_segs,
                float(np.float32(min_seg_identity)),
                torch.cuda.current_stream().cuda_stream)
        _extend_rc(rc, "segment-loop", S, W, Lq, Lt)
        LAUNCHES_EXTEND += 1
        _counted(W)
    return tuple(out.unbind(0))


def extend_moves_cuda(q_pad: torch.Tensor, t_pad: torch.Tensor,
                      q0: torch.Tensor, t0: torch.Tensor,
                      qlen: torch.Tensor, tlen: torch.Tensor, *, S: int,
                      W: int, max_segs: int, min_seg_identity: float,
                      split: int | None = None,
                      max_segs_b: int | None = None):
    """Launch the move-writing segment loop: every lane's segments in one
    launch, each segment kept in its slot.  Lanes below ``split`` (default
    N) run at most ``max_segs`` segments, the others ``max_segs_b``
    (default ``max_segs``).

    Inputs as :func:`extend_counts_cuda`.  Returns (final, slots): final
    the six int32 [N] fields of :class:`..ops.align.ExtensionResult`;
    slots (moves int32 [G, N, S, W/16], r_end, w_end, qoff_before,
    toff_before int32 [G, N], ok bool [G, N]) with G = max(max_segs,
    max_segs_b), written for the slots k < nsegs[b] of each lane b only
    (the rest is uninitialised; :func:`..ops.align.slots_to_raw` fills it).
    Raises as :func:`extend_counts_cuda`.
    """
    global LAUNCHES_EXTEND_MOVES
    dev, N, Lq, Lt = _extend_inputs(q_pad, t_pad, q0, t0, qlen, tlen, W,
                                    "move-loop")
    split = N if split is None else split
    max_segs_b = max_segs if max_segs_b is None else max_segs_b
    G = max(max_segs, max_segs_b, 1)
    out = torch.empty((6, N), dtype=torch.int32, device=dev)
    moves = torch.empty((G, N, S, W // 16), dtype=torch.int32, device=dev)
    small = [torch.empty((G, N), dtype=torch.int32, device=dev)
             for _ in range(4)]
    ok = torch.empty((G, N), dtype=torch.bool, device=dev)
    if N:
        lib = _load()
        next_lane = torch.empty(1, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.mecat_extend_moves(
                *(t.data_ptr() for t in (q_pad, t_pad, q0, t0, qlen, tlen,
                                         out, moves, *small, ok,
                                         next_lane)),
                N, S, W, Lq, Lt, max_segs, split, max_segs_b,
                float(np.float32(min_seg_identity)),
                torch.cuda.current_stream().cuda_stream)
        _extend_rc(rc, "move-loop", S, W, Lq, Lt)
        LAUNCHES_EXTEND_MOVES += 1
        _counted(W)
    return tuple(out.unbind(0)), (moves, *small, ok)
