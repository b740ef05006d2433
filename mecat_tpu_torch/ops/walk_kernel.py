"""Build, bind and launch the Hopper kernels of the device scans
(csrc/cns_walk.cu): the row walk, the deposit scan and the column walk.

Each replaces a ``lax.scan`` of the JAX package that the port's plain
version runs as a Python loop of small torch ops:

- :func:`traceback_rows_cuda`: ``mecat_tpu/ops/align.py:traceback_rows``
  (plain version :func:`..ops.align.traceback_rows_plain`);
- :func:`deposit_scan_cuda`: ``mecat_tpu/ops/consensus_banded.py:
  _deposit_scan`` (plain version
  :func:`..ops.consensus_banded.deposit_scan_plain`);
- :func:`traceback_ops_cuda`: the walk of ``mecat_tpu/ops/align.py:
  traceback_ops`` (plain version :func:`..ops.align.traceback_ops_plain`).

:mod:`.cuda_build` compiles the source with ``nvcc`` for ``sm_90a`` into a
shared library with plain C entry points at first CUDA use, and it is
called through ``ctypes`` on PyTorch's current stream.  Nothing here runs
at import: CPU-only machines import this module freely.

``LAUNCHES_ROWS``, ``LAUNCHES_DEPOSIT`` and ``LAUNCHES_COLS`` count the
launches of the three kernels, so a run can show that its scans went
through them; :func:`launches` reads all three under the keys the metrics
summaries print.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cuda_build import check_tensor as _check
from .dp_kernel import check_band

LIBRARY = "mecat_walk"
#: the C entry points' answer to a shape the kernels do not take
#: (cudaErrorInvalidValue); the geometry checks live in the .cu file
_INVALID_VALUE = 1

#: launches of the row walk since process start (or the caller's reset)
LAUNCHES_ROWS = 0
#: launches of the deposit scan
LAUNCHES_DEPOSIT = 0
#: launches of the column walk
LAUNCHES_COLS = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        cuda_build.build(LIBRARY)
        lib = ctypes.CDLL(cuda_build.lib_path(LIBRARY))
        for fn, n_ptr, n_int in ((lib.mecat_walk_rows, 7, 3),
                                 (lib.mecat_walk_deposit, 10, 3),
                                 (lib.mecat_walk_cols, 5, 4)):
            fn.argtypes = ([ctypes.c_void_p] * n_ptr
                           + [ctypes.c_int] * n_int + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launches() -> dict:
    """The three launch counters, by the keys of the metrics summaries."""
    return {"walk_launches_rows": LAUNCHES_ROWS,
            "walk_launches_deposit": LAUNCHES_DEPOSIT,
            "walk_launches_cols": LAUNCHES_COLS}


def launches_since(before: dict) -> dict:
    """Launches of each kernel since ``before`` (a :func:`launches`)."""
    return {k: v - before[k] for k, v in launches().items()}


def _device_of(name: str, t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the walk kernels need CUDA tensors, {name} is on "
                         f"{t.device}")
    return t.device


def _call(fn, ptrs, ints, dev, what: str) -> None:
    with torch.cuda.device(dev):
        rc = fn(*ptrs, *ints, torch.cuda.current_stream().cuda_stream)
    if rc == _INVALID_VALUE:
        raise ValueError(f"the {what} kernel does not take {ints} "
                         "(see mecat_tpu_torch/csrc/cns_walk.cu)")
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _walk_inputs(moves, seg_qlen, w_end, W: int):
    dev = _device_of("moves", moves)
    if moves.dim() != 3:
        raise ValueError(f"moves has shape {tuple(moves.shape)}, expected "
                         f"[N, S, W/16]")
    N, S, _ = moves.shape
    _check("moves", moves, torch.int32, (N, S, W // 16), dev)
    _check("seg_qlen", seg_qlen, torch.int32, (N,), dev)
    _check("w_end", w_end, torch.int32, (N,), dev)
    return dev, N, S


def traceback_rows_cuda(moves: torch.Tensor, seg_qlen: torch.Tensor,
                        w_end: torch.Tensor, W: int):
    """Launch the row walk; returns (mv, h, w_out) int32 [N, S] and w0
    int32 [N] as :func:`..ops.align.traceback_rows_plain`.

    moves int32 [N, S, W/16]; seg_qlen, w_end int32 [N]; W a multiple of 16
    in [BAND_MIN, BAND_MAX] (:func:`.dp_kernel.check_band`, checked before
    anything is built).  Raises on anything the kernel does not take.
    """
    global LAUNCHES_ROWS
    dev, N, S = _walk_inputs(moves, seg_qlen, w_end, W)
    check_band(W)
    mv, h, wo = (torch.empty((N, S), dtype=torch.int32, device=dev)
                 for _ in range(3))
    w0 = torch.empty(N, dtype=torch.int32, device=dev)
    if N:
        _call(_load().mecat_walk_rows,
              [t.data_ptr() for t in (moves, seg_qlen, w_end, mv, h, wo,
                                      w0)], (N, S, W), dev, "row walk")
        LAUNCHES_ROWS += 1
    return mv, h, wo, w0


def deposit_scan_cuda(wo, aw, h, mv, vbase, delta, keep_ins, W: int):
    """Launch the deposit scan; returns (val0 int8, ipack int32, icnt
    int32) planes [N, S + W/2 - 1] as
    :func:`..ops.consensus_banded.deposit_scan_plain`.

    wo, aw, h, mv, vbase, delta int32 [N, S]; keep_ins bool [N, S].
    Raises on anything the kernel does not take.
    """
    global LAUNCHES_DEPOSIT
    dev = _device_of("wo", wo)
    if wo.dim() != 2:
        raise ValueError(f"wo has shape {tuple(wo.shape)}, expected [N, S]")
    N, S = wo.shape
    for name, t in (("wo", wo), ("aw", aw), ("h", h), ("mv", mv),
                    ("vbase", vbase), ("delta", delta)):
        _check(name, t, torch.int32, (N, S), dev)
    _check("keep_ins", keep_ins, torch.bool, (N, S), dev)
    LP = S + W // 2 - 1
    val0 = torch.empty((N, LP), dtype=torch.int8, device=dev)
    ipack, icnt = (torch.empty((N, LP), dtype=torch.int32, device=dev)
                   for _ in range(2))
    if N:
        _call(_load().mecat_walk_deposit,
              [t.data_ptr() for t in (wo, aw, h, mv, vbase, delta, keep_ins,
                                      val0, ipack, icnt)],
              (N, S, W), dev, "deposit scan")
        LAUNCHES_DEPOSIT += 1
    return val0, ipack, icnt


def traceback_ops_cuda(moves: torch.Tensor, seg_qlen: torch.Tensor,
                       w_end: torch.Tensor, W: int, max_cols: int):
    """Launch the column walk; returns (ops int8 [N, max_cols], n_cols
    int32 [N]): the right-aligned tape and its length, as the walk of
    :func:`..ops.align.traceback_ops_plain`.

    moves int32 [N, S, W/16]; seg_qlen, w_end int32 [N]; W as
    :func:`traceback_rows_cuda`.  Raises on anything the kernel does not
    take.
    """
    global LAUNCHES_COLS
    dev, N, S = _walk_inputs(moves, seg_qlen, w_end, W)
    check_band(W)
    ops = torch.empty((N, max_cols), dtype=torch.int8, device=dev)
    n_cols = torch.empty(N, dtype=torch.int32, device=dev)
    if N:
        _call(_load().mecat_walk_cols,
              [t.data_ptr() for t in (moves, seg_qlen, w_end, ops, n_cols)],
              (N, S, W, max_cols), dev, "column walk")
        LAUNCHES_COLS += 1
    return ops, n_cols
