"""The row-update micro-benchmark family: Hopper kernel, wrapper, plain version.

Port of the Pallas kernel family of ``tools/roll_micro.py`` (``build_call``,
body ``make_kernel``): five variants of the counts-only DP row-update loop,
selected by ``(rolls, best)``, that time the row update with one cost
removed at a time.  Each variant is a well-defined integer function;
``noroll`` and ``baremin`` are not an alignment, on purpose.

:func:`roll_micro` launches ``csrc/roll_micro.cu`` for CUDA tensors (or
raises) and runs :func:`roll_micro_plain`, a torch row loop that restates
the Pallas body literally, for CPU tensors.  Layout is lane-major like the
port's other kernels: ``q`` uint8 [B, S], ``t`` uint8 [B, S + W], ``tmax``
and ``segq`` int32 [B], result int32 [B, 8] (the Pallas family is
band-major: transpose to compare).  ``LAUNCHES`` counts the kernel's
launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cuda_build import check_tensor as _check

LIBRARY = "mecat_roll_micro"
VINF = 1 << 30
_NEG = -(1 << 26)
IND_K = 4096
_K1 = IND_K + 1
PENALTY = 2

#: name -> (rolls, best), as tools/roll_micro.py names them
VARIANTS = {
    "full": (True, "log"),
    "noroll": (False, "log"),
    "nobest": (True, "none"),
    "elembest": (True, "elem"),
    "baremin": (False, "none"),
}
_BEST_CODE = {"none": 0, "log": 1, "elem": 2}
_INVALID_VALUE = 1      # cudaErrorInvalidValue

#: launches of the kernel (any variant) since process start or the caller's
#: reset
LAUNCHES = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        cuda_build.build(LIBRARY)
        lib = ctypes.CDLL(cuda_build.lib_path(LIBRARY))
        lib.mecat_roll_micro.argtypes = ([ctypes.c_void_p] * 5
                                         + [ctypes.c_int] * 5
                                         + [ctypes.c_void_p])
        lib.mecat_roll_micro.restype = ctypes.c_int
        _lib = lib
    return _lib


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor wrapped into int32 as two's complement arithmetic
    does (JAX's int32 multiply wraps; int64 here keeps it defined)."""
    return (torch.remainder(x + (1 << 31), 1 << 32) - (1 << 31)).to(
        torch.int32)


def roll_micro_plain(q: torch.Tensor, t: torch.Tensor, tmax: torch.Tensor,
                     segq: torch.Tensor, S: int, W: int, rolls: bool,
                     best: str) -> torch.Tensor:
    """Plain PyTorch version of the family: the Pallas body, row by row.

    q uint8 [B, S]; t uint8 [B, S + W]; tmax, segq int32 [B]; ``rolls``
    False replaces the vertical neighbour and the closure's shifted operand
    by the cell itself; ``best`` is "log", "elem" or "none".  Returns int32
    [B, 8]: log (row, cell, value, score, 0...), elem ((-kmax) % 1024, cell,
    value, 0...), none the last row's first 8 band cells.
    """
    B = q.shape[0]
    dev = q.device
    half = W // 2
    w_idx = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    tmax_c = tmax[:, None]
    segq_c = segq[:, None]
    j0 = w_idx - half
    prev = torch.where((j0 >= 0) & (j0 <= tmax_c), j0.clamp(min=0) * _K1,
                       VINF).to(torch.int32)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    if best == "elem":
        bs = torch.full((B, W), _NEG, dtype=torch.int32, device=dev)
        bd = torch.full((B, W), VINF, dtype=torch.int32, device=dev)
    else:
        bs, br, bd = zero, zero, zero
        bw = torch.full((B,), half, dtype=torch.int32, device=dev)
    for i in range(1, S + 1):
        qc = q[:, i - 1:i].to(torch.int32)
        td = t[:, i - 1:i - 1 + W].to(torch.int32)
        sub = (qc != td).to(torch.int32)
        diag = prev + sub * IND_K
        vsrc = torch.roll(prev, shifts=W - 1, dims=1) if rolls else prev
        vert = torch.where(w_idx < W - 1, vsrc, VINF) + _K1
        cand = torch.minimum(diag, vert)
        j = i - half + w_idx
        valid = (j >= 0) & (j <= tmax_c)
        cand = torch.where(valid, cand, VINF)
        y = cand - w_idx * _K1
        k = 1
        while k < W:
            ysrc = torch.roll(y, shifts=k, dims=1) if rolls else y
            y = torch.minimum(y, torch.where(w_idx >= k, ysrc, VINF))
            k *= 2
        cur = y + w_idx * _K1
        cur = torch.where(valid, cur.clamp(max=VINF), VINF)
        prev = cur
        if best == "none":
            continue
        dist = torch.div(cur, IND_K, rounding_mode="floor")
        score = torch.where(valid & (cur < VINF) & (i <= segq_c),
                            i + j - 2 * PENALTY * dist, _NEG)
        if best == "log":
            row_max = score.max(dim=1, keepdim=True).values
            row_arg = torch.where(score == row_max, w_idx, W).min(
                dim=1, keepdim=True).values
            row_d = torch.where(w_idx == row_arg, cur, VINF).min(dim=1).values
            row_max, row_arg = row_max[:, 0], row_arg[:, 0]
            upd = row_max > bs
            bs = torch.where(upd, row_max, bs)
            br = torch.where(upd, i, br)
            bw = torch.where(upd, row_arg, bw)
            bd = torch.where(upd, row_d, bd)
        else:
            # key = score * 1024 - i in wrapping int32: a masked score of
            # -2^26 gives -2^36, which wraps to 0
            key = _wrap32(score.long() * 1024 - i)
            upd = key > bs
            bs = torch.where(upd, key, bs)
            bd = torch.where(upd, cur, bd)
    out = torch.zeros((B, 8), dtype=torch.int32, device=dev)
    if best == "elem":
        kmax = bs.max(dim=1, keepdim=True).values
        warg = torch.where(bs == kmax, w_idx, W).min(dim=1,
                                                     keepdim=True).values
        vbest = torch.where(w_idx == warg, bd, VINF).min(dim=1).values
        out[:, 0] = torch.remainder(-kmax[:, 0], 1024)
        out[:, 1] = warg[:, 0]
        out[:, 2] = vbest
    elif best == "log":
        out[:, 0], out[:, 1], out[:, 2], out[:, 3] = br, bw, bd, bs
    else:
        out[:, :] = prev[:, :8]
    return out


def roll_micro_cuda(q: torch.Tensor, t: torch.Tensor, tmax: torch.Tensor,
                    segq: torch.Tensor, S: int, W: int, rolls: bool,
                    best: str) -> torch.Tensor:
    """Launch the kernel for one variant; returns int32 [B, 8].  Raises on
    anything the kernel does not take."""
    global LAUNCHES
    if q.device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {q.device}")
    if best not in _BEST_CODE:
        raise ValueError(f"best must be one of {sorted(_BEST_CODE)}")
    B = q.shape[0]
    dev = q.device
    _check("q", q, torch.uint8, (B, S), dev)
    _check("t", t, torch.uint8, (B, S + W), dev)
    _check("tmax", tmax, torch.int32, (B,), dev)
    _check("segq", segq, torch.int32, (B,), dev)
    lib = _load()
    out = torch.empty((B, 8), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        rc = lib.mecat_roll_micro(
            q.data_ptr(), t.data_ptr(), tmax.data_ptr(), segq.data_ptr(),
            out.data_ptr(), B, S, W, int(bool(rolls)), _BEST_CODE[best],
            torch.cuda.current_stream().cuda_stream)
    if rc == _INVALID_VALUE:
        raise ValueError(
            f"the kernel does not take S={S}, W={W}, rolls={rolls}, "
            f"best={best!r} (see mecat_tpu_torch/csrc/roll_micro.cu)")
    if rc != 0:
        raise RuntimeError(f"kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def roll_micro(q: torch.Tensor, t: torch.Tensor, tmax: torch.Tensor,
               segq: torch.Tensor, S: int, W: int, rolls: bool,
               best: str) -> torch.Tensor:
    """One variant on the tensors' device: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return roll_micro_plain(q, t, tmax, segq, S, W, rolls, best)
    return roll_micro_cuda(q, t, tmax, segq, S, W, rolls, best)
