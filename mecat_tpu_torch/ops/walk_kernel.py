"""Build, bind and launch the Hopper kernels of correction's and mapping's
device scans: the row walk, the deposit scan and the column walk
(csrc/cns_walk.cu), and the tag fold's planes and fold (csrc/cns_fold.cu).

Each replaces a device scan of the JAX package that the port's plain
version runs as a Python loop of small torch ops:

- :func:`traceback_rows_cuda`: ``mecat_tpu/ops/align.py:traceback_rows``
  (plain version :func:`..ops.align.traceback_rows_plain`);
- :func:`deposit_rows_cuda`: both directions' ``mecat_tpu/ops/
  consensus_banded.py:direction_rowinfo`` and their ``_deposit_scan``
  (plain version :func:`..ops.consensus_banded.plane_inputs_plain`);
- :func:`traceback_ops_cuda`: the walk of ``mecat_tpu/ops/align.py:
  traceback_ops`` (plain version :func:`..ops.align.traceback_ops_plain`);
- :func:`global_planes_cuda`: the window write, placement and side-band
  chains of ``mecat_tpu/ops/consensus_banded.py:banded_global_planes``
  (plain version :func:`..ops.consensus_banded.banded_global_planes_plain`);
- :func:`fold_tags_cuda`: the presence fold and ``cov_diff`` of
  ``mecat_tpu/ops/consensus_banded.py:banded_accumulate_tags`` (plain
  version :func:`..ops.consensus_banded.fold_tags_plain`).

:mod:`.cuda_build` compiles each source with ``nvcc`` for ``sm_90a`` into a
shared library with plain C entry points at first CUDA use, and it is
called through ``ctypes`` on PyTorch's current stream.  Nothing here runs
at import: CPU-only machines import this module freely.

``LAUNCHES_ROWS``, ``LAUNCHES_DEPOSIT``, ``LAUNCHES_COLS``,
``LAUNCHES_PLANES`` and ``LAUNCHES_FOLD`` count the launches of the five
kernels, so a run can show that its scans went through them;
:func:`launches` reads them all under the keys the metrics summaries print.
"""
from __future__ import annotations

import ctypes

import torch

from .. import constants as C
from . import cuda_build
from .cuda_build import check_tensor as _check
from .dp_kernel import check_band

_D1 = C.MAX_INS_DELTA + 1  # the delta rows of a counts column

LIBRARY = "mecat_walk"
LIBRARY_FOLD = "mecat_fold"
#: the C entry points' answer to a shape the kernels do not take
#: (cudaErrorInvalidValue); the geometry checks live in the .cu file
_INVALID_VALUE = 1

#: launches of the row walk since process start (or the caller's reset)
LAUNCHES_ROWS = 0
#: launches of the deposit scan (with the row information inside)
LAUNCHES_DEPOSIT = 0
#: launches of the column walk
LAUNCHES_COLS = 0
#: launches of the tag fold's planes kernel
LAUNCHES_PLANES = 0
#: launches of the tag fold's fold kernel
LAUNCHES_FOLD = 0

#: library name -> loaded ctypes library
_libs: dict = {}
#: each library's entry points: (name, pointer arguments, int arguments)
_ENTRIES = {
    LIBRARY: (("mecat_walk_rows", 7, 3), ("mecat_walk_deposit_rows", 21, 6),
              ("mecat_walk_cols", 5, 4)),
    LIBRARY_FOLD: (("mecat_fold_planes", 21, 6), ("mecat_fold_tags", 10, 3)),
}


def _load(name: str):
    """Library ``name``, built and bound at its first use."""
    if name not in _libs:
        cuda_build.build(name)
        lib = ctypes.CDLL(cuda_build.lib_path(name))
        for entry, n_ptr, n_int in _ENTRIES[name]:
            fn = getattr(lib, entry)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr
                           + [ctypes.c_int] * n_int + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def launches() -> dict:
    """The five launch counters, by the keys of the metrics summaries."""
    return {"walk_launches_rows": LAUNCHES_ROWS,
            "walk_launches_deposit": LAUNCHES_DEPOSIT,
            "walk_launches_cols": LAUNCHES_COLS,
            "walk_launches_planes": LAUNCHES_PLANES,
            "walk_launches_fold": LAUNCHES_FOLD}


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
                         "(see its source under mecat_tpu_torch/csrc/)")
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
        _call(_load(LIBRARY).mecat_walk_rows,
              [t.data_ptr() for t in (moves, seg_qlen, w_end, mv, h, wo,
                                      w0)], (N, S, W), dev, "row walk")
        LAUNCHES_ROWS += 1
    return mv, h, wo, w0


def deposit_rows_args(right_rows, left_rows, q, qseed, *, S: int, W: int,
                      device) -> tuple:
    """Check the fused deposit's inputs (those of
    :func:`..ops.consensus_banded.plane_inputs`) against what the kernel
    takes, on ``device``; returns (B, L_s, G_r, G_l).  Raises on anything
    the kernel does not take."""
    if q.dim() != 2:
        raise ValueError(f"q has shape {tuple(q.shape)}, expected [B, L_s]")
    if W < 2 or W % 2 or S < 1:
        raise ValueError(f"the deposit kernel does not take S={S}, W={W}")
    B, L_s = q.shape
    _check("q", q, torch.uint8, (B, L_s), device)
    _check("qseed", qseed, torch.int32, (B,), device)
    Gs = []
    for tag, rows in (("r", right_rows), ("l", left_rows)):
        if rows[0].dim() != 3:
            raise ValueError(f"mv_{tag} has shape {tuple(rows[0].shape)}, "
                             f"expected [G, B, S]")
        G = rows[0].shape[0]
        for name, t in zip(("mv", "h", "wo", "w0", "qoff", "toff"), rows):
            _check(f"{name}_{tag}", t, torch.int32,
                   (G, B, S) if name in ("mv", "h", "wo") else (G, B),
                   device)
        _check(f"ok_{tag}", rows[6], torch.bool, (G, B), device)
        Gs.append(G)
    return (B, L_s, *Gs)


def deposit_rows_cuda(right_rows, left_rows, q, qseed, *, S: int, W: int):
    """Launch the deposit on both directions' row walks, the row
    information made inside it; returns (planes_r, planes_l, side_r,
    side_l, lj_end) as :func:`..ops.consensus_banded.plane_inputs_plain`:
    each direction's planes (val0 int8, ipack, icnt int32) [G, B, S + W/2
    - 1] and side arrays (toff, ok, lead, bnd_pack, bnd_cnt) [G, B] (toff
    and ok the inputs' own), views of one output of each array, right
    first; the left direction's j_end [G_l, B].

    right_rows, left_rows: (mv, h, wo int32 [G, B, S], w0, qoff, toff int32
    [G, B], ok bool [G, B]) as ``ops/align.rows_from_moves`` makes them; q
    uint8 [B, L_s]; qseed int32 [B].  Raises on anything the kernel does
    not take.
    """
    global LAUNCHES_DEPOSIT
    dev = _device_of("q", q)
    B, L_s, G_r, G_l = deposit_rows_args(right_rows, left_rows, q, qseed,
                                         S=S, W=W, device=dev)
    LP = S + W // 2 - 1
    G2 = G_r + G_l
    # each output is one buffer, cut by one split a buffer (the host
    # launches few ops a chunk)
    val0 = torch.empty((G2, B, LP), dtype=torch.int8, device=dev)
    ipack, icnt = (torch.empty((G2, B, LP), dtype=torch.int32, device=dev)
                   for _ in range(2))
    # lead, bnd_pack and bnd_cnt
    side = torch.empty((3, G2, B), dtype=torch.int32, device=dev)
    j_end = torch.empty((G_l, B), dtype=torch.int32, device=dev)
    if G2 * B:
        _call(_load(LIBRARY).mecat_walk_deposit_rows,
              [t.data_ptr() for t in (*right_rows[:5], right_rows[6],
                                      *left_rows[:5], left_rows[6], q, qseed,
                                      val0, ipack, icnt)]
              + [side.data_ptr() + 4 * G2 * B * k for k in range(3)]
              + [j_end.data_ptr()],
              (G_r * B, G_l * B, B, S, W, L_s), dev, "deposit")
        LAUNCHES_DEPOSIT += 1
    planes = [a.split((G_r, G_l)) for a in (val0, ipack, icnt)]
    side_r, side_l = (x.unbind(0) for x in side.split((G_r, G_l), dim=1))
    return (tuple(p[0] for p in planes), tuple(p[1] for p in planes),
            (right_rows[5], right_rows[6], *side_r),
            (left_rows[5], left_rows[6], *side_l), j_end)


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
        _call(_load(LIBRARY).mecat_walk_cols,
              [t.data_ptr() for t in (moves, seg_qlen, w_end, ops, n_cols)],
              (N, S, W, max_cols), dev, "column walk")
        LAUNCHES_COLS += 1
    return ops, n_cols


def _check_aligned(name: str, t: torch.Tensor, to: int) -> None:
    if t.data_ptr() % to:
        raise ValueError(f"{name} is not {to}-byte aligned")


def planes_args(planes_r, planes_l, side_r, side_l, lj_end, tseed, *,
                L_t: int, S: int, W: int, device) -> tuple:
    """Check the planes kernel's inputs (the arguments of
    :func:`..ops.consensus_banded.banded_global_planes_plain`) against
    what it takes, on ``device``; returns (B, G_r, G_l, the pointers in the
    entry point's order).  Raises on anything the kernel does not take."""
    if tseed.dim() != 1:
        raise ValueError(f"tseed has shape {tuple(tseed.shape)}, expected "
                         f"[B]")
    if W < 2 or W % 2 or S < 1 or L_t < 0:
        raise ValueError(f"the planes kernel does not take S={S}, W={W}, "
                         f"L_t={L_t}")
    B = tseed.shape[0]
    LP = S + W // 2 - 1
    G_r, G_l = (p[0].shape[0] if p[0].dim() == 3 else -1
                for p in (planes_r, planes_l))
    for tag, G, planes, side in (("r", G_r, planes_r, side_r),
                                 ("l", G_l, planes_l, side_l)):
        for name, t, dt in zip(("val0", "ipack", "icnt"), planes,
                               (torch.int8, torch.int32, torch.int32)):
            _check(f"{name}_{tag}", t, dt, (G, B, LP), device)
        for name, t in zip(("toff", "ok", "lead", "bnd_pack", "bnd_cnt"),
                           side):
            _check(f"{name}_{tag}", t,
                   torch.bool if name == "ok" else torch.int32, (G, B),
                   device)
    _check("lj_end", lj_end, torch.int32, (G_l, B), device)
    _check("tseed", tseed, torch.int32, (B,), device)
    flat = (*planes_r, *planes_l, *side_r, *side_l, lj_end, tseed)
    for i, t in enumerate(flat):
        if t.dtype == torch.int32:
            _check_aligned(f"argument {i}", t, 4)
    return B, G_r, G_l, [t.data_ptr() for t in flat]


def global_planes_cuda(planes_r, planes_l, side_r, side_l, lj_end, tseed, *,
                       L_t: int, S: int, W: int):
    """Launch the planes kernel; returns (g0 int8, gpack int32, gcnt int32)
    [B, L_t] as :func:`..ops.consensus_banded.banded_global_planes_plain`
    on the same arguments.  Raises on anything the kernel does not take."""
    global LAUNCHES_PLANES
    dev = _device_of("tseed", tseed)
    B, G_r, G_l, ptrs = planes_args(planes_r, planes_l, side_r, side_l,
                                    lj_end, tseed, L_t=L_t, S=S, W=W,
                                    device=dev)
    g0 = torch.empty((B, L_t), dtype=torch.int8, device=dev)
    gp, gc = (torch.empty((B, L_t), dtype=torch.int32, device=dev)
              for _ in range(2))
    if B and L_t:
        _call(_load(LIBRARY_FOLD).mecat_fold_planes,
              ptrs + [t.data_ptr() for t in (g0, gp, gc)],
              (B, G_r, G_l, S, W, L_t), dev, "planes")
        LAUNCHES_PLANES += 1
    return g0, gp, gc


def fold_args(counts, cov_diff, g0, gpack, gcnt, tlen, t_slot, pair_ok,
              tbeg, tend, L_t: int, device) -> tuple:
    """Check the fold kernel's arguments (those of
    :func:`..ops.consensus_banded.fold_tags_plain`) on ``device``; returns
    (B, T, the pointers in the entry point's order).  Raises on anything the
    kernel does not take."""
    if counts.dim() != 4 or g0.dim() != 2:
        raise ValueError(f"counts has shape {tuple(counts.shape)} and g0 "
                         f"{tuple(g0.shape)}, expected [T, L_t, 16, 5] and "
                         f"[B, L_t]")
    T, B = counts.shape[0], g0.shape[0]
    _check("counts", counts, torch.int32, (T, L_t, _D1, 5), device)
    _check("cov_diff", cov_diff, torch.int32, (T, L_t + 1), device)
    _check("g0", g0, torch.int8, (B, L_t), device)
    for name, t in (("gpack", gpack), ("gcnt", gcnt)):
        _check(name, t, torch.int32, (B, L_t), device)
    for name, t in (("tlen", tlen), ("t_slot", t_slot), ("tbeg", tbeg),
                    ("tend", tend)):
        _check(name, t, torch.int32, (B,), device)
    _check("pair_ok", pair_ok, torch.bool, (B,), device)
    flat = (g0, gpack, gcnt, tlen, t_slot, pair_ok, tbeg, tend, counts,
            cov_diff)
    for i, t in enumerate(flat):
        if t.dtype == torch.int32:
            _check_aligned(f"argument {i}", t, 4)
    return B, T, [t.data_ptr() for t in flat]


def fold_tags_cuda(counts, cov_diff, g0, gpack, gcnt, tlen, t_slot, pair_ok,
                   tbeg, tend, L_t: int):
    """Launch the fold kernel: counts int32 [T, L_t, 16, 5] and cov_diff
    int32 [T, L_t + 1] are updated in place, as
    :func:`..ops.consensus_banded.fold_tags_plain` updates them, and
    returned.  t_slot of a pair with pair_ok must lie in [0, T): for one
    that does not the kernel traps, as torch's ``index_add_`` asserts on
    CUDA, and the next synchronising call raises RuntimeError (the plain
    version raises on the CPU).  Raises on anything the kernel does not
    take."""
    global LAUNCHES_FOLD
    dev = _device_of("counts", counts)
    B, T, ptrs = fold_args(counts, cov_diff, g0, gpack, gcnt, tlen, t_slot,
                           pair_ok, tbeg, tend, L_t, dev)
    if B and T and L_t:
        _call(_load(LIBRARY_FOLD).mecat_fold_tags, ptrs, (B, L_t, T), dev,
              "fold")
        LAUNCHES_FOLD += 1
    return counts, cov_diff
