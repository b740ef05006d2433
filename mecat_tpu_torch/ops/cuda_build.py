"""Build the port's CUDA sources with ``nvcc`` into shared libraries.

Each source under ``csrc/`` becomes one library with plain C entry points in
``_build/`` (not committed), compiled for ``sm_90a`` at its first CUDA use
and loaded with ``ctypes`` by the module that wraps it.  A library carries a
stamp with the SHA-256 of its source and flags; a changed source rebuilds.
Nothing here runs at import: machines without nvcc import this module
freely.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
#: every kernel library of the package: name -> source file under csrc/
SOURCES = {"mecat_dp": "dp_segment.cu", "mecat_roll_micro": "roll_micro.cu"}


def source_path(name: str) -> str:
    return os.path.join(_PKG, "csrc", SOURCES[name])


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(name: str, verbose: bool = False) -> float:
    """Compile library ``name`` unless an up-to-date one exists.

    Returns the seconds spent compiling (0.0 when up to date).  With
    ``verbose`` the compiler's resource report (``-Xptxas -v``) is printed.
    """
    source, lib = source_path(name), lib_path(name)
    with open(source, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()
    stamp = lib + ".sha256"
    if os.path.exists(lib) and os.path.exists(stamp):
        with open(stamp) as fh:
            if fh.read().strip() == digest:
                return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, source]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCES[name]} "
                           f"({proc.returncode}):\n{proc.stderr}")
    if verbose and proc.stderr:
        print(proc.stderr, flush=True)
    os.replace(tmp, lib)
    with open(stamp, "w") as fh:
        fh.write(digest)
    return time.time() - t0


def build_all(verbose: bool = False) -> dict:
    """Build every library, one nvcc per source, all started together.
    Returns name -> seconds spent compiling."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        jobs = {name: pool.submit(build, name, verbose) for name in SOURCES}
        return {name: job.result() for name, job in jobs.items()}


def check_tensor(name: str, t, dtype, shape, device) -> None:
    """Raise unless tensor ``t`` has this device, dtype and shape and is
    contiguous: what a kernel wrapper checks before it passes a pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
