"""Named counters and stage timers, emitted as JSON lines on stderr, and
the spans a ``torch.profiler`` sees inside the program.

``Metrics`` is a copy of ``mecat_tpu.utils.metrics.Metrics`` (the same line
format, the same ``MECAT_TPU_METRICS=0`` switch).  A run's last line is its
summary: ``{"component": ..., "event": "summary", <counter>: <value>, ...}``.

:func:`span` and :func:`kernel_span` name a phase of the program on the
profiler's clock, and only while a profiler records: otherwise each returns
one shared null context.  A span is the child of whatever range or span
encloses it in time, so it carries no id of its own.  Two kinds:

* a host span (``span``) is a profiler event of the host alone: it names
  what the host does (and waits for) in that phase and labels no kernel;
* a kernel span (``kernel_span``) is a ``record_function`` range, so every
  device op launched inside it is labelled with its name.  It is for leaf
  ranges that launch no DP-loop kernel (``ops/align._extend_direction_impl``,
  ``_extend_both_with_moves``), whose kernels keep the label of the range
  around the call; ``kernel_depth()`` counts the kernel spans open.  A
  profile reader that finds a launch's range among the last few hundred
  ranges opened before it loses the caller's range after that many, so a
  site that runs once a correction chunk (hundreds a slice) opens a host
  span, never a kernel span.

A span's name holds no ``#`` and does not start with ``cu``.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch
from torch.autograd import _profiler_enabled


class Metrics:
    """Counters and stage timers of one component."""

    def __init__(self, component: str, emit: bool = True):
        self.component = component
        self.counters: Dict[str, float] = defaultdict(float)
        self._emit = emit and os.environ.get("MECAT_TPU_METRICS", "1") != "0"

    def set(self, name: str, value: float) -> None:
        self.counters[name] = value

    @contextlib.contextmanager
    def stage(self, name: str, **extra) -> Iterator[None]:
        """Time a pipeline stage; emits one JSON line on exit."""
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.counters[f"{name}_seconds"] += dt
            self.emit(stage=name, seconds=round(dt, 3), **extra)

    def emit(self, **fields) -> None:
        if not self._emit:
            return
        rec = {"component": self.component, "ts": round(time.time(), 3),
               **fields}
        print(json.dumps(rec), file=sys.stderr, flush=True)

    def emit_summary(self) -> None:
        self.emit(event="summary", **{k: round(v, 3) if isinstance(v, float)
                                      else v
                                      for k, v in self.counters.items()})


_NULL = contextlib.nullcontext()
_kernel_depth = 0


def span(name: str):
    """A host span named ``name`` while a profiler records, else the shared
    null context."""
    if _profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NULL


class _KernelSpan:
    __slots__ = ("_range",)

    def __init__(self, name: str):
        self._range = torch.profiler.record_function(name)

    def __enter__(self):
        global _kernel_depth
        self._range.__enter__()
        _kernel_depth += 1

    def __exit__(self, *exc):
        global _kernel_depth
        _kernel_depth -= 1
        return self._range.__exit__(*exc)


def kernel_span(name: str):
    """A kernel span named ``name`` while a profiler records, else the
    shared null context."""
    if _profiler_enabled():
        return _KernelSpan(name)
    return _NULL


def kernel_depth() -> int:
    """How many kernel spans are open."""
    return _kernel_depth
