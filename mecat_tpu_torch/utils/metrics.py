"""Named counters and stage timers, emitted as JSON lines on stderr.

Copy of ``mecat_tpu.utils.metrics.Metrics`` (the same line format, the same
``MECAT_TPU_METRICS=0`` switch).  A run's last line is its summary:
``{"component": ..., "event": "summary", <counter>: <value>, ...}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from collections import defaultdict
from typing import Dict, Iterator


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
