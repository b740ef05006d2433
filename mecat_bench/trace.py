"""Reduce a ``torch.profiler`` run to what the metrics read.

Device activity is every kernel, copy and memset the profile holds.  Each
is tied to the host event it was launched under (its linked correlation
id), and the innermost ``record_function`` range around that event's start
names the work (``pw.collect#12``: the collect of the window's 13th unit).
The window is the ``bench.window`` range.  The events are read in memory:
a window of a million host ops would make a chrome trace of a gigabyte.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple



@dataclass
class Op:
    name: str
    start: float      # us
    end: float        # us
    label: Optional[str]  # innermost host range of the launch


@dataclass
class Trace:
    window: Tuple[float, float]
    ops: List[Op]
    ranges: List[Tuple[float, float, str]]
    host_ops: List[Tuple[float, float, str]] = field(default_factory=list)
    _busy: Optional[List[Tuple[float, float]]] = field(default=None,
                                                      repr=False)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """Union of device activity inside the window, sorted."""
        if self._busy is None:
            lo, hi = self.window
            spans = sorted((max(o.start, lo), min(o.end, hi))
                           for o in self.ops if o.end > lo and o.start < hi)
            out: List[list] = []
            for s, e in spans:
                if out and s <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], e)
                else:
                    out.append([s, e])
            self._busy = [(s, e) for s, e in out]
        return self._busy

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def op_seconds(self, pattern: str, units=None) -> float:
        """Summed device seconds of the ops whose name matches
        ``pattern``; with ``units``, only those launched by a range of one
        of those window positions."""
        rx = re.compile(pattern)
        match: Dict[str, bool] = {}
        total = 0.0
        for o in self.ops:
            hit = match.get(o.name)
            if hit is None:
                hit = match[o.name] = bool(rx.search(o.name))
            if hit and (units is None or unit_of(o.label) in units):
                total += o.end - o.start
        return total * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, by name, and the idle time
        between device activity by what the host was doing then (the
        innermost annotated range and the host op under it), in seconds."""
        by_name: Dict[str, float] = defaultdict(float)
        short: Dict[str, str] = {}
        lo, hi = self.window
        for o in self.ops:
            if o.end > lo and o.start < hi:
                name = short.get(o.name)
                if name is None:
                    name = short[o.name] = short_name(o.name)
                by_name[name] += (min(o.end, hi) - max(o.start, lo)) * 1e-6
        gaps: Dict[str, float] = defaultdict(float)
        prev = lo
        for s, e in self.busy_intervals() + [(hi, hi)]:
            if s > prev:
                gaps[self.host_label((prev + s) / 2)] += (s - prev) * 1e-6
            prev = max(prev, e)
        return {"device_ops": _top(by_name, top),
                "idle_gaps": _top(gaps, top)}

    def host_label(self, t: float) -> str:
        """What the host did at time t: innermost range and host op."""
        rng = _innermost(self.ranges, t)
        op = _innermost(self.host_ops, t, back=16)
        name = base_label(rng) if rng else "outside ranges"
        return f"{name}/{op}" if op else f"{name}/python"


def _top(d: Dict[str, float], n: int) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list (the
    first ``(`` outside template brackets that opens no ``(anonymous``)."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0 and not name.startswith(
                "(anonymous", i):
            name = name[:i]
            break
    return name[:160]


def base_label(label: Optional[str]) -> Optional[str]:
    return label.split("#")[0] if label else label


def unit_of(label: Optional[str]) -> Optional[int]:
    """The window position in a range label ``name#pos``."""
    if not label or "#" not in label:
        return None
    return int(label.rsplit("#", 1)[1])


def _innermost(ranges, t: float, back: int = 256) -> Optional[str]:
    """Name of the shortest of the sorted (start, end, name) ranges that
    contains t, among the ``back`` that start last before t: ranges nest,
    so the innermost is one that started late."""
    i = bisect.bisect_right(ranges, (t, float("inf"), ""))
    best, best_len = None, None
    for s, e, n in ranges[max(0, i - back):i]:
        if s <= t <= e and (best_len is None or e - s < best_len):
            best, best_len = n, e - s
    return best


def read_profile(prof) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``, read
    from its kineto events in memory (no trace file).

    A runtime call's id is that of the device activity it started, so the
    call's time places the launch inside the ``record_function`` ranges; a
    frontend event (a host op or a range) is an event of no linked id that
    is no runtime call."""
    from torch.autograd import DeviceType
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    front: Dict[int, float] = {}
    runtime: Dict[int, float] = {}
    ranges: List[Tuple[float, float, str]] = []
    host_ops: List[Tuple[float, float, str]] = []
    device = []
    window = None
    for ev in prof.profiler.kineto_results.events():
        kind = ev.device_type()
        name = ev.name()
        start = ev.start_ns() * 1e-3
        if kind == cuda:
            device.append((name, start, start + ev.duration_ns() * 1e-3,
                           ev.correlation_id(), ev.linked_correlation_id()))
        elif kind == cpu:
            corr = ev.correlation_id()
            if ev.linked_correlation_id() or name.startswith("cu"):
                # a runtime or driver call (a launch, a copy); its id is the
                # device activity's own.  A launch outside any op (a kernel
                # bound through ctypes) has no linked op, and the ids of ops
                # and of calls are counted apart, so the two are kept apart
                runtime[corr] = start
                continue
            # kineto's own host events can share an op's id; the op (or
            # range) that owns the id starts first
            front[corr] = min(start, front.get(corr, start))
            end = start + ev.duration_ns() * 1e-3
            if ev.is_user_annotation():
                if name == "bench.window":
                    window = (start, end)
                else:
                    ranges.append((start, end, name))
            else:
                host_ops.append((start, end, name))
    # the card's copy of a range (a "gpu_user_annotation") carries the
    # range's name and is no work; a launch is placed by its runtime call,
    # else by the start of the host op it was launched under
    annotations = {r[2] for r in ranges} | {"bench.window"}
    device = [(name, start, end, runtime.get(corr, front.get(linked)))
              for name, start, end, corr, linked in device
              if name not in annotations]
    ranges.sort()
    host_ops.sort()
    ops = [Op(name, start, end,
              None if t is None else _innermost(ranges, t))
           for name, start, end, t in device]
    if window is None:
        window = (min((o.start for o in ops), default=0.0),
                  max((o.end for o in ops), default=0.0))
    return Trace(window=window, ops=ops, ranges=ranges, host_ops=host_ops)
