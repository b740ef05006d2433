"""The program's own spans in a :class:`trace.Trace`.

The program opens two kinds of span while a profiler records
(``mecat_tpu_torch/utils/metrics.py``): host spans, which the reader files
among the host ops (``Trace.host_ops``), and kernel spans, which are
``record_function`` ranges (``Trace.ranges``) and so label the device ops
launched inside them (``Op.label``).  One name may be either kind:
``dp.lanes`` is a kernel span on the counts path (pw) and a host span on
the move path, which correction enters once a chunk (the reader finds a
launch's unit among the last 256 ranges before it, so a slice may open
only a few).  A span is a child of the benchmark's unit range around it,
so it needs no id of its own.

For each trace, once: the device seconds of the ops each kernel span
labels, and the idle seconds (the window less the union of device
activity) inside the union of each span's intervals, and inside the union
of every program span.  All are clipped to the window, and computed by
sweeps over sorted intervals.  A span that does not occur in the window
reads None; one that occurs reads its quantity, 0 included.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

#: the program's spans
NAMES = ("pw.prep", "pw.probe", "pw.select", "pw.extend", "pw.m4",
         "ddf.scan", "dp.lanes", "cns.plan", "cns.chunk", "cns.tags",
         "cns.tally", "cns.vote", "cns.emit")

Intervals = List[Tuple[float, float]]


@dataclass
class SpanTimes:
    present: Set[str] = field(default_factory=set)
    device_s: Dict[str, float] = field(default_factory=dict)
    idle_s: Dict[str, float] = field(default_factory=dict)
    idle_total_s: float = 0.0
    idle_covered_s: float = 0.0


def merge(intervals) -> Intervals:
    """The union of (start, end) intervals, sorted and disjoint."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a: Intervals, b: Intervals) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_intervals(trace) -> Intervals:
    """The window less the union of device activity, sorted."""
    lo, hi = trace.window
    out, prev = [], lo
    for s, e in trace.busy_intervals():
        if s > prev:
            out.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        out.append((prev, hi))
    return out


def times(trace) -> SpanTimes:
    """The :class:`SpanTimes` of ``trace``, computed once."""
    cached = getattr(trace, "_program_spans", None)
    if cached is not None:
        return cached
    lo, hi = trace.window
    names = set(NAMES)
    by_name: Dict[str, list] = {}
    for s, e, name in itertools.chain(trace.host_ops, trace.ranges):
        if name in names and e > lo and s < hi:
            by_name.setdefault(name, []).append((max(s, lo), min(e, hi)))
    device: Dict[str, float] = {}
    for o in trace.ops:
        if o.label in names and o.end > lo and o.start < hi:
            device[o.label] = device.get(o.label, 0.0) + (
                min(o.end, hi) - max(o.start, lo)) * 1e-6
    idle = idle_intervals(trace)
    every = merge(iv for ivs in by_name.values() for iv in ivs)
    st = SpanTimes(
        present=set(by_name),
        device_s=device,
        idle_s={n: overlap(merge(ivs), idle) * 1e-6
                for n, ivs in by_name.items()},
        idle_total_s=sum(e - s for s, e in idle) * 1e-6,
        idle_covered_s=overlap(every, idle) * 1e-6)
    trace._program_spans = st
    return st


def busy_pct(ctx, name: str) -> Optional[float]:
    """Device seconds of the ops kernel span ``name`` labels, over the
    window's busy seconds, in %."""
    tr = ctx.trace
    if tr is None or tr.busy_s <= 0:
        return None
    st = times(tr)
    if name not in st.present:
        return None
    return 100.0 * st.device_s.get(name, 0.0) / tr.busy_s


def idle_pct(ctx, name: str) -> Optional[float]:
    """Idle seconds inside the spans named ``name``, over the window's
    seconds, in %."""
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    st = times(tr)
    if name not in st.present:
        return None
    return 100.0 * st.idle_s[name] / tr.window_s


def idle_coverage(trace) -> Tuple[float, float]:
    """(idle seconds inside any program span, idle seconds) of the
    window."""
    st = times(trace)
    return st.idle_covered_s, st.idle_total_s
