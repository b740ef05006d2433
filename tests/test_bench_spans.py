"""The benchmark's readers of the program's spans (``mecat_bench/spans.py``
and the ``busy_pct.*`` / ``idle_pct.*`` metrics) on kineto-like events.

Each trace holds a unit range, host spans (events that are no user
annotation), kernel spans (ranges), DP-loop and other device ops, and idle
gaps; every value below is computed by hand from those times.  Without the
program's events (a program that opens no span) each new reader reads
None, and the benchmark's other device readers read the same with and
without them.
"""
from types import SimpleNamespace

import pytest

from torch.autograd import DeviceType

from mecat_bench import harness, spans, trace

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
EXTEND_COUNTS = ("void (anonymous namespace)::extend_kernel<4, false, 128, "
                 "false, false>(ExtendArgs)")
EXTEND_MOVES = ("void (anonymous namespace)::extend_kernel<4, true, 128, "
                "false, false>(ExtendArgs)")


class Events:
    """kineto-like events, as ``mecat_bench/tests/test_bench_trace.py``
    builds them: ranges, host ops and spans, and launches whose device op
    runs later."""

    def __init__(self):
        self.events = []
        self.corr = 100

    def ev(self, name, dev, corr, linked, start, dur, ann=False):
        self.events.append(SimpleNamespace(
            name=lambda: name, device_type=lambda: dev,
            correlation_id=lambda: corr, linked_correlation_id=lambda: linked,
            start_ns=lambda: start, duration_ns=lambda: dur,
            is_user_annotation=lambda: ann))

    def range(self, name, start, end):
        self.corr += 1
        self.ev(name, CPU, self.corr, 0, start, end - start, ann=True)
        self.ev(name, CUDA, 0, 0, start, end - start)  # the card's copy

    def host(self, name, start, end):
        self.corr += 1
        self.ev(name, CPU, self.corr, 0, start, end - start)

    def launch(self, at, kernel, start, dur):
        self.corr += 1
        self.ev("cudaLaunchKernel", CPU, self.corr, 0, at, 5)
        self.ev(kernel, CUDA, self.corr, 0, start, dur)


def _read(ev):
    return trace.read_profile(SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev.events))))


def pw_trace(program: bool):
    """A 100 us window: a dispatch (prep, then a probe with the scan's and
    the lanes' kernel spans and a DP-loop launch) and a collect (M4)."""
    e = Events()
    e.range("bench.window", 0, 100_000)
    e.range("pw.dispatch#3", 1_000, 40_000)
    e.range("pw.collect#3", 40_000, 90_000)
    if program:
        e.host("pw.prep", 1_000, 10_000)
        e.host("pw.probe", 10_000, 38_000)
        e.range("ddf.scan", 11_000, 15_000)
        e.range("dp.lanes", 15_000, 17_000)
        e.host("pw.m4", 60_000, 89_000)
    e.host("aten::copy_", 2_000, 2_100)
    e.launch(2_050, "Memcpy HtoD (Pageable -> Device)", 3_000, 1_000)
    e.launch(11_550, "DeviceRadixSortOnesweepKernel", 16_000, 4_000)
    e.launch(15_500, "flip_kernel", 20_000, 2_000)
    e.launch(18_000, EXTEND_COUNTS, 22_000, 8_000)
    e.launch(60_500, "Memcpy DtoH (Device -> Pageable)", 61_000, 1_000)
    return _read(e)


def cns_trace(program: bool):
    """A 200 us window, one slice: plan, a chunk (lanes, the move loop, a
    row walk, the tag fold; host spans, as a chunk opens no range), the
    tally (the card busy all through), the vote, the emit."""
    e = Events()
    e.range("bench.window", 0, 200_000)
    e.range("cns.slice#0", 0, 190_000)
    if program:
        e.host("cns.plan", 1_000, 20_000)
        e.host("cns.chunk", 20_000, 80_000)
        e.host("dp.lanes", 21_000, 25_000)
        e.host("cns.tags", 55_000, 70_000)
        e.host("cns.tally", 80_000, 100_000)
        e.range("cns.vote", 100_000, 150_000)
        e.host("cns.emit", 150_000, 185_000)
    e.launch(10_000, "gather_kernel", 12_000, 2_000)
    e.launch(22_000, "index_kernel", 26_000, 4_000)
    e.launch(30_000, EXTEND_MOVES, 30_000, 20_000)
    e.launch(35_000, "walk_rows_kernel", 50_000, 5_000)
    e.launch(41_000, "fold_planes_kernel", 55_000, 3_000)
    e.launch(45_000, "tensor_kernel_scan_innermost_dim", 58_000, 2_000)
    e.launch(70_000, "fold_tags_kernel", 78_000, 24_000)
    e.launch(110_000, "cumprod_scan_kernel", 120_000, 10_000)
    e.launch(120_000, "reduce_kernel", 130_000, 5_000)
    e.launch(151_000, "Memcpy DtoH (Device -> Pageable)", 160_000, 1_000)
    return _read(e)


def _ctx(tr, **kw):
    return SimpleNamespace(trace=tr, device_kind="NVIDIA H100 80GB HBM3",
                           **kw)


def _metric(name, ctx):
    return harness.metric_reader(name)(ctx)


# busy 16 us of 100: [3, 4] [16, 30] [61, 62]; idle [0, 3] [4, 16] [30, 61]
# [62, 100]
PW = {"busy_pct.ddf.scan": 100 * 4 / 16, "busy_pct.dp.lanes": 100 * 2 / 16,
      "idle_pct.pw.prep": 100 * (2 + 6) / 100,
      "idle_pct.pw.probe": 100 * (6 + 8) / 100}
# busy 76 us of 200: [12, 14] [26, 60] [78, 102] [120, 135] [160, 161];
# idle [0, 12] [14, 26] [60, 78] [102, 120] [135, 160] [161, 200]
CNS = {"idle_pct.cns.tags": 100 * 10 / 200,
       "busy_pct.cns.vote": 100 * (10 + 5) / 76,
       "idle_pct.cns.plan": 100 * (11 + 6) / 200,
       "idle_pct.cns.chunk": 100 * (6 + 18) / 200,
       "idle_pct.cns.vote": 100 * (18 + 15) / 200,
       "idle_pct.cns.emit": 100 * (10 + 24) / 200}


def test_busy_sums_of_the_synthetic_traces():
    assert pw_trace(True).busy_s == pytest.approx(16e-6)
    assert cns_trace(True).busy_s == pytest.approx(76e-6)


@pytest.mark.parametrize("name,want", sorted({**PW, **CNS}.items()))
def test_span_reader_reads_the_hand_value(name, want):
    tr = pw_trace(True) if name in PW else cns_trace(True)
    assert _metric(name, _ctx(tr)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted({**PW, **CNS}))
def test_span_reader_is_none_without_its_span(name):
    tr = pw_trace(False) if name in PW else cns_trace(False)
    assert _metric(name, _ctx(tr)) is None
    assert _metric(name, _ctx(None)) is None


def test_a_span_that_occurs_reads_zero_for_no_time():
    tr = cns_trace(True)
    st = spans.times(tr)
    assert "cns.tally" in st.present and st.idle_s["cns.tally"] == 0.0
    # dp.lanes is a host span in correction: it labels no op
    assert spans.busy_pct(_ctx(tr), "dp.lanes") == 0.0
    # ddf.scan does not occur in a correction slice
    assert spans.busy_pct(_ctx(tr), "ddf.scan") is None


def test_kernel_spans_label_their_ops_and_leave_the_dp_loop_its_unit():
    tr = pw_trace(True)
    labels = {o.name: o.label for o in tr.ops}
    assert labels["DeviceRadixSortOnesweepKernel"] == "ddf.scan"
    assert labels["flip_kernel"] == "dp.lanes"
    assert labels[EXTEND_COUNTS] == "pw.dispatch#3"
    # a host span labels nothing, and no device op bears a span's name
    assert labels["Memcpy HtoD (Pageable -> Device)"] == "pw.dispatch#3"
    assert not {o.name for o in tr.ops} & set(spans.NAMES)


def test_chunk_host_spans_leave_the_dp_loop_its_unit():
    # the reader finds a launch's range among the last 256 ranges opened
    # before it: a slice of 300 chunks that opened a range a chunk would
    # lose its DP-loop kernels' unit; host spans a chunk do not
    for program_range in (False, True):
        e = Events()
        e.range("bench.window", 0, 10_000_000)
        e.range("cns.slice#7", 0, 9_000_000)
        for c in range(300):
            t = 1_000 + 20_000 * c
            e.host("cns.chunk", t, t + 19_000)
            (e.range if program_range else e.host)("cns.tags", t + 10_000,
                                                   t + 12_000)
        e.launch(7_000_000, EXTEND_MOVES, 7_100_000, 1_000)
        label = _read(e).ops[0].label
        assert (label == "cns.slice#7") is not program_range


def test_program_spans_cover_the_idle_time():
    covered, idle = spans.idle_coverage(pw_trace(True))
    assert idle == pytest.approx(84e-6)
    # idle inside pw.prep, pw.probe and pw.m4: 8 + 14 + 28 us
    assert covered == pytest.approx(50e-6)
    covered, idle = spans.idle_coverage(cns_trace(True))
    assert idle == pytest.approx(124e-6)
    # everything from 1 to 185 us: 11 + 12 + 18 + 18 + 25 + 24
    assert covered == pytest.approx(108e-6)


@pytest.mark.parametrize("name,make,work", [
    ("extend_counts_roofline_pct", pw_trace, "dp_counts"),
    ("scan_sort_pct.pw", pw_trace, None),
    ("device_idle_pct.pw", pw_trace, None),
    ("extend_moves_roofline_pct", cns_trace, "dp_moves"),
    ("walk_fold_pct.cns", cns_trace, None),
    ("device_idle_pct.cns", cns_trace, None)])
def test_device_readers_read_the_same_with_the_program_spans(name, make,
                                                             work):
    tally = {"cells": 1e9, "q_bytes": 1e6, "t_bytes": 1e6}
    unit = 3 if make is pw_trace else 0
    got = [_metric(name, _ctx(make(program), sample=[unit],
                              work={work: tally} if work else {}))
           for program in (False, True)]
    assert got[0] is not None and got[0] > 0
    assert got[1] == pytest.approx(got[0])
