"""The profile reader on kineto-like events: launches placed by their
runtime call (also a call outside any op, as a ctypes-bound kernel's),
the card's copies of ranges left out of the busy time."""
from types import SimpleNamespace

import pytest

from torch.autograd import DeviceType

from mecat_bench import trace

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def _ev(name, dev, corr, linked, start, dur, ann=False):
    return SimpleNamespace(
        name=lambda: name, device_type=lambda: dev,
        correlation_id=lambda: corr, linked_correlation_id=lambda: linked,
        start_ns=lambda: start, duration_ns=lambda: dur,
        is_user_annotation=lambda: ann)


def test_read_profile_places_every_launch():
    events = [
        _ev("bench.window", CPU, 1, 0, 0, 10_000, ann=True),
        _ev("pw.collect#3", CPU, 2, 0, 1_000, 3_000, ann=True),
        # an op and a ctypes launch that share an id: ids of ops and of
        # runtime calls are counted apart
        _ev("aten::empty_strided", CPU, 77, 0, 1_200, 10),
        _ev("cudaLaunchKernel", CPU, 77, 0, 1_500, 5),
        _ev("void (anonymous namespace)::extend_kernel<4, false, 128, "
            "false, false>(ExtendArgs)", CUDA, 77, 0, 2_000, 4_000),
        _ev("pw.dispatch#4", CPU, 3, 0, 5_000, 2_000, ann=True),
        _ev("aten::add", CPU, 5, 0, 6_000, 50),
        _ev("cudaLaunchKernel", CPU, 900, 5, 6_010, 5),
        _ev("add_kernel", CUDA, 900, 5, 7_500, 100),
        _ev("pw.collect#3", CUDA, 0, 0, 1_000, 3_000),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    tr = trace.read_profile(prof)
    assert [(o.label) for o in tr.ops] == ["pw.collect#3", "pw.dispatch#4"]
    assert tr.window_s == pytest.approx(10_000e-9)
    assert tr.busy_s == pytest.approx(4_100e-9)
    assert tr.op_seconds(r"extend_kernel<\d+, false",
                         units={3}) == pytest.approx(4_000e-9)
    assert tr.op_seconds(r"extend_kernel<\d+, false", units={4}) == 0
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] == (
        "(anonymous namespace)::extend_kernel<4, false, 128, false, false>")
    assert sum(v for _, v in bd["idle_gaps"]) == pytest.approx(
        tr.window_s - tr.busy_s)
