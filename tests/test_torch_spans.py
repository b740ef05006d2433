"""The port's spans (``mecat_tpu_torch.utils.metrics.span`` / ``kernel_span``).

With no profiler running both return the module's one null context.  Under
a CPU ``torch.profiler`` one fused pw batch and one correction slice open
every span of the program: host spans as events that are no user
annotation, kernel spans as ``record_function`` ranges (this pins the
private ``_RecordFunctionFast`` behaviour against a torch upgrade).  No
DP-loop entry runs inside a kernel span, a correction chunk opens no
range, and the outputs are the same bytes with and without the profiler.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread is as fast, and several test workers share the cores
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from mecat_tpu_torch.index.kmer_index import build_index  # noqa: E402
from mecat_tpu_torch.io.packed_db import PackedDB  # noqa: E402
from mecat_tpu_torch.ops import align  # noqa: E402
from mecat_tpu_torch.pipeline.cns import (CnsOptions, CnsStats,  # noqa: E402
                                          correct_batch_device,
                                          load_supports)
from mecat_tpu_torch.pipeline.pw import (PwOptions, PwStats,  # noqa: E402
                                         process_query_batch_fused)
from mecat_tpu_torch.testing import DIST_PW, GOLDEN_CNS  # noqa: E402
from mecat_tpu_torch.utils import metrics  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
HOST = ("pw.prep", "pw.probe", "pw.select", "pw.extend", "pw.m4",
        "cns.plan", "cns.chunk", "cns.tags", "cns.tally", "cns.emit")
KERNEL = ("ddf.scan", "cns.vote")
#: a kernel span on the counts path (pw), a host span on the move path
BOTH = ("dp.lanes",)
DP_LOOPS = ("_extend_direction_impl", "_extend_both_with_moves")


def _pw_batch():
    db = PackedDB.from_fasta(os.path.join(GOLDEN, "reads.fasta"))
    opts = PwOptions(**dict(DIST_PW, num_candidates=12, scan_batch=8))
    index = build_index(db.codes, db.starts, db.lengths, k=opts.kmer_size,
                        device="cpu")
    recs = process_query_batch_fused(
        db, 0, index, torch.as_tensor(db.codes), list(range(3, 11)), opts,
        db, PwStats(), 4096, 8192)
    return "".join(r.format() + "\n" for r in recs)


def _cns_slice(**opts):
    db = PackedDB.from_fasta(os.path.join(GOLDEN, "reads.fasta"))
    by_t = load_supports(os.path.join(GOLDEN, "candidates.txt"), db, 0)
    templates = sorted(by_t)[:6]
    return list(correct_batch_device(
        db, templates, by_t, CnsOptions(**dict(GOLDEN_CNS, **opts)),
        CnsStats(), device="cpu"))


def _events(prof):
    """(name, is_user_annotation) of every span of the program."""
    return [(ev.name(), ev.is_user_annotation())
            for ev in prof.profiler.kineto_results.events()
            if ev.name() in HOST + KERNEL + BOTH]


@pytest.fixture(scope="module")
def runs():
    """Both units without and with the profiler; with it, the kernel-span
    depth at every call of a DP-loop entry."""
    plain = (_pw_batch(), _cns_slice())
    depths = []
    saved = {n: getattr(align, n) for n in DP_LOOPS}

    def spy(fn):
        def call(*a, **kw):
            depths.append(metrics.kernel_depth())
            return fn(*a, **kw)
        return call

    for n, fn in saved.items():
        setattr(align, n, spy(fn))
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = (_pw_batch(), _cns_slice())
    finally:
        for n, fn in saved.items():
            setattr(align, n, fn)
    events = {}
    for name, ann in _events(prof):
        events.setdefault(name, set()).add(ann)
    return dict(plain=plain, traced=traced, depths=depths, events=events)


def test_spans_are_one_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    null = metrics.span("pw.prep")
    assert metrics.kernel_span("ddf.scan") is null
    assert all(metrics.span(n) is null for n in HOST)
    assert all(metrics.kernel_span(n) is null for n in KERNEL + BOTH)
    with metrics.kernel_span("cns.vote"):
        assert metrics.kernel_depth() == 0


def test_kernel_span_counts_its_depth_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]):
        assert metrics.kernel_depth() == 0
        with metrics.kernel_span("cns.vote"):
            with metrics.kernel_span("dp.lanes"):
                assert metrics.kernel_depth() == 2
            assert metrics.kernel_depth() == 1
        with metrics.span("cns.emit"):
            assert metrics.kernel_depth() == 0
    assert metrics.kernel_depth() == 0


@pytest.mark.parametrize("name", HOST)
def test_host_span_is_recorded_as_no_annotation(runs, name):
    assert runs["events"].get(name) == {False}


@pytest.mark.parametrize("name", KERNEL)
def test_kernel_span_is_recorded_as_a_range(runs, name):
    assert runs["events"].get(name) == {True}


def test_lane_span_is_recorded_as_either_kind(runs):
    assert runs["events"].get("dp.lanes") == {False, True}


def test_a_correction_chunk_opens_no_range():
    # a profile reader finds a launch's unit range among the last 256
    # ranges before it, and a slice runs hundreds of chunks
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _cns_slice(extend_batch=8)
    names = _events(prof)
    chunks = sum(n == "cns.chunk" for n, _ in names)
    slices = sum(n == "cns.plan" for n, _ in names)
    assert chunks >= 4 * slices > 0
    assert [n for n, ann in names if ann] == ["cns.vote"] * slices


def test_span_names_keep_clear_of_the_trace_reader():
    # '#' ends a unit label; a leading 'cu' marks a runtime call
    for name in HOST + KERNEL + BOTH:
        assert "#" not in name and not name.startswith("cu")
        assert name != "bench.window"


def test_no_dp_loop_runs_inside_a_kernel_span(runs):
    assert len(runs["depths"]) > 0
    assert set(runs["depths"]) == {0}


def test_outputs_equal_with_and_without_the_profiler(runs):
    (m4, cns), (m4_t, cns_t) = runs["plain"], runs["traced"]
    assert m4 and m4.encode() == m4_t.encode()
    assert len(cns) > 0 and len(cns) == len(cns_t)
    for (n, s), (n_t, s_t) in zip(cns, cns_t):
        assert n == n_t
        assert np.asarray(s).tobytes() == np.asarray(s_t).tobytes()
