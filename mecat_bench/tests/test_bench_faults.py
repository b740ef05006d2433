"""A run with the timed path broken underneath comes out not correct.

Each cell's kind is driven through ``harness.run_cell`` on the CPU at a
tiny size (the chip's look skipped), once sound and once with each fault
the cell can have: the step returns its state unchanged (no output), half
of the batch left out, an answer altered where it is produced (every record or segment, so
that the sample meets it).  One chip
has no exchange between chips to leave out.
"""
import time

import pytest

from mecat_bench import harness
from mecat_bench.tests.conftest import TINY, TINY_PW

ROOT = harness.ROOT


def _spec(cell):
    wl, cfg, traffic = harness.cell_spec(cell, ROOT)
    cfg = dict(cfg)
    if traffic["kind"] == "pw":
        cfg.update(TINY, genome_size=12000, mean_len=3000)
        cfg["pw_options"] = dict(TINY_PW, num_candidates=4, scan_batch=8,
                                 align_segment=256, align_band=64)
    else:
        cfg.update(genome_size=12000, coverage=8, mean_len=3000,
                   min_len=2000)
        cfg["cns_options"] = dict(cfg["cns_options"], align_segment=256,
                                  align_band=64)
        traffic = dict(traffic, table_cap_bytes=1 << 30, check_templates=4)
    return wl, cfg, traffic


def _run(cell, seed=424242424242):
    res = harness.run_cell(cell, seed, 0.05, False, device="cpu",
                           t_proc=time.time(), spec=_spec(cell))
    assert res["attempted"] >= 1
    return res


def _drop_half(fn, arg):
    def wrapped(*a, **k):
        a = list(a)
        ids = a[arg]
        a[arg] = list(ids)[:max(1, len(ids) // 2)]
        return fn(*a, **k)
    return wrapped


def _alter_text(fn):
    def wrapped(*a, **k):
        lines = fn(*a, **k).splitlines(keepends=True)
        for i, ln in enumerate(lines):
            f = ln.split("\t")
            f[6] = str(int(f[6]) + 1)
            lines[i] = "\t".join(f)
        return "".join(lines)
    return wrapped


def _alter_segment(fn):
    def wrapped(*a, **k):
        for name, seg in fn(*a, **k):
            seg = seg.copy()
            seg[len(seg) // 2] = (seg[len(seg) // 2] + 1) % 4
            yield name, seg
    return wrapped


def _nothing(fn, empty):
    def wrapped(*a, **k):
        fn(*a, **k)
        return empty() if callable(empty) else empty
    return wrapped


PW_FAULTS = {
    "unchanged": lambda P: {"collect_query_batch_fused":
                            _nothing(P.collect_query_batch_fused, "")},
    "half_batch": lambda P: {"dispatch_query_batch_fused":
                             _drop_half(P.dispatch_query_batch_fused, 4)},
    "altered": lambda P: {"collect_query_batch_fused":
                          _alter_text(P.collect_query_batch_fused)},
}
CNS_FAULTS = {
    "unchanged": lambda P: {"correct_batch_device":
                            _nothing(P.correct_batch_device, lambda: iter(
                                ()))},
    "half_batch": lambda P: {"correct_batch_device":
                             _drop_half(P.correct_batch_device, 1)},
    "altered": lambda P: {"correct_batch_device":
                          _alter_segment(P.correct_batch_device)},
}


def test_pw_m4_sound_run_is_correct():
    assert _run("ecoli-pacbio.pw-m4")["correct"]


@pytest.mark.parametrize("fault", sorted(PW_FAULTS))
def test_pw_m4_fault_is_caught(fault, monkeypatch):
    from mecat_tpu_torch.pipeline import pw as P
    for name, fn in PW_FAULTS[fault](P).items():
        monkeypatch.setattr(P, name, fn)
    assert not _run("ecoli-pacbio.pw-m4")["correct"]


def test_cns_sound_run_is_correct():
    assert _run("yeast-ont.cns")["correct"]


@pytest.mark.parametrize("fault", sorted(CNS_FAULTS))
def test_cns_fault_is_caught(fault, monkeypatch):
    from mecat_tpu_torch.pipeline import cns as P
    for name, fn in CNS_FAULTS[fault](P).items():
        monkeypatch.setattr(P, name, fn)
    assert not _run("yeast-ont.cns")["correct"]
