"""The port's mecat2cns (mecat_tpu_torch.pipeline.cns) vs the JAX package.

On one simulated pile the host planning equals the reference's, and
``correct_batch_device`` gives the same corrected reads as the JAX device
route for candidate (``-i 0``) and M4 (``-i 1``) input.  ``run_cns``
reproduces ``tests/golden/corrected.fasta`` byte for byte, the CLI equals the
JAX package's ``run_cns`` under the same preset, and the output depends
neither on the table cap, nor on the partition size, nor on spilling the
supports to partition files.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread is as fast, and several test workers share the cores
torch.set_num_threads(1)
pytest.importorskip("jax")

from mecat_tpu.io.packed_db import PackedDB as RefDB
from mecat_tpu.pipeline import cns as ref
from mecat_tpu_torch.cli import mecat2cns
from mecat_tpu_torch.io.fasta import write_fasta
from mecat_tpu_torch.pipeline import cns as port
from mecat_tpu_torch.pipeline.pw import PwOptions, run_pw
from mecat_tpu_torch.testing import GOLDEN_CNS
from mecat_tpu_torch.utils.sim import random_genome, simulate_reads

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
OPTS = dict(min_align_size=300, min_length=500, extend_batch=32,
            align_segment=128, align_band=64)


@pytest.fixture(scope="module")
def pile(tmp_path_factory):
    """28 reads over a 9 kb genome with their candidates and M4 overlaps
    (the pile of tests/test_cns_device.py)."""
    d = tmp_path_factory.mktemp("torch_cns")
    genome = random_genome(9000, seed=51)
    db, _ = simulate_reads(genome, 28, mean_len=1800, min_len=1000,
                           seed=52, error_rate=0.1)
    reads = str(d / "r.fa")
    write_fasta(reads, [(db.name(i), db.read(i)) for i in range(db.n_reads)])
    pw = dict(kmer_size=9, scan_stride=4, num_candidates=12, scan_batch=8,
              min_block_score=2)
    cand, m4 = str(d / "c.txt"), str(d / "o.m4")
    run_pw(reads, cand, str(d / "w0"), PwOptions(task=0, **pw), db=db,
           device="cpu")
    run_pw(reads, m4, str(d / "w1"),
           PwOptions(task=1, min_align_size=400, extend_batch=32,
                     align_segment=128, align_band=64, **pw), db=db,
           device="cpu")
    return dict(db=db, ref_db=RefDB.from_fasta(reads), reads=reads,
                inputs={0: cand, 1: m4}, dir=d)


def _as_dict(records):
    out = {n: np.asarray(s).tobytes() for n, s in records}
    assert len(out) == len(records)
    return out


@pytest.mark.parametrize("input_type", [0, 1])
def test_support_tables_match_reference(pile, input_type):
    path = pile["inputs"][input_type]
    want = ref.load_supports(path, pile["ref_db"], input_type)
    got = port.load_supports(path, pile["db"], input_type)
    assert list(got) == list(want) and len(got) > 20
    for t in want:
        np.testing.assert_array_equal(got.get(t), want.get(t))
    assert got.get(10 ** 6) == ()


def test_planning_matches_reference(pile, monkeypatch):
    db, rdb = pile["db"], pile["ref_db"]
    by_t = port.load_supports(pile["inputs"][0], db, 0)
    templates = sorted(by_t)
    opts, ropts = port.CnsOptions(**OPTS), ref.CnsOptions(**OPTS)
    for cap in (1 << 29, 1 << 22, 1 << 20):
        monkeypatch.setenv("MECAT_TPU_CNS_TABLE_BYTES", str(cap))
        assert (port.plan_table_slices(db, templates, cap)
                == ref.plan_table_slices(rdb, templates))
    assert len(port.plan_table_slices(db, templates, 1 << 20)) > 2
    shapes = port._slice_shapes(db, templates, opts)
    assert shapes == ref._slice_shapes(rdb, templates, ropts)
    T, L_t, _, msegs, _, _ = shapes
    for t in templates[:6]:
        np.testing.assert_array_equal(
            port.select_supports(db, by_t, t, opts),
            ref.select_supports(rdb, by_t, t, ropts))
    got = port.plan_pairs(db, templates, by_t, opts, L_t, msegs)
    want = ref.plan_pairs(rdb, templates, by_t, ropts, L_t, msegs)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert port.plan_pairs(db, [templates[0]], {}, opts, L_t, msegs) is None
    for n in (1, 8, 9, 33, 97, 500):
        for m in (12, 70, 200):
            assert port.seg_bucket(n, m) == ref.seg_bucket(n, m)


def test_options_match_reference():
    for tech in (0, 1):
        got = port.CnsOptions.for_tech(tech, min_length=2000, min_coverage=None)
        want = ref.CnsOptions.for_tech(tech, min_length=2000,
                                       min_coverage=None)
        for name in ("min_mapping_ratio", "min_align_size", "min_coverage",
                     "min_length", "min_identity", "max_supports",
                     "max_est_coverage", "extend_batch", "align_segment",
                     "align_band", "partition_size", "tech"):
            assert getattr(got, name) == getattr(want, name), name
        assert tuple(got.vote_params()) == tuple(want.vote_params())
    assert tuple(port.CnsOptions().vote_params()) == (65, 60, 5, 8, 0, 50, 25)
    assert ref.CnsOptions().vote_params() is None   # = the same defaults


@pytest.mark.parametrize("input_type", [0, 1])
def test_correct_batch_device_matches_jax(pile, input_type):
    path = pile["inputs"][input_type]
    by_ref = ref.load_supports(path, pile["ref_db"], input_type)
    by_port = port.load_supports(path, pile["db"], input_type)
    templates = sorted(by_ref)
    rs, ps = ref.CnsStats(), port.CnsStats()
    want = list(ref.correct_batch_device(
        pile["ref_db"], templates, by_ref,
        ref.CnsOptions(input_type=input_type, **OPTS), rs))
    got = list(port.correct_batch_device(
        pile["db"], templates, by_port,
        port.CnsOptions(input_type=input_type, **OPTS), ps, device="cpu"))
    assert len(want) > 10
    assert [n for n, _ in got] == [n for n, _ in want]
    assert _as_dict(got) == _as_dict(want)
    for name in ("templates", "supports_aligned", "corrected_reads",
                 "corrected_bases"):
        assert getattr(ps, name) == getattr(rs, name), name
    assert 0 < ps.dp_lane_segs_useful <= ps.dp_lane_segs_issued
    assert ps.table_slices == 1


def test_output_independent_of_table_cap(pile):
    db = pile["db"]
    by_t = port.load_supports(pile["inputs"][0], db, 0)
    templates = sorted(by_t)
    opts = port.CnsOptions(win_radius=4, win_mass_frac=0.4,
                           win_peak_frac=0.2, **OPTS)
    st = port.CnsStats()
    full = _as_dict(list(port.correct_batch_device(
        db, templates, by_t, opts, port.CnsStats(), device="cpu")))
    sub = _as_dict(list(port.correct_batch_device(
        db, templates, by_t, opts, st, device="cpu", cap=1 << 22)))
    assert st.table_slices > 1
    assert full == sub and len(full) > 10


def test_table_cap_of_the_cpu_is_fixed():
    assert port.table_cap("cpu") == 1 << 29
    assert port.table_cap(torch.device("cpu")) == port.CPU_TABLE_CAP


def _golden_args(out):
    return [os.path.join(GOLDEN, "candidates.txt"),
            os.path.join(GOLDEN, "reads.fasta"), out]


def _golden_bytes():
    with open(os.path.join(GOLDEN, "corrected.fasta"), "rb") as fh:
        return fh.read()


def test_run_cns_golden_bytes(tmp_path):
    out = str(tmp_path / "corrected.fasta")
    stats = port.run_cns(*_golden_args(out), port.CnsOptions(**GOLDEN_CNS),
                         device="cpu")
    with open(out, "rb") as fh:
        assert fh.read() == _golden_bytes()
    assert stats.corrected_reads == 25 and stats.templates == 24


def test_run_cns_streamed_partitions_equal_in_memory(tmp_path):
    """Spilled to partition files of 7 templates each (and so batched 7
    templates at a time): the same bytes."""
    out = str(tmp_path / "streamed.fasta")
    port.run_cns(*_golden_args(out),
                 port.CnsOptions(partition_size=7, **GOLDEN_CNS),
                 device="cpu", stream=True)
    with open(out, "rb") as fh:
        assert fh.read() == _golden_bytes()
    assert not os.path.exists(out + ".parts")


def test_partition_files_match_reference(pile, tmp_path, monkeypatch):
    monkeypatch.setenv("MECAT_TPU_NO_NATIVE", "1")
    for input_type in (0, 1):
        path = pile["inputs"][input_type]
        got = port.partition_supports(path, pile["db"], input_type,
                                      str(tmp_path / f"p{input_type}"), 10)
        want = ref.partition_supports(path, pile["ref_db"], input_type,
                                      str(tmp_path / f"r{input_type}"), 10)
        assert [(a, b) for a, b, _ in got] == [(a, b) for a, b, _ in want]
        assert len(got) == 3
        whole = port.load_supports(path, pile["db"], input_type)
        for (lo, hi, gp), (_, _, wp) in zip(got, want):
            with open(gp, "rb") as fa, open(wp, "rb") as fb:
                assert fa.read() == fb.read()
            part = port.load_supports_partition(gp, input_type, lo, hi)
            assert list(part) == [t for t in whole if lo <= t < hi]
            for t in part:
                np.testing.assert_array_equal(part.get(t), whole.get(t))


def test_cli_on_cpu_matches_jax_run_cns_and_the_api(tmp_path):
    """The CLI always lays the -x preset under its flags, and the pacbio
    preset switches the window-pooled insertion rule on, which the golden
    run (plain ``CnsOptions``) had off and no flag switches off.  So the CLI
    on the golden input is held to the JAX package's ``run_cns`` under the
    same preset-resolved options, and to the port's own API."""
    out = str(tmp_path / "cli.fasta")
    rc = mecat2cns.main(["-i", "0", "-a", "300", "-l", "500", "-r", "0.6",
                         "-c", "4", "--extend-batch", "32",
                         "--align-segment", "128", "--align-band", "64",
                         "--device", "cpu", *_golden_args(out)])
    assert rc == 0
    with open(out, "rb") as fh:
        got = fh.read()
    kw = dict(GOLDEN_CNS, min_mapping_ratio=0.6, min_coverage=4)
    api_out = str(tmp_path / "api.fasta")
    port.run_cns(*_golden_args(api_out), port.CnsOptions.for_tech(0, **kw),
                 device="cpu")
    jax_out = str(tmp_path / "jax.fasta")
    ref.run_cns(*_golden_args(jax_out), ref.CnsOptions.for_tech(0, **kw))
    for path in (api_out, jax_out):
        with open(path, "rb") as fh:
            assert got == fh.read(), path
    assert got.count(b">") > 20
    assert got != _golden_bytes()         # the preset's window rule binds


def test_cli_refuses_rounds_and_missing_device(tmp_path, capsys):
    """``--rounds 2`` is no longer refused (it runs, here on the candidate
    lines that name the first read); a missing device still is."""
    out = str(tmp_path / "x.fasta")
    cut = str(tmp_path / "cut.txt")
    with open(_golden_args(out)[0]) as fh, open(cut, "w") as oh:
        oh.writelines(ln for ln in fh if "1" in ln.split()[:2])
    rc = mecat2cns.main(["--rounds", "2", "-a", "300", "-l", "500",
                         "--extend-batch", "32", "--align-segment", "128",
                         "--align-band", "64", "--device", "cpu", cut,
                         *_golden_args(out)[1:]])
    assert rc == 0 and "not ported" not in capsys.readouterr().err
    with open(out, "rb") as fh:
        assert fh.read().count(b">") >= 1
    assert not hasattr(port, "_require_single_round")
    missing = str(tmp_path / "y.fasta")
    with pytest.raises(SystemExit) as e:
        mecat2cns.main(["--device", "cuda:7", *_golden_args(missing)])
    assert e.value.code == 2
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            mecat2cns.main(["--device", "cuda", *_golden_args(missing)])
        assert e.value.code == 2
    assert not os.path.exists(missing)
