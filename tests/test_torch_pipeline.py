"""The port's correct+trim pipeline (mecat_tpu_torch.cli.pipeline,
cli.extract_sequences, pipeline.trim) and its mecat2canu CLI vs the JAX
package: files equal byte for byte.

``extract``, ``coverage_intervals`` and ``run_trim`` equal the originals;
the pipeline CLI on a small simulated read set writes, stage by stage, the
artifacts of the JAX stages called with the same options (the JAX
correction through its device route), with one and with two correction
rounds, and a second call runs no stage; the ``mecat2canu`` CLI assembles
error-free tiled reads back into their genome; each new CLI refuses a
device that is missing.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread is as fast, and several test workers share the cores
torch.set_num_threads(1)
pytest.importorskip("jax")

from mecat_tpu.cli import extract_sequences as ref_extract
from mecat_tpu.pipeline import cns as ref_cns
from mecat_tpu.pipeline import pw as ref_pw
from mecat_tpu.pipeline import trim as ref_trim
from mecat_tpu_torch import constants as C
from mecat_tpu_torch.cli import extract_sequences, mecat2canu, pipeline
from mecat_tpu_torch.io.fasta import decode_bases, iter_fasta, write_fasta
from mecat_tpu_torch.io.packed_db import revcomp
from mecat_tpu_torch.pipeline import trim
from mecat_tpu_torch.testing import db_from, tiled_reads
from mecat_tpu_torch.utils.sim import random_genome, simulate_reads

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
ARTIFACTS = ("candidates.txt", "corrected.fasta", "extracted.fasta",
             "asm_overlaps.m4", "trimmed.fasta")


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_extract_matches_reference(tmp_path):
    rng = np.random.default_rng(5)
    recs = [(f"c{i}", rng.integers(0, 4, int(n), dtype=np.uint8))
            for i, n in enumerate(rng.integers(200, 3000, 25))]
    recs[7] = ("tie", recs[3][1].copy())          # two reads of one length
    src = str(tmp_path / "c.fasta")
    write_fasta(src, recs)
    for size, cov in ((1000, 4.0), (2000, 7.5), (10 ** 6, 1.0), (10, 0.0)):
        n = extract_sequences.extract(src, str(tmp_path / "port"), size, cov)
        assert n == ref_extract.extract(src, str(tmp_path / "ref"), size, cov)
        assert (_bytes(str(tmp_path / "port.fasta"))
                == _bytes(str(tmp_path / "ref.fasta")))
    # the tool itself; the selection keeps input order
    assert extract_sequences.main([src, str(tmp_path / "cli"), "1000", "4",
                                   "--device", "cpu"]) == 0
    ref_extract.extract(src, str(tmp_path / "ref"), 1000, 4.0)
    assert _bytes(str(tmp_path / "cli.fasta")) == _bytes(
        str(tmp_path / "ref.fasta"))
    names = [r.name for r in iter_fasta(str(tmp_path / "cli.fasta"))]
    assert names == sorted(names, key=lambda s: [n for n, _ in recs].index(s))
    assert 0 < len(names) < len(recs)


def test_coverage_intervals_match_reference():
    rng = np.random.default_rng(6)
    for trial in range(40):
        L = int(rng.integers(1, 400))
        n = int(rng.integers(0, 12))
        a = rng.integers(-20, L + 20, n)
        b = a + rng.integers(-5, L, n)
        ev, ml = int(rng.integers(1, 4)), int(rng.integers(1, 60))
        want = ref_trim.coverage_intervals(L, (a, b), ev, ml)
        assert trim.coverage_intervals(L, (a, b), ev, ml) == want
        pairs = list(zip(a.tolist(), b.tolist()))
        assert trim.coverage_intervals(L, pairs, ev, ml) == want
    spans = [(0, 30), (0, 30), (60, 100), (60, 100)]
    assert trim.coverage_intervals(100, spans, 2, 10) == [(0, 30), (60, 100)]
    assert trim.coverage_intervals(100, [], 1, 10) == []


@pytest.mark.parametrize("min_evidence,min_len", [(2, 500), (1, 1000),
                                                  (4, 200)])
def test_run_trim_on_given_overlaps_matches_reference(tmp_path, monkeypatch,
                                                      min_evidence, min_len):
    """The golden reads and their golden M4 overlaps: nothing runs on a
    device, the bytes and the counts are the original's, through its native
    table parser and through its Python one."""
    reads = os.path.join(GOLDEN, "reads.fasta")
    m4 = os.path.join(GOLDEN, "overlaps.m4")
    kw = dict(min_evidence=min_evidence, min_trimmed_length=min_len)
    got = trim.run_trim(reads, str(tmp_path / "port.fa"), str(tmp_path / "w"),
                        trim.TrimOptions(**kw), overlaps_path=m4,
                        device="cpu")
    for native in ("0", "1"):
        monkeypatch.setenv("MECAT_TPU_NO_NATIVE", native)
        want = ref_trim.run_trim(reads, str(tmp_path / "ref.fa"),
                                 str(tmp_path / "rw"),
                                 ref_trim.TrimOptions(**kw), overlaps_path=m4)
        assert _bytes(str(tmp_path / "port.fa")) == _bytes(
            str(tmp_path / "ref.fa"))
        for f in ("reads_in", "reads_out", "bases_in", "bases_out"):
            assert getattr(got, f) == getattr(want, f), f
    assert 0 < got.reads_out and got.bases_out < got.bases_in
    assert not os.path.exists(str(tmp_path / "w" / "trim_overlaps.m4"))


PIPE_ARGS = ["-x", "1", "-g", "9000", "-c", "20", "-a", "400", "-n", "12",
             "--min-coverage", "3", "--min-length", "500",
             "--kmer-size", "9", "--scan-stride", "4", "--scan-batch", "8",
             "--extend-batch", "32", "--align-segment", "128",
             "--align-band", "64"]
PW_KW = dict(num_candidates=12, min_align_size=400, kmer_size=9,
             scan_stride=4, scan_batch=8, extend_batch=32, align_segment=128,
             align_band=64, diag_bin=C.DDF_DIAG_BIN)


def _ref_stages(reads, out, rounds, monkeypatch):
    """The five stages through the JAX package, as its pipeline CLI calls
    them, with the correction on its device route."""
    os.makedirs(out)
    art = lambda name: os.path.join(out, name)
    monkeypatch.setattr(ref_cns, "_pick_correct_batch",
                        lambda: ref_cns.correct_batch_device)
    ref_pw.run_pw(reads, art("candidates.txt"), art("wrk_pw"),
                  ref_pw.PwOptions(task=0, **PW_KW))
    ref_cns.run_cns(
        art("candidates.txt"), reads, art("corrected.fasta"),
        ref_cns.CnsOptions.for_tech(
            1, input_type=0, min_coverage=3, min_length=500,
            align_segment=128, align_band=64, extend_batch=32,
            draft_est_coverage=None, rounds=rounds))
    ref_extract.extract(art("corrected.fasta"), art("extracted"), 9000, 20.0)
    ref_pw.run_pw(art("extracted.fasta"), art("asm_overlaps.m4"),
                  art("wrk_asm"),
                  ref_pw.PwOptions(task=1, min_identity=85.0, **PW_KW))
    ref_trim.run_trim(art("extracted.fasta"), art("trimmed.fasta"),
                      art("wrk_trim"),
                      ref_trim.TrimOptions(min_trimmed_length=500),
                      overlaps_path=art("asm_overlaps.m4"))


@pytest.fixture(scope="module")
def raw_reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pipe")
    genome = random_genome(9000, seed=111)
    db, _ = simulate_reads(genome, 30, mean_len=1800, min_len=1200,
                           seed=112, error_rate=0.08)
    reads = str(d / "raw.fasta")
    write_fasta(reads, [(db.name(i), db.read(i)) for i in range(db.n_reads)])
    return reads, d


@pytest.mark.parametrize("rounds", [1, 2])
def test_pipeline_cli_matches_the_jax_stages(raw_reads, monkeypatch, rounds):
    reads, d = raw_reads
    out, ref_out = str(d / f"out{rounds}"), str(d / f"ref{rounds}")
    argv = ["-d", reads, "-o", out, *PIPE_ARGS, "--rounds", str(rounds),
            "--device", "cpu"]
    assert pipeline.main(argv) == 0
    _ref_stages(reads, ref_out, rounds, monkeypatch)
    for name in ARTIFACTS:
        got = _bytes(os.path.join(out, name))
        assert got == _bytes(os.path.join(ref_out, name)), name
        assert len(got) > 1000, name
    assert _bytes(os.path.join(out, "trimmed.fasta")).count(b">") >= 10
    # resume: a second call runs no stage and touches no artifact
    mtimes = {a: os.stat(os.path.join(out, a)).st_mtime_ns for a in ARTIFACTS}
    assert pipeline.main(argv) == 0
    assert mtimes == {a: os.stat(os.path.join(out, a)).st_mtime_ns
                      for a in ARTIFACTS}
    # a lost artifact is made again, to the same bytes
    want = _bytes(os.path.join(out, "trimmed.fasta"))
    os.remove(os.path.join(out, "trimmed.fasta"))
    assert pipeline.main(argv) == 0
    assert _bytes(os.path.join(out, "trimmed.fasta")) == want


def test_mecat2canu_cli_assembles_tiled_reads(tmp_path):
    assert mecat2canu.parse_size("4.8m") == 4_800_000
    assert mecat2canu.parse_size("500k") == 500_000
    assert mecat2canu.parse_size("12") == 12
    genome = random_genome(8000, seed=12)
    read_len, step = 2000, 1200
    n = (len(genome) - read_len) // step + 1
    reads, _ = tiled_reads(genome, n, read_len, step, flip_every=3)
    db = db_from(reads)
    reads_fa = str(tmp_path / "reads.fasta")
    write_fasta(reads_fa, [(db.name(i), db.read(i))
                           for i in range(db.n_reads)])
    wrk = str(tmp_path / "wrk")
    argv = ["-p", "t", "-d", wrk, "-assemble", "-pacbio-corrected", reads_fa,
            "genomeSize=8k", "minReadLength=500", "minOverlapLength=400",
            "maxThreads=4", "--device", "cpu"]
    assert mecat2canu.main(argv) == 0
    contigs = list(iter_fasta(os.path.join(wrk, "t.contigs.fasta")))
    assert len(contigs) >= 1
    longest = max(contigs, key=lambda r: len(r.codes)).codes
    assert len(longest) >= 0.8 * len(genome)
    gs = decode_bases(genome)
    assert decode_bases(longest) in gs or decode_bases(revcomp(longest)) in gs
    assert not os.path.exists(os.path.join(wrk, "trim.done"))
    for stage in ("gatekeeper", "meryl", "overlap", "ovstore", "erate",
                  "unitig", "consensus", "output"):
        assert os.path.exists(os.path.join(wrk, stage + ".done")), stage
    assert mecat2canu.main(["-p", "t", "-d", wrk, "--device", "cpu"]) == 2
    assert mecat2canu.main(["-p", "t", "-d", wrk, "-pacbio-corrected",
                            reads_fa, "genomeSize", "--device", "cpu"]) == 2


@pytest.mark.parametrize("tool,argv", [
    (pipeline, ["-d", "a", "-o", "b", "-g", "1"]),
    (mecat2canu, ["-p", "a", "-d", "b", "-pacbio-corrected", "c"]),
    (extract_sequences, ["a", "b", "1", "1"])])
def test_new_clis_refuse_a_missing_device(tool, argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        tool.main([*argv, "--device", "cuda:7"])
    assert e.value.code == 2
    if not torch.cuda.is_available():             # the default is the card
        with pytest.raises(SystemExit) as e:
            tool.main(argv)
        assert e.value.code == 2
    assert os.listdir(str(tmp_path)) == []
