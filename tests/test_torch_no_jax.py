"""The port runs where JAX is missing, as on the machine with the GPU.

A subprocess blocks ``jax`` and ``jaxlib`` on ``sys.meta_path``, imports
every module of ``mecat_tpu_torch`` (``native``, ``native.scalar``,
``utils.scaling`` and ``bench`` among them) and ``chip_smoke``, runs
``run_pw(device="cpu")`` on the golden reads, which must reproduce
``tests/golden/overlaps.m4``, and runs the ``mecat2cns`` CLI on a cut of the
golden candidates, which must correct the templates it keeps whole, once
more with ``--rounds 2``, then the ``pipeline``, ``extract_sequences`` and
``mecat2canu`` CLIs on the golden reads.  It then maps the golden reads back
onto three of them with the ``mecat2ref`` CLI and runs the ``roll_micro``
tool, and runs the two-rank toy dry run of the sharded drivers (``python
-m mecat_tpu_torch.parallel.dryrun 2 --device cpu --toy``), whose ranks
find ``jax`` shadowed by packages that refuse to import; then the native
scalar engine, the bench at a tiny size with its scalar leg, and a
one-rank scaling report, whose rank finds ``jax`` shadowed too.  All run
on ``--device cpu``, and each new entry point must refuse to start
without a device.  Neither JAX nor the JAX package (``mecat_tpu``, whose
init configures JAX) may be loaded at the end, and ``chip_smoke.main()``
must refuse to run without a CUDA device.
"""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r'''
import importlib, os, pkgutil, sys, tempfile


class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ModuleNotFoundError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, BlockJax())
sys.path.insert(0, ROOT)
import mecat_tpu_torch

mods = [m.name for m in pkgutil.walk_packages(mecat_tpu_torch.__path__,
                                              "mecat_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
for m in ("native", "native.api", "native.scalar", "utils.scaling", "bench"):
    assert "mecat_tpu_torch." + m in mods, m
from mecat_tpu_torch.pipeline.pw import PwOptions, run_pw

golden = os.path.join(ROOT, "tests", "golden")
with tempfile.TemporaryDirectory() as d:
    out = os.path.join(d, "out.m4")
    run_pw(os.path.join(golden, "reads.fasta"), out, os.path.join(d, "w"),
           PwOptions(task=1, kmer_size=9, scan_stride=4, min_align_size=400,
                     num_candidates=12, scan_batch=8, extend_batch=32,
                     align_segment=128, align_band=64, min_block_score=2),
           device="cpu")
    with open(out, "rb") as fh, \
            open(os.path.join(golden, "overlaps.m4"), "rb") as gh:
        assert fh.read() == gh.read(), "golden bytes differ"
    # correction through the CLI, on the candidate lines that name one of
    # the first 3 reads: those 3 templates keep all their supports, and a
    # template's corrected reads depend on its own supports alone, so they
    # must equal the golden file's
    from mecat_tpu_torch.cli import mecat2cns
    from mecat_tpu_torch.io.fasta import iter_fasta

    cut = os.path.join(d, "cand_cut.txt")
    with open(os.path.join(golden, "candidates.txt")) as fh, \
            open(cut, "w") as oh:
        oh.writelines(ln for ln in fh
                      if {ln.split()[0], ln.split()[1]} & {"1", "2", "3"})
    out = os.path.join(d, "corrected.fasta")
    rc = mecat2cns.main(["-i", "0", "-a", "300", "-l", "500", "-r", "0.6",
                         "-c", "4", "--extend-batch", "32",
                         "--align-segment", "128", "--align-band", "64",
                         "--device", "cpu", cut,
                         os.path.join(golden, "reads.fasta"), out])
    assert rc == 0
    names = [r.name for r in iter_fasta(os.path.join(golden, "reads.fasta"))]
    mine = lambda path: {r.name: r.codes.tobytes() for r in iter_fasta(path)
                         if r.name.rsplit("_", 1)[0] in names[:3]}
    got = mine(out)
    assert len(got) >= 3, sorted(got)
    # two correction rounds through the same CLI: the same templates come
    # out, and the second round changes at least one of them
    out2 = os.path.join(d, "corrected2.fasta")
    rc = mecat2cns.main(["-i", "0", "-a", "300", "-l", "500", "-r", "0.6",
                         "-c", "4", "--extend-batch", "32",
                         "--align-segment", "128", "--align-band", "64",
                         "--rounds", "2", "--device", "cpu", cut,
                         os.path.join(golden, "reads.fasta"), out2])
    assert rc == 0
    got2 = mine(out2)
    assert len(got2) >= 3 and got2 != got, sorted(got2)
    # the correct+trim pipeline, the sequence picker and the assembler on
    # the golden reads (nanopore preset: these reads are short)
    from mecat_tpu_torch.cli import extract_sequences, mecat2canu, pipeline

    pipe = os.path.join(d, "pipe")
    rc = pipeline.main(["-d", os.path.join(golden, "reads.fasta"), "-o", pipe,
                        "-x", "1", "-g", "20000", "-a", "400", "-n", "12",
                        "--min-coverage", "3", "--min-length", "500",
                        "--kmer-size", "9", "--scan-stride", "4",
                        "--scan-batch", "8", "--extend-batch", "32",
                        "--align-segment", "128", "--align-band", "64",
                        "--device", "cpu"])
    assert rc == 0
    for name in ("candidates.txt", "corrected.fasta", "extracted.fasta",
                 "asm_overlaps.m4", "trimmed.fasta"):
        assert os.path.getsize(os.path.join(pipe, name)) > 0, name
    rc = extract_sequences.main([os.path.join(pipe, "corrected.fasta"),
                                 os.path.join(d, "picked"), "20000", "2",
                                 "--device", "cpu"])
    assert rc == 0 and os.path.getsize(os.path.join(d, "picked.fasta")) > 0
    rc = mecat2canu.main(["-p", "g", "-d", os.path.join(d, "asm"),
                          "-assemble", "-pacbio-corrected",
                          os.path.join(pipe, "trimmed.fasta"),
                          "genomeSize=20k", "minOverlapLength=400",
                          "--device", "cpu"])
    assert rc == 0
    assert os.path.exists(os.path.join(d, "asm", "output.done"))
    for tool, argv in ((pipeline, ["-d", "a", "-o", "b", "-g", "1"]),
                       (mecat2canu, ["-p", "a", "-d", "b",
                                     "-pacbio-corrected", "c"]),
                       (extract_sequences, ["a", "b", "1", "1"])):
        try:
            tool.main(argv)
        except SystemExit as e:
            assert e.code == 2
        else:
            raise AssertionError(f"{tool.__name__} started without a card")
    # mapping through the CLI: the golden reads against three of their own
    # number as the reference, so those three map onto themselves in full
    from mecat_tpu_torch.cli import mecat2ref
    from mecat_tpu_torch.io.fasta import write_fasta

    recs = list(iter_fasta(os.path.join(golden, "reads.fasta")))
    ref = os.path.join(d, "ref.fasta")
    write_fasta(ref, [(r.name, r.codes) for r in recs[:3]])
    sam = os.path.join(d, "out.sam")
    rc = mecat2ref.main(["-d", os.path.join(golden, "reads.fasta"), "-r", ref,
                         "-w", os.path.join(d, "wr"), "-o", sam, "-a", "400",
                         "--kmer-size", "9", "--scan-stride", "4",
                         "--scan-batch", "8", "--extend-batch", "32",
                         "--align-segment", "128", "--align-band", "64",
                         "--device", "cpu"])
    assert rc == 0
    with open(sam) as fh:
        lines = [ln.split("\t") for ln in fh if not ln.startswith("@")]
    assert len(lines) == len(recs)
    for r, f in zip(recs[:3], lines[:3]):
        assert (f[0], f[1], f[2], f[3]) == (r.name, "0", r.name, "1"), f[:6]
        assert f[5] == f"{len(r.codes)}M", f[5]
    try:
        mecat2ref.main(["-d", "a", "-r", "b", "-w", "c", "-o", "e",
                        "--device", "cuda"])
    except SystemExit as e:
        assert e.code == 2
    else:
        raise AssertionError("mecat2ref started without its device")
    # the row-update micro-benchmark's tool: the plain version on the CPU,
    # and no start at all on a missing card
    from mecat_tpu_torch.tools import roll_micro

    assert roll_micro.main(["--b", "4", "--s", "16", "--w", "32", "--reps",
                            "1", "--device", "cpu"]) == 0
    try:
        roll_micro.main(["--b", "4", "--s", "16", "--w", "32"])
    except SystemExit as e:
        assert e.code == 2
    else:
        raise AssertionError("the roll_micro tool started without a card")
    # the multi-rank dry run: its ranks are fresh interpreters, so jax and
    # jaxlib are shadowed by packages that refuse to import
    import subprocess

    blk = os.path.join(d, "blk")
    for name in ("jax", "jaxlib"):
        os.makedirs(os.path.join(blk, name))
        with open(os.path.join(blk, name, "__init__.py"), "w") as fh:
            fh.write("raise ModuleNotFoundError('blocked: ' + __name__)\n")
    proc = subprocess.run(
        [sys.executable, "-m", "mecat_tpu_torch.parallel.dryrun", "2",
         "--device", "cpu", "--toy", "--timeout", "240"], cwd=d,
        env=dict(os.environ, PYTHONPATH=blk + os.pathsep + ROOT),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "DRYRUN " in proc.stdout, proc.stdout[-2000:]
    # the scalar engine, the bench (its scalar leg included) and the
    # scaling report's ranks, which also find jax shadowed
    from mecat_tpu_torch import bench
    from mecat_tpu_torch.native.scalar import ScalarEngine
    from mecat_tpu_torch.utils import scaling

    eng = ScalarEngine(recs[0].codes, [0], [len(recs[0].codes)], k=9)
    assert eng.n_valid == len(recs[0].codes) - 8
    assert bench.main(["--device", "cpu", "--genome", "6000", "--coverage",
                       "8", "--mean-len", "3000", "--B", "8", "--L", "4096",
                       "--ncand", "4", "--batches", "1", "--no-cns",
                       "--scalar"]) == 0
    assert bench.main(["--device", "cuda"]) == 2
    assert scaling.main(["--device", "cuda"]) == 2
    os.environ["PYTHONPATH"] = blk + os.pathsep + ROOT
    rows = scaling.scaling_report([(1, 1)], batch=2, n_batches=1, n_reads=4,
                                  genome_n=6000, emit=None, device="cpu",
                                  timeout=240)
    assert rows[0]["step_seconds"] > 0 and rows[0]["virtual_mesh"]
import chip_smoke

assert chip_smoke.main([]) != 0, "chip_smoke ran without a CUDA device"
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "mecat_tpu"))
assert not loaded, loaded
print("NO_JAX_OK", len(mods))
'''


def test_port_imports_and_runs_without_jax(tmp_path):
    env = dict(os.environ, MECAT_TPU_METRICS="0", CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")    # the test workers share the cores
    proc = subprocess.run(
        [sys.executable, "-c", f"ROOT = {ROOT!r}\n" + _SCRIPT],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n_mods = int(proc.stdout.split("NO_JAX_OK")[1])
    assert n_mods >= 56
    assert '"ok"' not in proc.stdout           # no result line from the smoke
