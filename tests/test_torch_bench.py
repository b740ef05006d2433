"""``python -m mecat_tpu_torch.bench --device cpu`` at a tiny size: one JSON
line with ``bench.py``'s keys, and the same overlaps, useful lane-segments,
cns supports and corrected reads as ``bench.py``'s ``run_on`` / ``run_cns``
on the same workload (run in a subprocess that imports ``bench.py`` with
the matching ``BENCH_*`` variables on the JAX CPU backend)."""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the tiny workload: 24 reads of mean 3 kb over an 8 kb genome, 8 a batch
SIZE = dict(genome=8000, coverage=12, mean_len=3000, L=4096, B=8, ncand=8,
            batches=3, cns_templates=8)
KEYS = {"metric", "value", "unit", "vs_baseline",
        "baseline_scalar_core_ovl_s", "index_build_s", "warmup_s",
        "steady_s", "dp_gcells_per_s_issued", "dp_gcells_per_s_useful",
        "cns_supports_per_s", "cns_templates", "cns_supports",
        "cns_corrected_reads", "cns_corrected_reads_per_s", "cns_steady_s",
        "cns_first_pass_s", "backend", "device", "overlaps",
        "useful_segments", "batches", "reads", "dp_launches",
        "dp_launches_extend", "cns_dp_launches_moves",
        "cns_dp_launches_extend_moves", "cns_walk_launches_rows",
        "cns_walk_launches_deposit", "cns_walk_launches_cols",
        "cns_walk_launches_planes", "cns_walk_launches_fold"}

_REFERENCE = r'''
import json, sys
sys.path.insert(0, ROOT)
import bench, jax
db, idx = bench.build_workload()
overlaps, useful, _, _, supports = bench.run_on(
    jax.devices()[0], db, idx, BATCHES, collect_supports=True)
cns = bench.run_cns(db, supports)
print("REFERENCE " + json.dumps(dict(
    overlaps=overlaps, useful_segments=useful, reads=db.n_reads,
    cns_supports=cns["cns_supports"],
    cns_corrected_reads=cns["cns_corrected_reads"])))
'''


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def test_bench_line_matches_reference_bench():
    argv = [sys.executable, "-m", "mecat_tpu_torch.bench", "--device", "cpu",
            "--scalar"]
    for k, v in SIZE.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    proc = subprocess.run(argv, cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == KEYS
    assert line["backend"] == "torch"
    assert line["device"] == {"name": "cpu", "power_limit_w": None,
                              "count": 0}
    assert line["batches"] == SIZE["batches"]
    assert line["dp_launches"] == line["cns_dp_launches_moves"] == 0
    assert line["dp_launches_extend"] == 0
    assert line["cns_dp_launches_extend_moves"] == 0
    assert line["cns_walk_launches_rows"] == 0
    assert line["cns_walk_launches_deposit"] == 0
    assert line["cns_walk_launches_cols"] == 0
    assert line["cns_walk_launches_planes"] == 0
    assert line["cns_walk_launches_fold"] == 0
    assert line["overlaps"] > 0 and line["cns_corrected_reads"] > 0
    assert line["baseline_scalar_core_ovl_s"] > 0
    assert line["vs_baseline"] == (line["value"]
                                   / line["baseline_scalar_core_ovl_s"])

    code = _REFERENCE.replace("ROOT", repr(ROOT)).replace(
        "BATCHES", str(SIZE["batches"]))
    ref = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env=_env(
            JAX_PLATFORMS="cpu", BENCH_GENOME=str(SIZE["genome"]),
            BENCH_COVERAGE=str(SIZE["coverage"]),
            BENCH_MEAN_LEN=str(SIZE["mean_len"]), BENCH_L=str(SIZE["L"]),
            BENCH_B=str(SIZE["B"]), BENCH_NCAND=str(SIZE["ncand"]),
            BENCH_CNS_TEMPLATES=str(SIZE["cns_templates"])))
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = json.loads([ln for ln in ref.stdout.splitlines()
                       if ln.startswith("REFERENCE ")][-1][10:])
    assert {k: line[k] for k in want} == want


def test_bench_refuses_cuda_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "mecat_tpu_torch.bench", "--device", "cuda"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and proc.stdout == ""
