"""A configuration, a traffic mix and a metric added as files only.

In a copy of the benchmark, new files under ``configs/``, ``traffic/`` and
``metrics/`` plus entries in the copy's ``BENCHMARK.json`` make a new cell
that the harness lists, resolves and runs (on the CPU, at a tiny size),
reporting the new metric; no file the copy already had is edited.
"""
import hashlib
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "mecat_bench")):
        if "__pycache__" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


SCRIPT = r'''
import json, sys, time
sys.path.insert(0, PROGRAM)
sys.path.insert(0, ROOT)
import torch
torch.set_num_threads(2)
from mecat_bench import harness
assert harness.ROOT == ROOT, harness.ROOT
found = harness.listing(ROOT)
res = harness.run_cell("tiny-ont.candidates", 5, 0.5, False, device="cpu",
                       t_proc=time.time(), root=ROOT)
trace_res = harness.run_cell("tiny-ont.candidates", 6, 0.5, True,
                             device="cpu", t_proc=time.time(), root=ROOT)
print(json.dumps({"found": found, "metrics": res["metrics"],
                  "traced": trace_res["metrics"],
                  "correct": [res["correct"], trace_res["correct"]]}))
'''


def test_new_cell_from_files_only(tmp_path):
    root = str(tmp_path / "checkout")
    os.makedirs(root)
    shutil.copytree(os.path.join(ROOT, "mecat_bench"),
                    os.path.join(root, "mecat_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digests(root)

    base = os.path.join(root, "mecat_bench")
    cfg = json.load(open(os.path.join(base, "configs", "yeast-ont.json")))
    cfg.update(name="tiny-ont", genome_size=20000, coverage=6,
               mean_len=3000, min_len=2000)
    cfg["pw_options"]["scan_batch"] = 8
    with open(os.path.join(base, "configs", "tiny-ont.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(base, "traffic", "candidates-small.json"),
              "w") as fh:
        json.dump({"kind": "pw", "why": "tiny -j 0 batches", "task": 0,
                   "check_units": 1, "control_units": 2}, fh)
    with open(os.path.join(base, "metrics", "candidates_per_read.pw.py"),
              "w") as fh:
        fh.write("def read(ctx):\n"
                 "    return ctx.counters['candidates'] / max(\n"
                 "        1, len(ctx.sample))\n")
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["workloads"].append({"name": "tiny-ont.candidates",
                               "config": "tiny-ont",
                               "traffic": "candidates-small", "chips": 1,
                               "why": "a cell added by data alone"})
    for m in bench["end_to_end"]:
        if m["name"] == "pw_bases_per_s":
            m["workloads"].append("tiny-ont.candidates")
    bench["per_layer"].append({
        "name": "candidates_per_read.pw", "unit": "1", "better": "higher",
        "source": "program_counter", "layer": "pw driver",
        "moves": "pw_bases_per_s", "workloads": ["tiny-ont.candidates"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)

    out = subprocess.run(
        [sys.executable, "-c",
         f"ROOT = {root!r}\nPROGRAM = {ROOT!r}\n" + SCRIPT],
        capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "tiny-ont" in res["found"]["configs"]
    assert "candidates-small" in res["found"]["traffic"]
    assert "candidates_per_read.pw" in res["found"]["metrics"]
    assert set(res["metrics"]) == {"pw_bases_per_s", "setup_s"}
    assert res["metrics"]["pw_bases_per_s"]["value"] > 0
    assert "candidates_per_read.pw" in res["traced"]
    assert res["correct"] == [True, True]
    after = _digests(root)
    assert {k: after[k] for k in before} == before
