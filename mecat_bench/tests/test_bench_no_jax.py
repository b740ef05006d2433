"""The harness loads neither JAX nor the JAX package.

A subprocess blocks ``jax``, ``jaxlib``, ``flax`` and ``mecat_tpu`` on
``sys.meta_path`` (comparing each module's top-level name whole, so
``mecat_tpu_torch`` passes), imports the harness and the run script, and
runs what a CPU reaches: generation, the truth candidates, both
references, configuration, traffic and metric lookup by name.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SCRIPT = r'''
import importlib.abc, sys
BLOCKED = {"jax", "jaxlib", "flax", "mecat_tpu"}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, ROOT)
import json, torch
torch.set_num_threads(2)
from mecat_bench import harness, run
from mecat_bench.gen.candidates import truth_candidates
from mecat_bench.gen.reads import simulate
from mecat_bench.reference import cns as rcns, pw as rpw
from mecat_bench.kinds import cns as kcns, pw as kpw

bench = harness.load_benchmark(ROOT)
for wl in bench["workloads"]:
    harness.cell_spec(wl["name"], ROOT, bench)
for m in bench["per_layer"]:
    harness.metric_reader(m["name"], ROOT)
cfg = dict(genome_size=16000, coverage=6, mean_len=3000, min_len=2000,
           error_rate=0.12, profile=[0.4, 0.2, 0.4])
sim = simulate(cfg, 11, "cpu", keep_map=True)
cands = truth_candidates(sim, 400)
reads = rpw.Reads(sim.codes, sim.starts, sim.lengths)
opts = dict(harness.load_json(ROOT, "configs", "yeast-ont")["pw_options"],
            task=1, num_candidates=4)
plan = rpw.plan(reads.lengths, opts)
index = rpw.build_index(reads, 0, len(reads.lengths), 13, None, "cpu")
rpw.batch_m4(reads, index, 0, len(reads.lengths), plan[-1][0], plan[-1][2],
             plan[-1][3], opts)
copts = harness.load_json(ROOT, "configs", "yeast-ont")["cns_options"]
r = rcns.Reads(sim.codes, sim.starts, sim.lengths, "cpu")
table = rcns.support_table(cands)
tmpl = sorted(table)
rcns.correct_templates(r, table, copts, tmpl, tmpl[:2])
print(json.dumps(run.forbidden_modules()))
'''


def test_harness_imports_no_jax():
    code = f"ROOT = {ROOT!r}\n" + SCRIPT
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_whole_top_level_names():
    sys.path.insert(0, ROOT)
    from mecat_bench import run
    saved = dict(sys.modules)
    try:
        sys.modules["mecat_tpu_torch_extra"] = sys
        sys.modules["jaxon"] = sys
        assert "mecat_tpu_torch_extra" not in run.forbidden_modules()
        assert "jaxon" not in run.forbidden_modules()
        sys.modules["mecat_tpu.constants"] = sys
        assert "mecat_tpu.constants" in run.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]
