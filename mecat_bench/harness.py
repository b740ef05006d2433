"""The benchmark's core: find a cell's files by name, run it once, report.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix.  Each is a data file found by its name:
``configs/<config>.json`` holds the deployment's sizes and options,
``traffic/<mix>.json`` the parameters of the work, among them ``kind``, the
module of ``kinds/`` that drives that kind of work through the program.
Each per-layer metric is a reader ``metrics/<name>.py`` with
``read(ctx) -> float | None``.  Adding a cell, a configuration or a metric
adds files and entries; no file here changes.

One run (:func:`run_cell`): generate the inputs from the seed, set up the
program's state, warm the cell's shapes, run the timed window (under
``torch.profiler`` with ``trace``), read the peak memory, free the
program's state, check the sampled outputs against the plain reference,
and return the result line's fields.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace

from . import trace as trace_mod
from .units import sample_units

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def load_json(root: str, folder: str, name: str) -> dict:
    """``mecat_bench/<folder>/<name>.json`` under ``root``."""
    path = os.path.join(root, os.path.basename(PKG_DIR), folder,
                        name + ".json")
    with open(path) as fh:
        return json.load(fh)


def listing(root: str = ROOT) -> dict:
    """Names of every configuration, traffic mix and metric reader found
    under the benchmark's folders."""
    base = os.path.join(root, os.path.basename(PKG_DIR))

    def names(folder, ext):
        d = os.path.join(base, folder)
        return sorted(f[:-len(ext)] for f in os.listdir(d)
                      if f.endswith(ext) and not f.startswith("_"))

    return {"configs": names("configs", ".json"),
            "traffic": names("traffic", ".json"),
            "metrics": names("metrics", ".py")}


def metric_reader(name: str, root: str = ROOT):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(root, os.path.basename(PKG_DIR), "metrics",
                        name + ".py")
    spec = importlib.util.spec_from_file_location(
        "mecat_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kind_module(kind: str):
    return importlib.import_module(f"{__package__}.kinds.{kind}")


def cell_spec(name: str, root: str = ROOT, bench: dict | None = None):
    """(workload entry, configuration, traffic) of cell ``name``."""
    bench = bench or load_benchmark(root)
    for wl in bench["workloads"]:
        if wl["name"] == name:
            return (wl, load_json(root, "configs", wl["config"]),
                    load_json(root, "traffic", wl["traffic"]))
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, name: str, section: str) -> list:
    """The metrics of ``section`` that cell ``name`` reports."""
    return [m for m in bench[section]
            if "workloads" not in m or name in m["workloads"]]


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device, t_proc: float, root: str = ROOT, control: bool = False,
             spec=None) -> dict:
    """One run of cell ``name``; returns the result line's fields plus
    ``checks`` (name -> (value, limit)).  ``spec`` overrides the cell's
    (workload, config, traffic), as the CPU tests do."""
    import torch

    device = torch.device(device)
    bench = load_benchmark(root)
    wl, cfg, traffic = spec or cell_spec(name, root, bench)
    kind = kind_module(traffic["kind"])
    if control:
        return _run_control(kind, cfg, traffic, seed, device)

    state = kind.setup(cfg, traffic, seed, device)
    kind.warm(state)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - t_proc
    _log(f"{name}: set-up {setup_s:.3f} s " + " ".join(
        f"{k} {v:.3f}" for k, v in state.timings.items()))

    # every window starts from the same collected heap
    gc.collect()
    prof = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
    with prof as p:
        with _annotate("bench.window") if trace else contextlib.nullcontext():
            win = kind.window(state, seconds, _annotate if trace else None)
    peak = (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)
    counters = kind.counters(state, win)
    tr = trace_mod.read_profile(p) if trace else None
    kind.free(state)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    _log(f"{name}: window {win.seconds:.3f} s, {len(win.done)} units")
    sample = sample_units(win.done, seed, int(traffic["check_units"]))
    t = time.time()
    checks, work = kind.check(state, sample, trace)
    _log(f"{name}: reference check of units "
         f"{[u.pos for u in sample]} {time.time() - t:.3f} s")

    out = {"attempted": win.attempted, "failed": win.failed}
    metrics = {}
    if not trace:
        e2e = kind.end_to_end(state, win)
        e2e["setup_s"] = setup_s
        for m in cell_metrics(bench, wl["name"], "end_to_end"):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    else:
        ctx = SimpleNamespace(cell=wl["name"], window_s=win.seconds,
                              device_kind=(torch.cuda.get_device_name(device)
                                           if device.type == "cuda" else "cpu"),
                              counters=counters, trace=tr, work=work,
                              sample=[u.pos for u in sample])
        for m in cell_metrics(bench, wl["name"], "per_layer"):
            value = metric_reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["breakdown"] = tr.breakdown()
        out["busy_s"] = tr.busy_s
        out["window_s"] = tr.window_s
    out["metrics"] = metrics
    out["peak"] = peak
    out["checks"] = checks
    out["correct"] = bool(checks) and all(v <= lim
                                          for v, lim in checks.values())
    return out


def _run_control(kind, cfg, traffic, seed, device) -> dict:
    """The control of the cell's kind (``kind.control``): the reference in
    the program's place, changed as that kind states, judged as a run."""
    checks = kind.control(cfg, traffic, seed, device)
    return {"attempted": 0, "failed": 0, "metrics": {}, "peak": 0,
            "checks": checks,
            "correct": all(v <= lim for v, lim in checks.values())}


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@contextlib.contextmanager
def _annotate(label: str):
    from torch.profiler import record_function
    with record_function(label):
        yield
