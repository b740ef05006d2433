"""mecat2cns's table slices through the program (``-i 0``, one round).

Traffic keys: ``table_cap_bytes`` (the slice plan's table cap: what
``table_cap`` gives on an 80 GB card), ``check_units`` (completed slices
the reference checks), ``check_templates`` (templates of each checked
slice the reference recomputes, the longest among them),
``control_units``, ``control_est_coverage`` (the control's pile cut),
``warm_seconds``.

Set-up simulates the reads with their truth maps, derives the ``-j 0``
candidate records from the truth (``gen.candidates``), builds the support
table with the program's own record parse, uploads the device volume, and
plans the table slices of every template with supports, as ``run_cns``
plans its one partition.  The window runs ``correct_batch_device`` one
slice at a time, in a fixed order that interleaves lengths, cycling; a
slice counts once every corrected read of it is out.
"""
from __future__ import annotations

import copy
import dataclasses
import random
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from ..gen.candidates import truth_candidates
from ..gen.reads import release, simulate
from ..reference import cns as ref
from ..units import Unit, Window, interleave, sample_units


@dataclass
class State:
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    sim: object
    cands: np.ndarray = None
    opts: object = None
    db: object = None
    by_template: object = None
    dev_vol: object = None
    slices: list = field(default_factory=list)
    order: list = field(default_factory=list)
    stats: object = None
    stats0: object = None
    timings: dict = field(default_factory=dict)


def _inputs(cfg, traffic, seed, device):
    t = time.perf_counter()
    sim = simulate(cfg, seed, device, keep_map=True)
    t_gen = time.perf_counter() - t
    t = time.perf_counter()
    cands = truth_candidates(sim, int(cfg["cns_options"]["min_align_size"]))
    return sim, cands, t_gen, time.perf_counter() - t


def setup(cfg: dict, traffic: dict, seed: int, device) -> State:
    from mecat_tpu_torch.io.packed_db import PackedDB
    from mecat_tpu_torch.pipeline import cns as P

    sim, cands, t_gen, t_cand = _inputs(cfg, traffic, seed, device)
    release(device)
    st = State(cfg=cfg, traffic=traffic, seed=seed, device=device, sim=sim,
               cands=cands)
    st.timings.update(generate_s=t_gen, candidates_s=t_cand)
    if device.type == "cuda":
        from mecat_tpu_torch.ops import cuda_build
        t = time.perf_counter()
        cuda_build.build_all()
        st.timings["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    st.opts = P.CnsOptions(**cfg["cns_options"])
    st.db = PackedDB(codes=sim.codes, starts=sim.starts, lengths=sim.lengths,
                     names=[])
    # the program's parse of -i 0 records, without the text
    t1, c1, t2, c2 = P._sides_from_columns(cands, 0)
    n = len(t1)
    st.by_template = P.SupportTable(
        np.concatenate([t1, t2]), np.concatenate([c1, c2]),
        tiebreak=np.concatenate([2 * np.arange(n), 2 * np.arange(n) + 1]))
    st.dev_vol = P.device_volume(st.db, device)
    templates = sorted(st.by_template)
    st.slices = P.plan_table_slices(st.db, templates,
                                    int(traffic["table_cap_bytes"]))
    st.order = interleave(len(st.slices))
    st.stats = P.CnsStats()
    st.timings["supports_plan_s"] = time.perf_counter() - t
    return st


def _run_slice(st: State, k: int) -> dict:
    from mecat_tpu_torch.pipeline import cns as P
    out = {}
    for name, seg in P.correct_batch_device(
            st.db, st.slices[k], st.by_template, st.opts, st.stats,
            device=st.device, dev_vol=st.dev_vol,
            cap=int(st.traffic["table_cap_bytes"])):
        out[name] = np.asarray(seg, dtype=np.uint8).tobytes()
    return out


def _bases(st: State, k: int) -> int:
    return int(st.db.lengths[st.slices[k]].sum())


def warm(st: State) -> None:
    """The longest and the shortest slice, then slices of the window's
    order until ``warm_seconds`` have passed."""
    t = time.perf_counter()
    for k in sorted({len(st.slices) - 1, 0}, reverse=True):
        _run_slice(st, k)
    i = 0
    while time.perf_counter() - t < float(st.traffic.get("warm_seconds", 0)):
        _run_slice(st, st.order[i % len(st.order)])
        i += 1
    st.timings["warm_s"] = time.perf_counter() - t


def window(st: State, seconds: float, annotate=None) -> Window:
    import contextlib
    ann = annotate or (lambda label: contextlib.nullcontext())
    st.stats0 = copy.copy(st.stats)
    n = len(st.order)
    done: List[Unit] = []
    t0 = time.perf_counter()
    pos = 0
    while time.perf_counter() - t0 < seconds:
        k = st.order[pos % n]
        u = Unit(pos, k, _bases(st, k))
        with ann(f"cns.slice#{pos}"):
            u.text = _run_slice(st, k)
        done.append(u)
        pos += 1
    return Window(done=done, attempted=len(done), failed=0,
                  seconds=time.perf_counter() - t0)


def counters(st: State, win: Window) -> dict:
    a, b = dataclasses.asdict(st.stats0), dataclasses.asdict(st.stats)
    return {k: b[k] - a[k] for k in a}


def end_to_end(st: State, win: Window) -> dict:
    return {"cns_bases_per_s": sum(u.bases for u in win.done) / win.seconds}


def free(st: State) -> None:
    st.dev_vol = None


class _Ref:
    """The reference's own view of the inputs: support table, slice plan,
    device volume."""

    def __init__(self, sim, cands, cfg, traffic, device):
        self.opts = dict(cfg["cns_options"])
        self.reads = ref.Reads(sim.codes, sim.starts, sim.lengths, device)
        self.by_template = ref.support_table(cands)
        self.slices = ref.plan_table_slices(
            self.reads, sorted(self.by_template),
            int(traffic["table_cap_bytes"]))

    def sample(self, k: int, seed: int, n: int) -> List[int]:
        """``n`` templates of slice k drawn from the seed, the longest
        always among them."""
        sl = list(self.slices[k])
        longest = max(sl, key=lambda t: (int(self.reads.lengths[t]), -t))
        rest = [t for t in sl if t != longest]
        return [longest] + random.Random(seed * 7919 + k).sample(
            rest, min(n - 1, len(rest)))

    def texts(self, k, sample, fdtype) -> dict:
        segs = ref.correct_templates(self.reads, self.by_template, self.opts,
                                     list(self.slices[k]), sample,
                                     fdtype=fdtype)
        return {t: [np.asarray(s, np.uint8).tobytes() for s in v]
                for t, v in segs.items()}


def _program_segments(unit: Unit, t: int) -> list:
    """The program's segments of template t (headers ``{t}_{k}``)."""
    out, k = [], 0
    while f"{t}_{k}" in unit.text:
        out.append(unit.text[f"{t}_{k}"])
        k += 1
    return out


def segments_differing(got: dict, want: dict) -> int:
    """Templates whose corrected segments differ in number or in any base
    (each segment compared whole), summed: differing segments of each
    template, plus the count difference."""
    diff = 0
    for t, w in want.items():
        g = got.get(t, [])
        diff += abs(len(g) - len(w)) + sum(a != b for a, b in zip(g, w))
    return diff


def check(st: State, sample: List[Unit], trace: bool = False):
    """Sampled templates of each sampled slice against the reference;
    returns (checks, work).  With ``trace`` work also holds the DP work
    every pair of those slices needs (``reference.cns.slice_tally``)."""
    r = _Ref(st.sim, st.cands, st.cfg, st.traffic, st.device)
    n_t = int(st.traffic["check_templates"])
    diff, segs = 0, 0
    tally = ref.Tally()
    for u in sample:
        tmpl = r.sample(u.plan, st.seed, n_t)
        want = r.texts(u.plan, tmpl, torch.float32)
        got = {t: _program_segments(u, t) for t in tmpl}
        diff += segments_differing(got, want)
        segs += sum(len(v) for v in want.values())
        if trace:
            t = ref.slice_tally(r.reads, r.by_template, r.opts,
                                list(r.slices[u.plan]))
            for k in ("cells", "q_bytes", "t_bytes", "lane_segments"):
                setattr(tally, k, getattr(tally, k) + getattr(t, k))
    work = {"dp_moves": dataclasses.asdict(tally),
            "units": [u.pos for u in sample], "reference_segments": segs}
    return {"corrected_segments_differing": (diff, 0),
            "no_unit_checked": (0 if sample and segs else 1, 0)}, work


def control(cfg: dict, traffic: dict, seed: int, device):
    """The control: the reference in the program's place with one stated
    guarantee broken, the one a speed-up would be tempted to break: piles
    cut at an estimated coverage of ``control_est_coverage`` (20) instead
    of the configuration's 25, so every template votes from fewer
    supports.  Beside it, the reading of the float32 gates (segment and
    pair identity, mapping ratio) in bfloat16; the configuration states no
    arithmetic precision (alignment, tags and vote are integers), and those
    gates rarely sit near their thresholds."""
    sim, cands, _, _ = _inputs(cfg, traffic, seed, device)
    r = _Ref(sim, cands, cfg, traffic, device)
    order = interleave(len(r.slices))[:int(traffic["control_units"])]
    units = [Unit(p, k, int(r.reads.lengths[r.slices[k]].sum()))
             for p, k in enumerate(order)]
    low = broken = 0
    for u in sample_units(units, seed, int(traffic["check_units"])):
        tmpl = r.sample(u.plan, seed, int(traffic["check_templates"]))
        want = r.texts(u.plan, tmpl, torch.float32)
        low += segments_differing(r.texts(u.plan, tmpl, torch.bfloat16),
                                  want)
        opts = r.opts
        r.opts = dict(opts,
                      max_est_coverage=int(traffic["control_est_coverage"]))
        broken += segments_differing(r.texts(u.plan, tmpl, torch.float32),
                                     want)
        r.opts = opts
    return {"corrected_segments_differing": (broken, 0),
            "bfloat16_gates_segments_differing": (low, 0)}
