"""mecat2pw's query batches through the program, one volume's index.

Traffic keys: ``task`` (1: the ``-j 1`` fused route, M4 out; 0: the
``-j 0`` staged route, candidate text out), ``check_units`` (completed
batches the reference recomputes), ``control_units`` (how many batches of
the window order the control draws its sample from), ``warm_seconds``.

Set-up simulates the reads, builds volume 0's k-mer index on the device
(and for ``-j 1`` uploads the volume's codes), and plans the batches as
``run_pw`` plans them over every query read.  The window takes the batches
in a fixed order that interleaves lengths (:func:`interleave`), cycling, and
runs them as ``run_pw`` does: ``-j 1`` at depth one (batch k + 1
dispatched before batch k is collected), ``-j 0`` one after another.  A
batch counts once its text is out.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..gen.reads import release, simulate
from ..reference import pw as ref
from ..units import Unit, Window, interleave, sample_units


@dataclass
class State:
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    sim: object
    opts: object = None
    db: object = None
    vol_db: object = None
    va: int = 0
    vb: int = 0
    index: object = None
    vol_codes: object = None
    plan: list = field(default_factory=list)
    order: list = field(default_factory=list)
    stats: object = None
    stats0: object = None
    timings: dict = field(default_factory=dict)


def options(cfg: dict, traffic: dict) -> dict:
    """The run's mecat2pw options: the configuration's preset, the
    traffic's task."""
    return dict(cfg["pw_options"], task=int(traffic["task"]))


def setup(cfg: dict, traffic: dict, seed: int, device) -> State:
    from mecat_tpu_torch.index.kmer_index import build_index
    from mecat_tpu_torch.io.packed_db import PackedDB
    from mecat_tpu_torch.pipeline import pw as P
    from mecat_tpu_torch.pipeline.common import bucket_length

    t = time.perf_counter()
    st = State(cfg=cfg, traffic=traffic, seed=seed, device=device,
               sim=simulate(cfg, seed, device))
    st.timings["generate_s"] = time.perf_counter() - t
    release(device)
    if device.type == "cuda":
        from mecat_tpu_torch.ops import cuda_build
        t = time.perf_counter()
        cuda_build.build_all()
        st.timings["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    st.opts = P.PwOptions(**options(cfg, traffic))
    sim = st.sim
    st.db = PackedDB(codes=sim.codes, starts=sim.starts,
                     lengths=sim.lengths, names=[])
    st.va, st.vb = st.db.split_volumes(st.opts.volume_bases)[0]
    st.vol_db = (st.db if (st.va, st.vb) == (0, st.db.n_reads)
                 else st.db.subset(range(st.va, st.vb)))
    vdb = st.vol_db
    st.index = build_index(vdb.codes, vdb.starts, vdb.lengths,
                           k=st.opts.kmer_size,
                           freq_cutoff_abs=st.opts.index_cutoff,
                           device=device)
    vol_max = int(vdb.lengths.max())
    n = st.db.n_reads
    vols = st.db.split_volumes(st.opts.volume_bases)
    if st.opts.task == 1:
        st.vol_codes = torch.as_tensor(vdb.codes, device=device)
        for qa, qb in vols:
            st.plan += list(P.plan_fused_batches(st.db, qa, qb, vol_max,
                                                 st.opts))
    else:
        # run_pw's staged loop over the volume pairs (0, j)
        lt = bucket_length(vol_max)
        for qa, qb in vols:
            order = np.argsort(st.db.lengths[qa:qb], kind="stable") + qa
            for bs in range(0, len(order), st.opts.scan_batch):
                qids = [int(q) for q in order[bs:bs + st.opts.scan_batch]]
                st.plan.append((qids, st.opts.scan_batch, bucket_length(
                    int(st.db.lengths[qids].max())), lt))
    st.order = interleave(len(st.plan))
    st.stats = P.PwStats(reads=n)
    st.timings["index_plan_s"] = time.perf_counter() - t
    return st


def _dispatch(st: State, k: int):
    from mecat_tpu_torch.pipeline import pw as P
    qids, rows, lq, lt = st.plan[k]
    return P.dispatch_query_batch_fused(
        st.db, st.va, st.index, st.vol_codes, qids, st.opts, st.vol_db,
        st.stats, lq, lt, batch_rows=rows)


def _collect(st: State, pending) -> str:
    from mecat_tpu_torch.pipeline import pw as P
    return P.collect_query_batch_fused(pending, st.va, st.vol_db, st.opts,
                                       st.stats)


def _staged(st: State, k: int) -> str:
    from mecat_tpu_torch.pipeline import pw as P
    qids, _, lq, lt = st.plan[k]
    _, text = P.process_query_batch(st.db, st.va, st.index, qids, st.opts,
                                    st.vol_db, st.stats, lq, lt)
    return text


def _bases(st: State, k: int) -> int:
    return int(st.db.lengths[st.plan[k][0]].sum())


def _run_unit(st: State, k: int) -> str:
    if st.opts.task == 1:
        return _collect(st, _dispatch(st, k))
    return _staged(st, k)


def warm(st: State) -> None:
    """The longest and the shortest batch, then batches of the window's
    order until ``warm_seconds`` have passed: the kernels load, the
    allocator holds the largest shapes and the card and the host run at
    their working clocks before the window."""
    t = time.perf_counter()
    for k in sorted({len(st.plan) - 1, 0}, reverse=True):
        _run_unit(st, k)
    i = 0
    while time.perf_counter() - t < float(st.traffic.get("warm_seconds", 0)):
        _run_unit(st, st.order[i % len(st.order)])
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
    if st.opts.task == 1:
        pending: Optional[tuple] = None
        while True:
            k = st.order[pos % n]
            with ann(f"pw.dispatch#{pos}"):
                nxt = _dispatch(st, k)
            if pending is not None:
                u, p = pending
                with ann(f"pw.collect#{u.pos}"):
                    u.text = _collect(st, p)
                done.append(u)
            pending = (Unit(pos, k, _bases(st, k)), nxt)
            pos += 1
            if time.perf_counter() - t0 >= seconds:
                u, p = pending
                with ann(f"pw.collect#{u.pos}"):
                    u.text = _collect(st, p)
                done.append(u)
                break
    else:
        while time.perf_counter() - t0 < seconds:
            k = st.order[pos % n]
            u = Unit(pos, k, _bases(st, k))
            with ann(f"pw.batch#{pos}"):
                u.text = _staged(st, k)
            done.append(u)
            pos += 1
    return Window(done=done, attempted=len(done), failed=0,
                  seconds=time.perf_counter() - t0)


def counters(st: State, win: Window) -> dict:
    """The program's counters over the window."""
    a, b = dataclasses.asdict(st.stats0), dataclasses.asdict(st.stats)
    return {k: b[k] - a[k] for k in a}


def end_to_end(st: State, win: Window) -> dict:
    return {"pw_bases_per_s": sum(u.bases for u in win.done) / win.seconds}


def free(st: State) -> None:
    st.index = st.vol_codes = None


def _reference(st_sim, cfg, traffic, device):
    opts = options(cfg, traffic)
    reads = ref.Reads(st_sim.codes, st_sim.starts, st_sim.lengths)
    va, vb = ref.volumes(reads.lengths, opts["volume_bases"])[0]
    index = ref.build_index(reads, va, vb, opts["kmer_size"],
                            opts["index_cutoff"], device)
    return opts, reads, va, vb, index, ref.plan(reads.lengths, opts)


def _unit_text(opts, reads, va, vb, index, plan, k, fdtype, tally):
    qids, _, lq, lt = plan[k]
    if opts["task"] == 1:
        return ref.batch_m4(reads, index, va, vb, qids, lq, lt, opts,
                            fdtype=fdtype, tally=tally)
    return ref.batch_candidates(reads, index, va, vb, qids, lq, opts)


def lines_differing(got: str, want: str) -> int:
    """Lines in one text and not the other, counted with multiplicity."""
    from collections import Counter
    a, b = Counter(got.splitlines()), Counter(want.splitlines())
    return sum(((a - b) + (b - a)).values())


def _check_name(opts) -> str:
    return "m4_lines_differing" if opts["task"] == 1 else \
        "candidate_lines_differing"


def check(st: State, sample: List[Unit], trace: bool = False):
    """Each sampled batch's text against the reference's; returns (checks,
    work) where work holds the reference's tally of the batches' DP."""
    opts, reads, va, vb, index, plan = _reference(st.sim, st.cfg, st.traffic,
                                                  st.device)
    diff, tally, lines = 0, ref.Tally(), 0
    for u in sample:
        want = _unit_text(opts, reads, va, vb, index, plan, u.plan,
                          torch.float32, tally)
        diff += lines_differing(u.text, want)
        lines += want.count("\n")
    work = {"dp_counts": dataclasses.asdict(tally), "units":
            [u.pos for u in sample], "reference_lines": lines}
    return {_check_name(opts): (diff, 0),
            "no_unit_checked": (0 if sample else 1, 0)}, work


def control(cfg: dict, traffic: dict, seed: int, device):
    """The reference with its float32 arithmetic in bfloat16, in the
    program's place, judged as a run judges the program."""
    sim = simulate(cfg, seed, device)
    opts, reads, va, vb, index, plan = _reference(sim, cfg, traffic, device)
    order = interleave(len(plan))[:int(traffic["control_units"])]
    units = [Unit(p, k, int(reads.lengths[plan[k][0]].sum()))
             for p, k in enumerate(order)]
    diff = 0
    for u in sample_units(units, seed, int(traffic["check_units"])):
        got = _unit_text(opts, reads, va, vb, index, plan, u.plan,
                         torch.bfloat16, ref.Tally())
        want = _unit_text(opts, reads, va, vb, index, plan, u.plan,
                          torch.float32, ref.Tally())
        diff += lines_differing(got, want)
    return {_check_name(opts): (diff, 0)}
