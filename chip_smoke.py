#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mecat_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line; any failure ends the run with a
non-zero exit and no result line:

1. card: ``nvidia-smi`` name and power limit; build the Hopper DP kernel
   from ``mecat_tpu_torch/csrc/dp_segment.cu`` and time the build;
2. kernel against its plain PyTorch version on the card at (S, W) =
   (128, 64) and (512, 128), 4096 lanes: r, w, v equal on every lane
   (including lanes with no valid cell and inactive lanes), median times;
3. golden bytes: ``run_pw(device="cuda")`` on ``tests/golden/reads.fasta``
   reproduces ``tests/golden/overlaps.m4`` (-j 1) and ``candidates.txt``
   (-j 0) byte for byte;
4. the bench workload (500 kb genome, 15x, mean 5 kb, 12 % error, seeds
   91/92; k 13, stride 10, N 16, S 512, W 128, 30 segments, B 128, L 8192)
   through ``overlap_step``: a warm-up batch, then ``--passes`` (default 7)
   steady passes over every batch; per-pass seconds (quartiles), overlaps/s
   of the median pass, issued and useful DP Gcells/s, peak device memory;
   batch 0 equals the plain-version ``overlap_step``.  ``--profile`` adds
   one pass under ``torch.profiler`` and prints the device-time breakdown;
5. the CLI ``python -m mecat_tpu_torch.cli.mecat2pw -j 1`` on the bench
   reads as a subprocess: exit 0, record count, wall seconds, and its own
   metrics summary (phase split, useful DP Gcells/s, DP kernel launches,
   which must be > 0).

The DP kernel's launch counter is zeroed just before phase 4's steady
passes and read just after them, so the reported launches are those of the
main path only.  The line before the last is a JSON object with the
kernel's numbers; the last line is ``{"ok": true, "device": {...}}``.
Exits non-zero without a CUDA device or without the repository beside it.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "mecat_tpu_torch/csrc/dp_segment.cu"
KERNEL_REPLACES = "mecat_tpu/ops/pallas_dp.py:56"

# bench workload (bench.py:57-65)
GENOME, COVERAGE, MEAN_LEN, B, L = 500_000, 15, 5000, 128, 8192
CFG = dict(k=13, stride=10, max_occ=16, num_candidates=16, diag_bin=256,
           L_target=L, S=512, W=128, max_segs=30, min_align_size=1000,
           min_identity=70.0)
DP_LANES = 4096   # the bench's 2 * B * N extension lanes


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_median_ms(fn, reps: int) -> float:
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_kernel(S: int, W: int) -> dict:
    import torch

    from mecat_tpu_torch.ops.align import (dp_segment_best,
                                           dp_segment_best_plain)
    from mecat_tpu_torch.testing import dp_inputs

    dev = torch.device("cuda")
    args = [torch.as_tensor(a, device=dev)
            for a in dp_inputs(S, W, DP_LANES, seed=121 + S + W)]
    got = dp_segment_best(*args, S, W)
    want = dp_segment_best_plain(*args, S, W)
    torch.cuda.synchronize()
    err = 0
    for name, g, w in zip(("r", "w", "j", "d", "ind"), got, want):
        diff = (g.long() - w.long()).abs()
        err = max(err, int(diff.max()))
        if not torch.equal(g, w):
            bad = int((g != w).sum())
            raise AssertionError(f"kernel != plain at S={S} W={W}: {name} "
                                 f"differs on {bad} lanes")
    ms = cuda_median_ms(lambda: dp_segment_best(*args, S, W), 21)
    plain_ms = cuda_median_ms(lambda: dp_segment_best_plain(*args, S, W), 3)
    say(f"phase 2: kernel == plain at S={S} W={W} lanes={DP_LANES}: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_golden(work: str) -> None:
    from mecat_tpu_torch.pipeline.pw import PwOptions, run_pw
    from mecat_tpu_torch.testing import GOLDEN_J0, GOLDEN_J1

    golden = os.path.join(ROOT, "tests", "golden")
    reads = os.path.join(golden, "reads.fasta")
    for name, opts, want in (("-j 1", GOLDEN_J1, "overlaps.m4"),
                             ("-j 0", GOLDEN_J0, "candidates.txt")):
        out = os.path.join(work, want)
        t0 = time.time()
        run_pw(reads, out, os.path.join(work, "w" + want), PwOptions(**opts),
               device="cuda")
        with open(out, "rb") as fh, \
                open(os.path.join(golden, want), "rb") as gh:
            if fh.read() != gh.read():
                raise AssertionError(f"golden {want} differs on the card")
        say(f"phase 3: golden {name} byte-equal on the card "
            f"({time.time() - t0:.2f} s)")


def bench_reads():
    from mecat_tpu_torch.utils.sim import random_genome, simulate_reads

    n_reads = int(GENOME * COVERAGE / MEAN_LEN)
    n_reads -= n_reads % B or B
    genome = random_genome(GENOME, seed=91)
    db, _ = simulate_reads(genome, n_reads, mean_len=MEAN_LEN, min_len=2000,
                           seed=92, error_rate=0.12)
    return db


def steady_pass(batches, table, overlap_step):
    """One pass of ``overlap_step`` over every batch; returns (seconds,
    overlaps, useful lane-segments), timed on the host up to a sync."""
    import torch

    t0 = time.time()
    valid, segs = [], []
    for a in batches:
        o = overlap_step(*a, *table, **CFG)
        valid.append(o.valid.sum())
        segs.append(o.n_segs.sum())
    overlaps = int(torch.stack(valid).sum())
    useful_segs = int(torch.stack(segs).sum())
    return time.time() - t0, overlaps, useful_segs


def profile_pass(batches, table, overlap_step, path: str) -> None:
    """One pass under torch.profiler: kernel time in total and by kernel.

    Only the device's own kernel events are summed (an operator's row
    repeats the time of the kernels it launched).  The whole table goes to
    ``path``; the top kernels are printed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _, _ = steady_pass(batches, table, overlap_step)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    total_us = sum(dev_us(e) for e in kernels)
    n_dev = sum(e.count for e in kernels)
    say(f"profile: one pass under torch.profiler: wall {wall * 1e3:.2f} ms, "
        f"kernel time {total_us / 1e3:.2f} ms in {n_dev} kernels")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        say(f"profile:   {dev_us(e) / 1e3:9.3f} ms "
            f"{100 * dev_us(e) / max(total_us, 1):5.1f} %  x{e.count:<6d} "
            f"{e.key[:70]}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(events.table(sort_by="self_cuda_time_total", row_limit=60))


def phase_bench(db, passes: int, profile_path: str | None) -> dict:
    import torch

    from mecat_tpu_torch.index.kmer_index import build_index
    from mecat_tpu_torch.ops import dp_kernel
    from mecat_tpu_torch.ops.align import dp_segment_best_plain
    from mecat_tpu_torch.pipeline.device_step import overlap_step

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    idx = build_index(db.codes, db.starts, db.lengths, k=CFG["k"],
                      device=dev)
    vol = torch.as_tensor(db.codes, device=dev)
    torch.cuda.synchronize()
    index_s = time.time() - t0
    table = (vol, idx.offsets, idx.pos_rid, idx.pos_loc, idx.read_starts,
             idx.read_lengths, idx.max_occ_cutoff)
    n_batches = db.n_reads // B
    batches = []
    for bi in range(n_batches):
        bases, lens = db.padded_batch(range(bi * B, (bi + 1) * B), pad_to=L)
        batches.append((torch.as_tensor(bases, device=dev),
                        torch.as_tensor(lens, device=dev),
                        torch.arange(bi * B, (bi + 1) * B, dtype=torch.int32,
                                     device=dev)))

    t0 = time.time()
    out0 = overlap_step(*batches[0], *table, **CFG)
    torch.cuda.synchronize()
    first_s = time.time() - t0

    dp_kernel.LAUNCHES = 0               # the main path's run starts here
    runs = [steady_pass(batches, table, overlap_step) for _ in range(passes)]
    launches = dp_kernel.LAUNCHES        # ... and ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if len({(ov, sg) for _, ov, sg in runs}) != 1:
        raise AssertionError(f"passes disagree: {runs}")
    _, overlaps, useful_segs = runs[0]
    if overlaps <= 0:
        raise AssertionError("bench workload found no overlaps")
    secs = np.array([r[0] for r in runs])
    q1, med, q3 = np.percentile(secs, [25, 50, 75])
    cells_issued = (n_batches * B * CFG["num_candidates"] * 2
                    * CFG["max_segs"] * CFG["S"] * CFG["W"])
    cells_useful = useful_segs * CFG["S"] * CFG["W"]
    say(f"phase 4: bench {db.n_reads} reads, {db.total_bases} bases, "
        f"{n_batches} batches: index build {index_s:.4f} s, first batch "
        f"{first_s:.4f} s, peak device memory {peak_gb:.3f} GB")
    say(f"phase 4: {passes} steady passes, s per pass: quartiles "
        f"{q1:.4f} / {med:.4f} / {q3:.4f}, range {secs.min():.4f}-"
        f"{secs.max():.4f}; all: {' '.join(f'{x:.4f}' for x in secs)}")
    say(f"phase 4: per pass {overlaps} overlaps, {useful_segs} useful "
        f"lane-segments, {launches // passes} DP launches; median pass "
        f"{overlaps / med:.1f} overlaps/s (range {overlaps / secs.max():.1f}-"
        f"{overlaps / secs.min():.1f}), {cells_issued / med / 1e9:.2f} "
        f"Gcells/s issued, {cells_useful / med / 1e9:.2f} Gcells/s useful")
    if profile_path:
        profile_pass(batches, table, overlap_step, profile_path)

    plain = overlap_step(*batches[0], *table, **CFG, dp=dp_segment_best_plain)
    for name, g, w in zip(out0._fields, out0, plain):
        if not torch.equal(g, w):
            raise AssertionError(f"overlap_step batch 0: {name} differs "
                                 f"between kernel and plain version")
    if not bool(torch.isfinite(out0.identity).all()):
        raise AssertionError("non-finite identity in overlap_step output")
    say("phase 4: batch 0 OverlapStepOut equal to the plain-version "
        "overlap_step on the card (every field)")
    return dict(launches=launches)


def phase_cli(db, work: str) -> None:
    from mecat_tpu_torch.io.fasta import write_fasta

    reads = os.path.join(work, "bench_reads.fasta")
    write_fasta(reads, [(db.name(i), db.read(i)) for i in range(db.n_reads)])
    out = os.path.join(work, "bench.m4")
    cmd = [sys.executable, "-m", "mecat_tpu_torch.cli.mecat2pw", "-j", "1",
           "-d", reads, "-o", out, "-w", os.path.join(work, "wrk"),
           "-n", "16", "-a", "1000"]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"CLI exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    with open(out) as fh:
        n_rec = sum(1 for line in fh if line.strip())
    summary = None
    for line in proc.stderr.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            if rec.get("component") == "pw" and rec.get("event") == "summary":
                summary = rec
    if summary is None:
        raise AssertionError("CLI printed no metrics summary")
    say(f"phase 5: CLI mecat2pw -j 1 -n 16 -a 1000 on {db.n_reads} reads: "
        f"exit 0, {n_rec} M4 records, wall {wall:.2f} s, of which outside "
        f"run_pw (process start, imports, CUDA set-up) "
        f"{wall - summary.get('seconds', 0.0):.2f} s")
    keys = ("seconds", "index_build_seconds", "volume_pair_seconds",
            "staged_prep_s", "staged_scan_s", "staged_pull_s",
            "staged_extend_s", "candidates", "overlaps", "dp_gcells_per_s",
            "dp_gcells_per_s_useful", "dp_launches")
    say("phase 5: CLI summary " + json.dumps(
        {k: summary[k] for k in keys if k in summary}))
    if n_rec <= 0:
        raise AssertionError("CLI wrote no overlaps")
    if summary.get("dp_launches", 0) <= 0:
        raise AssertionError("the CLI's DP did not go through the kernel")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--passes", type=int, default=7,
                   help="steady passes over the bench batches (phase 4)")
    p.add_argument("--profile", metavar="PATH",
                   help="profile one more phase-4 pass; full table to PATH")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "mecat_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mecat_tpu_torch.ops import dp_kernel

    card = card_line()
    say(f"card: {card}")
    build_s = dp_kernel.build(verbose=True)
    say(f"phase 1: DP kernel built in {build_s:.2f} s")

    stats = {(S, W): phase_kernel(S, W) for S, W in ((128, 64), (512, 128))}

    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT)
    try:
        t0 = time.time()
        db = bench_reads()
        say(f"bench reads simulated in {time.time() - t0:.2f} s")
        phase_golden(work)
        bench = phase_bench(db, args.passes, args.profile)
        phase_cli(db, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    main_shape = stats[(CFG["S"], CFG["W"])]
    say(json.dumps({"kernels": [{
        "name": "dp_segment_best", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": bench["launches"],
        "max_abs_err": max(s["max_abs_err"] for s in stats.values()),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"]}]}))
    say(f"card: {card}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
