#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mecat_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line; any failure ends the run with a
non-zero exit and no result line:

1. card: ``nvidia-smi`` name and power limit; build every Hopper kernel
   source under ``mecat_tpu_torch/csrc/`` (one ``nvcc`` each, started
   together) and time the builds;
2. each kernel against its plain PyTorch version on the card at (S, W) =
   (128, 64) and (512, 128), median times and the card's bound for the same
   work.  DP kernels, 4096 lanes (lanes with no valid cell and inactive
   lanes included).  Counts-only kernel: r, w, j, d, ind equal on every
   lane.  Move-writing kernel: the same, the packed move words equal on
   every row up to the lane's best row, and the row tracebacks of the two
   move matrices equal on every lane.  Then both DP wrappers alone
   (``ops/dp_kernel``, nothing around them) at the shapes the paths
   launch: (512, 128), full-length segments, 64 / 256 / 1,024 / 4,096 live
   lanes scattered over 4,096 and 64 of 128, every lane held against the
   plain version; ms a launch replayed from a CUDA graph, ms of one launch
   from the host, ns a row, and the bound on the same inputs
   (``--kernels-only`` stops here).  The ``roll_micro`` family, 2048
   lanes (the tool's own lanes plus lanes with varied tmax and segq): all 8
   output rows of each of the five variants equal on every lane; then the
   tool itself, ``mecat_tpu_torch.tools.roll_micro`` at its defaults, whose
   launches are the family's main path;
3. golden bytes: ``run_pw(device="cuda")`` on ``tests/golden/reads.fasta``
   reproduces ``tests/golden/overlaps.m4`` (-j 1) and ``candidates.txt``
   (-j 0), and ``run_cns(device="cuda")`` on the candidates reproduces
   ``tests/golden/corrected.fasta``, byte for byte;
4. the bench workload (500 kb genome, 15x, mean 5 kb, 12 % error, seeds
   91/92; k 13, stride 10, N 16, S 512, W 128, 30 segments, B 128, L 8192)
   through ``overlap_step``: a warm-up batch, then ``--passes`` (default 3)
   steady passes over every batch; per-pass seconds (quartiles), overlaps/s
   of the median pass, issued and useful DP Gcells/s, peak device memory;
   batch 0 equals the plain-version ``overlap_step``.  ``--profile`` adds
   one pass under ``torch.profiler`` and prints the device-time breakdown;
5. the CLI ``python -m mecat_tpu_torch.cli.mecat2pw -j 1`` on the bench
   reads as a subprocess: exit 0, record count, wall seconds, and its own
   metrics summary (phase split, useful DP Gcells/s, DP kernel launches,
   which must be > 0);
6. correction at full width: supports from the first 4 bench batches'
   ``overlap_step`` output (forward strand, self hits dropped), the up to
   128 templates with >= 5 supports, pacbio preset with ``min_length`` 2000
   (S 512, W 128, 128 pairs a chunk) through ``correct_batch_device``: a
   warm pass, then a timed pass; supports/s, corrected reads and bases,
   table slices, DP launches, issued and useful DP Gcells, peak device
   memory; the 8 most-supported templates once more with the plain DP give
   the same corrected reads.  ``--profile`` adds a pass with synchronising timers
   around the chunk's stages and a ``torch.profiler`` pass over the first
   16 templates;
7. the CLIs ``mecat2pw -j 0`` then ``mecat2cns -i 0 -l 2000`` on the bench
   reads as subprocesses: wall seconds, the cns summary line, corrected
   reads > 0 and move-kernel launches > 0;
8. mapping exactness: a 30 kb + 20 kb reference and 21 reads (one of them
   junk), ``run_ref(device="cuda")`` and ``run_ref(device="cpu")`` in this
   process give byte-equal SAM and byte-equal M4-format output; the junk
   read is FLAG 4; both DP kernels were launched by the CUDA SAM run;
9. mapping at a real reference size: one 46 Mb contig (seed 301), 2,000
   simulated reads of mean 10 kb at 12 % error (seed 302), default
   ``RefOptions``, SAM out, through ``python -m
   mecat_tpu_torch.cli.mecat2ref --device cuda`` as a subprocess: wall and
   ``run_ref`` seconds, reads/s, the phase split, launches of each DP
   kernel, issued and useful DP lane-segments, peak device memory; one
   primary line per read, at least 95 % of the mapped reads at their true
   locus, every mapped CIGAR consuming its read.  ``--profile`` adds one
   ``run_ref`` on the same files in this process under ``torch.profiler``
   (after a warm one) for the card's busy share and its top kernels.

Each kernel's launch counter is zeroed just before the timed run of its
path (phase 4's steady passes, phase 6's timed pass, the tool's run in
phase 2, the CUDA SAM run of phase 8) and read just after, so the reported
launches are those of the main paths only.  The line before
the last is a JSON object with the kernels' numbers; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device or
without the repository beside it.
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
KERNEL_REPLACES = "mecat_tpu/ops/pallas_dp.py:56"          # _dp_kernel
KERNEL_REPLACES_MOVES = "mecat_tpu/ops/pallas_dp.py:115"   # its move stream
ROLL_SOURCE = "mecat_tpu_torch/csrc/roll_micro.cu"
ROLL_REPLACES = "tools/roll_micro.py:155"                  # build_call

# The card's peaks for the kernels' bounds (NVIDIA's H100 SXM data sheet):
# 3.35 TB/s of HBM, and for int32 a quarter of the 67 TFLOP/s float32
# figure: an FMA counts as two FLOPs, and an SM has half as many INT32
# lanes as FP32 lanes.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
#: int32 operations per DP cell, as the kernel source's header counts them
OPS_PER_CELL = {False: 12, True: 18}

# bench workload (bench.py:57-65)
GENOME, COVERAGE, MEAN_LEN, B, L = 500_000, 15, 5000, 128, 8192
CFG = dict(k=13, stride=10, max_occ=16, num_candidates=16, diag_bin=256,
           L_target=L, S=512, W=128, max_segs=30, min_align_size=1000,
           min_identity=70.0)
DP_LANES = 4096   # the bench's 2 * B * N extension lanes
#: int32 operations per cell of each roll_micro variant, as the header of
#: csrc/roll_micro.cu counts them
ROLL_OPS_PER_CELL = {"full": 28, "noroll": 25, "nobest": 14, "elembest": 26,
                     "baremin": 11}
ROLL_LANES = 2048   # the tool's default

# mapping at a real reference size (tools/ref_bench.py:39-44)
REF_GENOME, REF_READS, REF_MEAN_LEN = 46_000_000, 2000, 10_000
#: the small mapping check's options (tests/test_ref.py)
REF_SMALL = dict(num_candidates=8, num_extend=3, min_align_size=400,
                 kmer_size=10, scan_stride=5, scan_batch=16, extend_batch=32,
                 align_segment=128, align_band=64)


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


def cuda_graph_ms(fn, launches: int = 20, reps: int = 7) -> float:
    """Device time of one call of ``fn`` with no host in the way: ``launches``
    calls captured into one CUDA graph, the graph replayed ``reps`` times
    between events; the median replay over ``launches``."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = cuda_median_ms(graph.replay, reps) / launches
    del graph
    return ms


def dp_bound(tmax, seg_q, active, S: int, W: int, with_moves: bool) -> dict:
    """The least time the card could take for one DP launch on these lanes.

    Bytes: q, the framed target window, tmax, seg_q and active read once,
    the three results written once, and with moves the words of the rows
    the data needs.  Operations: the cells of those rows at the source's
    operation count.  A lane needs rows 1..min(seg_q, S), cut where the
    band has left the target (row > tmax + W/2, one row to find that out);
    an inactive lane needs none.
    """
    import torch

    lanes = int(tmax.shape[0])
    rows = torch.minimum(seg_q.clamp(0, S), (tmax + W // 2 + 1).clamp(min=1))
    rows = int(torch.where(active, rows, 0).sum())
    n_bytes = lanes * (S + S + W + 4 + 4 + 1 + 12)
    if with_moves:
        n_bytes += rows * (W // 16) * 4
    ops = rows * W * OPS_PER_CELL[with_moves]
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations")


def phase_kernel(S: int, W: int) -> dict:
    """Both kernels against the plain version at one shape; returns
    {with_moves: numbers}."""
    import torch

    from mecat_tpu_torch.ops.align import (dp_segment_best,
                                           dp_segment_best_plain,
                                           traceback_rows)
    from mecat_tpu_torch.testing import dp_inputs

    dev = torch.device("cuda")
    args = [torch.as_tensor(a, device=dev)
            for a in dp_inputs(S, W, DP_LANES, seed=121 + S + W)]
    _, _, tmax, seg_q, active = args
    out = {}
    for with_moves in (False, True):
        got = dp_segment_best(*args, S, W, want_moves=with_moves)
        want = dp_segment_best_plain(*args, S, W, want_moves=with_moves)
        torch.cuda.synchronize()
        err = 0
        what = "moves kernel" if with_moves else "kernel"
        names = ("r", "w", "j", "d", "ind")
        for name, g, w in zip(names, got[-5:], want[-5:]):
            err = max(err, int((g.long() - w.long()).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(
                    f"{what} != plain at S={S} W={W}: {name} differs on "
                    f"{int((g != w).sum())} lanes")
        if with_moves:
            moves, r_best, w_best = got[0], got[1], got[2]
            row = torch.arange(1, S + 1, device=dev)[None, :, None]
            readable = (row <= r_best[:, None, None]) & active[:, None, None]
            diff = torch.where(readable, moves.long() - want[0].long(), 0)
            err = max(err, int(diff.abs().max()))
            if err:
                raise AssertionError(
                    f"moves kernel != plain at S={S} W={W}: "
                    f"{int((diff != 0).sum())} move words differ")
            for name, g, w in zip(
                    ("mv", "h", "w_out", "w0"),
                    traceback_rows(moves, r_best, w_best, W),
                    traceback_rows(want[0], r_best, w_best, W)):
                if not torch.equal(g, w):
                    raise AssertionError(
                        f"row traceback of the kernel's moves != the plain "
                        f"version's at S={S} W={W}: {name}")
            del moves, diff, readable
        del got, want
        ms = cuda_median_ms(
            lambda: dp_segment_best(*args, S, W, want_moves=with_moves), 21)
        plain_ms = cuda_median_ms(
            lambda: dp_segment_best_plain(*args, S, W,
                                          want_moves=with_moves), 3)
        bound = dp_bound(tmax, seg_q, active, S, W, with_moves)
        say(f"phase 2: {what} == plain at S={S} W={W} lanes={DP_LANES}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median), bound "
            f"{bound['bound_ms']:.4f} ms by {bound['bound_by']}")
        out[with_moves] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               **bound)
    return out


#: (lanes, live lanes) of the launches the paths make: the overlap and
#: mapping paths launch 4,096 lanes of which 64-1,024 are live, the
#: correction path 128 lanes of which about half are
PATH_SHAPES = ((4096, 64), (4096, 256), (4096, 1024), (4096, 4096),
               (128, 64))


def phase_kernel_path_shapes(S: int, W: int) -> dict:
    """Both kernels alone (the wrappers of ``ops/dp_kernel``, nothing
    around them) at the shapes the paths launch: full-length segments
    (``seg_q = S``), the live lanes scattered over the launch.  Every lane
    is first held against the plain version.  Returns {with_moves: {"live
    of lanes": numbers}}; ``ns_row`` is the kernel time over the rows of
    the longest lane.  ``ms`` is the device time of a launch replayed from
    a CUDA graph (back to back, no host between launches), ``one_launch_ms``
    the time between two events around one call from the host, which holds
    the wrapper's host time wherever the kernel is shorter than it."""
    import torch

    from mecat_tpu_torch.ops import dp_kernel
    from mecat_tpu_torch.ops.align import dp_segment_best_plain
    from mecat_tpu_torch.testing import dp_inputs_full

    dev = torch.device("cuda")
    q, tpad, tmax, seg_q = (
        torch.as_tensor(a, device=dev)
        for a in dp_inputs_full(S, W, max(n for n, _ in PATH_SHAPES),
                                seed=141))
    rng = np.random.default_rng(142)
    out = {False: {}, True: {}}
    for lanes, live in PATH_SHAPES:
        mask = np.zeros(lanes, bool)
        mask[rng.choice(lanes, live, replace=False)] = True
        active = torch.as_tensor(mask, device=dev)
        args = (q[:lanes], tpad[:lanes], tmax[:lanes], seg_q[:lanes], active)
        rows = int(torch.minimum(seg_q[:lanes],
                                 tmax[:lanes] + W // 2 + 1)[active].max())
        for with_moves in (False, True):
            fn = (dp_kernel.dp_segment_best_moves_cuda if with_moves
                  else dp_kernel.dp_segment_best_cuda)
            got = fn(*args, S, W)
            want = dp_segment_best_plain(*args, S, W, want_moves=with_moves)
            torch.cuda.synchronize()
            r, w, v = got[-3:]
            j = r - W // 2 + w
            if not (torch.equal(r, want[-5]) and torch.equal(w, want[-4])
                    and torch.equal(j, want[-3])):
                raise AssertionError(
                    f"kernel != plain at {live} live of {lanes} lanes, "
                    f"moves={with_moves}")
            if with_moves:
                row = torch.arange(1, S + 1, device=dev)[None, :, None]
                readable = row <= r[:, None, None]
                if not torch.equal(torch.where(readable, got[0], 0),
                                   torch.where(readable, want[0], 0)):
                    raise AssertionError(
                        f"move words differ at {live} live of {lanes} lanes")
            del got, want
            one_ms = cuda_median_ms(lambda: fn(*args, S, W), 21)
            ms = cuda_graph_ms(lambda: fn(*args, S, W))
            bound = dp_bound(tmax[:lanes], seg_q[:lanes], active, S, W,
                             with_moves)
            what = "moves kernel" if with_moves else "kernel"
            say(f"phase 2: {what} alone at S={S} W={W}, {live} live of "
                f"{lanes} lanes: {ms:.4f} ms a launch replayed from a CUDA "
                f"graph, {1e6 * ms / rows:.1f} ns a row ({rows} rows); one "
                f"launch from the host between two events {one_ms:.4f} ms; "
                f"bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}")
            out[with_moves][f"{live} of {lanes}"] = dict(
                ms=ms, ns_row=1e6 * ms / rows, one_launch_ms=one_ms, **bound)
    return out


def phase_roll_micro(S: int, W: int) -> dict:
    """The five roll_micro variants against the plain version at one shape;
    returns {variant: numbers}."""
    import torch

    from mecat_tpu_torch.ops import roll_micro as rm
    from mecat_tpu_torch.testing import roll_micro_inputs

    dev = torch.device("cuda")
    args = [torch.as_tensor(a, device=dev)
            for a in roll_micro_inputs(S, W, ROLL_LANES, seed=131 + S + W)]
    cells = S * W * ROLL_LANES
    # every row of every lane runs whatever the data holds: each input read
    # once, the 8 results written once
    t_bytes = ROLL_LANES * (S + S + W + 4 + 4 + 32) / HBM_BYTES_PER_S
    out = {}
    for name, (rolls, best) in rm.VARIANTS.items():
        got = rm.roll_micro(*args, S, W, rolls, best)
        want = rm.roll_micro_plain(*args, S, W, rolls, best)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(
                f"roll_micro {name} != plain at S={S} W={W}: "
                f"{int((got != want).any(dim=1).sum())} lanes differ")
        ms = cuda_median_ms(
            lambda: rm.roll_micro(*args, S, W, rolls, best), 21)
        plain_ms = cuda_median_ms(
            lambda: rm.roll_micro_plain(*args, S, W, rolls, best), 2)
        t_ops = cells * ROLL_OPS_PER_CELL[name] / INT32_OPS_PER_S
        bound = dict(bound_ms=1e3 * max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes > t_ops else "operations")
        say(f"phase 2: roll_micro {name} == plain at S={S} W={W} "
            f"lanes={ROLL_LANES} (all 8 rows): kernel {ms:.4f} ms = "
            f"{cells / ms / 1e6:.2f} Gcells/s, plain {plain_ms:.4f} ms "
            f"(median), bound {bound['bound_ms']:.4f} ms by "
            f"{bound['bound_by']}")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         gcells_s=cells / ms / 1e6, **bound)
    return out


def phase_roll_micro_tool() -> int:
    """The family's own path: the tool at its defaults on the card.  Returns
    the kernel launches it made."""
    import contextlib
    import io

    from mecat_tpu_torch.ops import roll_micro as rm
    from mecat_tpu_torch.tools import roll_micro as tool

    buf = io.StringIO()
    rm.LAUNCHES = 0                      # the tool's run starts here
    with contextlib.redirect_stdout(buf):
        rc = tool.main(["--device", "cuda"])
    launches = rm.LAUNCHES               # ... and ends here
    line = buf.getvalue().strip().splitlines()[-1]
    rec = json.loads(line)
    if rc != 0 or launches <= 0 or rec.get("launches") != launches:
        raise AssertionError(f"the roll_micro tool failed: rc {rc}, "
                             f"{launches} launches, {line}")
    say(f"phase 2: python -m mecat_tpu_torch.tools.roll_micro --device cuda: "
        f"{line}")
    return launches


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

    from mecat_tpu_torch.pipeline.cns import CnsOptions, run_cns
    from mecat_tpu_torch.testing import GOLDEN_CNS

    out = os.path.join(work, "corrected.fasta")
    t0 = time.time()
    run_cns(os.path.join(golden, "candidates.txt"), reads, out,
            CnsOptions(**GOLDEN_CNS), device="cuda")
    with open(out, "rb") as fh, \
            open(os.path.join(golden, "corrected.fasta"), "rb") as gh:
        if fh.read() != gh.read():
            raise AssertionError("golden corrected.fasta differs on the card")
    say(f"phase 3: golden corrected.fasta (mecat2cns -i 0) byte-equal on the "
        f"card ({time.time() - t0:.2f} s)")


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
    return dict(launches=launches,
                supports=bench_supports(batches[:4], table, overlap_step))


def bench_supports(batches, table, overlap_step) -> dict:
    """Support lists for the correction phase from the overlap step's own
    output: template -> [(support read, 0, support seed, template seed,
    score)], forward strand, self hits dropped (bench.py's cns leg)."""
    by_template: dict = {}
    for a in batches:
        o = overlap_step(*a, *table, **CFG)
        qids = a[2].cpu().numpy()
        valid = o.valid.cpu().numpy()
        cols = [x.cpu().numpy() for x in (o.target, o.score, o.qseed,
                                           o.tseed)]
        b, n = np.nonzero(valid)
        for qid, tgt, score, qs, ts in zip(qids[b],
                                           *(c[b, n] for c in cols)):
            if int(qid) != int(tgt):
                by_template.setdefault(int(tgt), []).append(
                    (int(qid), 0, int(qs), int(ts), int(score)))
    return by_template


class StageTimers:
    """Synchronising wall-clock timers around the stages of the cns chunk,
    put in place of the functions the pipeline calls (and taken out again).
    They serialise host and card, so the pass they time is slower than an
    untimed one; the split is what they are for."""

    def __init__(self):
        import torch

        from mecat_tpu_torch.ops import align, consensus_banded
        from mecat_tpu_torch.pipeline import cns

        self.sync = torch.cuda.synchronize
        self.seconds: dict = {}
        self.calls: dict = {}
        self.sites = [(align, "traceback_rows", "row walk"),
                      (align, "_extend_direction_impl", "segment loop + DP"),
                      (consensus_banded, "_deposit_scan", "deposit scan"),
                      (consensus_banded, "banded_global_planes",
                       "global planes (incl. deposit scan)"),
                      (consensus_banded, "banded_presence", "presence"),
                      (cns, "banded_accumulate_tags",
                       "tags total (planes + presence + tally)"),
                      (cns, "call_tables", "vote"),
                      (cns, "plan_pairs", "host planning"),
                      (cns, "_collect_slice_device", "pull + split")]
        self.saved = []

    def _wrap(self, fn, label):
        def timed(*a, **kw):
            self.sync()
            t0 = time.time()
            out = fn(*a, **kw)
            if label == "pull + split":
                out = list(out)          # a generator: run it here
            self.sync()
            self.seconds[label] = (self.seconds.get(label, 0.0)
                                   + time.time() - t0)
            self.calls[label] = self.calls.get(label, 0) + 1
            return out
        return timed

    def __enter__(self):
        for mod, name, label in self.sites:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))
            setattr(mod, name, self._wrap(fn, label))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def phase_cns(db, by_template: dict, profile_path: str | None) -> dict:
    import torch

    from mecat_tpu_torch import constants as C
    from mecat_tpu_torch.ops import dp_kernel
    from mecat_tpu_torch.ops.align import dp_segment_best_plain
    from mecat_tpu_torch.pipeline.cns import (CnsOptions, CnsStats,
                                              correct_batch_device,
                                              device_volume)

    dev = torch.device("cuda")
    ranked = sorted((t for t, s in by_template.items() if len(s) >= 5),
                    key=lambda t: -len(by_template[t]))[:128]
    templates = sorted(ranked)
    if not templates:
        raise AssertionError("no template with >= 5 supports")
    opts = CnsOptions.for_tech(C.TECH_PACBIO, min_length=2000)
    dev_vol = device_volume(db, dev)

    def one_pass(ts, **kw):
        stats = CnsStats()
        torch.cuda.synchronize()
        t0 = time.time()
        out = list(correct_batch_device(db, ts, by_template, opts, stats,
                                        device=dev, dev_vol=dev_vol, **kw))
        torch.cuda.synchronize()
        return out, stats, time.time() - t0

    _, _, warm_s = one_pass(templates)
    torch.cuda.reset_peak_memory_stats()
    dp_kernel.LAUNCHES_MOVES = 0         # the main path's run starts here
    out, stats, dt = one_pass(templates)
    launches = dp_kernel.LAUNCHES_MOVES  # ... and ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches <= 0:
        raise AssertionError("the cns pass launched no move-writing kernel")
    if stats.corrected_reads <= 0 or stats.corrected_reads != len(out):
        raise AssertionError(f"cns pass corrected {stats.corrected_reads} "
                             f"reads, yielded {len(out)}")
    if any(seg.dtype != np.uint8 or int(seg.max()) > 3 for _, seg in out):
        raise AssertionError("a corrected read holds something else than "
                             "base codes 0..3")
    cells = opts.align_segment * opts.align_band
    say(f"phase 6: cns at full width: {len(templates)} templates, "
        f"{stats.supports_aligned} supports aligned in {dt:.4f} s (warm pass "
        f"{warm_s:.4f} s): {stats.supports_aligned / dt:.1f} supports/s, "
        f"{stats.corrected_reads} corrected reads, {stats.corrected_bases} "
        f"bases, {stats.table_slices} table slices, {launches} DP launches, "
        f"peak device memory {peak_gb:.3f} GB")
    say(f"phase 6: DP lane-segments issued {stats.dp_lane_segs_issued}, "
        f"useful {stats.dp_lane_segs_useful}: "
        f"{stats.dp_lane_segs_issued * cells / 1e9:.3f} Gcells issued, "
        f"{stats.dp_lane_segs_useful * cells / 1e9:.3f} useful, "
        f"{stats.dp_lane_segs_useful * cells / dt / 1e9:.3f} useful Gcells/s")

    if profile_path:
        profile_cns(one_pass, templates, profile_path)

    first = sorted(ranked[:8])           # the 8 deepest piles
    names = {db.name(t) for t in first}
    want = {n: seg.tobytes() for n, seg in out
            if n.rsplit("_", 1)[0] in names}
    plain, _, plain_s = one_pass(first, dp=dp_segment_best_plain)
    if {n: seg.tobytes() for n, seg in plain} != want or not want:
        raise AssertionError("corrected reads of the first 8 templates "
                             "differ between the kernel and the plain DP")
    say(f"phase 6: the 8 most-supported templates through the plain DP "
        f"({plain_s:.2f} s): the same {len(want)} corrected reads")
    return dict(launches=launches)


def profile_cns(one_pass, templates, path: str) -> None:
    """Where a cns pass spends its time: one pass under synchronising stage
    timers, and one ``torch.profiler`` pass over the first 16 templates for
    the card's busy share and its top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with StageTimers() as tm:
        _, _, wall = one_pass(templates)
    say(f"profile cns: one pass under synchronising stage timers: wall "
        f"{wall:.3f} s")
    for label, sec in sorted(tm.seconds.items(), key=lambda kv: -kv[1]):
        say(f"profile cns:   {sec:9.3f} s {100 * sec / wall:5.1f} %  "
            f"x{tm.calls[label]:<5d} {label}")

    sub = templates[:16]
    one_pass(sub)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, stats, wall = one_pass(sub)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    total_us = sum(dev_us(e) for e in kernels)
    say(f"profile cns: {len(sub)} templates, {stats.supports_aligned} "
        f"supports under torch.profiler: wall {wall:.3f} s, kernel time "
        f"{total_us / 1e6:.3f} s in {sum(e.count for e in kernels)} kernels "
        f"(card busy {100 * total_us / 1e6 / wall:.1f} % of the profiled "
        f"wall)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        say(f"profile cns:   {dev_us(e) / 1e3:9.3f} ms "
            f"{100 * dev_us(e) / max(total_us, 1):5.1f} %  x{e.count:<7d} "
            f"{e.key[:70]}")
    with open(path + ".cns", "w") as fh:
        fh.write(events.table(sort_by="self_cuda_time_total", row_limit=60))


def run_cli(module: str, argv: list, component: str):
    """Run one of the port's CLIs as a subprocess; returns (wall seconds,
    its metrics summary record).  Raises unless it exits 0 with a summary."""
    cmd = [sys.executable, "-m", f"mecat_tpu_torch.cli.{module}", *argv]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"CLI {module} exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    summary = None
    for line in proc.stderr.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            if (rec.get("component") == component
                    and rec.get("event") == "summary"):
                summary = rec
    if summary is None:
        raise AssertionError(f"CLI {module} printed no metrics summary")
    return wall, summary


def count_lines(path: str, prefix: str = "") -> int:
    with open(path) as fh:
        return sum(1 for line in fh if line.strip()
                   and line.startswith(prefix))


def phase_cli(reads: str, n_reads: int, work: str) -> None:
    out = os.path.join(work, "bench.m4")
    wall, summary = run_cli(
        "mecat2pw", ["-j", "1", "-d", reads, "-o", out, "-w",
                     os.path.join(work, "wrk"), "-n", "16", "-a", "1000"],
        "pw")
    n_rec = count_lines(out)
    say(f"phase 5: CLI mecat2pw -j 1 -n 16 -a 1000 on {n_reads} reads: "
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


def phase_cli_cns(reads: str, n_reads: int, work: str) -> None:
    cand = os.path.join(work, "bench_cand.txt")
    pw_wall, pw = run_cli(
        "mecat2pw", ["-j", "0", "-d", reads, "-o", cand, "-w",
                     os.path.join(work, "wrk0"), "-n", "16"], "pw")
    n_cand = count_lines(cand)
    say(f"phase 7: CLI mecat2pw -j 0 -n 16 on {n_reads} reads: exit 0, "
        f"{n_cand} candidate records, wall {pw_wall:.2f} s (run_pw "
        f"{pw.get('seconds', 0.0):.2f} s)")
    if n_cand <= 0:
        raise AssertionError("mecat2pw -j 0 wrote no candidates")
    out = os.path.join(work, "bench_corrected.fasta")
    wall, summary = run_cli(
        "mecat2cns", ["-i", "0", "-l", "2000", "--device", "cuda", cand,
                      reads, out], "cns")
    n_out = count_lines(out, ">")
    say(f"phase 7: CLI mecat2cns -i 0 -l 2000 on those candidates: exit 0, "
        f"{n_out} corrected reads, wall {wall:.2f} s, of which outside "
        f"run_cns {wall - summary.get('seconds', 0.0):.2f} s")
    say("phase 7: CLI summary " + json.dumps(
        {k: v for k, v in summary.items()
         if k not in ("component", "ts", "event")}))
    if n_out <= 0 or summary.get("corrected_reads", 0) != n_out:
        raise AssertionError("the cns CLI wrote no corrected reads, or not "
                             "as many as its summary says")
    if summary.get("dp_launches", 0) <= 0:
        raise AssertionError("the cns CLI's DP did not go through the "
                             "move-writing kernel")


def phase_ref_small(work: str) -> dict:
    """Mapping exactness on the card: CUDA and CPU runs give the same
    bytes.  Returns the launches of the two DP kernels on the CUDA SAM
    run."""
    from mecat_tpu_torch.io.fasta import write_fasta
    from mecat_tpu_torch.ops import dp_kernel
    from mecat_tpu_torch.pipeline.ref import RefOptions, run_ref
    from mecat_tpu_torch.utils.sim import random_genome, simulate_reads

    g1 = random_genome(30000, seed=81)
    g2 = random_genome(20000, seed=82)
    ref = os.path.join(work, "small_genome.fasta")
    write_fasta(ref, [("chr1", g1), ("chr2", g2)])
    db, _ = simulate_reads(g1, 12, mean_len=2000, min_len=1000, seed=83,
                           error_rate=0.08)
    db2, _ = simulate_reads(g2, 8, mean_len=2000, min_len=1000, seed=84,
                            error_rate=0.08)
    seqs = [(f"c1_{i}", db.read(i)) for i in range(db.n_reads)]
    seqs += [(f"c2_{i}", db2.read(i)) for i in range(db2.n_reads)]
    seqs.append(("junk", random_genome(1500, seed=99)))
    reads = os.path.join(work, "small_reads.fasta")
    write_fasta(reads, seqs)

    launches = {}
    for fmt in ("sam", "m4"):
        outs = {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(work, f"small_{dev}.{fmt}")
            if (fmt, dev) == ("sam", "cuda"):
                dp_kernel.LAUNCHES = dp_kernel.LAUNCHES_MOVES = 0
            t0 = time.time()
            stats = run_ref(reads, ref, out,
                            os.path.join(work, f"small_w_{dev}_{fmt}"),
                            RefOptions(output_format=fmt, **REF_SMALL),
                            device=dev)
            dt = time.time() - t0
            if (fmt, dev) == ("sam", "cuda"):
                launches = dict(counts=dp_kernel.LAUNCHES,
                                moves=dp_kernel.LAUNCHES_MOVES)
            with open(out, "rb") as fh:
                outs[dev] = fh.read()
            if stats.mapped != len(seqs) - 1:
                raise AssertionError(f"small mapping ({fmt}, {dev}): "
                                     f"{stats.mapped} of {len(seqs)} mapped")
            say(f"phase 8: run_ref {fmt} on {dev}: {stats.mapped}/"
                f"{stats.reads} mapped in {dt:.2f} s")
        if outs["cuda"] != outs["cpu"] or len(outs["cpu"]) < 200:
            raise AssertionError(f"small mapping: {fmt} bytes differ between "
                                 f"cuda and cpu")
        if fmt == "sam":
            junk = [ln.split("\t")[1] for ln in
                    outs["cuda"].decode().splitlines()
                    if ln.startswith("junk\t")]
            if junk != ["4"]:
                raise AssertionError(f"the junk read's FLAGs: {junk}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"the CUDA SAM run launched {launches}")
    say(f"phase 8: SAM and M4 output byte-equal between cuda and cpu, junk "
        f"read FLAG 4, DP launches on the CUDA SAM run: {launches}")
    return launches


def cigar_query_len(cigar: str) -> int:
    n = q = 0
    for ch in cigar:
        if ch.isdigit():
            n = n * 10 + int(ch)
        else:
            if ch in "MIS":
                q += n
            n = 0
    return q


def profile_ref(reads: str, ref: str, work: str, path: str) -> None:
    """Where a mapping run spends the card's time: ``run_ref`` in this
    process, once to warm up and once under ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mecat_tpu_torch.pipeline.ref import run_ref

    def one(tag):
        torch.cuda.synchronize()
        t0 = time.time()
        stats = run_ref(reads, ref, os.path.join(work, f"prof_{tag}.sam"),
                        os.path.join(work, f"prof_w_{tag}"), device="cuda")
        torch.cuda.synchronize()
        return stats, time.time() - t0

    _, warm_s = one("warm")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stats, wall = one("prof")
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    total_us = sum(dev_us(e) for e in kernels)
    say(f"profile ref: run_ref in this process: warm {warm_s:.3f} s; under "
        f"torch.profiler wall {wall:.3f} s (index {stats.index_s:.3f}, prep "
        f"{stats.prep_s:.3f}, scan {stats.scan_s:.3f}, count "
        f"{stats.count_s:.3f}, ops {stats.ops_s:.3f}, emit "
        f"{stats.emit_s:.3f}), kernel time {total_us / 1e6:.3f} s in "
        f"{sum(e.count for e in kernels)} kernels (card busy "
        f"{100 * total_us / 1e6 / wall:.1f} % of the profiled wall)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:10]:
        say(f"profile ref:   {dev_us(e) / 1e3:9.3f} ms "
            f"{100 * dev_us(e) / max(total_us, 1):5.1f} %  x{e.count:<7d} "
            f"{e.key[:70]}")
    with open(path + ".ref", "w") as fh:
        fh.write(events.table(sort_by="self_cuda_time_total", row_limit=60))


def phase_ref_genome(work: str, profile_path: str | None) -> dict:
    """Mapping at a real reference size through the CLI; returns its
    summary."""
    from mecat_tpu_torch.io.fasta import write_fasta
    from mecat_tpu_torch.utils.sim import random_genome, simulate_reads

    t0 = time.time()
    genome = random_genome(REF_GENOME, seed=301)
    db, truths = simulate_reads(genome, REF_READS, mean_len=REF_MEAN_LEN,
                                min_len=3000, seed=302, error_rate=0.12)
    ref = os.path.join(work, "ref.fasta")
    reads = os.path.join(work, "ref_reads.fasta")
    write_fasta(ref, [("chr_sim", genome)])
    write_fasta(reads, [(db.name(i), db.read(i)) for i in range(db.n_reads)])
    del genome
    say(f"phase 9: simulated a {REF_GENOME} base contig and {db.n_reads} "
        f"reads ({db.total_bases} bases, longest {int(db.lengths.max())}) "
        f"in {time.time() - t0:.2f} s")
    out = os.path.join(work, "ref.sam")
    wall, summary = run_cli(
        "mecat2ref", ["-d", reads, "-r", ref, "-w",
                      os.path.join(work, "ref_wrk"), "-o", out,
                      "--device", "cuda"], "ref")
    say(f"phase 9: CLI mecat2ref on {db.n_reads} reads vs {REF_GENOME} "
        f"bases: exit 0, wall {wall:.2f} s, run_ref "
        f"{summary.get('seconds', 0.0):.2f} s, "
        f"{db.n_reads / max(summary.get('seconds', 0.0), 1e-9):.2f} reads/s "
        f"({db.n_reads / wall:.2f} of the wall)")
    say("phase 9: CLI summary " + json.dumps(
        {k: v for k, v in summary.items()
         if k not in ("component", "ts", "event")}))

    # one primary line per read; pos_agree by the rule of
    # tools/ref_bench.py:63-89; every mapped CIGAR consumes its read
    length = {db.name(i): int(db.lengths[i]) for i in range(db.n_reads)}
    primary, mapped_pos = {}, {}
    with open(out) as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            f = line.split("\t")
            flag = int(f[1])
            if flag & 0x900:
                continue
            primary[f[0]] = primary.get(f[0], 0) + 1
            if flag & 0x4:
                continue
            mapped_pos[f[0]] = int(f[3]) - 1
            if not cigar_query_len(f[5]) == len(f[9]) == length[f[0]]:
                raise AssertionError(f"CIGAR of {f[0]} consumes "
                                     f"{cigar_query_len(f[5])} of "
                                     f"{length[f[0]]} bases")
    if sorted(primary) != sorted(length) or set(primary.values()) != {1}:
        raise AssertionError("not one primary line per read")
    agree = sum(1 for i, tr in enumerate(truths)
                if db.name(i) in mapped_pos
                and tr.start - 2000 <= mapped_pos[db.name(i)] <= tr.end + 2000)
    mapped = len(mapped_pos)
    pos_agree = agree / max(mapped, 1)
    say(f"phase 9: {mapped} of {db.n_reads} reads mapped, pos_agree "
        f"{pos_agree:.4f}, one primary line per read, every CIGAR consumes "
        f"its read")
    if pos_agree < 0.95 or mapped != summary.get("mapped"):
        raise AssertionError(f"pos_agree {pos_agree:.4f} ({agree}/{mapped}); "
                             f"the summary says {summary.get('mapped')}")
    if min(summary.get("dp_launches", 0),
           summary.get("dp_launches_moves", 0)) <= 0:
        raise AssertionError("the mapping CLI's DP did not go through both "
                             "kernels")
    if profile_path:
        profile_ref(reads, ref, work, profile_path)
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--passes", type=int, default=3,
                   help="steady passes over the bench batches (phase 4)")
    p.add_argument("--profile", metavar="PATH",
                   help="profile one more phase-4 pass (full table to PATH), "
                        "the phase-6 cns pass (table to PATH.cns) and a "
                        "phase-9 mapping run (table to PATH.ref)")
    p.add_argument("--kernels-only", action="store_true",
                   help="stop after phase 2's DP kernel checks and timings "
                        "(no result line)")
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
    from mecat_tpu_torch.ops import cuda_build

    card = card_line()
    say(f"card: {card}")
    t0 = time.time()
    built = cuda_build.build_all(verbose=True)
    say("phase 1: kernel libraries built side by side in "
        f"{time.time() - t0:.2f} s: " + ", ".join(
            f"{cuda_build.SOURCES[n]} {sec:.2f} s" for n, sec in built.items()))

    shapes = ((128, 64), (512, 128))
    stats = {(S, W): phase_kernel(S, W) for S, W in shapes}
    path_shapes = phase_kernel_path_shapes(CFG["S"], CFG["W"])
    if args.kernels_only:
        say(json.dumps({"path_shapes": {
            "moves" if m else "counts": v for m, v in path_shapes.items()}}))
        say(f"card: {card}")
        return 0
    roll = {(S, W): phase_roll_micro(S, W) for S, W in shapes}
    roll_launches = phase_roll_micro_tool()

    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT)
    try:
        t0 = time.time()
        db = bench_reads()
        say(f"bench reads simulated in {time.time() - t0:.2f} s")
        phase_golden(work)
        bench = phase_bench(db, args.passes, args.profile)
        from mecat_tpu_torch.io.fasta import write_fasta

        reads = os.path.join(work, "bench_reads.fasta")
        write_fasta(reads, [(db.name(i), db.read(i))
                            for i in range(db.n_reads)])
        phase_cli(reads, db.n_reads, work)
        cns = phase_cns(db, bench["supports"], args.profile)
        phase_cli_cns(reads, db.n_reads, work)
        ref_small = phase_ref_small(work)
        ref_cli = phase_ref_genome(work, args.profile)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # both main paths run S 512, W 128: that shape's times and bound
    main_shape = stats[(CFG["S"], CFG["W"])]
    kernels = []
    for name, with_moves, replaces, launches, key, cli_key in (
            ("dp_segment_best", False, KERNEL_REPLACES, bench["launches"],
             "counts", "dp_launches"),
            ("dp_segment_best_moves", True, KERNEL_REPLACES_MOVES,
             cns["launches"], "moves", "dp_launches_moves")):
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": replaces, "launches": launches,
            # the mapping pass: phase 8's CUDA SAM run in this process, and
            # the CLI's own count of phase 9
            "launches_mapping": ref_small[key],
            "launches_mapping_cli": ref_cli[cli_key],
            "max_abs_err": max(s[with_moves]["max_abs_err"]
                               for s in stats.values()),
            **{k: main_shape[with_moves][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            # no single PyTorch call computes a banded min-plus DP segment
            "library_ms": None,
            # the wrapper alone at the shapes the paths launch
            "path_shapes": path_shapes[with_moves]})
    # the tool runs S 512, W 128; the family's headline numbers are `full`'s
    roll_main = roll[(512, 128)]
    kernels.append({
        "name": "roll_micro", "route": "cuda", "source": ROLL_SOURCE,
        "replaces": ROLL_REPLACES, "launches": roll_launches,
        "max_abs_err": max(v["max_abs_err"] for s_ in roll.values()
                           for v in s_.values()),
        **{k: roll_main["full"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        # no PyTorch call computes any of the five row-update functions
        "library_ms": None,
        "variants": {n: {k: v[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "gcells_s")}
                     for n, v in roll_main.items()}})
    say(json.dumps({"kernels": kernels}))
    say(f"card: {card}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
