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
   move matrices equal on every lane.  The segment-loop kernel (the
   counts-only segment loop of ``ops/align._extend_direction_impl``, one
   launch for every lane's whole extension) against the plain host loop at
   both shapes, 4096 direction lanes of ``testing.extend_inputs`` pairs
   (8,192-base rows, 12 % noise, edge lanes) and of the ``dp_inputs`` lanes
   as pairs, at 30 segments and at 1: all six outputs equal on every lane,
   one launch a call and none of the per-segment kernel; at (512, 128) the
   wrapper alone, ms of one launch from the host and from a CUDA graph, the
   plain loop's ms, the bound on this data and ns a dependent step of the
   longest lane's chain of segments.  The move loop (the move-writing
   segment loop of both directions, one launch) against the host loop on
   the ``extend_inputs`` pairs at both shapes, 30 right / 20 left
   segments and 1 / 1: both ExtensionResults and every element of the six
   raw arrays (moves, r_end, w_end, qoff and toff before, ok) of every
   slot < G, one launch a call and none of the other DP kernels; at (512,
   128) the wrapper alone as for the counts loop.  Every DP-family kernel
   (both per-segment kernels, both loops, the row and the column walk) at
   the band widths 32, 48, 96, 160, 256, 272, 384, 512, 528, 1024, 2048,
   3072, 3088, 4096, 8192 and 24576 (past 512 a DP lane of several warps,
   past 3072 a thread-block cluster, whose four DP launches at each such
   width the wrappers' cluster counter must show) against its plain
   version, the deposit (its row information inside) on the rows of that
   row walk, on random rows and on walk-shaped edge rows (against the
   plain composition, ``direction_rowinfo`` twice then
   ``deposit_scan_plain``), and the tag fold's two kernels on 64 pairs of
   ``testing.fold_inputs`` (L_t 900 and 2,100: one tile and three of the
   planes kernel); at 512, 1024, 2048, 4096 and 8192 each wrapper's ms of
   one launch from the host beside its bound on those inputs.
   Then both DP wrappers alone
   (``ops/dp_kernel``, nothing around them) at the shapes the paths
   launch: (512, 128), full-length segments, 64 / 256 / 1,024 / 4,096 live
   lanes scattered over 4,096 and 64 of 128, every lane held against the
   plain version; ms a launch replayed from a CUDA graph, ms of one launch
   from the host, ns a row, and the bound on the same inputs.  The three
   walk kernels of ``csrc/cns_walk.cu`` (row walk, deposit scan, column
   walk at mapping's MAXC) against their plain versions, every element of
   every lane, at both shapes on 4096 lanes: the move-writing DP kernel's
   words and endpoints, and random words with the edge lanes of
   ``testing.walk_inputs``; the deposit on the rows of each walk, on
   random rows and on the walk-shaped edge rows of
   ``testing.deposit_rows_inputs``.  Each wrapper alone on the first set:
   ms of one launch from
   the host and from a CUDA graph, the plain version's ms, the bound, ns a
   dependent step of the longest lane (for the column walk a row step,
   its columns beside it).  The tag fold's two kernels of
   ``csrc/cns_fold.cu`` (the planes and the fold of every correction
   chunk) against their plain versions at (512, 128), every element of the
   planes, counts and cov_diff: the row walks of 128 and of 64
   ``testing.extend_inputs`` pairs of 8,192 bases (a cns chunk on 16 table
   slots and a polish chunk), the 128 pairs on 4 slots (a deep pile), 128
   edge pairs of ``testing.fold_inputs`` and 64 with 40 / 36 segments;
   each wrapper alone at the three chunks: ms of one launch from the host
   and from a CUDA graph, the bound, for the fold also the sector floor
   (each distinct 32-byte sector of counts and cov_diff that a present
   cell lies in, read and written once); at the cns chunk the plain
   version's ms and, for the fold, one ``index_add_`` of the int32
   presence buffer; the planes kernel's probe (graph ms on 16, 32, 64 and
   128 of the pairs, on them with no deposit cell read, and one
   ``copy_`` of its bound's bytes).  Then the deposit on the row walks of
   the 128-pair cns chunk and of ``testing.cns_pile``'s correction pile
   (through ``run_cns``'s chunk), every element against the plain
   composition, and the host's side of the tag fold
   (``phase_tag_fold_host``): ``plane_inputs`` of the cns chunk, host and
   graph ms, and the torch ops dispatched and device operations launched
   inside one ``banded_accumulate_tags`` (``--kernels-only`` stops
   here).
   The ``roll_micro`` family, 2048
   lanes (the tool's own lanes plus lanes with varied tmax and segq): all 8
   output rows of each of the five variants equal on every lane; then the
   tool itself, ``mecat_tpu_torch.tools.roll_micro`` at its defaults, whose
   launches are the family's main path;
3. golden bytes: ``run_pw(device="cuda", route="staged")`` on
   ``tests/golden/reads.fasta`` reproduces ``tests/golden/overlaps.m4``
   (-j 1, the staged route's bytes) and ``candidates.txt`` (-j 0), and
   ``run_cns(device="cuda")`` on the candidates reproduces
   ``tests/golden/corrected.fasta``, byte for byte, through the move loop;
   then the CLI ``mecat2cns -i 0 -a 300 -l 500 --extend-batch 32
   --align-band 384`` on the same pile with ``--device cuda`` and with
   ``--device cpu``: byte-equal corrected reads, and the CUDA run's summary
   must show the move loop, both correction walks and the tag fold's two
   kernels (as must the golden cns run); the same at ``--align-band 4096``
   (a DP lane of a cluster of two blocks) on the candidates of the pile's
   first two query reads;
4. the bench workload (500 kb genome, 15x, mean 5 kb, 12 % error, seeds
   91/92; k 13, stride 10, N 16, S 512, W 128, 30 segments, B 128, L 8192)
   through ``overlap_step``: a warm-up batch, then ``--passes`` (default 3)
   steady passes over every batch; per-pass seconds (quartiles), overlaps/s
   of the median pass, issued and useful DP Gcells/s, peak device memory;
   batch 0 equals the plain-version ``overlap_step``.  ``--profile`` adds
   one pass under ``torch.profiler`` and prints the device-time breakdown;
5. the CLI ``python -m mecat_tpu_torch.cli.mecat2pw -j 1 --route staged``
   on the bench reads as a subprocess (the staged route, which -j 1 on
   cuda no longer takes by default): exit 0, record count, wall seconds,
   and its own metrics summary (phase split, useful DP Gcells/s,
   segment-loop kernel launches, which must be > 0);
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
7. the CLIs ``mecat2pw -j 0`` then ``mecat2cns -i 0 -l 2000`` as
   subprocesses, cut in depth to the bench reads that start in the first
   quarter of the genome (the same 15x pile depth over 125 kb; phase 11
   runs the same two stages on every read): wall seconds, the cns summary
   line, corrected reads > 0 and move-kernel launches > 0;
8. mapping exactness: a 30 kb + 20 kb reference and 21 reads (one of them
   junk), ``run_ref(device="cuda")`` and ``run_ref(device="cpu")`` in this
   process give byte-equal SAM and byte-equal M4-format output; the junk
   read is FLAG 4; both DP kernels were launched by the CUDA SAM run; then
   the same SAM run at ``align_band`` 1024 (two warps a DP lane) and at
   4096 (a cluster of two blocks a DP lane, every DP launch on the cluster
   route) on cuda and cpu, byte-equal, the CUDA run through the counts
   loop, the move loop and the column walk at that width;
9. mapping at a real reference size: one 46 Mb contig (seed 301), 2,000
   simulated reads of mean 10 kb at 12 % error (seed 302), default
   ``RefOptions``, SAM out, through ``python -m
   mecat_tpu_torch.cli.mecat2ref --device cuda`` as a subprocess: wall and
   ``run_ref`` seconds, reads/s, the phase split, launches of each DP
   kernel, issued and useful DP lane-segments, peak device memory; one
   primary line per read, at least 95 % of the mapped reads at their true
   locus, every mapped CIGAR consuming its read.  ``--profile`` adds one
   ``run_ref`` on the same files in this process under ``torch.profiler``
   (after a warm one) for the card's busy share and its top kernels;
10. correction rounds: (a) the simulated pile of
   ``mecat_tpu_torch.testing.cns_pile`` through ``run_cns`` with
   ``rounds=2`` on ``cuda`` and on ``cpu``: byte-equal corrected reads; (b)
   phase 6's workload through ``correct_batch_rounds`` with ``rounds=2``: a
   warm pass, then a timed pass; supports/s, corrected reads and bases,
   move-kernel launches, issued and useful lane-segments, peak device
   memory, beside phase 6's single-round figures;
11. the correct+trim pipeline at full width: ``python -m
   mecat_tpu_torch.cli.pipeline -d reads.fasta -o out -g 500000 -a 1000
   --min-length 2000 --device cuda`` on every bench read as a subprocess:
   wall seconds, seconds a stage, reads and bases after each stage, each
   stage's own summary line; a second call must skip all five stages;
12. the assembler at full width: ``python -m mecat_tpu_torch.cli.mecat2canu
   -p bench -d wrk -trim-assemble -pacbio-corrected out/corrected.fasta
   genomeSize=500k --device cuda`` on phase 11's corrected reads: wall
   seconds, seconds a stage, overlaps, unitigs, contigs, N50, the longest
   contig, polish tiles and kernel launches, and the share of the longest
   contig's 21-mers (both strands) that occur in the simulated genome;
   every stage marker exists and a second call re-runs nothing.  Before it,
   the polish exactness check: a 7-read contig polished in device tiles on
   ``cuda`` equals the same on ``cpu`` and the host route.  ``--profile``
   adds one polish pass of the longest contig under the stage timers of
   phase 6;
13. the fused pw route and the sharded drivers: (a) ``run_pw(route=
   "fused")`` on ``cuda`` equals its ``cpu`` run, bytes and ``PwStats``, on
   the reads of ``tests/test_dist.py`` and on ``tests/golden/reads.fasta``
   at ``-j 1``; (b) the CLI ``mecat2pw -j 1 -n 16 -a 1000 --device cuda``
   with no ``--route`` on the bench reads, which must take the fused
   route, beside phase 5's staged run: wall and ``run_pw`` seconds,
   records, launches (segment-loop kernel > 0, move-writing kernels 0),
   issued and useful Gcells, the route's phase split; (c) one
   rank on
   NCCL in this process (``init_distributed`` with a ``file://`` store):
   ``run_pw_dist`` on the bench reads gives 13b's records, ``run_cns_dist``
   with one and two rounds on the 28-read pile of ``testing.cns_pile``
   gives ``run_cns``'s; (d) four ranks on ``cuda:0`` over ``gloo``
   (``testing.run_ranks``: subprocesses, one thread each): the collectives
   on CUDA tensors, ``sharded_overlap_step`` at (n_data, n_hash) = (2, 2)
   equal to ``overlap_step`` on the data of ``tests/test_sharded.py``,
   ``run_pw_dist`` at (2, 2) and (1, 4) equal to 13a's fused records,
   ``run_cns_dist`` with two rounds equal to ``run_cns``; seconds, exchange
   bytes and launches of every rank; then ``python -m
   mecat_tpu_torch.parallel.dryrun 8 --device cuda`` at the production
   shapes with its content check (every corrected segment above its raw
   read's identity and at least 95 %);
14. the last modules: (a) the native data layer (``mecat_tpu_torch.native``,
   built with ``g++`` on the card's host) against its plain Python
   versions, byte for byte, with host seconds of both: ``parse_path`` of
   the bench reads and phase 9's mapping reads, ``format_block`` of phase
   5's records, ``format_candidate_columns`` of phase 7's candidates,
   ``partition_supports`` of those candidates (files of 64 templates) and
   ``edit_stats`` of 6 bench reads against their truth loci; (b) the
   scalar C++ engine (``native.scalar.ScalarEngine``) on the bench reads:
   its index counts and cutoff equal ``build_index`` on the card, its scan
   of 8 reads equals ``scan_candidates`` on the card; (c) ``python -m
   mecat_tpu_torch.bench --device cuda --scalar`` as a subprocess, its JSON
   line printed: its overlaps equal phase 4's per-batch overlaps summed over
   the same 32 cyclic batches, its cns supports and corrected reads equal
   phase 6's, and its ``vs_baseline`` divides by the scalar rate measured
   in that run on this host; (d) ``python -m mecat_tpu_torch.bench
   --scaling --device cuda``: the scaling report at its six default meshes,
   1 to 8 ranks sharing the card over ``gloo``, every row with
   ``step_seconds`` > 0, ``virtual_mesh`` true and DP launches.  Phase 3's
   ``-j 0`` golden candidates go through the device strand merge.

The sharded drivers start as ``torch.distributed`` ranks: under
``torchrun`` (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``, ``--device cuda``
takes card ``LOCAL_RANK``), or with rank, world size and an init method
given to ``parallel.dist.init_distributed``; NCCL where every rank has a
card of its own, ``gloo`` on the CPU or where ranks share a card.

Each kernel's launch counter is zeroed just before the timed run of its
path (phase 4's steady passes, phase 6's timed pass, the tool's run in
phase 2, the CUDA SAM runs of phase 8, phase 10's timed pass, phase 13c;
around phase 3's cns run and each two-round and polish check)
and read just after (the DP counters all together), so the reported
launches are those of the main paths only; the CLIs of phases 7, 9, 11, 12
and 13b, the ranks of 13d and the
bench and scaling processes of phase 14 are processes of their own and
report their own counts (the dry run's and the scaling report's summed
over their ranks; the bench's of its timed overlap window and its steady
cns pass).  The row walk, the deposit scan and the tag fold's planes and
fold must launch on every correction path (phases 3, 6, 7, 10, 11, 12,
13c, 13d, the dry run, 14c), the column walk
on every mapping run (both of 8, and 9); every counts path (phases 4, 5, 8, 9, 11, 12,
13b-13d, 14c, 14d) must launch the segment-loop kernel and never the
per-segment counts kernel, whose body runs inside it; every correction,
rounds, polish and mapping phase-B path (phases 3, 6, 7, 8, 9, 10, 11,
12, 13c, 13d, 14c) must launch the move loop and never the per-segment
move kernel, whose body runs inside it.  The line before the
last is a JSON object with the kernels' numbers; the last line is
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
#: the reference's counts-only segment loop (while_loop; body seg_step
#: at :468) that the segment-loop kernel of KERNEL_SOURCE replaces
EXTEND_REPLACES = "mecat_tpu/ops/align.py:531"
#: the reference's move-writing segment loop (lax.scan of seg_step) that
#: the move loop of KERNEL_SOURCE replaces
EXTEND_MOVES_REPLACES = "mecat_tpu/ops/align.py:520"
WALK_SOURCE = "mecat_tpu_torch/csrc/cns_walk.cu"
#: each walk kernel -> the reference's scan it replaces
WALK_REPLACES = {
    "traceback_rows": "mecat_tpu/ops/align.py:300",           # scan :354
    # direction_rowinfo :141 and the deposit _deposit_scan :87 (scan :128)
    "deposit_scan": "mecat_tpu/ops/consensus_banded.py:141",
    "traceback_ops": "mecat_tpu/ops/align.py:234",            # scan :283
}

FOLD_SOURCE = "mecat_tpu_torch/csrc/cns_fold.cu"
#: each tag-fold kernel -> the reference's function whose device scans it
#: replaces
FOLD_REPLACES = {
    # window scan :249, side-band associative scan :256 (_segmented)
    "global_planes": "mecat_tpu/ops/consensus_banded.py:267",
    # banded_presence :347 and the one-hot matmul fold :381
    "fold_tags": "mecat_tpu/ops/consensus_banded.py:368",
}
#: each tag-fold kernel -> its launch counter's short name
FOLD_SHORT = {"global_planes": "planes", "fold_tags": "fold"}
#: the cns chunk's template width in phase 2's path cases (templates of the
#: bench reads, mean 5 kb)
FOLD_L_T = 8192
#: the chunks at which phase 2 times the tag fold's kernels: name -> case
#: of phase_fold (128 pairs of a cns chunk on 16 slots, 64 of a polish
#: chunk, the cns chunk's pairs on 4 slots)
FOLD_CHUNKS = {"cns": (128, "path"), "polish": (64, "path"), "deep": "deep"}

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
#: int32 operations of the walk kernels, as the header of csrc/cns_walk.cu
#: counts them: the row walk a 32-cell chunk of a walked row and a row
#: besides; the deposit a row, its row information a row (three warp
#: scans), a gap cell and an output char; the column walk a tape column
WALK_OPS = dict(row_chunk=20, row=12, deposit_row=24, rowinfo_row=40,
                gap_cell=3, deposit_char=6, col_step=16)
#: int32 operations of the tag fold's kernels: the planes kernel an output
#: column and a side-band entry; the fold a column and an add on a present
#: cell
FOLD_OPS = dict(planes_col=12, planes_entry=40, fold_col=10, fold_add=4)

#: band widths held in phase 2 besides the paths' 64 and 128: every other
#: DP kernel instance (C = 2, 4, ..., 16 cells a thread) with and without
#: padding cells, the row walk's odd word counts and each of its thread
#: groups (1-32 threads a lane); past 512 a DP lane of several warps (528:
#: a second warp of one real thread; 1024, 2048: two and four whole
#: slices; 3072: the widest lane of one block) and walks of 16 and 8 lanes
#: a block; past 3072 a DP lane of a thread-block cluster (3088: two
#: blocks of four slices, one of padding; 4096: two of four; 8192: three of
#: six, two of padding; BAND_MAX = 24576: eight of six) and walks of 4, 2
#: and 1 lanes a block
BAND_SWEEP = (32, 48, 96, 160, 256, 272, 384, 512, 528, 1024, 2048, 3072,
              3088, 4096, 8192, 24576)
#: widths at which phase 2 times every DP-family kernel (S = 128, 256 lanes)
BAND_TIMED = (512, 1024, 2048, 4096, 8192)
#: the widest band a block holds a DP lane for (ops/dp_kernel.BAND_BLOCK_MAX)
BLOCK_BAND = 3072
#: the band of phase 8's wide mapping run (a DP lane of two warps) and of
#: its cluster run (a DP lane of two blocks of four warps)
REF_WIDE_BAND = 1024
REF_CLUSTER_BAND = 4096
#: the band of phase 3's wide CLI run: a width past the paths' 64 and 128
#: that the reference takes (C = 12 cells a thread, 32 threads a row walk)
WIDE_BAND = 384
#: the band of phase 3's cluster CLI run
CLUSTER_BAND = 4096
#: the four DP kernels' launch counters: record key -> summary key
DP_KEYS = (("counts", "dp_launches"), ("moves", "dp_launches_moves"),
           ("extend", "dp_launches_extend"),
           ("extend_moves", "dp_launches_extend_moves"))

# mapping at a real reference size (tools/ref_bench.py:39-44)
REF_GENOME, REF_READS, REF_MEAN_LEN = 46_000_000, 2000, 10_000
#: the small mapping check's options (tests/test_ref.py)
REF_SMALL = dict(num_candidates=8, num_extend=3, min_align_size=400,
                 kmer_size=10, scan_stride=5, scan_batch=16, extend_batch=32,
                 align_segment=128, align_band=64)


def say(msg: str) -> None:
    print(msg, flush=True)


#: the kernels of ops/walk_kernel, by the short names of their counters
WALK_KERNELS = ("rows", "deposit", "cols", "planes", "fold")
#: the kernels every correction path must launch
CORRECTION_KERNELS = ("rows", "deposit", "planes", "fold")


def zero_walk_counts() -> None:
    """Set the launch counters of the walks and the tag fold to 0."""
    from mecat_tpu_torch.ops import walk_kernel as wk

    wk.LAUNCHES_ROWS = wk.LAUNCHES_DEPOSIT = wk.LAUNCHES_COLS = 0
    wk.LAUNCHES_PLANES = wk.LAUNCHES_FOLD = 0


def need_walks(where: str, counts: dict,
               kernels=CORRECTION_KERNELS) -> dict:
    """The launches of the walks and the tag fold in ``counts`` (a metrics
    summary, a bench line or ``walk_kernel.launches()``); raises unless each
    of ``kernels`` was launched."""
    walks = {k: counts.get(f"walk_launches_{k}", 0) for k in WALK_KERNELS}
    missing = [k for k in kernels if walks[k] <= 0]
    if missing:
        raise AssertionError(f"{where} did not go through the kernels "
                             f"{missing}: {walks}")
    return walks


def zero_dp_counts() -> None:
    """Set the four DP kernels' launch counters to 0, and the count of
    their launches on the cluster route."""
    from mecat_tpu_torch.ops import dp_kernel

    dp_kernel.LAUNCHES = dp_kernel.LAUNCHES_MOVES = 0
    dp_kernel.LAUNCHES_EXTEND = dp_kernel.LAUNCHES_EXTEND_MOVES = 0
    dp_kernel.LAUNCHES_CLUSTER = 0


def dp_launches_of(counts: dict, prefix: str = "") -> dict:
    """The four DP kernels' launches in ``counts`` (``dp_kernel.launches()``,
    a metrics summary, or a bench line with ``prefix``), by record key."""
    return {key: counts.get(prefix + name, 0) for key, name in DP_KEYS}


def need_moves_loop(where: str, launches: dict) -> None:
    """Raises unless a correction or mapping path ran its move-writing DP
    through the move loop (``extend_moves`` launches > 0) and never
    through the per-segment move kernel, whose body runs inside it."""
    if launches.get("extend_moves", 0) <= 0 or launches.get("moves", 0):
        raise AssertionError(
            f"{where} did not run its move-writing DP through the move loop "
            f"alone: {launches}")


def need_loop(where: str, extend: int, per_segment: int) -> None:
    """Raises unless a counts path ran its DP through the segment-loop
    kernel (``extend`` launches > 0) and never through the per-segment
    counts kernel."""
    if extend <= 0 or per_segment != 0:
        raise AssertionError(
            f"{where} did not run its counts DP through the segment-loop "
            f"kernel alone: {extend} loop-kernel launches, {per_segment} "
            f"per-segment counts-kernel launches")


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


def card_bound(n_bytes: float, ops: float) -> dict:
    """The least time the card could take: the bytes over the memory rate
    or the int32 operations over their peak rate, whichever is longer."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations")


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
    return card_bound(n_bytes, rows * W * OPS_PER_CELL[with_moves])


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


def extend_cases(S: int, W: int):
    """The pairs the segment-loop kernel is held on: DP_LANES / 2 pairs of
    ``testing.extend_inputs`` (rows of 8,192 bases at 12 % noise as the
    bench's, with its edge lanes), and the ``dp_inputs`` lanes as pairs
    seeded at 0 (the query row up to seg_q, the framed window's target up to
    tmax, so lanes with nothing to extend among them)."""
    import torch

    from mecat_tpu_torch.testing import dp_inputs, extend_inputs

    dev = torch.device("cuda")
    n = DP_LANES // 2
    q, tpad, tmax, seg_q, _ = dp_inputs(S, W, n, seed=181 + S + W)
    zeros = np.zeros(n, np.int32)
    return [("extend_inputs pairs",
             [torch.as_tensor(a, device=dev)
              for a in extend_inputs(n, L, S, seed=191 + S + W)]),
            ("the dp_inputs lanes as pairs",
             [torch.as_tensor(a, device=dev)
              for a in (q, np.ascontiguousarray(tpad[:, W // 2:]), seg_q,
                        tmax, zeros, zeros)])]


def loop_bound(run, S: int, W: int, moves: bool):
    """A host loop on the plain DP (a segment loop's plain version), timed
    between two events, and the work it did: (its result, its ms, bound
    numbers, dependent steps of the longest lane, lane-segments run).
    ``run(dp)`` runs the loop with segment function ``dp`` and returns
    (result, G): G, where the loop runs both directions, is the right
    direction's segments (the first G calls), else None.

    A lane-segment computes rows 1..min(seg_q, S, tmax + W/2) (one more row
    finds the band gone, as in ``dp_bound``) of W cells at the source's
    operations a cell (18 with moves); it reads its S + S + W window bytes,
    with moves writes its S * W/4 bytes of move words (zeros past the last
    row) and 17 bytes of endpoint, and each lane its four int32 inputs and
    six outputs once.  The longest lane's chain: 2 rows + W steps a
    segment, over its segments (each direction lane its own chain)."""
    import torch

    from mecat_tpu_torch.ops import align

    rows_of = []

    def recording(q_seg, tpad, tmax, seg_q, active, S, W, **kw):
        rows = torch.minimum(seg_q.clamp(0, S),
                             (tmax + W // 2 + 1).clamp(min=1))
        rows_of.append(torch.where(active, rows, 0).long())
        return align.dp_segment_best_plain(q_seg, tpad, tmax, seg_q, active,
                                           S, W, **kw)

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    res, G = run(recording)
    b.record()
    torch.cuda.synchronize()
    plain_ms = a.elapsed_time(b)
    n_rows = lane_segs = chain = n_lanes = 0
    for part in ((rows_of,) if G is None else (rows_of[:G], rows_of[G:])):
        rows = torch.stack(part)
        n_lanes += rows.shape[1]
        n_rows += int(rows.sum())
        lane_segs += int((rows > 0).sum())
        chain = max(chain, int(torch.where(rows > 0, 2 * rows + W,
                                           0).sum(0).max()))
    per_seg = S + S + W + (S * W // 4 + 17 if moves else 0)
    bound = card_bound(lane_segs * per_seg + n_lanes * 40,
                       n_rows * W * OPS_PER_CELL[moves])
    return res, plain_ms, bound, chain, lane_segs


def phase_extend(S: int, W: int, time_it: bool) -> dict:
    """The segment-loop kernel against the plain loop at one shape, on
    every lane of both cases of ``extend_cases``, at the bench's 30
    segments and at 1: the six outputs equal, one launch a call and no
    per-segment launch.  With ``time_it``, on the first case at 30 segments
    the plain loop is timed (one run, the one the kernel is held against)
    and the wrapper alone: ms of one launch from the host and replayed from
    a CUDA graph, the bound, and ns a dependent step of the longest lane.
    Returns those numbers."""
    import torch

    from mecat_tpu_torch import constants as C
    from mecat_tpu_torch.ops import align, dp_kernel

    err = 0
    timed = None
    for what, pairs in extend_cases(S, W):
        lanes = [x.contiguous() for x in align.direction_lanes(*pairs, S, W)]
        for max_segs in (CFG["max_segs"], 1):
            kw = dict(S=S, W=W, max_segs=max_segs,
                      min_seg_identity=C.MIN_SEGMENT_IDENTITY)
            before = dp_kernel.launches()
            got, _ = align._extend_direction_impl(*lanes, **kw)
            launched = dp_kernel.launches_since(before)
            if time_it and timed is None:
                want, plain_ms, b, chain, lane_segs = loop_bound(
                    lambda dp: (align._extend_direction_impl(
                        *lanes, **kw, dp=dp)[0], None), S, W, False)
                timed = (lanes, max_segs)
            else:
                want, _ = align._extend_direction_impl(
                    *lanes, **kw, dp=align.dp_segment_best_plain)
            torch.cuda.synchronize()
            if launched != {"dp_launches": 0, "dp_launches_moves": 0,
                            "dp_launches_extend": 1,
                            "dp_launches_extend_moves": 0}:
                raise AssertionError(f"the counts loop on cuda launched "
                                     f"{launched}")
            for name, g, w in zip(align.ExtensionResult._fields, got, want):
                err = max(err, int((g.long() - w.long()).abs().max()))
                if not torch.equal(g, w):
                    raise AssertionError(
                        f"segment-loop kernel != plain at S={S} W={W}, "
                        f"max_segs {max_segs}, {what}: {name} differs on "
                        f"{int((g != w).sum())} of {g.numel()} lanes")
            say(f"phase 2: segment-loop kernel == plain at S={S} W={W}, "
                f"{lanes[0].shape[0]} lanes of {what}, max_segs {max_segs}: "
                f"all six outputs equal on every lane "
                f"({int(want.n_segs.sum())} lane-segments, the longest lane "
                f"{int(want.n_segs.max())})")
    if not time_it:
        return dict(max_abs_err=err)
    lanes, max_segs = timed
    kw = dict(S=S, W=W, max_segs=max_segs,
              min_seg_identity=C.MIN_SEGMENT_IDENTITY)
    fn = lambda: dp_kernel.extend_counts_cuda(*lanes, **kw)
    ms = cuda_median_ms(fn, 21)
    graph_ms = cuda_graph_ms(fn, launches=5, reps=5)
    say(f"phase 2: segment-loop kernel alone at S={S} W={W}, "
        f"{lanes[0].shape[0]} lanes, max_segs {max_segs}: one launch from "
        f"the host {ms:.4f} ms, replayed from a CUDA graph {graph_ms:.4f} ms "
        f"({1e6 * graph_ms / max(chain, 1):.1f} ns a step of the longest "
        f"lane's {chain}); plain loop {plain_ms:.2f} ms; {lane_segs} "
        f"lane-segments; bound {b['bound_ms']:.4f} ms by {b['bound_by']}")
    return dict(max_abs_err=err, ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
                chain_steps=chain, ns_step=1e6 * graph_ms / max(chain, 1),
                lane_segments=lane_segs, **b)


def check_moves_loop(got, want, pairs, S: int, W: int, what: str) -> int:
    """The move loop's (left, right, raw2, G) against the host loop's on
    the plain DP: both ExtensionResults, G and every element of the six raw
    arrays of every slot < G, the plain moves past each segment's last row
    set to zero as the kernels leave them.  Returns the largest difference
    (0)."""
    import torch

    from mecat_tpu_torch.ops import align
    from mecat_tpu_torch.testing import moves_as_the_kernels_leave_them

    err = 0
    for side, g_res, w_res in zip(("left", "right"), got[:2], want[:2]):
        for name, g, w in zip(align.ExtensionResult._fields, g_res, w_res):
            err = max(err, int((g.long() - w.long()).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(f"move loop != plain, {what}: {side} "
                                     f"{name} differs")
    if got[3] != want[3] or got[2][0].shape != want[2][0].shape:
        raise AssertionError(f"move loop != plain, {what}: G {got[3]} / "
                             f"{tuple(got[2][0].shape)}, plain {want[3]} / "
                             f"{tuple(want[2][0].shape)}")
    lanes = align.direction_lanes(*pairs, S, W)
    want_raw = moves_as_the_kernels_leave_them(want[2], want[3], lanes[4],
                                               lanes[5], S, W)
    for name, g, w in zip(("moves", "r_end", "w_end", "qoff_before",
                           "toff_before", "ok"), got[2], want_raw):
        err = max(err, int((g.long() - w.long()).abs().max()))
        if not torch.equal(g, w):
            raise AssertionError(f"move loop != plain, {what}: {name} "
                                 f"differs on {int((g != w).sum())} of "
                                 f"{g.numel()} elements")
    return err


def phase_extend_moves(S: int, W: int, time_it: bool) -> dict:
    """The move loop (the move-writing segment loop of both directions, one
    launch) against the host loop at one shape, on the ``extend_inputs``
    case of ``extend_cases``, at 30 segments right and 20 left and at 1:
    both ExtensionResults and the six raw arrays on every slot < G, one
    launch a call and none of the other DP kernels.  With ``time_it`` the
    host loop of the first call is timed (the run the kernel is held
    against) and the wrapper alone: ms of one launch from the host and
    replayed from a CUDA graph, the bound, and ns a dependent step of the
    longest lane.  Returns those numbers."""
    import torch

    from mecat_tpu_torch import constants as C
    from mecat_tpu_torch.ops import align, dp_kernel

    what, pairs = extend_cases(S, W)[0]
    err = 0
    timed = None
    for max_segs, max_left in ((CFG["max_segs"], 20), (1, 1)):
        kw = dict(S=S, W=W, max_segs=max_segs, max_segs_left=max_left,
                  min_seg_identity=C.MIN_SEGMENT_IDENTITY)
        before = dp_kernel.launches()
        got = align._extend_both_with_moves(*pairs, **kw,
                                            dp=align.dp_segment_best)
        launched = dp_kernel.launches_since(before)
        if time_it and timed is None:
            def host_loop(dp):
                res = align._extend_both_with_moves(*pairs, **kw, dp=dp)
                return res, res[3]

            want, plain_ms, b, chain, lane_segs = loop_bound(host_loop, S, W,
                                                             True)
            timed = (max_segs, max_left)
        else:
            want = align._extend_both_with_moves(
                *pairs, **kw, dp=align.dp_segment_best_plain)
        torch.cuda.synchronize()
        if launched != {"dp_launches": 0, "dp_launches_moves": 0,
                        "dp_launches_extend": 0,
                        "dp_launches_extend_moves": 1}:
            raise AssertionError(f"the move loop on cuda launched {launched}")
        err = max(err, check_moves_loop(
            got, want, pairs, S, W,
            f"S={S} W={W}, max_segs {max_segs} / {max_left}, {what}"))
        say(f"phase 2: move loop == plain at S={S} W={W}, "
            f"{2 * pairs[0].shape[0]} direction lanes of {what}, max_segs "
            f"{max_segs} right / {max_left} left: both ExtensionResults and "
            f"every element of the six raw arrays of all "
            f"{want[2][0].shape[0]} "
            f"slots (G {want[3]} right) equal; "
            f"{int(want[0].n_segs.sum() + want[1].n_segs.sum())} "
            f"lane-segments")
        del got, want
    if not time_it:
        return dict(max_abs_err=err)
    max_segs, max_left = timed
    lanes = [x.contiguous() for x in align.direction_lanes(*pairs, S, W)]
    B = pairs[0].shape[0]
    fn = lambda: dp_kernel.extend_moves_cuda(
        *lanes, S=S, W=W, max_segs=max_segs, split=B, max_segs_b=max_left,
        min_seg_identity=C.MIN_SEGMENT_IDENTITY)
    ms = cuda_median_ms(fn, 11)
    graph_ms = cuda_graph_ms(fn, launches=3, reps=5)
    torch.cuda.empty_cache()
    say(f"phase 2: move loop alone at S={S} W={W}, {len(lanes[0])} lanes, "
        f"max_segs {max_segs} / {max_left}: one launch from the host "
        f"{ms:.4f} ms, replayed from a CUDA graph {graph_ms:.4f} ms "
        f"({1e6 * graph_ms / max(chain, 1):.1f} ns a step of the longest "
        f"lane's {chain}); plain loop {plain_ms:.2f} ms; {lane_segs} "
        f"lane-segments; bound {b['bound_ms']:.4f} ms by {b['bound_by']}")
    return dict(max_abs_err=err, ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
                chain_steps=chain, ns_step=1e6 * graph_ms / max(chain, 1),
                lane_segments=lane_segs, **b)


def phase_widths() -> tuple:
    """Every DP-family kernel at the band widths of BAND_SWEEP (S = 128):
    the two per-segment kernels on 256 ``dp_inputs`` lanes (the endpoints
    on every lane, the move words on every row: the plain version's up to
    the last row computed, zeros after), the row and the column walk on the
    move kernel's words, the deposit scan on the rows of that row walk and
    on random rows, the tag fold's planes and fold on 64 pairs of
    ``fold_inputs`` at L_t 900 and 2,100, the counts loop on 256 direction lanes of
    ``extend_inputs`` pairs and the move loop on the same pairs, each
    against its plain version.  At the widths of BAND_TIMED each kernel's
    wrapper alone on those inputs, ms of one launch from the host (median
    of 11), and its bound on them.  Past BLOCK_BAND each of the four DP
    kernels must have launched once on the cluster route (their wrappers'
    cluster counter).  Returns ({kernel: largest difference}, {W: {kernel:
    ms}}, {W: {kernel: bound numbers}})."""
    import torch

    from mecat_tpu_torch import constants as C
    from mecat_tpu_torch.ops import align, consensus_banded, dp_kernel
    from mecat_tpu_torch.testing import dp_inputs, extend_inputs, fold_case

    dev = torch.device("cuda")
    S = 128
    if (dp_kernel.BAND_MAX, dp_kernel.BAND_BLOCK_MAX) != (BAND_SWEEP[-1],
                                                          BLOCK_BAND):
        raise AssertionError("BAND_SWEEP must end at the kernels' BAND_MAX")
    err = dict.fromkeys(("dp_segment_best", "dp_segment_best_moves",
                         "extend_counts", "extend_moves", "traceback_rows",
                         "traceback_ops", "deposit_scan", *FOLD_REPLACES), 0)

    def check(name, got, want, W):
        for g, w in zip(got, want):
            err[name] = max(err[name], int((g.long() - w.long()).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(f"{name} kernel != plain at S={S} W={W}")

    timed, bounds = {}, {}
    for W in BAND_SWEEP:
        cluster0 = dp_kernel.LAUNCHES_CLUSTER
        args = [torch.as_tensor(a, device=dev)
                for a in dp_inputs(S, W, 256, seed=211 + W)]
        want = align.dp_segment_best_plain(*args, S, W, want_moves=True)
        check("dp_segment_best", align.dp_segment_best(*args, S, W), want[1:],
              W)
        got = align.dp_segment_best(*args, S, W, want_moves=True)
        last = torch.minimum(args[3].clamp(max=S), args[2] + W // 2)
        last = torch.where(args[2] < 0, 0, last).clamp(min=0)
        row = torch.arange(1, S + 1, device=dev)[None, :, None]
        check("dp_segment_best_moves", got, (torch.where(
            (row <= last[:, None, None]) & args[4][:, None, None], want[0],
            0), *want[1:]), W)
        moves, r_best, w_best = got[:3]
        rows = align.traceback_rows(moves, r_best, w_best, W)
        check("traceback_rows", rows,
              align.traceback_rows_plain(moves, r_best, w_best, W), W)
        deps = [deposit_case(dev, S, W, 255, 231 + W, walk=rows[:3]),
                deposit_case(dev, S, W, 255, 232 + W, source="random"),
                deposit_case(dev, S, W, 255, 233 + W)]
        for dep in deps:
            check("deposit_scan", flat(consensus_banded.plane_inputs(
                *dep, S, W)), flat(consensus_banded.plane_inputs_plain(
                    *dep, S, W)), W)
        dep = deps[0]
        # L_t 2,100: three tiles of the planes kernel, side-band cells at
        # the first one's last column and the second one's first
        check_fold(err, *fold_case(dev, S, W, 2100, "edge", B=64,
                                   seed=242 + W), S, W, 2100, "fold_inputs")
        fplanes, ffold = fold_case(dev, S, W, 900, "edge", B=64,
                                   seed=241 + W)
        fwant = check_fold(err, fplanes, ffold, S, W, 900, "fold_inputs")
        TC = align.max_tape_cols(S, W, C.MIN_SEGMENT_IDENTITY)
        check("traceback_ops",
              align.traceback_ops(moves, r_best, w_best, W, TC),
              align.traceback_ops_plain(moves, r_best, w_best, W, TC), W)
        pairs = [torch.as_tensor(a, device=dev)
                 for a in extend_inputs(128, 20 * S, S, seed=221 + W)]
        lanes = [x.contiguous() for x in align.direction_lanes(*pairs, S, W)]
        kw = dict(S=S, W=W, min_seg_identity=C.MIN_SEGMENT_IDENTITY)
        got_counts = align._extend_direction_impl(*lanes, **kw,
                                                  max_segs=16)[0]
        # the plain loops, with the cells they run for the bounds
        want_counts, _, b_counts, chain_counts, _ = loop_bound(
            lambda dp: (align._extend_direction_impl(
                *lanes, **kw, max_segs=16, dp=dp)[0], None), S, W, False)
        check("extend_counts", got_counts, want_counts, W)
        kw.update(max_segs=16, max_segs_left=9)
        got_moves = align._extend_both_with_moves(*pairs, **kw,
                                                  dp=align.dp_segment_best)

        def host_loop(dp):
            res = align._extend_both_with_moves(*pairs, **kw, dp=dp)
            return res, res[3]

        want_moves, _, b_moves, chain_moves, _ = loop_bound(host_loop, S, W,
                                                            True)
        err["extend_moves"] = max(err["extend_moves"], check_moves_loop(
            got_moves, want_moves, pairs, S, W, f"S={S} W={W}"))
        del got_moves, want_moves
        torch.cuda.synchronize()
        on_cluster = dp_kernel.LAUNCHES_CLUSTER - cluster0
        if on_cluster != (4 if W > BLOCK_BAND else 0):
            raise AssertionError(f"at W={W} the DP kernels made {on_cluster} "
                                 f"launches on the cluster route")
        if W in BAND_TIMED:
            from mecat_tpu_torch.ops import dp_kernel
            from mecat_tpu_torch.ops import walk_kernel as wk

            mk = dict(S=S, W=W, min_seg_identity=C.MIN_SEGMENT_IDENTITY)
            runs = {
                "dp_segment_best": lambda: dp_kernel.dp_segment_best_cuda(
                    *args, S, W),
                "dp_segment_best_moves":
                    lambda: dp_kernel.dp_segment_best_moves_cuda(*args, S, W),
                "extend_counts": lambda: dp_kernel.extend_counts_cuda(
                    *lanes, max_segs=16, **mk),
                "extend_moves": lambda: dp_kernel.extend_moves_cuda(
                    *lanes, max_segs=16, **mk),
                "traceback_rows": lambda: wk.traceback_rows_cuda(
                    moves, r_best, w_best, W),
                "traceback_ops": lambda: wk.traceback_ops_cuda(
                    moves, r_best, w_best, W, TC),
                "deposit_scan": lambda: wk.deposit_rows_cuda(
                    *dep, S=S, W=W),
                "global_planes": lambda: wk.global_planes_cuda(
                    *fplanes, L_t=900, S=S, W=W),
                "fold_tags": lambda: wk.fold_tags_cuda(
                    *ffold[:2], *fwant, *ffold[2:], 900)}
            timed[W] = {name: cuda_median_ms(fn, 11)
                        for name, fn in runs.items()}
            ops = align.traceback_ops_plain(moves, r_best, w_best, W, TC)
            bounds[W] = {
                "dp_segment_best": dp_bound(*args[2:], S, W, False),
                "dp_segment_best_moves": dp_bound(*args[2:], S, W, True),
                "extend_counts": dict(b_counts, chain_steps=chain_counts),
                "extend_moves": dict(b_moves, chain_steps=chain_moves),
                **{k: dict(v[0], chain_steps=v[1]) for k, v in walk_bounds(
                    S, W, TC, r_best, rows, ops, dep).items()},
                **fold_bound(fplanes, ffold, fwant, 900, S)}
            say(f"phase 2: band W={W} (S={S}, 256 lanes), ms of one launch "
                f"from the host: " + ", ".join(
                    f"{k} {v:.4f} (bound {bounds[W][k]['bound_ms']:.4f} by "
                    f"{bounds[W][k]['bound_by']})"
                    for k, v in timed[W].items()))
        say(f"phase 2: band W={W} (S={S}): both per-segment DP kernels (256 "
            f"lanes, every move word), the row and the column walk on their "
            f"words, the deposit with its row information on that walk's "
            f"rows, on random rows and on walk-shaped edge rows, "
            f"the counts loop and the move loop (256 direction lanes, 16 / 9 "
            f"segments), the tag fold's planes and fold (64 pairs of "
            f"fold_inputs, L_t 900 and 2,100) == their plain versions; "
            f"{on_cluster} DP launches on the cluster route")
    return err, timed, bounds


def walk_bounds(S: int, W: int, maxc: int, seg_qlen, rows, ops, dep_args):
    """The bound of each walk kernel on these inputs, with the lane chain
    it walks: {kernel: (bound numbers, dependent steps of the longest
    lane)}.  Bytes: each input read once and each output written once,
    where the row walk reads the moves of the rows it walks (those it
    visits, and one more where its path broke) and the column walk one
    word a row it visits; operations as the source's header counts them
    (``WALK_OPS``), over the rows, gap cells and tape columns this data
    needs.  The column walk's chain is counted in row steps: one a
    non-horizontal code of its tape."""
    import torch

    N = int(seg_qlen.shape[0])
    mv = rows[0]
    visited = (mv >= 0).sum(dim=1)
    broke = visited < seg_qlen.clamp(0, S)
    rows_read = visited + broke.to(visited.dtype)
    n_rows = int(rows_read.sum())
    out = {"traceback_rows": (card_bound(
        n_rows * W // 4 + N * (8 + 12 * S + 4),
        n_rows * (WALK_OPS["row_chunk"] * W // 32 + WALK_OPS["row"])),
        int(rows_read.max()))}
    out["deposit_scan"] = (deposit_bound(dep_args, S, W), S)
    tape, n_cols = ops[0], ops[3]
    row_steps = ((tape >= 0) & (tape != 3)).sum(dim=1)
    col_rows = int(row_steps.sum())
    out["traceback_ops"] = (card_bound(
        col_rows * 4 + N * (maxc + 4 + 8),
        int(n_cols.sum()) * WALK_OPS["col_step"]), int(row_steps.max()))
    return out


def deposit_bound(dep, S: int, W: int) -> dict:
    """The deposit's bound on ``dep`` (plane_inputs' arguments but S and
    W): bytes, each input read once (a row's mv, h, wo and query char, a
    lane's w0, qoff and ok, the seeds) and each output written once (9
    bytes an output char, 12 of side arrays a lane, 4 of j_end a left
    lane); operations as the source's header counts them, the row
    information's on every row, the deposit's on the rows and gap cells of
    the lanes that are ok."""
    import torch

    rr, lr, q, qseed = dep
    LP = S + W // 2 - 1
    N = sum(r[6].numel() for r in (rr, lr))
    rows_ok = sum(int(r[6].sum()) for r in (rr, lr)) * S
    gap_cells = 0
    for mv, h, wo, *_, ok in (rr, lr):
        lo = (wo + 1).clamp(min=0)
        hi = torch.minimum(wo + h, torch.full_like(wo, W - 1))
        gap_cells += int(torch.where((mv >= 0) & ok[..., None],
                                     (hi - lo + 1).clamp(min=0), 0).sum())
    return card_bound(
        N * S * 13 + N * 9 + 4 * qseed.numel() + N * (LP * 9 + 12)
        + 4 * lr[6].numel(),
        N * S * WALK_OPS["rowinfo_row"] + rows_ok * WALK_OPS["deposit_row"]
        + gap_cells * WALK_OPS["gap_cell"] + N * LP * WALK_OPS["deposit_char"])


def deposit_case(dev, S: int, W: int, n: int, seed: int, walk=None,
                 source: str = "walk"):
    """The deposit's inputs (plane_inputs' arguments but S and W) on the
    card for n lanes, 3 right and 2 left segments of n // 5 pairs
    (``testing.deposit_rows_inputs``): on the rows of a walk (``walk`` =
    its mv, h, wo tensors) or on generated rows, walk-shaped with the edge
    lanes or random."""
    import torch

    from mecat_tpu_torch.testing import deposit_rows_inputs

    if walk is not None:
        walk = [a.cpu().numpy() for a in walk]
    rr, lr, q, qseed = deposit_rows_inputs(S, W, n // 5, 3 * S, seed,
                                           source=source, walk=walk)
    on = lambda a: torch.as_tensor(np.array(a), device=dev)
    return tuple(on(a) for a in rr), tuple(on(a) for a in lr), on(q), on(
        qseed)


def flat(out) -> list:
    """plane_inputs' nested result as one list of tensors."""
    return [t for x in out for t in (x if isinstance(x, tuple) else (x,))]


def phase_walks(S: int, W: int) -> dict:
    """The three walk kernels against their plain versions at one shape on
    every lane and every output element: the row walk and the column walk
    (at mapping's MAXC) on the move-writing DP kernel's words and endpoints
    for the dp_inputs lanes, and on random words with the edge lanes of
    ``testing.walk_inputs``; the deposit with its row information on the
    rows of each of those walks, on random rows and on walk-shaped edge
    rows, against the plain composition.  Then, on the DP kernel's words
    and the rows
    of their walk, each wrapper alone: ms of one launch from the host
    between two events (``ms``) and a launch replayed from a CUDA graph
    (``graph_ms``), the plain version's ms, the bound, and ns a dependent
    step of the longest lane (a row step of the column walk, whose longest
    lane's columns are given beside it).  Returns {kernel: numbers}."""
    import torch

    from mecat_tpu_torch import constants as C
    from mecat_tpu_torch.ops import align, consensus_banded
    from mecat_tpu_torch.ops import walk_kernel as wk
    from mecat_tpu_torch.testing import dp_inputs, walk_inputs

    dev = torch.device("cuda")
    maxc = align.max_tape_cols(S, W, C.MIN_SEGMENT_IDENTITY)
    args = [torch.as_tensor(a, device=dev)
            for a in dp_inputs(S, W, DP_LANES, seed=151 + S + W)]
    cases = [("the DP kernel's moves on the dp_inputs lanes",
              align.dp_segment_best(*args, S, W, want_moves=True)[:3]),
             ("random words with the edge lanes",
              [torch.as_tensor(a, device=dev)
               for a in walk_inputs(S, W, DP_LANES, seed=161 + S + W)])]
    err = dict.fromkeys(WALK_REPLACES, 0)

    def check(name, got, want, what):
        for g, w in zip(got, want):
            err[name] = max(err[name], int((g.long() - w.long()).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(
                    f"{name} kernel != plain at S={S} W={W} on {what}: "
                    f"{int((g != w).sum())} elements differ")

    timed = None
    for k, (what, (moves, seg_qlen, w_end)) in enumerate(cases):
        rows = align.traceback_rows(moves, seg_qlen, w_end, W)
        rows_plain = align.traceback_rows_plain(moves, seg_qlen, w_end, W)
        ops = align.traceback_ops(moves, seg_qlen, w_end, W, maxc)
        ops_plain = align.traceback_ops_plain(moves, seg_qlen, w_end, W,
                                              maxc)
        torch.cuda.synchronize()
        check("traceback_rows", rows, rows_plain, what)
        check("traceback_ops", ops, ops_plain, what)
        seed = 171 + S + W + 3 * k
        deps = [deposit_case(dev, S, W, DP_LANES - 1, seed, walk=rows[:3]),
                deposit_case(dev, S, W, DP_LANES - 1, seed + 1,
                             source="random"),
                deposit_case(dev, S, W, DP_LANES - 1, seed + 2)]
        for dep, rows_what in zip(deps, ("the rows of that walk",
                                         "random rows", "edge rows")):
            got = flat(consensus_banded.plane_inputs(*dep, S, W))
            want = flat(consensus_banded.plane_inputs_plain(*dep, S, W))
            torch.cuda.synchronize()
            check("deposit_scan", got, want, f"{what}, {rows_what}")
        say(f"phase 2: walk kernels == plain at S={S} W={W}, {DP_LANES} "
            f"lanes of {what}: row walk (mv, h, w_out, w0; "
            f"{int((rows[0] >= 0).sum())} rows visited), column walk at "
            f"MAXC {maxc} (ops, qi, tj, n_cols; {int(ops[3].sum())} "
            f"columns), the deposit with its row information on the rows "
            f"of that walk, on random rows and on edge rows (planes and "
            f"side arrays): every element equal")
        if timed is None:
            timed = (moves, seg_qlen, w_end, rows_plain, ops_plain, deps[0])
    moves, seg_qlen, w_end, rows_plain, ops_plain, dep = timed
    runs = {
        "traceback_rows": (
            lambda: wk.traceback_rows_cuda(moves, seg_qlen, w_end, W),
            lambda: align.traceback_rows_plain(moves, seg_qlen, w_end, W)),
        "deposit_scan": (
            lambda: wk.deposit_rows_cuda(*dep, S=S, W=W),
            lambda: consensus_banded.plane_inputs_plain(*dep, S, W)),
        "traceback_ops": (
            lambda: wk.traceback_ops_cuda(moves, seg_qlen, w_end, W, maxc),
            lambda: align.traceback_ops_plain(moves, seg_qlen, w_end, W,
                                              maxc)),
    }
    bounds = walk_bounds(S, W, maxc, seg_qlen, rows_plain, ops_plain, dep)
    out = {}
    for name, (fn, plain) in runs.items():
        ms = cuda_median_ms(fn, 21)
        graph_ms = cuda_graph_ms(fn)
        plain_ms = cuda_median_ms(plain, 3)
        b, steps = bounds[name]
        what = "step"
        extra = {}
        if name == "traceback_ops":
            what = "row step"
            extra = dict(chain_cols=int(ops_plain[3].max()))
        say(f"phase 2: {name} kernel alone at S={S} W={W}, {DP_LANES} "
            f"lanes: one launch from the host {ms:.4f} ms, replayed from a "
            f"CUDA graph {graph_ms:.4f} ms ({1e6 * graph_ms / steps:.1f} ns "
            f"a {what} of the longest lane's {steps}"
            + (f", {extra['chain_cols']} columns" if extra else "")
            + f"); plain {plain_ms:.2f} ms; bound {b['bound_ms']:.4f} ms by "
            f"{b['bound_by']}")
        out[name] = dict(max_abs_err=err[name], ms=ms, graph_ms=graph_ms,
                         plain_ms=plain_ms, chain_steps=steps,
                         ns_step=1e6 * graph_ms / steps, **extra, **b)
    return out


def _last_writer_bytes(planes, side, u, covered, LG: int) -> int:
    """The deposit bytes the planes kernel needs from one direction: at
    each covered local column u [B, L_t] the cell of the highest segment
    whose clamped window holds it, if that segment is ok (9 bytes; 8 below
    its lead, where GAP stands in for val0).  A non-ok segment's empties,
    and a column no segment holds, need no deposit cell."""
    import torch

    toff, ok, lead = side[:3]
    LP = planes[0].shape[2]
    start = toff.long().clamp(0, LG - LP)
    owner = torch.full_like(u, -1)
    col = torch.zeros_like(u)
    for g in range(toff.shape[0]):
        c = u - start[g][:, None]
        hit = covered & (c >= 0) & (c < LP)
        owner = torch.where(hit, g, owner)
        col = torch.where(hit, c, col)
    at = owner.clamp(min=0)
    kept = (owner >= 0) & ok.t().gather(1, at)
    below = col < lead.t().long().gather(1, at)
    return int(torch.where(kept, torch.where(below, 8, 9), 0).sum())


def fold_bound(plane_args, fold_args, planes, L_t: int, S: int) -> dict:
    """The bound of each tag-fold kernel on these inputs, with the bytes
    this data needs.  Planes: the deposit cells that are the last writer of
    an output column in an ok segment (_last_writer_bytes; the side-band
    entries read the same cells), the side arrays once, and its three
    planes written (9 bytes a cell of [B, L_t]).  Fold: pair_ok of every
    pair and the four other pair arrays of a kept one; g0 and gcnt of the
    live cells (pair_ok, column < tlen), gpack where gcnt > 0; a 4-byte
    read-modify-write of each present cell of counts and each cov_diff
    cell a span ends on.  Operations as FOLD_OPS counts them, the fold's
    on the live cells."""
    import torch

    planes_r, planes_l, side_r, side_l, lj_end, tseed = plane_args
    B = planes[0].shape[0]
    LG = L_t + planes_r[0].shape[2] + S
    G2 = planes_r[0].shape[0] + planes_l[0].shape[0]
    side_bytes = sum(t.numel() * t.element_size()
                     for t in (*side_r, *side_l, lj_end, tseed))
    l_idx = torch.arange(L_t, device=tseed.device)[None, :]
    # the placements, as the kernel clamps them: right over left, the left
    # flipped
    ts = tseed.long()[:, None]
    r = LG + l_idx - (LG + ts).clamp(0, LG + L_t)
    lf = LG + l_idx - ts.clamp(0, LG + L_t)
    in_r = (r >= 0) & (r < LG)
    in_l = ~in_r & (lf >= 0) & (lf < LG)
    deposit_bytes = (_last_writer_bytes(planes_r, side_r, r, in_r, LG)
                     + _last_writer_bytes(planes_l, side_l, LG - 1 - lf,
                                          in_l, LG))
    planes_b = card_bound(
        deposit_bytes + side_bytes + 9 * B * L_t,
        B * L_t * FOLD_OPS["planes_col"] + G2 * B * FOLD_OPS["planes_entry"])
    counts, cov, tlen, t_slot, pair_ok, tbeg, tend = fold_args
    g0, gp, gc = planes
    live = pair_ok[:, None] & (l_idx < tlen[:, None])
    n_live = int(live.sum())
    base = (t_slot.long()[:, None] * L_t + l_idx) * (counts[0, 0].numel())
    cells = [torch.where(live & (g0 >= 0) & (g0 <= 4), base + g0.long(), -1)]
    for d in range(1, 16):
        based = ((gp >> (2 * (d - 1))) & 3).long()
        cells.append(torch.where(live & (gc >= d), base + 5 * d + based, -1))
    cells = torch.stack(cells).reshape(-1)
    cells = cells[cells >= 0]
    adds = int(cells.numel())
    n_cells = int(torch.unique(cells).numel())
    a = tbeg.clamp(0, L_t).long()
    e = torch.minimum(tend, tlen).clamp(0, L_t).long()
    span = pair_ok & (e > a)
    ends = torch.cat([t_slot.long()[span] * (L_t + 1) + a[span],
                      t_slot.long()[span] * (L_t + 1) + e[span]])
    n_cov = int(torch.unique(ends).numel())
    reads = (B + 16 * int(pair_ok.sum()) + 5 * n_live
             + 4 * int((live & (gc > 0)).sum()))
    fold_b = card_bound(
        reads + 8 * (n_cells + n_cov),
        n_live * FOLD_OPS["fold_col"] + adds * FOLD_OPS["fold_add"])
    # the sector floor: the card moves 32-byte sectors, so each distinct
    # sector of counts and cov_diff that a present cell or a span's end
    # lies in is read once and written once (8 int32 a sector; torch's
    # allocations start on a sector)
    sectors = (int(torch.unique(cells // 8).numel())
               + int(torch.unique(ends // 8).numel()))
    sector_ms = 1e3 * (reads + 64 * sectors) / HBM_BYTES_PER_S
    return {"global_planes": dict(planes_b, deposit_bytes=deposit_bytes),
            "fold_tags": dict(fold_b, present_cells=n_cells, adds=adds,
                              live_cells=n_live, sectors=sectors,
                              sector_ms=sector_ms)}


def check_fold(err: dict, plane_args, fold_args, S: int, W: int, L_t: int,
               what: str):
    """Both tag-fold kernels against their plain versions on these inputs,
    every element: the planes, then counts and cov_diff after the fold
    (from the same starting tables).  Updates the largest difference in
    ``err``; returns the kernel's planes (contiguous, equal to the plain
    version's)."""
    import torch

    from mecat_tpu_torch.ops import consensus_banded as cb

    got = cb.global_planes(*plane_args, L_t=L_t, S=S, W=W)
    want = cb.banded_global_planes_plain(*plane_args, L_t=L_t, S=S, W=W)
    counts, cov = fold_args[0].clone(), fold_args[1].clone()
    cb.fold_tags(counts, cov, *got, *fold_args[2:], L_t)
    want_c, want_v = fold_args[0].clone(), fold_args[1].clone()
    cb.fold_tags_plain(want_c, want_v, *want, *fold_args[2:], L_t)
    torch.cuda.synchronize()
    for name, pairs in (("global_planes", zip(got, want)),
                        ("fold_tags", ((counts, want_c), (cov, want_v)))):
        for g, w in pairs:
            err[name] = max(err[name], int((g.long() - w.long()).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(
                    f"{name} kernel != plain at S={S} W={W} on {what}: "
                    f"{int((g != w).sum())} elements differ")
    return got


def planes_probe(err: dict, plane_args, fold_args, L_t: int, S: int,
                 W: int) -> dict:
    """What holds the planes kernel back at the cns chunk, read from outside
    the kernel (no counter tool works on the card), each a graph ms: the
    kernel on the chunk's first 16, 32, 64 and all of its pairs (a kernel
    bound by bytes takes time in proportion to them); on the chunk with
    every segment's ok cleared, so that no deposit cell is read (the
    segments are still listed and every element written; held against the
    plain version, every element); and one uint8 ``copy_`` that moves the
    chunk's bound bytes, half read and half written (what one launch takes
    to stream them on this card).  Returns those numbers."""
    import torch

    from mecat_tpu_torch.ops import walk_kernel as wk

    planes_r, planes_l, side_r, side_l, lj_end, tseed = plane_args
    B = tseed.shape[0]

    def first(n):
        cut = lambda ts, dim: tuple(t.narrow(dim, 0, n).contiguous()
                                    for t in ts)
        return [cut(planes_r, 1), cut(planes_l, 1), cut(side_r, 1),
                cut(side_l, 1), *cut((lj_end,), 1), *cut((tseed,), 0)]

    by_pairs = {}
    for n in (16, 32, 64, B):
        args = first(n)
        by_pairs[n] = cuda_graph_ms(lambda: wk.global_planes_cuda(
            *args, L_t=L_t, S=S, W=W))
    no_ok = lambda side: (side[0], torch.zeros_like(side[1]), *side[2:])
    bare = [planes_r, planes_l, no_ok(side_r), no_ok(side_l), lj_end, tseed]
    check_fold(err, bare, fold_args, S, W, L_t, "the cns chunk, no segment ok")
    got = wk.global_planes_cuda(*bare, L_t=L_t, S=S, W=W)
    bare_bound = fold_bound(bare, fold_args, got, L_t, S)["global_planes"]
    bare_ms = cuda_graph_ms(lambda: wk.global_planes_cuda(
        *bare, L_t=L_t, S=S, W=W))
    n_bytes = int(fold_bound(plane_args, fold_args, got, L_t, S)[
        "global_planes"]["bound_ms"] * HBM_BYTES_PER_S / 1e3)
    src = torch.ones(n_bytes // 2, dtype=torch.uint8, device=tseed.device)
    dst = torch.empty_like(src)
    copy_ms = cuda_graph_ms(lambda: dst.copy_(src))
    say(f"phase 2: global_planes probe at the cns chunk, graph ms: "
        + ", ".join(f"{n} pairs {ms:.4f}" for n, ms in by_pairs.items())
        + f"; no deposit cell read {bare_ms:.4f} (bound "
        f"{bare_bound['bound_ms']:.4f} by {bare_bound['bound_by']}); a "
        f"copy_ of the bound's {n_bytes} bytes {copy_ms:.4f}")
    return {"graph_ms_by_pairs": by_pairs, "no_loads_graph_ms": bare_ms,
            "no_loads_bound_ms": bare_bound["bound_ms"],
            "copy_bytes": n_bytes, "copy_graph_ms": copy_ms}


def phase_fold(S: int, W: int) -> dict:
    """The tag fold's two kernels (``csrc/cns_fold.cu``) against their plain
    versions at the cns cell's shape, every element: on the row walks of
    ``testing.extend_inputs`` pairs of FOLD_L_T bases as a cns chunk hands
    them over, 128 pairs on 16 slots (a cns chunk), the same pairs on 4
    slots (a deep pile) and 64 pairs (a polish chunk), and on the edge
    pairs of ``testing.fold_inputs`` (also with 40 and 36 segments, more
    than a warp's lanes).  Then each wrapper alone at each
    chunk of FOLD_CHUNKS: ms of one launch from the host and replayed from
    a CUDA graph, the bound, and for the fold the sector floor; at the cns
    chunk also the plain version's ms and, for the fold, the ms of one
    ``index_add_`` of the int32 presence buffer into counts (the PyTorch
    call that computes the fold), and ``planes_probe``.  Returns {kernel:
    numbers at the cns chunk, with ``chunks``: {chunk: numbers}; the
    planes' with ``probe``}."""
    import torch

    from mecat_tpu_torch.ops import consensus_banded as cb
    from mecat_tpu_torch.ops import walk_kernel as wk
    from mecat_tpu_torch.testing import fold_case

    dev = torch.device("cuda")
    err = dict.fromkeys(FOLD_REPLACES, 0)
    cases = {}
    for B, source, L_t in ((128, "path", FOLD_L_T), (64, "path", FOLD_L_T),
                           (128, "edge", 4096)):
        cases[(B, source)] = (*fold_case(dev, S, W, L_t, source, B=B,
                                         seed=191 + B), L_t)
    # more segments a direction than a warp has lanes
    cases["segments"] = (*fold_case(dev, S, W, 3000, "edge", B=64, seed=193,
                                    segs=(40, 36)), 3000)
    # the cns chunk's pairs on 4 slots
    plane_args, fold_args, L_t = cases[(128, "path")]
    slot = torch.as_tensor(np.random.default_rng(5).integers(
        0, 4, 128).astype(np.int32), device=dev)
    cases["deep"] = (plane_args, [
        torch.zeros((4, *fold_args[0].shape[1:]), dtype=torch.int32,
                    device=dev),
        torch.zeros((4, L_t + 1), dtype=torch.int32, device=dev),
        fold_args[2], slot, *fold_args[4:]], L_t)
    wants = {}
    for key, (plane_args, fold_args, L_t) in cases.items():
        wants[key] = check_fold(err, plane_args, fold_args, S, W, L_t,
                                f"{key} inputs")
        say(f"phase 2: tag fold kernels == plain at S={S} W={W}, {key} "
            f"inputs, L_t {L_t}, {plane_args[0][0].shape[0]} / "
            f"{plane_args[1][0].shape[0]} segments, "
            f"{fold_args[0].shape[0]} slots: planes (g0, gpack, gcnt) and "
            f"the fold (counts, cov_diff; {int(fold_args[4].sum())} pairs "
            f"kept): every element equal")
    out = {name: {"chunks": {}} for name in FOLD_REPLACES}
    for chunk, key in FOLD_CHUNKS.items():
        plane_args, fold_args, L_t = cases[key]
        want = wants[key]
        bounds = fold_bound(plane_args, fold_args, want, L_t, S)
        counts, cov = fold_args[0].clone(), fold_args[1].clone()
        small = [t.contiguous() for t in fold_args[2:]]
        runs = {"fold_tags": lambda: wk.fold_tags_cuda(
            counts, cov, *want, *small, L_t)}
        if chunk != "deep":         # the deep pile's planes are the cns's
            runs["global_planes"] = lambda: wk.global_planes_cuda(
                *plane_args, L_t=L_t, S=S, W=W)
        for name, fn in runs.items():
            b = bounds[name]
            num = dict(ms=cuda_median_ms(fn, 21), graph_ms=cuda_graph_ms(fn),
                       **b)
            out[name]["chunks"][chunk] = num
            say(f"phase 2: {name} kernel alone at S={S} W={W}, {chunk} "
                f"chunk ({want[0].shape[0]} pairs on "
                f"{fold_args[0].shape[0]} slots), L_t {L_t}: one launch "
                f"from the host {num['ms']:.4f} ms, replayed from a CUDA "
                f"graph {num['graph_ms']:.4f} ms; bound "
                f"{b['bound_ms']:.4f} ms by {b['bound_by']} "
                f"({100 * b['bound_ms'] / num['graph_ms']:.1f} % of the "
                f"graph time)"
                + (f"; sector floor {b['sector_ms']:.4f} ms "
                   f"({100 * b['sector_ms'] / num['graph_ms']:.1f} %; "
                   f"{b['sectors']} sectors, {b['live_cells']} live cells, "
                   f"{b['present_cells']} present cells, {b['adds']} adds)"
                   if "adds" in b
                   else f" ({b['deposit_bytes']} bytes of deposit cells "
                        f"read)"))
    plane_args, fold_args, L_t = cases[FOLD_CHUNKS["cns"]]
    want = wants[FOLD_CHUNKS["cns"]]
    out["global_planes"]["probe"] = planes_probe(err, plane_args, fold_args,
                                                 L_t, S, W)
    counts, cov = fold_args[0].clone(), fold_args[1].clone()
    T = counts.shape[0]
    pres = cb.banded_presence(*want, fold_args[2], fold_args[4], L_t).view(
        want[0].shape[0], -1).to(torch.int32)
    slot = fold_args[3].long()
    plain = {
        "global_planes": (lambda: cb.banded_global_planes_plain(
            *plane_args, L_t=L_t, S=S, W=W), None),
        "fold_tags": (
            lambda: cb.fold_tags_plain(counts, cov, *want, *fold_args[2:],
                                       L_t),
            lambda: counts.view(T, -1).index_add_(0, slot, pres)),
    }
    for name, (fn, library) in plain.items():
        plain_ms = cuda_median_ms(fn, 3)
        library_ms = cuda_median_ms(library, 21) if library else None
        say(f"phase 2: {name} at the cns chunk: plain {plain_ms:.2f} ms; "
            + (f"index_add_ of the presence buffer {library_ms:.4f} ms"
               if library else "no PyTorch call computes it"))
        out[name].update(out[name]["chunks"]["cns"], max_abs_err=err[name],
                         plain_ms=plain_ms, library_ms=library_ms)
    return out


def cns_chunk_rows(dev, S: int, W: int, B: int = 128, seed: int = 191):
    """The row walks of a cns chunk at (S, W), as the chunk hands them to
    the tag fold: ``ops.align.extend_pair_batch_rows`` of B
    ``testing.extend_inputs`` pairs of FOLD_L_T bases (FOLD_L_T // S + 2
    segments a direction), and the fold's arguments after them: (right
    rows, left rows, q, qseed, tseed, pair arrays as ``fold_case``)."""
    import torch

    from mecat_tpu_torch import constants as C
    from mecat_tpu_torch.ops.align import extend_pair_batch_rows
    from mecat_tpu_torch.testing import extend_inputs

    on = lambda a: torch.as_tensor(np.array(a), device=dev)
    q, t, qlen, tlen, qs, ts = (on(a) for a in extend_inputs(B, FOLD_L_T, S,
                                                             seed))
    G = FOLD_L_T // S + 2
    pa, rr, lr = extend_pair_batch_rows(q, t, qlen, tlen, qs, ts, S=S, W=W,
                                        max_segs=G, max_segs_left=G)
    T = 16
    slot = on(np.random.default_rng(seed).integers(0, T, B).astype(np.int32))
    pair_ok = (pa.identity >= 60.0) & ((pa.tend - pa.tbeg) >= 20)
    counts = torch.zeros((T, FOLD_L_T, C.MAX_INS_DELTA + 1, 5),
                         dtype=torch.int32, device=dev)
    cov = torch.zeros((T, FOLD_L_T + 1), dtype=torch.int32, device=dev)
    return rr, lr, q, qs, ts, [counts, cov, tlen, slot, pair_ok, pa.tbeg,
                               pa.tend]


def phase_deposit_chunks(S: int, W: int, work: str) -> dict:
    """The deposit kernel with its row information against the plain
    composition (``direction_rowinfo`` twice, then ``deposit_scan_plain``),
    every element of the planes, the side arrays and j_end: on the row
    walks of the 128-pair cns chunk at (S, W) and on every chunk of a
    ``run_cns`` of ``testing.cns_pile``'s correction pile (golden options,
    S 128, W 64), whose chunks each launch it once.  Returns {what: lanes
    checked}."""
    import torch

    from mecat_tpu_torch.ops import consensus_banded as cb
    from mecat_tpu_torch.ops import walk_kernel as wk
    from mecat_tpu_torch.pipeline.cns import CnsOptions, run_cns
    from mecat_tpu_torch.testing import PILE_CNS, cns_pile

    dev = torch.device("cuda")
    checked = {}
    kernel = cb.plane_inputs

    def check(args, what):
        got = flat(kernel(*args))
        want = flat(cb.plane_inputs_plain(*args))
        torch.cuda.synchronize()
        for k, (g, w) in enumerate(zip(got, want)):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"deposit kernel != plain on {what}: output {k}, "
                    f"{int((g != w).sum())} elements differ")
        checked[what] = checked.get(what, 0) + got[0].shape[0] * got[
            0].shape[1] + got[3].shape[0] * got[3].shape[1]

    rr, lr, q, qs = cns_chunk_rows(dev, S, W)[:4]
    check((rr, lr, q, qs, S, W), f"the cns chunk at ({S}, {W})")
    d = os.path.join(work, "deposit_pile")
    os.makedirs(d)
    _, reads, cand = cns_pile(d, device="cuda")
    chunks = []

    def checked_plane_inputs(*a):
        check(a, "the cns pile's chunks")
        chunks.append(1)
        return kernel(*a)

    before = wk.launches()
    cb.plane_inputs = checked_plane_inputs
    try:
        run_cns(cand, reads, os.path.join(d, "out.fasta"),
                CnsOptions(**PILE_CNS), device="cuda")
    finally:
        cb.plane_inputs = kernel
    launched = wk.launches_since(before)["walk_launches_deposit"]
    if not chunks or launched != 2 * len(chunks):
        raise AssertionError(f"the pile's {len(chunks)} chunks launched the "
                             f"deposit {launched} times (once a chunk and "
                             f"once a check expected)")
    say(f"phase 2: deposit kernel == plain composition (row information and "
        f"deposit: planes, side arrays, j_end) on every element: "
        + ", ".join(f"{w} ({n} lanes)" for w, n in checked.items())
        + f"; {len(chunks)} pile chunks, one deposit launch each")
    return checked


def phase_tag_fold_host(S: int, W: int) -> dict:
    """The host's side of the tag fold at the cns chunk (128 pairs, S, W):
    ``plane_inputs`` alone, ms of one call from the host between two
    events and of a call replayed from a CUDA graph (median of 21 and of 7
    replays of 20), the whole ``banded_accumulate_tags`` (the ``cns.tags``
    span) from the host, and inside one ``banded_accumulate_tags`` the
    torch ops dispatched (a dispatch mode counts every aten call) and the
    device operations launched (kernels, copies and memsets in a
    ``torch.profiler`` trace; None where the trace shows no device
    activity).  Uses only names the tree has had since the tag fold's
    kernels came, so one tree's package can be timed against another's in
    turns."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    from mecat_tpu_torch.ops import consensus_banded as cb

    dev = torch.device("cuda")
    rr, lr, q, qs, ts, fold = cns_chunk_rows(dev, S, W)
    tags = lambda: cb.banded_accumulate_tags(
        fold[0], fold[1], rr, lr, qs, ts, q, *fold[2:], L_t=FOLD_L_T, S=S,
        W=W)
    rows = lambda: cb.plane_inputs(rr, lr, q, qs, S, W)

    class Dispatched(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Dispatched.ops += 1
            return func(*args, **(kwargs or {}))

    tags()
    torch.cuda.synchronize()
    with Dispatched():
        tags()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tags()
        torch.cuda.synchronize()
    device_ops = sum(1 for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    try:
        graph_ms = cuda_graph_ms(rows)
    except RuntimeError as e:            # a tree whose ops cannot be captured
        say(f"phase 2: plane_inputs not captured in a CUDA graph: {e}")
        graph_ms = None
    out = dict(pairs=int(q.shape[0]), segments=[int(rr[0].shape[0]),
                                                int(lr[0].shape[0])],
               torch_ops=Dispatched.ops, device_ops=device_ops or None,
               rows_ms=cuda_median_ms(rows, 21), rows_graph_ms=graph_ms,
               tags_ms=cuda_median_ms(tags, 21))
    say(f"phase 2: tag fold at the cns chunk ({out['pairs']} pairs, "
        f"{out['segments'][0]} / {out['segments'][1]} segments, S={S} "
        f"W={W}): plane_inputs from the host {out['rows_ms']:.4f} ms, "
        f"replayed from a CUDA graph {out['rows_graph_ms']} ms; "
        f"banded_accumulate_tags from the host {out['tags_ms']:.4f} ms, "
        f"{out['torch_ops']} torch ops dispatched and "
        f"{out['device_ops']} device operations launched inside one")
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
    n_bytes = ROLL_LANES * (S + S + W + 4 + 4 + 32)
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
        b = card_bound(n_bytes, cells * ROLL_OPS_PER_CELL[name])
        say(f"phase 2: roll_micro {name} == plain at S={S} W={W} "
            f"lanes={ROLL_LANES} (all 8 rows): kernel {ms:.4f} ms = "
            f"{cells / ms / 1e6:.2f} Gcells/s, plain {plain_ms:.4f} ms "
            f"(median), bound {b['bound_ms']:.4f} ms by {b['bound_by']}")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         gcells_s=cells / ms / 1e6, **b)
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


def phase_golden(work: str) -> dict:
    """Golden bytes on the card: the staged pw route (the golden files are
    its; -j 1 on cuda takes the fused route unless asked) and the cns run,
    whose DP must go through the move loop.  Returns the cns run's DP
    launches."""
    from mecat_tpu_torch.ops import dp_kernel
    from mecat_tpu_torch.pipeline.pw import PwOptions, run_pw
    from mecat_tpu_torch.testing import GOLDEN_J0, GOLDEN_J1

    golden = os.path.join(ROOT, "tests", "golden")
    reads = os.path.join(golden, "reads.fasta")
    for name, opts, want in (("-j 1", GOLDEN_J1, "overlaps.m4"),
                             ("-j 0", GOLDEN_J0, "candidates.txt")):
        out = os.path.join(work, want)
        t0 = time.time()
        run_pw(reads, out, os.path.join(work, "w" + want), PwOptions(**opts),
               device="cuda", route="staged")
        with open(out, "rb") as fh, \
                open(os.path.join(golden, want), "rb") as gh:
            if fh.read() != gh.read():
                raise AssertionError(f"golden {want} differs on the card")
        say(f"phase 3: golden {name} byte-equal on the card "
            f"({time.time() - t0:.2f} s)")

    from mecat_tpu_torch.pipeline.cns import CnsOptions, run_cns
    from mecat_tpu_torch.testing import GOLDEN_CNS

    from mecat_tpu_torch.ops import walk_kernel

    out = os.path.join(work, "corrected.fasta")
    t0 = time.time()
    before = dp_kernel.launches(), walk_kernel.launches()
    run_cns(os.path.join(golden, "candidates.txt"), reads, out,
            CnsOptions(**GOLDEN_CNS), device="cuda")
    launches = dp_launches_of(dp_kernel.launches_since(before[0]))
    walks = need_walks("the golden cns run",
                       walk_kernel.launches_since(before[1]))
    with open(out, "rb") as fh, \
            open(os.path.join(golden, "corrected.fasta"), "rb") as gh:
        if fh.read() != gh.read():
            raise AssertionError("golden corrected.fasta differs on the card")
    need_moves_loop("the golden cns run", launches)
    say(f"phase 3: golden corrected.fasta (mecat2cns -i 0) byte-equal on the "
        f"card ({time.time() - t0:.2f} s; DP launches {launches}, walk "
        f"launches {walks})")
    return dict(launches, walks=walks)


def phase_golden_wide(work: str, band: int = WIDE_BAND,
                      queries: int | None = None) -> dict:
    """The golden pile through the cns CLI at ``--align-band`` ``band``, on
    the card and on the CPU (each a process of its own): byte-equal
    corrected reads; the CUDA run must take the move loop and both
    correction walks.  ``queries``: only the candidate lines of the pile's
    first ``queries`` query reads (in file order), whose supports then
    correct those reads.  Returns its walk and DP launches."""
    golden = os.path.join(ROOT, "tests", "golden")
    candidates = os.path.join(golden, "candidates.txt")
    what = "the golden pile"
    if queries is not None:
        with open(candidates) as fh:
            lines = fh.read().splitlines(keepends=True)
        first = list(dict.fromkeys(ln.split()[0] for ln in lines))[:queries]
        kept = [ln for ln in lines if ln.split()[0] in first]
        candidates = os.path.join(work, f"candidates_w{band}.txt")
        with open(candidates, "w") as fh:
            fh.writelines(kept)
        what = (f"the golden pile's candidates of its first {queries} query "
                f"reads ({len(kept)} of {len(lines)} lines)")
    outs, summaries = {}, {}
    for device in ("cuda", "cpu"):
        outs[device] = os.path.join(work, f"corrected_w{band}_{device}"
                                          ".fasta")
        wall, summaries[device] = run_cli(
            "mecat2cns", ["-i", "0", "-a", "300", "-l", "500",
                          "--extend-batch", "32", "--align-band",
                          str(band), "--device", device, candidates,
                          os.path.join(golden, "reads.fasta"),
                          outs[device]], "cns")
        say(f"phase 3: CLI mecat2cns --align-band {band} --device "
            f"{device} on {what}: exit 0, "
            f"{summaries[device].get('corrected_reads')} corrected reads, "
            f"wall {wall:.2f} s")
    with open(outs["cuda"], "rb") as fh, open(outs["cpu"], "rb") as gh:
        cuda_bytes, cpu_bytes = fh.read(), gh.read()
    if not cuda_bytes or cuda_bytes != cpu_bytes:
        raise AssertionError(f"mecat2cns --align-band {band}: the card's "
                             "corrected reads differ from the CPU's (or are "
                             "empty)")
    launches = dp_launches_of(summaries["cuda"])
    need_moves_loop(f"the cns CLI at W={band}", launches)
    walks = need_walks(f"the cns CLI at W={band}", summaries["cuda"])
    say(f"phase 3: W={band}: {len(cuda_bytes)} bytes of corrected reads, "
        f"CUDA == CPU; DP launches {launches}, walk launches {walks}"
        + (" (at this band every DP launch takes the cluster route)"
           if band > BLOCK_BAND else ""))
    return dict(walks=walks, launches=launches)


def phase_golden_cluster(work: str) -> dict:
    """Phase 3's CLI run at ``--align-band`` CLUSTER_BAND, where a DP lane
    is a thread-block cluster.  The CPU side of a run at this band does 32x
    the cells of one at 128, and the whole pile took 64 s on the card's
    host at 384, so it runs on the candidates of the pile's first two query
    reads (24 lines): two corrected reads, about 25 s on the CPU."""
    return phase_golden_wide(work, CLUSTER_BAND, queries=2)


def bench_reads():
    from mecat_tpu_torch.utils.sim import random_genome, simulate_reads

    n_reads = int(GENOME * COVERAGE / MEAN_LEN)
    n_reads -= n_reads % B or B
    genome = random_genome(GENOME, seed=91)
    db, truths = simulate_reads(genome, n_reads, mean_len=MEAN_LEN,
                                min_len=2000, seed=92, error_rate=0.12)
    return db, truths, genome


def steady_pass(batches, table, overlap_step):
    """One pass of ``overlap_step`` over every batch; returns (seconds,
    overlaps, useful lane-segments, overlaps of each batch), timed on the
    host up to a sync."""
    import torch

    t0 = time.time()
    valid, segs = [], []
    for a in batches:
        o = overlap_step(*a, *table, **CFG)
        valid.append(o.valid.sum())
        segs.append(o.n_segs.sum())
    per_batch = tuple(torch.stack(valid).tolist())
    useful_segs = int(torch.stack(segs).sum())
    return time.time() - t0, sum(per_batch), useful_segs, per_batch


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
        wall = steady_pass(batches, table, overlap_step)[0]
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

    zero_dp_counts()                     # the main path's run starts here
    runs = [steady_pass(batches, table, overlap_step) for _ in range(passes)]
    launches = dp_kernel.launches()      # ... and ends here
    need_loop("the bench passes", launches["dp_launches_extend"],
              launches["dp_launches"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if len({r[1:] for r in runs}) != 1:
        raise AssertionError(f"passes disagree: {runs}")
    _, overlaps, useful_segs, per_batch = runs[0]
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
        f"lane-segments, {launches['dp_launches_extend'] // passes} "
        f"segment-loop kernel launches (per-segment counts kernel "
        f"{launches['dp_launches'] // passes}); median pass "
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
    say("phase 4: batch 0 OverlapStepOut of the segment-loop kernel equal "
        "to the plain-version overlap_step (host loop, plain DP) on the card "
        "(every field)")
    return dict(launches=launches, per_batch=per_batch,
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

        from mecat_tpu_torch.assembly import ctgcns
        from mecat_tpu_torch.ops import align, consensus_banded
        from mecat_tpu_torch.pipeline import cns

        self.sync = torch.cuda.synchronize
        self.seconds: dict = {}
        self.calls: dict = {}
        self.sites = [(align, "traceback_rows", "row walk"),
                      (align, "_extend_direction_impl", "segment loop + DP"),
                      (align, "_extend_both_with_moves",
                       "move loop + DP (both directions, cut to G)"),
                      (consensus_banded, "plane_inputs",
                       "deposit (row information inside)"),
                      (consensus_banded, "banded_global_planes",
                       "global planes (deposit + planes kernel)"),
                      (consensus_banded, "global_planes", "planes kernel"),
                      (consensus_banded, "fold_tags", "fold kernel"),
                      (cns, "banded_accumulate_tags",
                       "tag fold total (deposit + planes + fold)"),
                      (cns, "call_tables", "vote"),
                      (ctgcns, "call_tables", "vote"),
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
    from mecat_tpu_torch.ops import dp_kernel, walk_kernel
    from mecat_tpu_torch.ops.align import dp_segment_best_plain
    from mecat_tpu_torch.pipeline import cns as cns_module
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
    chunks = []
    tags = cns_module.banded_accumulate_tags

    def counted_tags(*a, **kw):
        chunks.append(1)
        return tags(*a, **kw)

    cns_module.banded_accumulate_tags = counted_tags
    zero_dp_counts()                     # the main path's run starts here
    zero_walk_counts()
    try:
        out, stats, dt = one_pass(templates)
    finally:
        cns_module.banded_accumulate_tags = tags
    launches = dp_launches_of(dp_kernel.launches())  # ... and ends here
    walks = need_walks("the cns pass", walk_kernel.launches())
    if walks["deposit"] != len(chunks):
        raise AssertionError(f"the cns pass ran {len(chunks)} chunks and "
                             f"{walks['deposit']} deposit launches")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    need_moves_loop("the cns pass", launches)
    if launches["counts"] or launches["extend"]:
        raise AssertionError(f"the cns pass launched a counts kernel: "
                             f"{launches}")
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
        f"bases, {stats.table_slices} table slices, {len(chunks)} chunks, "
        f"DP launches {launches}, walk launches {walks} (one deposit a "
        f"chunk), peak device memory {peak_gb:.3f} GB")
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
    return dict(launches=launches, walks=walks, templates=templates,
                opts=opts,
                round1=dict(seconds=dt, stats=stats, peak_gb=peak_gb))


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


def run_cli_summaries(module: str, argv: list):
    """Run one of the port's CLIs as a subprocess; returns (wall seconds,
    every metrics summary record it printed, in order).  Raises unless it
    exits 0."""
    cmd = [sys.executable, "-m", f"mecat_tpu_torch.cli.{module}", *argv]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"CLI {module} exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    records = [json.loads(line) for line in proc.stderr.splitlines()
               if line.startswith("{")]
    return wall, [r for r in records if r.get("event") == "summary"]


def run_cli(module: str, argv: list, component: str):
    """Run one of the port's CLIs as a subprocess; returns (wall seconds,
    its metrics summary record).  Raises unless it exits 0 with a summary."""
    wall, summaries = run_cli_summaries(module, argv)
    mine = [r for r in summaries if r.get("component") == component]
    if not mine:
        raise AssertionError(f"CLI {module} printed no metrics summary")
    return wall, mine[-1]


def count_lines(path: str, prefix: str = "") -> int:
    with open(path) as fh:
        return sum(1 for line in fh if line.strip()
                   and line.startswith(prefix))


def phase_cli(reads: str, n_reads: int, work: str) -> dict:
    out = os.path.join(work, "bench.m4")
    wall, summary = run_cli(
        "mecat2pw", ["-j", "1", "-d", reads, "-o", out, "-w",
                     os.path.join(work, "wrk"), "-n", "16", "-a", "1000",
                     "--route", "staged"],
        "pw")
    n_rec = count_lines(out)
    if summary.get("route") != "staged":
        raise AssertionError(f"--route staged ran {summary.get('route')!r}")
    say(f"phase 5: CLI mecat2pw -j 1 -n 16 -a 1000 --route staged on "
        f"{n_reads} reads: "
        f"exit 0, {n_rec} M4 records, wall {wall:.2f} s, of which outside "
        f"run_pw (process start, imports, CUDA set-up) "
        f"{wall - summary.get('seconds', 0.0):.2f} s")
    keys = ("seconds", "index_build_seconds", "volume_pair_seconds",
            "staged_prep_s", "staged_pull_s", "staged_extend_s",
            "candidates", "overlaps", "dp_gcells_per_s",
            "dp_gcells_per_s_useful", "dp_launches", "dp_launches_extend")
    say("phase 5: CLI summary " + json.dumps(
        {k: summary[k] for k in keys if k in summary}))
    if n_rec <= 0:
        raise AssertionError("CLI wrote no overlaps")
    need_loop("the pw CLI", summary.get("dp_launches_extend", 0),
              summary.get("dp_launches", 0))
    return dict(records=n_rec, wall=wall, summary=summary)


def phase_cli_cns(reads: str, n_reads: int, work: str) -> dict:
    """``reads``: the depth cut of the bench reads (see the module text).
    Returns the cns CLI's walk and DP launches."""
    cand = os.path.join(work, "bench_cand.txt")
    pw_wall, pw = run_cli(
        "mecat2pw", ["-j", "0", "-d", reads, "-o", cand, "-w",
                     os.path.join(work, "wrk0"), "-n", "16"], "pw")
    n_cand = count_lines(cand)
    say(f"phase 7: CLI mecat2pw -j 0 -n 16 on {n_reads} reads (cut: the "
        f"bench reads that start in the first quarter of the genome): exit 0, "
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
    launches = dp_launches_of(summary)
    need_moves_loop("the cns CLI", launches)
    return dict(walks=need_walks("the cns CLI", summary), launches=launches)


def small_mapping_case(work: str):
    """Phase 8's files: a 30 kb + 20 kb reference and 21 reads (20
    simulated at 8 % error, one junk).  Returns (reference, reads, read
    count)."""
    from mecat_tpu_torch.io.fasta import write_fasta
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
    return ref, reads, len(seqs)


def phase_ref_small(work: str) -> dict:
    """Mapping exactness on the card: CUDA and CPU runs give the same
    bytes.  Returns the launches of the two DP kernels on the CUDA SAM
    run."""
    from mecat_tpu_torch.ops import dp_kernel, walk_kernel
    from mecat_tpu_torch.pipeline.ref import RefOptions, run_ref

    ref, reads, n_seqs = small_mapping_case(work)
    launches = {}
    for fmt in ("sam", "m4"):
        outs = {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(work, f"small_{dev}.{fmt}")
            if (fmt, dev) == ("sam", "cuda"):
                zero_dp_counts()
                zero_walk_counts()
            t0 = time.time()
            stats = run_ref(reads, ref, out,
                            os.path.join(work, f"small_w_{dev}_{fmt}"),
                            RefOptions(output_format=fmt, **REF_SMALL),
                            device=dev)
            dt = time.time() - t0
            if (fmt, dev) == ("sam", "cuda"):
                launches = dict(dp_launches_of(dp_kernel.launches()),
                                walks=need_walks("the CUDA SAM run",
                                                 walk_kernel.launches(),
                                                 ("cols",)))
            with open(out, "rb") as fh:
                outs[dev] = fh.read()
            if stats.mapped != n_seqs - 1:
                raise AssertionError(f"small mapping ({fmt}, {dev}): "
                                     f"{stats.mapped} of {n_seqs} mapped")
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
    need_loop("the CUDA SAM run", launches["extend"], launches["counts"])
    need_moves_loop("the CUDA SAM run", launches)
    say(f"phase 8: SAM and M4 output byte-equal between cuda and cpu, junk "
        f"read FLAG 4, DP launches on the CUDA SAM run: {launches}")
    return launches


def phase_ref_wide(work: str, band: int = REF_WIDE_BAND) -> dict:
    """Phase 8's mapping at ``--align-band`` ``band``: REF_WIDE_BAND (a DP
    lane of two warps, walks of 16 lanes a block) or REF_CLUSTER_BAND (a DP
    lane of a cluster of two blocks, walks of 8 lanes a block).
    ``run_ref`` on cuda and on cpu give byte-equal SAM; the CUDA run must
    launch the counts loop, the move loop and the column walk at that
    width, past BLOCK_BAND every DP launch on the cluster route.  Returns
    the CUDA run's launches, as phase_ref_small's, with those on the
    cluster route."""
    from mecat_tpu_torch.ops import dp_kernel, walk_kernel
    from mecat_tpu_torch.pipeline.ref import RefOptions, run_ref

    ref, reads, n_seqs = small_mapping_case(work)
    opts = RefOptions(output_format="sam",
                      **dict(REF_SMALL, align_band=band))
    outs, launches = {}, {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(work, f"wide{band}_{dev}.sam")
        if dev == "cuda":
            zero_dp_counts()
            zero_walk_counts()
        t0 = time.time()
        stats = run_ref(reads, ref, out,
                        os.path.join(work, f"wide{band}_w_{dev}"), opts,
                        device=dev)
        dt = time.time() - t0
        if dev == "cuda":
            launches = dict(dp_launches_of(dp_kernel.launches()),
                            cluster=dp_kernel.LAUNCHES_CLUSTER,
                            walks=need_walks("the wide CUDA SAM run",
                                             walk_kernel.launches(),
                                             ("cols",)))
        with open(out, "rb") as fh:
            outs[dev] = fh.read()
        if stats.mapped != n_seqs - 1:
            raise AssertionError(f"wide mapping ({dev}): {stats.mapped} of "
                                 f"{n_seqs} mapped")
        say(f"phase 8: run_ref sam at W={band} on {dev}: "
            f"{stats.mapped}/{stats.reads} mapped in {dt:.2f} s")
    if outs["cuda"] != outs["cpu"] or len(outs["cpu"]) < 200:
        raise AssertionError(f"wide mapping: SAM bytes differ between cuda "
                             f"and cpu at W={band}")
    need_loop("the wide CUDA SAM run", launches["extend"], launches["counts"])
    need_moves_loop("the wide CUDA SAM run", launches)
    dp_total = sum(launches[k] for k, _ in DP_KEYS)
    if launches["cluster"] != (dp_total if band > BLOCK_BAND else 0):
        raise AssertionError(f"wide mapping at W={band}: {launches['cluster']}"
                             f" of {dp_total} DP launches on the cluster "
                             "route")
    say(f"phase 8: SAM byte-equal between cuda and cpu at W={band} "
        f"({len(outs['cpu'])} bytes), launches on the CUDA run: {launches}")
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
    need_loop("the mapping CLI", summary.get("dp_launches_extend", 0),
              summary.get("dp_launches", 0))
    need_moves_loop("the mapping CLI's phase B", dp_launches_of(summary))
    need_walks("the mapping CLI", summary, ("cols",))
    if profile_path:
        profile_ref(reads, ref, work, profile_path)
    return summary


def phase_rounds_small(work: str) -> None:
    """Phase 10a: two correction rounds give the same bytes on the card and
    on the CPU."""
    from mecat_tpu_torch.ops import dp_kernel, walk_kernel
    from mecat_tpu_torch.pipeline.cns import CnsOptions, run_cns
    from mecat_tpu_torch.testing import PILE_CNS, cns_pile

    d = os.path.join(work, "pile")
    os.makedirs(d)
    _, reads, cand = cns_pile(d, device="cuda")
    got, secs, launches, walks = {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(d, f"rounds2_{dev}.fasta")
        before = dp_kernel.launches(), walk_kernel.launches()
        t0 = time.time()
        run_cns(cand, reads, out, CnsOptions(rounds=2, **PILE_CNS),
                device=dev)
        secs[dev] = time.time() - t0
        launches[dev] = dp_launches_of(dp_kernel.launches_since(before[0]))
        walks[dev] = walk_kernel.launches_since(before[1])
        with open(out, "rb") as fh:
            got[dev] = fh.read()
    if not got["cuda"] or got["cuda"] != got["cpu"]:
        raise AssertionError("rounds=2 corrected reads differ between cuda "
                             "and cpu (or none came out)")
    need_moves_loop("rounds=2 on cuda", launches["cuda"])
    if any(launches["cpu"].values()):
        raise AssertionError(f"rounds=2 on cpu launched {launches['cpu']}")
    walks["cuda"] = need_walks("rounds=2 on cuda", walks["cuda"])
    if any(walks["cpu"].values()):
        raise AssertionError(f"rounds=2 on cpu launched {walks['cpu']}")
    say(f"phase 10: run_cns rounds=2 on the 28-read pile: "
        f"{got['cuda'].count(b'>')} corrected reads, {len(got['cuda'])} "
        f"bytes, byte-equal on cuda ({secs['cuda']:.2f} s, DP launches "
        f"{launches['cuda']}, walk launches "
        f"{walks['cuda']}) and cpu ({secs['cpu']:.2f} s)")


def phase_rounds(db, by_template: dict, cns: dict) -> dict:
    """Phase 10b: phase 6's workload with two correction rounds."""
    import dataclasses

    import torch

    from mecat_tpu_torch.ops import dp_kernel, walk_kernel
    from mecat_tpu_torch.pipeline.cns import (CnsStats, correct_batch_rounds,
                                              device_volume)

    dev = torch.device("cuda")
    templates = cns["templates"]
    opts = dataclasses.replace(cns["opts"], rounds=2)
    dev_vol = device_volume(db, dev)

    def one_pass():
        stats = CnsStats()
        torch.cuda.synchronize()
        t0 = time.time()
        out = list(correct_batch_rounds(db, templates, by_template, opts,
                                        stats, device=dev, dev_vol=dev_vol))
        torch.cuda.synchronize()
        return out, stats, time.time() - t0

    _, _, warm_s = one_pass()
    torch.cuda.reset_peak_memory_stats()
    # the main path's run starts here ...
    zero_dp_counts()
    zero_walk_counts()
    out, stats, dt = one_pass()
    # ... and ends here
    launches = dp_launches_of(dp_kernel.launches())
    walks = need_walks("two correction rounds", walk_kernel.launches())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    r1 = cns["round1"]
    s1 = r1["stats"]
    if launches["counts"] or launches["extend"]:
        raise AssertionError(f"the correction rounds launched a counts-only "
                             f"kernel: {launches}; they align through the "
                             f"move loop alone")
    need_moves_loop("two correction rounds", launches)
    if launches["extend_moves"] <= cns["launches"]["extend_moves"]:
        raise AssertionError(f"two rounds launched {launches}, one round "
                             f"{cns['launches']}")
    if stats.templates != len(templates) or stats.templates != s1.templates:
        raise AssertionError(f"templates counted {stats.templates} times for "
                             f"{len(templates)} templates")
    if stats.supports_aligned <= s1.supports_aligned:
        raise AssertionError("the draft round aligned no supports")
    if stats.corrected_reads <= 0 or stats.corrected_reads != len(out):
        raise AssertionError(f"rounds=2 corrected {stats.corrected_reads} "
                             f"reads, yielded {len(out)}")
    if any(seg.dtype != np.uint8 or int(seg.max()) > 3 for _, seg in out):
        raise AssertionError("a corrected read holds something else than "
                             "base codes 0..3")
    say(f"phase 10: cns at full width, rounds=2: {len(templates)} templates, "
        f"{stats.supports_aligned} supports aligned (both rounds) in "
        f"{dt:.4f} s (warm pass {warm_s:.4f} s): "
        f"{stats.supports_aligned / dt:.1f} supports/s, "
        f"{stats.corrected_reads} corrected reads, {stats.corrected_bases} "
        f"bases, DP launches {launches}, walk launches {walks}, "
        f"lane-segments issued {stats.dp_lane_segs_issued}, useful "
        f"{stats.dp_lane_segs_useful}, peak device memory {peak_gb:.3f} GB")
    say(f"phase 10: beside it, rounds=1 (phase 6): {s1.supports_aligned} "
        f"supports in {r1['seconds']:.4f} s: "
        f"{s1.supports_aligned / r1['seconds']:.1f} supports/s, "
        f"{s1.corrected_reads} corrected reads, {s1.corrected_bases} bases, "
        f"DP launches {cns['launches']}, lane-segments issued "
        f"{s1.dp_lane_segs_issued}, useful {s1.dp_lane_segs_useful}, peak "
        f"{r1['peak_gb']:.3f} GB; two rounds take "
        f"{dt / r1['seconds']:.2f}x the seconds")
    return dict(launches=launches, walks=walks)


def fasta_counts(path: str):
    """(reads, bases) of a FASTA file."""
    from mecat_tpu_torch.io.packed_db import PackedDB

    db = PackedDB.from_fasta(path)
    return db.n_reads, db.total_bases


def summary_fields(rec: dict) -> str:
    return json.dumps({k: v for k, v in rec.items()
                       if k not in ("component", "ts", "event")})


PIPELINE_STAGES = ("pw-candidates", "cns", "extract", "asm-overlaps", "trim")
PIPELINE_ARTIFACTS = ("candidates.txt", "corrected.fasta", "extracted.fasta",
                      "asm_overlaps.m4", "trimmed.fasta")


def phase_pipeline(reads: str, n_reads: int, n_bases: int, work: str) -> dict:
    """Phase 11: the correct+trim pipeline CLI on every bench read, then once
    more to show the resume.  Returns the corrected reads' path and the
    launches its stages reported."""
    out = os.path.join(work, "out")
    argv = ["-d", reads, "-o", out, "-g", str(GENOME), "-a", "1000",
            "--min-length", "2000", "--device", "cuda"]
    wall, summaries = run_cli_summaries("pipeline", argv)
    pipe = [r for r in summaries if r["component"] == "pipeline"]
    pws = [r for r in summaries if r["component"] == "pw"]
    cns = [r for r in summaries if r["component"] == "cns"]
    if len(pipe) != 1 or len(pws) != 2 or len(cns) != 1:
        raise AssertionError("the pipeline CLI printed "
                             f"{[r['component'] for r in summaries]}")
    pipe = pipe[0]
    if pipe.get("stages_run") != len(PIPELINE_STAGES):
        raise AssertionError(f"the pipeline ran {pipe.get('stages_run')} "
                             f"stages of {len(PIPELINE_STAGES)}")
    paths = [os.path.join(out, a) for a in PIPELINE_ARTIFACTS]
    for path in paths:
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            raise AssertionError(f"pipeline artifact {path} is missing or "
                                 f"empty")
    stage_s = {n: pipe.get(f"{n}_seconds") for n in PIPELINE_STAGES}
    say(f"phase 11: CLI pipeline -g {GENOME} -a 1000 --min-length 2000 "
        f"--device cuda on {n_reads} reads, {n_bases} bases: exit 0, wall "
        f"{wall:.2f} s, of which in the five stages "
        f"{sum(stage_s.values()):.2f} s; seconds a stage "
        + json.dumps(stage_s))
    corrected, extracted, trimmed = (fasta_counts(paths[i]) for i in (1, 2, 4))
    say(f"phase 11: after pw-candidates {count_lines(paths[0])} candidate "
        f"records; after cns {corrected[0]} reads, {corrected[1]} bases; "
        f"after extract {extracted[0]} reads, {extracted[1]} bases; after "
        f"asm-overlaps {count_lines(paths[3])} M4 records; after trim "
        f"{trimmed[0]} reads, {trimmed[1]} bases")
    for name, rec in (("pw-candidates", pws[0]), ("cns", cns[0]),
                      ("asm-overlaps", pws[1])):
        say(f"phase 11: stage {name} summary " + summary_fields(rec))
    if corrected[0] <= 0 or cns[0].get("corrected_reads") != corrected[0]:
        raise AssertionError("the pipeline's cns stage wrote no corrected "
                             "reads, or not as many as its summary says")
    if trimmed[0] <= 0:
        raise AssertionError("the pipeline trimmed every read away")
    launches = dict(counts=sum(r.get("dp_launches", 0) for r in pws),
                    extend=sum(r.get("dp_launches_extend", 0) for r in pws),
                    moves=cns[0].get("dp_launches_moves", 0),
                    extend_moves=cns[0].get("dp_launches_extend_moves", 0))
    # pw-candidates (-j 0) extends nothing; asm-overlaps (-j 1) does
    if pws[0].get("dp_launches_extend", 0) or pws[0].get("dp_launches", 0):
        raise AssertionError(f"the pipeline's pw-candidates stage launched a "
                             f"counts kernel: {summary_fields(pws[0])}")
    need_loop("the pipeline's asm-overlaps stage",
              pws[1].get("dp_launches_extend", 0),
              pws[1].get("dp_launches", 0))
    # -j 1 on cuda takes the fused route, as the reference's accelerator
    if pws[1].get("route") != "fused":
        raise AssertionError(f"the pipeline's asm-overlaps stage ran route "
                             f"{pws[1].get('route')!r}")
    need_moves_loop("the pipeline's cns stage", launches)
    walks = need_walks("the pipeline's cns stage", cns[0])

    stamps = [os.stat(p).st_mtime_ns for p in paths]
    wall2, again = run_cli_summaries("pipeline", argv)
    pipe2 = [r for r in again if r["component"] == "pipeline"]
    if (len(again) != 1 or len(pipe2) != 1 or pipe2[0].get("stages_run") != 0
            or [os.stat(p).st_mtime_ns for p in paths] != stamps):
        raise AssertionError(f"the second pipeline call did not skip every "
                             f"stage: {again}")
    say(f"phase 11: a second call skipped all five stages (wall "
        f"{wall2:.2f} s, every artifact untouched)")
    return dict(corrected=paths[1], launches=launches, walks=walks,
                wall=wall)


def kmer_share(seq: np.ndarray, genome: np.ndarray, k: int = 21) -> float:
    """Share of the k-mers of ``seq`` that occur in ``genome`` on either
    strand."""
    def kmers(codes):
        c = np.asarray(codes).astype(np.uint64)
        n = len(c) - k + 1
        v = np.zeros(n, np.uint64)
        for i in range(k):
            v = (v << np.uint64(2)) | c[i:i + n]
        return v

    ref = np.union1d(kmers(genome), kmers((3 - genome)[::-1]))
    return float(np.isin(kmers(seq), ref).mean())


def phase_polish_small(work: str) -> None:
    """The polish exactness check: a 7-read contig (1.2 kb reads at 5 %
    substitutions every 800 bases) through the tiled device polish on the
    card, on the CPU, and through the host route."""
    from mecat_tpu_torch.assembly import ctgcns
    from mecat_tpu_torch.ops import dp_kernel, walk_kernel
    from mecat_tpu_torch.testing import polish_case

    db, tig, backbone = polish_case(work, 6000, 7, seed=77)
    opts = ctgcns.CtgCnsOptions(extend_batch=8, align_segment=128,
                                align_band=64)
    before = dp_kernel.launches(), walk_kernel.launches()
    t0 = time.time()
    got = ctgcns._polish_contig_device(db, tig, backbone, opts, device="cuda")
    cuda_s = time.time() - t0
    launches = dp_launches_of(dp_kernel.launches_since(before[0]))
    walks = need_walks("the small polish on cuda",
                       walk_kernel.launches_since(before[1]))
    cpu = ctgcns._polish_contig_device(db, tig, backbone, opts, device="cpu")
    host = ctgcns._polish_contig_host(db, tig, backbone, opts, device="cuda")
    picked = ctgcns.polish_contig(db, tig, backbone, opts, device="cuda")
    for name, other in (("the cpu", cpu), ("the host route", host),
                        ("polish_contig", picked)):
        if not np.array_equal(got, other):
            raise AssertionError(f"the polished 7-read contig differs "
                                 f"between cuda tiles and {name}")
    need_moves_loop("the small polish on cuda", launches)
    if np.array_equal(got, backbone) or len(got) == 0:
        raise AssertionError(f"the small polish did nothing: DP launches "
                             f"{launches}")
    say(f"phase 12: polish exactness: the 7-read contig ({len(backbone)} "
        f"backbone bases -> {len(got)}) in device tiles on cuda "
        f"({cuda_s:.2f} s, DP launches {launches}, walk launches "
        f"{walks}) == the same on cpu == the host route == polish_contig")


ASM_MARKERS = ("gatekeeper", "meryl", "trim", "overlap", "ovstore", "erate",
               "unitig", "consensus", "output")


def phase_assembly(corrected: str, genome: np.ndarray, work: str,
                   profile: bool) -> dict:
    """Phase 12: the assembler CLI on the pipeline's corrected reads, then
    once more to show the resume."""
    from mecat_tpu_torch.io.packed_db import PackedDB

    wrk = os.path.join(work, "wrk")
    argv = ["-p", "bench", "-d", wrk, "-trim-assemble", "-pacbio-corrected",
            corrected, "genomeSize=500k", "--device", "cuda"]
    wall, summaries = run_cli_summaries("mecat2canu", argv)
    canu = [r for r in summaries if r["component"] == "canu"]
    if len(canu) != 1:
        raise AssertionError("the assembler CLI printed "
                             f"{[r['component'] for r in summaries]}")
    canu = canu[0]
    missing = [m for m in ASM_MARKERS
               if not os.path.exists(os.path.join(wrk, m + ".done"))]
    if missing or canu.get("stages_run") != len(ASM_MARKERS):
        raise AssertionError(f"assembler stages: {canu.get('stages_run')} "
                             f"run, markers missing: {missing}")
    stage_s = {m: canu.get(f"{m}_seconds") for m in ASM_MARKERS}
    n_in = fasta_counts(corrected)
    say(f"phase 12: CLI mecat2canu -trim-assemble genomeSize=500k --device "
        f"cuda on {n_in[0]} corrected reads, {n_in[1]} bases: exit 0, wall "
        f"{wall:.2f} s, run_assembly {canu.get('seconds')} s; seconds a "
        f"stage " + json.dumps(stage_s))
    say("phase 12: assembler summary " + summary_fields(canu))
    contigs = PackedDB.from_fasta(os.path.join(wrk, "bench.contigs.fasta"))
    if contigs.n_reads <= 0 or contigs.n_reads != canu.get("n_contigs"):
        raise AssertionError("the assembler wrote no contigs, or not as many "
                             "as its summary says")
    longest = int(np.argmax(contigs.lengths))
    share = kmer_share(contigs.read(longest), genome)
    walks = need_walks("the assembler's polish", canu)
    say(f"phase 12: {canu.get('n_reads')} reads kept, "
        f"{canu.get('n_overlaps')} overlaps, {canu.get('n_unitigs')} unitigs, "
        f"{contigs.n_reads} contigs, {contigs.total_bases} bases, N50 "
        f"{canu.get('n50')}, longest {int(contigs.lengths[longest])}; "
        f"polish: {canu.get('polish_tiles')} tiles, "
        f"{canu.get('polish_alignments')} (read, tile) alignments, "
        f"{canu.get('polish_contigs_device')} contigs in device tiles, "
        f"{canu.get('polish_contigs_host')} through the host route; DP "
        f"launches {dp_launches_of(canu)}, walk launches {walks}; "
        f"peak device memory {canu.get('peak_device_gb')} GB; "
        f"{100 * share:.2f} % of the longest contig's 21-mers occur "
        f"in the simulated genome")
    for name in ("bench.layout.txt", "bench.contigs.gfa", "bench.report",
                 "bench.trimmedReads.fasta", "bench.asm.m4"):
        if not os.path.exists(os.path.join(wrk, name)):
            raise AssertionError(f"assembler artifact {name} is missing")
    need_loop("the assembler", canu.get("dp_launches_extend", 0),
              canu.get("dp_launches", 0))
    need_moves_loop("the assembler's polish", dp_launches_of(canu))
    if canu.get("polish_tiles", 0) <= 0:
        raise AssertionError("no contig was polished in device tiles")
    if share < 0.9:
        raise AssertionError(f"only {100 * share:.2f} % of the longest "
                             f"contig's 21-mers occur in the genome")
    if int(contigs.lengths[longest]) < 200_000:
        raise AssertionError(f"the longest contig has "
                             f"{int(contigs.lengths[longest])} bases of a "
                             f"{GENOME} base genome")

    wall2, again = run_cli_summaries("mecat2canu", argv)
    if (len(again) != 1 or again[0].get("stages_run") != 0
            or any(dp_launches_of(again[0]).values())
            or again[0].get("n50") != canu.get("n50")):
        raise AssertionError(f"the second assembler call re-ran something: "
                             f"{again}")
    say(f"phase 12: a second call re-ran nothing (wall {wall2:.2f} s, the "
        f"same report)")
    if profile:
        profile_polish(wrk)
    return dict(launches=dp_launches_of(canu), walks=walks, wall=wall)


def profile_polish(wrk: str) -> None:
    """One polish pass of the assembly's largest unitig in this process,
    under the synchronising stage timers of the cns chunk."""
    import torch

    from mecat_tpu_torch.assembly import ctgcns
    from mecat_tpu_torch.assembly.unitig import arrays_to_layouts
    from mecat_tpu_torch.io.packed_db import PackedDB

    db = PackedDB.from_fasta(os.path.join(wrk, "bench.trimmedReads.fasta"))
    tigs = arrays_to_layouts(np.load(os.path.join(wrk, "bench.layout.npz")))
    tig = max(tigs, key=lambda t: len(t.rows))
    backbone = ctgcns.stitch_backbone(db, tig)
    opts = ctgcns.CtgCnsOptions()
    ctgcns.polish_contig(db, tig, backbone, opts, device="cuda")    # warm
    stats = ctgcns.PolishStats()
    with StageTimers() as tm:
        torch.cuda.synchronize()
        t0 = time.time()
        ctgcns.polish_contig(db, tig, backbone, opts, device="cuda",
                             stats=stats)
        torch.cuda.synchronize()
        wall = time.time() - t0
    say(f"profile polish: the largest unitig ({len(tig.rows)} reads, "
        f"{len(backbone)} backbone bases, {stats.tiles} tiles, "
        f"{stats.alignments} alignments) under synchronising stage timers: "
        f"wall {wall:.3f} s")
    for label, sec in sorted(tm.seconds.items(), key=lambda kv: -kv[1]):
        say(f"profile polish:   {sec:9.3f} s {100 * sec / wall:5.1f} %  "
            f"x{tm.calls[label]:<5d} {label}")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        ctgcns.polish_contig(db, tig, backbone, opts, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    total_us = sum(dev_us(e) for e in kernels)
    say(f"profile polish: the same pass under torch.profiler: wall "
        f"{wall:.3f} s, kernel time {total_us / 1e6:.3f} s in "
        f"{sum(e.count for e in kernels)} kernels (card busy "
        f"{100 * total_us / 1e6 / wall:.1f} % of the profiled wall)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:6]:
        say(f"profile polish:   {dev_us(e) / 1e3:9.3f} ms "
            f"{100 * dev_us(e) / max(total_us, 1):5.1f} %  x{e.count:<7d} "
            f"{e.key[:70]}")


def pw_stats_fields(stats) -> dict:
    return {k: getattr(stats, k) for k in ("candidates", "extended",
                                           "overlaps", "cells",
                                           "cells_useful")}


def phase_fused_exact(work: str) -> dict:
    """Phase 13a: the fused route on the card equals its CPU run, bytes and
    PwStats, on the reads of tests/test_dist.py and on the golden reads.
    Returns the paths of the test_dist reads and of their cuda M4."""
    from mecat_tpu_torch.pipeline.pw import PwOptions, run_pw
    from mecat_tpu_torch.testing import DIST_PW, GOLDEN_J1, dist_reads

    d = os.path.join(work, "fused")
    os.makedirs(d)
    _, dreads = dist_reads(d)
    golden = os.path.join(ROOT, "tests", "golden", "reads.fasta")
    out = {}
    for name, reads, opts in (("test_dist", dreads, DIST_PW),
                              ("golden", golden, GOLDEN_J1)):
        got = {}
        for dev in ("cuda", "cpu"):
            path = os.path.join(d, f"{name}_{dev}.m4")
            t0 = time.time()
            stats = run_pw(reads, path, os.path.join(d, f"w_{name}_{dev}"),
                           PwOptions(**opts), device=dev, route="fused")
            with open(path, "rb") as fh:
                got[dev] = (fh.read(), pw_stats_fields(stats),
                            time.time() - t0)
            out[(name, dev)] = path
        if got["cuda"][:2] != got["cpu"][:2] or not got["cuda"][0]:
            raise AssertionError(f"fused run_pw on {name}: cuda and cpu "
                                 f"differ ({got['cuda'][1]} / "
                                 f"{got['cpu'][1]}) or wrote nothing")
        n_rec = got["cuda"][0].count(b"\n")
        say(f"phase 13: fused run_pw -j 1 on the {name} reads: "
            f"{n_rec} records, bytes and PwStats "
            f"{json.dumps(got['cuda'][1])} equal on cuda "
            f"({got['cuda'][2]:.2f} s) and cpu ({got['cpu'][2]:.2f} s)")
    return dict(reads=dreads, m4=out[("test_dist", "cuda")])


def phase_fused_cli(reads: str, n_reads: int, work: str,
                    staged: dict) -> dict:
    """Phase 13b: the pw CLI on the bench reads with no ``--route``: -j 1 on
    cuda takes the fused route, beside phase 5's staged run."""
    out = os.path.join(work, "bench_fused.m4")
    wall, summary = run_cli(
        "mecat2pw", ["-j", "1", "-d", reads, "-o", out, "-w",
                     os.path.join(work, "wrk_fused"), "-n", "16", "-a",
                     "1000", "--device", "cuda"], "pw")
    n_rec = count_lines(out)
    keys = ("seconds", "index_build_seconds", "fused_prep_s",
            "fused_extend_s", "candidates", "overlaps", "dp_gcells_issued",
            "dp_gcells_useful", "dp_launches", "dp_launches_moves",
            "dp_launches_extend", "dp_launches_extend_moves")
    say(f"phase 13: CLI mecat2pw -j 1 -n 16 -a 1000 (the default route) on "
        f"{n_reads} reads: exit 0, {n_rec} M4 records, wall {wall:.2f} s, "
        f"run_pw {summary.get('seconds', 0.0):.2f} s; the staged route "
        f"(phase 5): {staged['records']} records, wall "
        f"{staged['wall']:.2f} s, run_pw "
        f"{staged['summary'].get('seconds', 0.0):.2f} s, "
        f"{staged['summary'].get('dp_launches_extend')} segment-loop "
        f"launches, Gcells issued "
        f"{staged['summary'].get('dp_gcells_issued')} / useful "
        f"{staged['summary'].get('dp_gcells_useful')}")
    say("phase 13: fused CLI summary " + json.dumps(
        {k: summary[k] for k in keys if k in summary}))
    if summary.get("route") != "fused" or n_rec <= 0:
        raise AssertionError(f"-j 1 on cuda ran route "
                             f"{summary.get('route')!r}, {n_rec} records")
    need_loop("the fused CLI", summary.get("dp_launches_extend", 0),
              summary.get("dp_launches", 0))
    launches = dp_launches_of(summary)
    if launches["moves"] or launches["extend_moves"]:
        raise AssertionError(f"the fused CLI launched a move-writing kernel: "
                             f"{launches}")
    return dict(m4=out, records=n_rec, launches=launches)


def phase_dist_one_rank(bench_reads_path: str, fused_cli: dict,
                        work: str) -> dict:
    """Phase 13c: one rank on NCCL.  run_pw_dist on the bench reads equals
    the fused CLI's records; run_cns_dist with one and two rounds on the
    28-read pile equals run_cns on the card.  Both launch counters are
    zeroed just before and read just after.  Returns the launches and the
    pile's paths and run_cns outputs."""
    import torch.distributed as dist

    from mecat_tpu_torch.ops import dp_kernel, walk_kernel
    from mecat_tpu_torch.parallel.cns_dist import run_cns_dist
    from mecat_tpu_torch.parallel.dist import init_distributed, run_pw_dist
    from mecat_tpu_torch.pipeline.cns import CnsOptions, run_cns
    from mecat_tpu_torch.pipeline.pw import PwOptions
    from mecat_tpu_torch.testing import (PILE_CNS, cns_pile, fasta_records,
                                         m4_records)

    d = os.path.join(work, "dist1")
    os.makedirs(d)
    _, preads, cand = cns_pile(d, device="cuda")
    single = {}
    for rounds in (1, 2):
        path = os.path.join(d, f"run_cns_r{rounds}.fasta")
        run_cns(cand, preads, path, CnsOptions(rounds=rounds, **PILE_CNS),
                device="cuda")
        single[rounds] = path
    init_distributed("cuda", rank=0, world_size=1,
                     init_method="file://" + os.path.join(d, "pg_store"))
    backend = dist.get_backend()
    try:
        zero_dp_counts()
        zero_walk_counts()
        t0 = time.time()
        out = os.path.join(d, "bench_dist.m4")
        stats = run_pw_dist(bench_reads_path, out, os.path.join(d, "wpw"),
                            PwOptions(task=1, num_candidates=16,
                                      min_align_size=1000),
                            n_data=1, n_hash=1, device="cuda")
        pw_s = time.time() - t0
        got, want = m4_records(out), m4_records(fused_cli["m4"])
        if got != want or stats.overlaps != len(got):
            raise AssertionError(f"run_pw_dist on one rank: {len(got)} "
                                 f"records ({stats.overlaps} counted), the "
                                 f"fused CLI {len(want)}, equal "
                                 f"{got == want}")
        cns_s = {}
        for rounds in (1, 2):
            t0 = time.time()
            out = os.path.join(d, f"dist_r{rounds}.fasta")
            run_cns_dist(cand, preads, out, os.path.join(d, f"w{rounds}"),
                         CnsOptions(rounds=rounds, **PILE_CNS),
                         device="cuda")
            cns_s[rounds] = time.time() - t0
            got, want = fasta_records(out), fasta_records(single[rounds])
            if got != want or not got:
                raise AssertionError(f"run_cns_dist rounds={rounds} on one "
                                     f"rank: {len(got)} records, run_cns "
                                     f"{len(want)}, equal {got == want}")
        launches = dp_launches_of(dp_kernel.launches())
        walks = need_walks("run_cns_dist on one rank", walk_kernel.launches())
    finally:
        dist.destroy_process_group()
    need_loop("run_pw_dist on one rank", launches["extend"],
              launches["counts"])
    need_moves_loop("run_cns_dist on one rank", launches)
    if backend != "nccl":
        raise AssertionError(f"one rank ran over {backend}, launches "
                             f"{launches}")
    say(f"phase 13: one rank over {backend}: run_pw_dist on the bench reads "
        f"{stats.overlaps} records equal to the fused CLI's ({pw_s:.2f} s); "
        f"run_cns_dist rounds=1 / 2 on the 28-read pile equal to run_cns "
        f"({cns_s[1]:.2f} / {cns_s[2]:.2f} s); launches {launches}, walk "
        f"launches {walks}")
    return dict(launches=launches, walks=walks, pile=(preads, cand),
                run_cns_r2=single[2])


def phase_dist_ranks(fused: dict, dist1: dict, work: str) -> dict:
    """Phase 13d: four ranks sharing the card over gloo (the collectives on
    CUDA tensors, the sharded overlap step, run_pw_dist on two grids,
    run_cns_dist with two rounds), then the production dry run on eight.
    Returns the dry run's launches summed over its ranks."""
    import torch

    from mecat_tpu_torch.index.kmer_index import build_index
    from mecat_tpu_torch.pipeline.device_step import overlap_step
    from mecat_tpu_torch.testing import (SHARDED_CFG, fasta_records,
                                         m4_records, rank_reports, run_ranks,
                                         sharded_case, valid_set)

    d = os.path.join(work, "ranks")
    os.makedirs(d)
    preads, cand = dist1["pile"]
    with open(os.path.join(d, "inputs.json"), "w") as fh:
        json.dump({"pw_reads": fused["reads"], "cns_reads": preads,
                   "cns_cand": cand}, fh)
    tasks = ["collectives", "overlap-2x2", "pw-2x2", "pw-1x4", "cns-r2"]
    t0 = time.time()
    run_ranks(4, d, tasks, device="cuda:0", timeout=600)
    wall = time.time() - t0
    rec = rank_reports(d, tasks, 4)
    backends = {r["backend"] for r in rec["collectives"]}
    if backends != {"gloo"}:
        raise AssertionError(f"four ranks on one card ran over {backends}")
    say("phase 13: 4 ranks on cuda:0 over gloo: all_to_all_single (int8, "
        "int32, int64), all_gather and all_reduce(MAX) on CUDA tensors "
        "give the expected values")

    db, bases, lens, self_id = sharded_case()
    idx = build_index(db.codes, db.starts, db.lengths, k=SHARDED_CFG["k"],
                      device="cuda")
    single = valid_set(overlap_step(
        *(torch.as_tensor(a, device="cuda") for a in (bases, lens, self_id)),
        torch.as_tensor(db.codes, device="cuda"), idx.offsets, idx.pos_rid,
        idx.pos_loc, idx.read_starts, idx.read_lengths, idx.max_occ_cutoff,
        **SHARDED_CFG))
    sharded = {tuple(o) for r in rec["overlap-2x2"] for o in r["overlaps"]}
    if sharded != single or not single:
        raise AssertionError(f"sharded_overlap_step (2, 2): {len(sharded)} "
                             f"overlaps, overlap_step {len(single)}")
    want = m4_records(fused["m4"])
    for grid in ("2x2", "1x4"):
        got = m4_records(os.path.join(d, "out", f"pw-{grid}.m4"))
        n_ov = sum(r["overlaps"] for r in rec[f"pw-{grid}"])
        if got != want or n_ov != len(got):
            raise AssertionError(f"run_pw_dist {grid}: {len(got)} records "
                                 f"({n_ov} counted), fused {len(want)}")
    got = fasta_records(os.path.join(d, "out", "cns-r2.fasta"))
    if got != fasta_records(dist1["run_cns_r2"]) or not got:
        raise AssertionError("run_cns_dist rounds=2 on four ranks differs "
                             "from run_cns")
    for t in tasks[1:]:
        dp_counts = [(r["launches_extend"], r["launches"], r["launches_moves"],
                      r["launches_extend_moves"]) for r in rec[t]]
        say(f"phase 13: 4 ranks, {t}: equal to the single device; seconds "
            f"{[round(r['seconds'], 2) for r in rec[t]]}, exchange bytes "
            f"{[r['exchange_bytes'] for r in rec[t]]}, launches (segment "
            f"loop, per-segment counts, per-segment moves, move loop) "
            f"{dp_counts}"
            f", walk launches {WALK_KERNELS} "
            f"{[tuple(need_walks(t, r, ()).values()) for r in rec[t]]}")
    for t in ("overlap-2x2", "pw-2x2", "pw-1x4"):
        need_loop(f"{t} on four ranks",
                  sum(r["launches_extend"] for r in rec[t]),
                  sum(r["launches"] for r in rec[t]))
    need_moves_loop("run_cns_dist on four ranks", {
        key: sum(r[name] for r in rec["cns-r2"])
        for key, name in (("moves", "launches_moves"),
                          ("extend_moves", "launches_extend_moves"))})
    ranks_walks = need_walks("run_cns_dist on four ranks", {
        k: sum(r[k] for r in rec["cns-r2"])
        for k in (f"walk_launches_{w}" for w in WALK_KERNELS)})
    say(f"phase 13: the four ranks took {wall:.2f} s with process start")

    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "mecat_tpu_torch.parallel.dryrun", "8",
         "--device", "cuda"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"the dry run on 8 ranks exited "
                           f"{proc.returncode}:\n{proc.stderr[-4000:]}"
                           f"{proc.stdout[-2000:]}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("DRYRUN ")]
    found = json.loads(line[-1][len("DRYRUN "):])
    say(f"phase 13: python -m mecat_tpu_torch.parallel.dryrun 8 --device "
        f"cuda (production shapes, content check) passed, wall {wall:.2f} "
        f"s: " + json.dumps(found))
    launches = {k: found[name] for k, name in (
        ("counts", "launches"), ("moves", "launches_moves"),
        ("extend", "launches_extend"),
        ("extend_moves", "launches_extend_moves"))}
    need_loop("the dry run", launches["extend"], launches["counts"])
    need_moves_loop("the dry run", launches)
    if not found.get("identity_checked"):
        raise AssertionError(f"the dry run launched {launches}, checked "
                             f"{found.get('identity_checked')} segments")
    return dict(launches=launches, walks=need_walks("the dry run", found),
                ranks_walks=ranks_walks)


def timed(fn, *args, **kwargs):
    """(fn's result, host seconds it took)."""
    t0 = time.time()
    out = fn(*args, **kwargs)
    return out, time.time() - t0


def phase_native(work: str, db, truths, genome) -> None:
    """Phase 14a: the native data layer built on the card's host, each
    function against its plain version on the files of earlier phases,
    byte for byte; host seconds of both."""
    from mecat_tpu_torch import native
    from mecat_tpu_torch.io import fasta, m4
    from mecat_tpu_torch.io.packed_db import PackedDB, revcomp
    from mecat_tpu_torch.pipeline import cns
    from mecat_tpu_torch.utils import accuracy

    build_s = native.api.build()
    say(f"phase 14: native data layer (g++ -O3 -march=native) built on the "
        f"card's host in {build_s:.2f} s")
    rows = []

    def check(what: str, same: bool, t_native: float, t_plain: float):
        if not same:
            raise AssertionError(f"native {what} differs from its plain "
                                 f"version")
        rows.append((what, t_native, t_plain))

    for name in ("bench_reads.fasta", "ref_reads.fasta"):
        path = os.path.join(work, name)
        nat, t_n = timed(PackedDB.from_fasta, path)
        plain, t_p = timed(lambda: PackedDB.from_records(
            fasta.iter_fasta_plain(path)))
        check(f"parse_path of {name} ({nat.n_reads} reads, "
              f"{nat.total_bases} bases)", nat.names == plain.names and all(
                  np.array_equal(a, b) for a, b in (
                      (nat.codes, plain.codes), (nat.starts, plain.starts),
                      (nat.lengths, plain.lengths))), t_n, t_p)
    path = os.path.join(work, "bench.m4")
    recs = list(m4.read_m4(path))
    text, t_n = timed(m4.format_block, recs)
    plain, t_p = timed(m4.format_block_plain, recs)
    with open(path) as fh:
        check(f"format_block of phase 5's {len(recs)} M4 records",
              text == plain == fh.read(), t_n, t_p)
    path = os.path.join(work, "bench_cand.txt")
    cands = list(m4.read_candidates(path))
    cols = {f: np.array([getattr(c, f) for c in cands])
            for f in ("qid", "sid", "score", "qdir", "qext", "qsize", "sdir",
                      "sext", "ssize")}
    text, t_n = timed(m4.format_candidate_columns, cols)
    plain, t_p = timed(m4.format_candidate_columns_plain, cols)
    with open(path) as fh:
        check(f"format_candidate_columns of phase 7's {len(cands)} "
              f"candidates", text == plain == fh.read(), t_n, t_p)
    cut = PackedDB.from_fasta(os.path.join(work, "bench_reads_cut.fasta"))
    parts = {}
    for kind, fn in (("native", cns.partition_supports),
                     ("plain", cns.partition_supports_plain)):
        got, sec = timed(fn, path, cut, 0, os.path.join(work, "parts_" + kind),
                         64)
        blobs = []
        for lo, hi, part in got:
            with open(part, "rb") as fh:
                blobs.append((lo, hi, fh.read()))
        parts[kind] = (blobs, sec)
    check(f"partition_supports of those candidates into "
          f"{len(parts['native'][0])} files of 64 templates",
          parts["native"][0] == parts["plain"][0] and parts["native"][0],
          parts["native"][1], parts["plain"][1])
    picked = [i for i in range(db.n_reads) if db.lengths[i] < 8000][:6]
    pairs = []
    for i in picked:
        tr = truths[i]
        truth = genome[tr.start:tr.end]
        pairs.append((db.read(i), revcomp(truth) if tr.strand else truth))
    got, t_n = timed(lambda: [accuracy.edit_stats(a, b, mode=1)
                              for a, b in pairs])
    want, t_p = timed(lambda: [accuracy.edit_stats_plain(a, b, mode=1)
                               for a, b in pairs])
    check(f"edit_stats of {len(pairs)} bench reads against their truth "
          f"loci", got == want, t_n, t_p)
    for what, t_n, t_p in rows:
        say(f"phase 14: {what}: equal; host s native {t_n:.4f}, Python "
            f"{t_p:.4f} ({t_p / max(t_n, 1e-9):.1f}x)")


def phase_scalar(db) -> None:
    """Phase 14b: the scalar C++ engine on the bench reads: its index
    counts equal the port's build_index on the card, its scan of 8 reads
    the port's scan_candidates on the card."""
    import torch

    from mecat_tpu_torch import constants as C
    from mecat_tpu_torch.index.kmer_index import build_index
    from mecat_tpu_torch.native.scalar import ScalarEngine
    from mecat_tpu_torch.ops.ddf import scan_candidates

    eng, build_s = timed(ScalarEngine, db.codes, db.starts, db.lengths,
                         k=CFG["k"])
    idx = build_index(db.codes, db.starts, db.lengths, k=CFG["k"],
                      device="cuda")
    n_distinct = int(torch.count_nonzero(torch.diff(idx.offsets)))
    if (eng.n_valid, eng.n_distinct, eng.cutoff()) != (
            idx.pos_rid.numel(), n_distinct, idx.max_occ_cutoff):
        raise AssertionError(
            f"scalar index {eng.n_valid} / {eng.n_distinct} / cutoff "
            f"{eng.cutoff()}, build_index {idx.pos_rid.numel()} / "
            f"{n_distinct} / {idx.max_occ_cutoff}")
    scan = dict(stride=CFG["stride"], max_occ=CFG["max_occ"],
                diag_bin=CFG["diag_bin"])
    n = CFG["num_candidates"]
    ids = list(range(8))
    bases, lens = db.padded_batch(ids)     # whole reads, as the engine scans
    cand = scan_candidates(
        torch.as_tensor(bases, device="cuda"),
        torch.as_tensor(lens, device="cuda"), idx.offsets, idx.pos_rid,
        idx.pos_loc, idx.max_occ_cutoff,
        torch.arange(len(ids), dtype=torch.int32, device="cuda"),
        k=CFG["k"], num_candidates=n, **scan)
    tgt, score, qseed, tseed, valid = (
        x.cpu().numpy() for x in (cand.target, cand.score, cand.qseed,
                                  cand.tseed, cand.valid))
    n_cand = 0
    for r in ids:
        s_out = eng.scan_read(db.read(r), r, cutoff=eng.cutoff(), n_cand=n,
                              **scan)
        k = int(valid[r].sum())
        n_cand += k
        if k > len(s_out[0]) or any(
                not np.array_equal(s[:k], d[r, :k])
                for s, d in zip(s_out, (tgt, score, qseed, tseed))) or any(
                x >= C.MIN_BLOCK_SCORE for x in s_out[1][k:]):
            raise AssertionError(f"scalar scan of read {r} differs from "
                                 f"scan_candidates on the card")
    say(f"phase 14: ScalarEngine on the bench reads (built in {build_s:.2f} "
        f"s): {eng.n_valid} occurrences, {eng.n_distinct} distinct k-mers, "
        f"cutoff {eng.cutoff()}, equal to build_index on the card; its "
        f"scan of 8 reads equals scan_candidates on the card ({n_cand} "
        f"candidates)")


def phase_bench_module(bench: dict, cns: dict) -> dict:
    """Phase 14c: ``python -m mecat_tpu_torch.bench --device cuda
    --scalar`` as a subprocess.  Its counts must be phase 4's and phase
    6's; returns its line."""
    cmd = [sys.executable, "-m", "mecat_tpu_torch.bench", "--device", "cuda",
           "--scalar"]
    proc, wall = timed(subprocess.run, cmd, cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"the bench exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    say(f"phase 14: python -m mecat_tpu_torch.bench --device cuda --scalar: "
        f"exit 0, wall {wall:.2f} s; its line:")
    say(json.dumps(line))
    per_batch = bench["per_batch"]
    want = sum(per_batch[bi % len(per_batch)]
               for bi in range(line["batches"]))
    stats = cns["round1"]["stats"]
    got = (line["overlaps"], line["cns_supports"], line["cns_corrected_reads"])
    want = (want, stats.supports_aligned, stats.corrected_reads)
    if got != want:
        raise AssertionError(f"bench overlaps / cns supports / corrected "
                             f"reads {got}; phases 4 and 6: {want}")
    if not (line["baseline_scalar_core_ovl_s"] or 0) > 0 or (
            line["vs_baseline"] is None):
        raise AssertionError("the bench measured no scalar denominator")
    need_loop("the bench's overlap leg", line["dp_launches_extend"],
              line["dp_launches"])
    need_moves_loop("the bench's cns leg", dict(
        moves=line["cns_dp_launches_moves"],
        extend_moves=line["cns_dp_launches_extend_moves"]))
    need_walks("the bench's cns leg", {k[len("cns_"):]: v
                                       for k, v in line.items()
                                       if k.startswith("cns_walk_")})
    say(f"phase 14: the bench's {line['overlaps']} overlaps equal phase 4's "
        f"batches over the same {line['batches']} cyclic steps; its "
        f"{line['cns_supports']} supports and {line['cns_corrected_reads']} "
        f"corrected reads equal phase 6's; scalar one core on this host "
        f"{line['baseline_scalar_core_ovl_s']:.1f} overlaps/s, vs_baseline "
        f"{line['vs_baseline']:.2f}")
    return line


def phase_scaling() -> dict:
    """Phase 14d: ``python -m mecat_tpu_torch.bench --scaling --device
    cuda`` at its default meshes, the ranks sharing the card over gloo;
    returns the DP launches summed over every mesh's ranks."""
    cmd = [sys.executable, "-m", "mecat_tpu_torch.bench", "--scaling",
           "--device", "cuda"]
    proc, wall = timed(subprocess.run, cmd, cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"the scaling report exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}{proc.stdout[-2000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    meshes = [r for r in report["rows"] if "n_data" in r]
    say(f"phase 14: python -m mecat_tpu_torch.bench --scaling --device cuda: "
        f"exit 0, wall {wall:.2f} s, {len(meshes)} meshes")
    for r in report["rows"]:
        say("phase 14: scaling " + json.dumps(r))
    bad = [r for r in meshes if not (r["step_seconds"] > 0
                                     and r["virtual_mesh"] is True
                                     and r["dp_launches_extend"] > 0
                                     and r["dp_launches"] == 0)]
    if len(meshes) != 6 or bad:
        raise AssertionError(f"scaling rows: {len(meshes)} meshes, failing "
                             f"{bad}")
    return dict(counts=sum(r["dp_launches"] for r in meshes), moves=0,
                extend=sum(r["dp_launches_extend"] for r in meshes),
                extend_moves=0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--passes", type=int, default=3,
                   help="steady passes over the bench batches (phase 4)")
    p.add_argument("--profile", metavar="PATH",
                   help="profile one more phase-4 pass (full table to PATH), "
                        "the phase-6 cns pass (table to PATH.cns), a "
                        "phase-9 mapping run (table to PATH.ref) and one "
                        "polish pass of phase 12 under stage timers")
    p.add_argument("--kernels-only", action="store_true",
                   help="stop after phase 2's DP, segment-loop and walk "
                        "kernel checks and timings (no result line)")
    args = p.parse_args(argv)
    t_start = time.time()

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
    main_sw = (CFG["S"], CFG["W"])
    stats = {(S, W): phase_kernel(S, W) for S, W in shapes}
    extend = {(S, W): phase_extend(S, W, (S, W) == main_sw)
              for S, W in shapes}
    extend_moves = {(S, W): phase_extend_moves(S, W, (S, W) == main_sw)
                    for S, W in shapes}
    widths, widths_ms, widths_bound = phase_widths()
    path_shapes = phase_kernel_path_shapes(*main_sw)
    walks = {(S, W): phase_walks(S, W) for S, W in shapes}
    fold = phase_fold(*main_sw)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT)
    try:
        deposit_chunks = phase_deposit_chunks(*main_sw, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    tag_fold_host = phase_tag_fold_host(*main_sw)
    if args.kernels_only:
        say(json.dumps({"extend": extend[main_sw],
                        "extend_moves": extend_moves[main_sw],
                        "widths": widths, "widths_ms": widths_ms,
                        "widths_bound": widths_bound,
                        "path_shapes": {
            "moves" if m else "counts": v for m, v in path_shapes.items()},
            "walks": walks[main_sw], "fold": fold,
            "deposit_chunks": deposit_chunks,
            "tag_fold_host": tag_fold_host}))
        say(f"card: {card}")
        return 0
    roll = {(S, W): phase_roll_micro(S, W) for S, W in shapes}
    roll_launches = phase_roll_micro_tool()

    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT)
    try:
        t0 = time.time()
        db, truths, genome = bench_reads()
        say(f"bench reads simulated in {time.time() - t0:.2f} s")
        golden_cns = phase_golden(work)
        golden_wide = phase_golden_wide(work)
        golden_cluster = phase_golden_cluster(work)
        bench = phase_bench(db, args.passes, args.profile)
        from mecat_tpu_torch.io.fasta import write_fasta

        reads = os.path.join(work, "bench_reads.fasta")
        write_fasta(reads, [(db.name(i), db.read(i))
                            for i in range(db.n_reads)])
        staged_cli = phase_cli(reads, db.n_reads, work)
        cns = phase_cns(db, bench["supports"], args.profile)
        # phase 7's depth cut: the reads of the genome's first quarter
        cut = [i for i, t in enumerate(truths) if t.start < GENOME // 4]
        reads_cut = os.path.join(work, "bench_reads_cut.fasta")
        write_fasta(reads_cut, [(db.name(i), db.read(i)) for i in cut])
        cli_cns = phase_cli_cns(reads_cut, len(cut), work)
        ref_small = phase_ref_small(work)
        ref_wide = phase_ref_wide(work)
        ref_cluster = phase_ref_wide(work, REF_CLUSTER_BAND)
        ref_cli = phase_ref_genome(work, args.profile)
        phase_rounds_small(work)
        rounds = phase_rounds(db, bench["supports"], cns)
        pipeline = phase_pipeline(reads, db.n_reads, db.total_bases, work)
        phase_polish_small(work)
        assembly = phase_assembly(pipeline["corrected"], genome, work,
                                  bool(args.profile))
        fused = phase_fused_exact(work)
        fused_cli = phase_fused_cli(reads, db.n_reads, work, staged_cli)
        dist1 = phase_dist_one_rank(reads, fused_cli, work)
        ranks = phase_dist_ranks(fused, dist1, work)
        phase_native(work, db, truths, genome)
        phase_scalar(db)
        bench_line = phase_bench_module(bench, cns)
        scaling = phase_scaling()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say(f"chip_smoke: every phase passed in {time.time() - t_start:.1f} s")

    # both main paths run S 512, W 128: that shape's times and bound
    main_shape = stats[main_sw]
    # each DP kernel's launches on every path: phase 4's bench passes
    # (counts, the main path of the counts kernels) or phase 6's cns pass
    # (moves, the main path of the move-writing kernels); the golden cns
    # run of phase 3 and phase 3's cns CLI at WIDE_BAND (the CUDA run's own
    # count); the pw CLI of phase 5; the cns CLI of phase 7; the
    # mapping pass (phase 8's CUDA SAM run in this process, and the CLI's
    # own count of phase 9); phase 10's timed two-round pass in this
    # process, and the counts the CLIs of phases 11 and 12 report; phase 13:
    # the default -j 1 pw CLI's own count (the fused route), the one-rank
    # NCCL drivers in this process, the 8-rank dry run summed over ranks;
    # phase 14: the bench module's timed overlap window (counts) and steady
    # cns pass (moves), and the scaling report's timed steps summed over
    # every mesh's ranks
    bench_launches = dp_launches_of(bench["launches"])
    paths = {
        key: dict(
            launches=(cns["launches"][key] if "moves" in key
                      else bench_launches[key]),
            launches_golden_cns=golden_cns[key],
            launches_cns_cli_wide=golden_wide["launches"][key],
            launches_cns_cli_cluster=golden_cluster["launches"][key],
            launches_pw_cli=staged_cli["summary"].get(cli_key, 0),
            launches_cns_cli=cli_cns["launches"][key],
            launches_mapping=ref_small[key],
            launches_mapping_wide=ref_wide[key],
            launches_mapping_cluster=ref_cluster[key],
            launches_mapping_cli=ref_cli.get(cli_key, 0),
            launches_rounds=rounds["launches"][key],
            launches_pipeline_cli=pipeline["launches"][key],
            launches_assembly_cli=assembly["launches"][key],
            launches_fused_cli=fused_cli["launches"][key],
            launches_dist=dist1["launches"][key],
            launches_dryrun=ranks["launches"][key],
            launches_bench=bench_line[
                "cns_" + cli_key if "moves" in key else cli_key],
            launches_scaling=scaling[key])
        for key, cli_key in DP_KEYS}
    kernels = []
    for name, with_moves, replaces, key in (
            ("dp_segment_best", False, KERNEL_REPLACES, "counts"),
            ("dp_segment_best_moves", True, KERNEL_REPLACES_MOVES, "moves")):
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": replaces, **paths[key],
            "max_abs_err": max([s[with_moves]["max_abs_err"]
                                for s in stats.values()] + [widths[name]]),
            **{k: main_shape[with_moves][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            # no single PyTorch call computes a banded min-plus DP segment
            "library_ms": None,
            # the wrapper alone at the shapes the paths launch
            "path_shapes": path_shapes[with_moves]})
    # every path runs the per-segment bodies inside the segment loops
    kernels[0]["body_runs_in"] = "extend_counts"
    kernels[1]["body_runs_in"] = "extend_moves"
    for name, replaces, loop in (
            ("extend_counts", EXTEND_REPLACES, extend),
            ("extend_moves", EXTEND_MOVES_REPLACES, extend_moves)):
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": replaces,
            **paths["extend" if name == "extend_counts" else "extend_moves"],
            "max_abs_err": max([e["max_abs_err"] for e in loop.values()]
                               + [widths[name]]),
            **{k: loop[main_sw][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                         "graph_ms", "chain_steps", "ns_step",
                         "lane_segments")},
            # no PyTorch call computes a segmented banded extension
            "library_ms": None})
    for k in kernels:
        k["band_widths"] = [64, 128, *BAND_SWEEP]
        k["ms_by_band"] = {W: t[k["name"]] for W, t in widths_ms.items()}
        k["bound_by_band"] = {W: b[k["name"]]
                              for W, b in widths_bound.items()}
        # phase 8's CUDA run at REF_CLUSTER_BAND: every DP launch on the
        # cluster route, counted by the wrappers
        k["launches_cluster_route_mapping"] = ref_cluster["cluster"]
    def correction_paths(short):
        # the correction paths: phase 6's cns pass (the main path), phase
        # 3's golden cns run and its cns CLI at WIDE_BAND, the cns CLI of
        # phase 7, phase 10's two rounds, the CLIs of phases 11 and 12,
        # run_cns_dist on one NCCL rank (13c) and summed over four gloo
        # ranks (13d), the 8-rank dry run, the bench's cns leg
        return dict(
            launches=cns["walks"][short],
            launches_golden_cns=golden_cns["walks"][short],
            launches_cns_cli=cli_cns["walks"][short],
            launches_cns_cli_wide=golden_wide["walks"][short],
            launches_cns_cli_cluster=golden_cluster["walks"][short],
            launches_rounds=rounds["walks"][short],
            launches_pipeline_cli=pipeline["walks"][short],
            launches_assembly_cli=assembly["walks"][short],
            launches_dist=dist1["walks"][short],
            launches_dist_ranks=ranks["ranks_walks"][short],
            launches_dryrun=ranks["walks"][short],
            launches_bench=bench_line[f"cns_walk_launches_{short}"])

    # the walks of both main paths run S 512, W 128 (mapping's MAXC 704)
    walk_main = walks[(CFG["S"], CFG["W"])]
    for name, short in (("traceback_rows", "rows"),
                        ("deposit_scan", "deposit"),
                        ("traceback_ops", "cols")):
        if short == "cols":
            # the mapping path: phase 8's CUDA SAM runs in this process (at
            # W = 64 and at REF_WIDE_BAND), and the CLI's own count of
            # phase 9
            paths = dict(launches=ref_small["walks"][short],
                         launches_mapping_wide=ref_wide["walks"][short],
                         launches_mapping_cluster=ref_cluster["walks"][short],
                         launches_mapping_cli=ref_cli[f"walk_launches_{short}"])
        else:
            paths = correction_paths(short)
        kernels.append({
            "name": name, "route": "cuda", "source": WALK_SOURCE,
            "replaces": WALK_REPLACES[name], **paths,
            "max_abs_err": max([w[name]["max_abs_err"]
                                for w in walks.values()]
                               + [widths.get(name, 0)]),
            **{k: walk_main[name][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                         "graph_ms", "chain_steps", "ns_step", "chain_cols")
               if k in walk_main[name]},
            "band_widths": [64, 128, *BAND_SWEEP],
            "ms_by_band": {W: t[name] for W, t in widths_ms.items()},
            "bound_by_band": {W: b[name] for W, b in widths_bound.items()},
            # the same wrapper at (S, W) = (128, 64)
            "at_128_64": {k: walks[(128, 64)][name][k]
                          for k in ("ms", "graph_ms", "chain_steps",
                                    "ns_step", "bound_ms")},
            # no single PyTorch call computes a banded walk or deposit
            "library_ms": None})
    # the tag fold of every correction chunk, at the cns cell's S 512, W 128
    for name, short in FOLD_SHORT.items():
        kernels.append({
            "name": name, "route": "cuda", "source": FOLD_SOURCE,
            "replaces": FOLD_REPLACES[name], **correction_paths(short),
            "max_abs_err": max(fold[name]["max_abs_err"], widths[name]),
            # library_ms: the fold's is one index_add_ of the presence
            # buffer; no PyTorch call computes the planes
            **{k: fold[name][k]
               for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                         "bound_by", "graph_ms", "deposit_bytes",
                         "live_cells", "present_cells", "adds", "sectors",
                         "sector_ms", "chunks", "probe")
               if k in fold[name]},
            "band_widths": [128, *BAND_SWEEP],
            "ms_by_band": {W: t[name] for W, t in widths_ms.items()},
            "bound_by_band": {W: b[name] for W, b in widths_bound.items()}})
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
        "variants": {n: {"library_ms": None,
                         **{k: v[k] for k in ("max_abs_err", "ms", "plain_ms",
                                              "bound_ms", "bound_by",
                                              "gcells_s")}}
                     for n, v in roll_main.items()}})
    say(json.dumps({"kernels": kernels}))
    say(f"card: {card}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
