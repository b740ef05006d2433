"""Multi-rank dry run of the sharded paths (port of
``__graft_entry__.dryrun_multichip``).

    python -m mecat_tpu_torch.parallel.dryrun N --device cpu|cuda [--toy]

starts N ranks as subprocesses (on ``cuda`` round-robin over the cards;
on the CPU, or where ranks share a card, over ``gloo``) and runs in each,
on a simulated volume:

1. one sharded overlap step (``sharded_overlap_step``) on a (data, hash)
   grid: n_hash = 2 for an even N, else 1; a batch of 2N reads;
2. the two-phase step: ``sharded_probe_step``, the survivors, then
   ``sharded_extend_step``;
3. one template-sharded correction slice (``correct_slice_sharded``) whose
   piles are the overlaps of step 1, on the first 2N templates.

By default at the production shapes (k 13, stride 10, S 512, W 128, 30
segments, 6.5 kb reads at about 13x, the pacbio preset with 32 pairs a
chunk), where every corrected segment must beat its raw read's identity
against the truth locus and reach 95 %; ``--toy`` takes the toy shapes (k
7, S 128, W 64).  Rank 0 prints what the ranks found; the exit code is 0
only when every rank passed.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import constants as C
from ..index.kmer_index import build_index
from ..io.packed_db import revcomp
from ..ops import dp_kernel, walk_kernel
from ..pipeline.cns import CnsOptions, CnsStats, device_volume
from ..pipeline.pw import _bucket_k
from ..utils.accuracy import edit_stats, identity_pct
from ..utils.sim import random_genome, simulate_reads
from . import sharded
from .cns_dist import correct_slice_sharded
from .dist import (all_gather_rows, global_max, global_sum,
                   init_distributed, launch_ranks, make_grid)
from .sharded import (index_shard, sharded_extend_step, sharded_overlap_step,
                      sharded_probe_step)

#: the toy shapes
CFG_TOY = dict(k=7, stride=4, max_occ=16, num_candidates=8, diag_bin=128,
               L_target=2048, S=128, W=64, max_segs=8, min_align_size=300,
               min_identity=65.0)
#: the production shapes: the real k and stride, the S 512 / W 128 DP, the
#: preset filters
CFG_PROD = dict(k=13, stride=10, max_occ=16, num_candidates=16,
                diag_bin=256, L_target=8192, S=512, W=128, max_segs=30,
                min_align_size=2000, min_identity=70.0)
#: about 13x over a genome short enough that a 16-read batch gives piles
#: that vote at the pacbio thresholds (min_coverage 6, min_length 5000)
SIM_PROD = dict(genome_n=8_000, L=8192, seed=71, mean_len=6500,
                min_len=5500)


def _sim_volume(n_reads: int = 16, genome_n: int = 12000, L: int = 2048,
                seed: int = 71, mean_len: int = 1500, min_len: int = 800):
    genome = random_genome(genome_n, seed=seed)
    db, truths = simulate_reads(genome, n_reads, mean_len=mean_len,
                                min_len=min_len, seed=seed + 1,
                                error_rate=0.08)
    bases, lens = db.padded_batch(range(n_reads), pad_to=L)
    return db, bases, lens, np.arange(n_reads, dtype=np.int32), genome, \
        truths


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def dryrun_rank(device, toy: bool) -> dict:
    """The dry run of this rank (the process group is up); returns what
    every rank found, summed, and raises AssertionError where a check
    fails."""
    if toy:
        cfg, sim = CFG_TOY, {}
        cns_opts = CnsOptions(min_align_size=200, min_length=200,
                              min_mapping_ratio=0.1, min_identity=60.0,
                              min_coverage=1, align_segment=128,
                              align_band=64, extend_batch=32)
    else:
        cfg, sim = CFG_PROD, dict(SIM_PROD)
        cns_opts = CnsOptions.for_tech(C.TECH_PACBIO, extend_batch=32)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_hash = 2 if world % 2 == 0 else 1
    grid = make_grid(world // n_hash, n_hash)
    batch = world * 2
    db, bases, lens, self_id, genome, truths = _sim_volume(
        n_reads=max(16, batch), **sim)
    idx = build_index(db.codes, db.starts, db.lengths, k=cfg["k"],
                      device=device)
    Bl = batch // grid.n_data
    mine = slice(grid.d * Bl, (grid.d + 1) * Bl)
    q = [torch.as_tensor(a[:batch][mine], device=device)
         for a in (bases, lens, self_id)]
    vol = (torch.as_tensor(db.codes, device=device), idx.read_starts,
           idx.read_lengths)
    shard = index_shard(idx, grid, device)
    found = {"grid": (grid.n_data, grid.n_hash), "batch": batch}

    # 1. the sharded one-shot overlap step
    out = sharded_overlap_step(*q, vol[0], shard, vol[1], vol[2],
                               idx.max_occ_cutoff, grid, **cfg)
    valid, target, qseed, tseed, score = (
        all_gather_rows(x).cpu().numpy()
        for x in (out.valid, out.target, out.qseed, out.tseed, out.score))
    _check(valid.shape[0] == batch, f"{valid.shape[0]} rows of {batch}")
    found["overlaps"] = int(valid.sum())

    # 2. the two-phase step: probe, survivors, extension
    N = cfg["num_candidates"]
    tgt_f, score_f, qseed_f, tseed_f, surv_f = sharded_probe_step(
        *q, vol[0], shard, vol[1], vol[2], idx.max_occ_cutoff, grid,
        k=cfg["k"], stride=cfg["stride"], max_occ=cfg["max_occ"],
        num_candidates=N, diag_bin=cfg["diag_bin"],
        L_target=cfg["L_target"], S=cfg["S"], W=cfg["W"], min_block_score=2)
    sel = np.flatnonzero(surv_f.cpu().numpy())
    K = _bucket_k(max(global_max(len(sel), device), 1))
    sel_pad = np.zeros(K, np.int64)
    sel_pad[:len(sel)] = sel
    res, _ = sharded_extend_step(
        q[0], q[1], vol[0], vol[1], vol[2], tgt_f, qseed_f, tseed_f,
        torch.as_tensor(sel_pad, device=device),
        torch.as_tensor(np.arange(K) < len(sel), device=device), grid, N=N,
        L_target=cfg["L_target"], S=cfg["S"], W=cfg["W"],
        max_segs=cfg["max_segs"])
    _check(bool((res.n_segs[:len(sel)] > 0).all()),
           "a survivor was not extended")
    found["survivors"] = global_sum(len(sel), device)
    found["K"] = K

    # 3. one template-sharded correction slice over the step-1 piles
    by_template: dict = {}
    for r, c in zip(*np.nonzero(valid)):
        by_template.setdefault(int(target[r, c]), []).append(
            (int(r), 0, max(0, int(qseed[r, c])), max(0, int(tseed[r, c])),
             int(score[r, c])))
    templates = sorted(by_template)[:world * 2] or [0]
    by_template = {t: by_template.get(t, []) for t in templates}
    stats = CnsStats()
    recs = list(correct_slice_sharded(grid, db, templates, by_template,
                                      cns_opts, stats,
                                      device_volume(db, device)))
    found["templates"] = len(templates)
    found["supports"] = global_sum(stats.supports_aligned, device)
    found["segments"] = global_sum(len(recs), device)
    _check(global_sum(stats.templates, device) == len(templates),
           "a template went missing")
    if not toy:
        # the vote must emit at the real thresholds, and every corrected
        # segment must beat its raw read against the truth locus
        _check(found["segments"] > 0, "the dry run corrected no segment")
        for name, seg in recs:
            t = int(re.match(r"sim_(\d+)_", name).group(1))
            tr = truths[t]
            truth = genome[tr.start:tr.end]
            if tr.strand:
                truth = revcomp(truth)
            cor = identity_pct(edit_stats(np.asarray(seg), truth, mode=1),
                               len(seg))
            raw = identity_pct(edit_stats(db.read(t), truth, mode=1),
                               int(db.lengths[t]))
            _check(cor > raw and cor >= 95.0,
                   f"{name}: corrected {cor:.2f} %, raw {raw:.2f} %")
        found["identity_checked"] = global_sum(len(recs), device)
    return found


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mecat_tpu_torch.parallel.dryrun",
        description="multi-rank dry run of the sharded paths")
    p.add_argument("n", type=int, help="number of ranks")
    p.add_argument("--device", default="cuda",
                   help="cuda (ranks round-robin over the cards) or cpu")
    p.add_argument("--toy", action="store_true",
                   help="toy shapes instead of the production shapes")
    p.add_argument("--timeout", type=float, default=900.0,
                   help="seconds the ranks may take together")
    # set by the launcher for each rank
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device on this machine")
    if args.rank is None:
        return _launch(args)

    torch.set_num_threads(1)
    init_distributed(device, rank=args.rank, world_size=args.world,
                     init_method=args.init_method)
    try:
        t0 = time.time()
        found = dryrun_rank(device, args.toy)
        found["seconds"] = round(time.time() - t0, 3)
        walks = walk_kernel.launches()
        mine = (dp_kernel.LAUNCHES, dp_kernel.LAUNCHES_MOVES,
                dp_kernel.LAUNCHES_EXTEND, dp_kernel.LAUNCHES_EXTEND_MOVES,
                sharded.EXCHANGE_BYTES, *walks.values())
        found["launches_by_rank"] = all_gather_rows(torch.tensor(
            [mine], dtype=torch.int64, device=device)).tolist()
        for i, key in enumerate(("launches", "launches_moves",
                                 "launches_extend", "launches_extend_moves",
                                 "exchange_bytes",
                                 *walks)):
            found[key] = global_sum(mine[i], device)
        if args.rank == 0:
            print("DRYRUN " + json.dumps(found), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _launch(args) -> int:
    n_cards = torch.cuda.device_count() if args.device == "cuda" else 0
    devices = ([f"cuda:{r % n_cards}" for r in range(args.n)] if n_cards
               else [args.device] * args.n)
    label = "toy" if args.toy else "production"
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="dryrun_") as work:
        logs = launch_ranks("mecat_tpu_torch.parallel.dryrun", args.n, work,
                            [str(args.n)] + (["--toy"] if args.toy else []),
                            devices=devices, timeout=args.timeout)
    line = [ln for ln in logs[0].splitlines() if ln.startswith("DRYRUN ")]
    print(f"dryrun[{label}]: {args.n} ranks on {', '.join(sorted(set(devices)))} "
          f"passed in {time.time() - t0:.1f} s", flush=True)
    print(line[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
