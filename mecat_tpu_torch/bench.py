"""Bench of the port: overlaps/s of the device overlap step, the cns leg and
the scalar one-core denominator (counterpart of the repository's
``bench.py``).

    python -m mecat_tpu_torch.bench [--device cuda|cpu] [--scalar]
    python -m mecat_tpu_torch.bench --scaling [--device cuda|cpu]

Prints ONE JSON line on stdout (progress goes to stderr).  Workload:
``bench.py``'s (``bench.py:68-83``): a random genome (seed 91), reads
simulated at 12 % error (seed 92, min length 2,000), a multiple of ``--B``
of them; ``overlap_step`` at ``CFG`` (k 13, stride 10, S 512, W 128, 30
segments).

* Overlap leg: a warm-up batch timed apart as ``warmup_s`` (it includes the
  DP kernel's build), then ``--batches`` steps over the pre-staged batches
  (cyclic over the reads), dispatched back to back; the timed window ends
  in one sync, the pull of the two tallies.
* cns leg (unless ``--no-cns``): the supports of the first 4 batches
  (forward strand, self hits dropped), the up to ``--cns-templates``
  templates with at least 5 supports, the pacbio preset with
  ``min_length`` 2000, through ``correct_batch_device``: one cold pass,
  then one steady pass.
* Scalar denominator (``--scalar``): the single-thread C++ engine
  (``native.scalar.ScalarEngine``) over the first 48 reads, forward strand
  only, on the same filters, measured in this run on this host's core;
  without the flag ``vs_baseline`` and ``baseline_scalar_core_ovl_s`` are
  null.
* ``--scaling`` runs ``utils.scaling.main`` instead.

``--device cuda`` without a card exits 2.  The line carries ``bench.py``'s
keys (``warmup_s`` in place of ``compile_s``), ``backend`` ``"torch"``,
``device`` (name and power limit from ``nvidia-smi`` on ``cuda``, and the
number of cards), the counts behind the rates (``overlaps``,
``useful_segments``, ``batches``, ``reads``) and the DP kernel launches of
the timed overlap window (``dp_launches_extend`` of the segment-loop kernel,
one a batch, beside ``dp_launches`` of the per-segment counts kernel, 0 on
that path) and of the steady cns pass (``cns_dp_launches_extend_moves`` of
the move loop, one a chunk, beside ``cns_dp_launches_moves`` of the
per-segment move kernel, 0 on that path), and the
walk kernels' launches of that pass (``cns_walk_launches_rows`` /
``_deposit`` / ``_cols``, and the tag fold's ``_planes`` / ``_fold``): 0
on the CPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from . import constants as C

#: the step configuration of ``bench.py:58-65`` (``num_candidates`` and
#: ``L_target`` follow ``--ncand`` and ``--L``)
CFG = dict(k=13, stride=10, max_occ=16, num_candidates=16, diag_bin=256,
           L_target=8192, S=512, W=128, max_segs=30, min_align_size=1000,
           min_identity=70.0)
#: the scalar leg's queries
SCALAR_QUERIES = 48


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def build_workload(genome_n: int, coverage: float, mean_len: int, B: int,
                   k: int, device):
    """The simulated reads (a multiple of B, at least B) and their k-mer
    index on ``device``; returns (db, index, index build seconds)."""
    from .index.kmer_index import build_index
    from .utils.sim import random_genome, simulate_reads

    n_reads = int(genome_n * coverage / mean_len)
    n_reads -= n_reads % B or B
    n_reads = max(n_reads, B)
    log(f"bench: genome={genome_n} reads={n_reads} mean_len={mean_len}")
    genome = random_genome(genome_n, seed=91)
    db, _ = simulate_reads(genome, n_reads, mean_len=mean_len, min_len=2000,
                           seed=92, error_rate=0.12)
    t0 = time.time()
    idx = build_index(db.codes, db.starts, db.lengths, k=k, device=device)
    _sync(device)
    index_s = time.time() - t0
    log(f"bench: index build {index_s:.3f}s ({idx.pos_rid.numel()} "
        f"positions)")
    return db, idx, index_s


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_on(device, db, idx, n_batches: int, B: int, L: int, cfg: dict,
           collect_supports: bool = False):
    """The overlap leg; returns (overlaps, useful lane-segments, steady
    seconds, warm-up seconds, supports or None, the DP kernels' launches
    of the timed window as :func:`.ops.dp_kernel.launches` keys them)."""
    from .ops import dp_kernel
    from .pipeline.device_step import overlap_step

    vol = torch.as_tensor(db.codes, device=device)
    table = (vol, idx.offsets, idx.pos_rid, idx.pos_loc, idx.read_starts,
             idx.read_lengths, idx.max_occ_cutoff)

    def batch_args(bi):
        bases, lens = db.padded_batch(range(bi * B, (bi + 1) * B), pad_to=L)
        return (torch.as_tensor(bases, device=device),
                torch.as_tensor(lens, device=device),
                torch.arange(bi * B, (bi + 1) * B, dtype=torch.int32,
                             device=device))

    t_w = time.time()
    overlap_step(*batch_args(0), *table, **cfg)
    _sync(device)
    warmup_s = time.time() - t_w

    # pre-staged batches: host batch building stays off the timed window
    n_cycle = db.n_reads // B
    staged = [batch_args(bi) for bi in range(min(n_batches, n_cycle))]
    dp0 = dp_kernel.launches()
    t0 = time.time()
    valid, segs = [], []
    for bi in range(n_batches):
        o = overlap_step(*staged[bi % len(staged)], *table, **cfg)
        valid.append(o.valid.sum())
        segs.append(o.n_segs.sum())
    # one stacked pull for both tallies: the window's only sync
    tallies = torch.stack([torch.stack(valid).sum(),
                           torch.stack(segs).sum()]).cpu()
    dt = time.time() - t0
    launches = dp_kernel.launches_since(dp0)
    overlaps, useful_segs = int(tallies[0]), int(tallies[1])

    supports = None
    if collect_supports:
        supports = []
        for bi in range(min(4, n_cycle)):
            a = staged[bi % len(staged)]
            o = overlap_step(*a, *table, **cfg)
            supports.append((a[2].cpu().numpy(),
                             {f: getattr(o, f).cpu().numpy()
                              for f in ("target", "score", "qseed", "tseed",
                                        "valid")}))
    return overlaps, useful_segs, dt, warmup_s, supports, launches


def run_cns(db, supports, device, max_templates: int):
    """The cns leg (``bench.py:160-211``): supports/s and corrected reads of
    ``correct_batch_device`` on the overlap step's own supports, or None
    when no template has 5 supports."""
    from .ops import dp_kernel, walk_kernel
    from .pipeline.cns import (CnsOptions, CnsStats, correct_batch_device,
                               device_volume)

    by_template: dict = {}
    for qids, o in supports:
        b, n = np.nonzero(o["valid"])
        for qid, tgt, score, qs, ts in zip(
                qids[b], o["target"][b, n], o["score"][b, n],
                o["qseed"][b, n], o["tseed"][b, n]):
            if int(qid) != int(tgt):
                by_template.setdefault(int(tgt), []).append(
                    (int(qid), 0, int(qs), int(ts), int(score)))
    templates = sorted(
        (t for t, s in by_template.items() if len(s) >= 5),
        key=lambda t: -len(by_template[t]))[:max_templates]
    if not templates:
        return None
    # the pacbio preset but for min_length: 5000 would drop nearly every
    # mean-5 kb read, 2000 keeps the alignment work the same
    opts = CnsOptions.for_tech(C.TECH_PACBIO, min_length=2000)
    dev_vol = device_volume(db, device)

    def one_pass():
        stats = CnsStats()
        t0 = time.time()
        for _ in correct_batch_device(db, sorted(templates), by_template,
                                      opts, stats, device=device,
                                      dev_vol=dev_vol):
            pass
        _sync(device)
        return stats, time.time() - t0

    _, cold_dt = one_pass()
    dp0 = dp_kernel.launches()
    walk0 = walk_kernel.launches()
    stats, dt = one_pass()
    dp = dp_kernel.launches_since(dp0)
    return dict(
        cns_dp_launches_moves=dp["dp_launches_moves"],
        cns_dp_launches_extend_moves=dp["dp_launches_extend_moves"],
        **{"cns_" + k: n
           for k, n in walk_kernel.launches_since(walk0).items()},
        cns_supports_per_s=stats.supports_aligned / dt if dt > 0 else None,
        cns_templates=stats.templates,
        cns_supports=stats.supports_aligned,
        cns_corrected_reads=stats.corrected_reads,
        cns_corrected_reads_per_s=stats.corrected_reads / dt
        if dt > 0 else None,
        cns_steady_s=dt, cns_first_pass_s=cold_dt)


def run_scalar(db, cfg: dict) -> dict:
    """The single-thread C++ engine over the first 48 reads, forward strand
    only (the step's parity mode); returns its counts and seconds."""
    from .native.scalar import ScalarEngine

    eng = ScalarEngine(db.codes, db.starts, db.lengths, k=cfg["k"])
    t0 = time.time()
    r = eng.overlap_range(
        0, min(SCALAR_QUERIES, db.n_reads), task=1, stride=cfg["stride"],
        max_occ=cfg["max_occ"], cutoff=eng.cutoff(),
        diag_bin=cfg["diag_bin"], n_cand=cfg["num_candidates"],
        min_block_score=C.MIN_BLOCK_SCORE, S=cfg["S"], W=cfg["W"],
        penalty=C.ALIGN_TRIM_PENALTY,
        min_seg_identity=C.MIN_SEGMENT_IDENTITY,
        min_identity=cfg["min_identity"],
        min_align_size=cfg["min_align_size"], strands=1)
    r["seconds"] = time.time() - t0
    return r


def device_info(device) -> dict:
    """Name and power limit (``nvidia-smi``) and the number of cards."""
    if torch.device(device).type != "cuda":
        return {"name": "cpu", "power_limit_w": None, "count": 0}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in out.rsplit(",", 1))
    return {"name": name, "power_limit_w": float(limit.split()[0]),
            "count": torch.cuda.device_count()}


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m mecat_tpu_torch.bench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--genome", type=int, default=500_000)
    p.add_argument("--coverage", type=float, default=15)
    p.add_argument("--mean-len", type=int, default=5000)
    p.add_argument("--L", type=int, default=8192,
                   help="query and target width")
    p.add_argument("--B", type=int, default=128, help="reads a batch")
    p.add_argument("--ncand", type=int, default=16,
                   help="candidates a read")
    p.add_argument("--batches", type=int, default=32,
                   help="timed overlap steps")
    p.add_argument("--no-cns", action="store_true", help="skip the cns leg")
    p.add_argument("--cns-templates", type=int, default=128)
    p.add_argument("--scalar", action="store_true",
                   help="measure the scalar one-core denominator")
    p.add_argument("--scaling", action="store_true",
                   help="run the strong-scaling report instead")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        log("bench: no CUDA device on this machine")
        return 2
    if args.scaling:
        from .utils.scaling import main as scaling_main

        return scaling_main(["--device", args.device])
    cfg = dict(CFG, num_candidates=args.ncand, L_target=args.L)
    B = args.B
    db, idx, index_s = build_workload(args.genome, args.coverage,
                                      args.mean_len, B, cfg["k"], device)
    overlaps, useful_segs, dt, warmup_s, supports, launches = run_on(
        device, db, idx, args.batches, B, args.L, cfg,
        collect_supports=not args.no_cns)
    rate = overlaps / dt if dt > 0 else 0.0
    # issued cells: every candidate's 2 directions x max_segs segments of
    # S x W; useful cells: the live lanes' segments
    cells_issued = (args.batches * B * cfg["num_candidates"] * 2
                    * cfg["max_segs"] * cfg["S"] * cfg["W"])
    cells_useful = useful_segs * cfg["S"] * cfg["W"]
    log(f"bench: {overlaps} overlaps in {dt:.3f}s -> {rate:.1f}/s "
        f"(warm-up {warmup_s:.2f}s)")

    scalar_rate = None
    if args.scalar:
        r = run_scalar(db, cfg)
        scalar_rate = r["passed"] / r["seconds"] if r["seconds"] > 0 else None
        log(f"bench: scalar one-core baseline: {r['passed']} passed in "
            f"{r['seconds']:.2f}s")
    result = {
        "metric": "pairwise overlap throughput (device overlap step, "
                  "simulated PacBio reads)",
        "value": rate,
        "unit": "overlaps/s/chip",
        "vs_baseline": rate / scalar_rate if scalar_rate else None,
        "baseline_scalar_core_ovl_s": scalar_rate,
        "index_build_s": index_s,
        "warmup_s": warmup_s,
        "steady_s": dt,
        "dp_gcells_per_s_issued": cells_issued / dt / 1e9 if dt > 0 else 0.0,
        "dp_gcells_per_s_useful": cells_useful / dt / 1e9 if dt > 0 else 0.0,
        "overlaps": overlaps,
        "useful_segments": useful_segs,
        "dp_launches": launches["dp_launches"],
        "dp_launches_extend": launches["dp_launches_extend"],
        "batches": args.batches,
        "reads": db.n_reads,
        "backend": "torch",
        "device": device_info(device),
    }
    if supports:
        cns = run_cns(db, supports, device, args.cns_templates)
        if cns:
            result.update(cns)
            log(f"bench: cns: {cns['cns_supports']} supports in "
                f"{cns['cns_steady_s']:.3f}s")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
