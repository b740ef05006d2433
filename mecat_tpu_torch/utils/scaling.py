"""Strong-scaling report of the sharded overlap step (port of
``mecat_tpu.utils.scaling``).

    python -m mecat_tpu_torch.utils.scaling [--device cuda|cpu]
    python -m mecat_tpu_torch.bench --scaling [--device cuda|cpu]

For each (n_data, n_hash) mesh, n_data x n_hash ranks start as
subprocesses (``parallel.dist.launch_ranks``: on ``cuda`` round-robin
over the cards, ``gloo`` where ranks share a card) and each runs
``parallel.sharded.sharded_overlap_step`` on a fixed global batch (strong
scaling: rank (d, h) takes data group d's rows, the index is split over
the hash ranks).  Each rank times the median of ``n_batches`` steps after
a warm-up one, on the host clock ending in a sync on ``cuda`` and in a
barrier; a mesh's step time is its slowest rank's median.  Rows carry the
reference's keys: ``step_seconds``, ``speedup_vs_1dev`` and
``scaling_efficiency`` against ``t1 = t * n_dev`` of the first mesh,
``platform``, ``virtual_mesh``, and a ``hash_collective_overhead`` row for
each (d, 2) mesh measured beside (2d, 1); each mesh's row adds
``dp_launches_extend`` and ``dp_launches``, the launches of the
segment-loop kernel (one a step's extension) and of the per-segment
counts kernel (none on this path) in its ranks' timed steps (0 on the
CPU).

``virtual_mesh`` is true on the CPU, and on ``cuda`` when the largest mesh
has more ranks than there are cards: the meshes' ranks then share devices,
so their times are a wiring check, not a scaling measurement of real
hardware.  It is a property of the whole report, as in the reference,
whose 1-device row is the normalisation of the shared-device rows.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

#: the reference's default meshes (n_data, n_hash)
DEFAULT_MESHES = ((1, 1), (2, 1), (4, 1), (2, 2), (4, 2), (8, 1))
#: the reference's step configuration (``mecat_tpu/utils/scaling.py:64-74``)
CFG = dict(k=13, stride=8, max_occ=16, num_candidates=8, diag_bin=256,
           L_target=4096, S=256, W=128, max_segs=12, min_align_size=500,
           min_identity=65.0)
#: query rows are padded to this width
L_QUERY = 4096


def _workload(batch: int, n_reads: int, genome_n: int):
    """The reference's simulated volume and its fixed global batch."""
    from .sim import random_genome, simulate_reads

    genome = random_genome(genome_n, seed=111)
    db, _ = simulate_reads(genome, n_reads, mean_len=3000, min_len=1500,
                           seed=112, error_rate=0.1)
    ids = np.arange(batch) % db.n_reads
    bases, lens = db.padded_batch(ids, pad_to=L_QUERY)
    return db, bases, lens, ids.astype(np.int32)


def rank_median_step(device, n_data: int, n_hash: int, batch: int,
                     n_batches: int, n_reads: int, genome_n: int
                     ) -> Tuple[float, dict]:
    """Median seconds of this rank's sharded overlap step and the DP
    kernels' launches of its timed steps, as
    :func:`..ops.dp_kernel.launches` keys them (the process group is up, or
    this is the only process)."""
    from ..index.kmer_index import build_index
    from ..ops import dp_kernel
    from ..parallel.dist import barrier, make_grid
    from ..parallel.sharded import index_shard, sharded_overlap_step

    device = torch.device(device)
    grid = make_grid(n_data, n_hash)
    db, bases, lens, self_id = _workload(batch, n_reads, genome_n)
    idx = build_index(db.codes, db.starts, db.lengths, k=CFG["k"],
                      device=device)
    Bl = batch // n_data
    mine = slice(grid.d * Bl, (grid.d + 1) * Bl)
    q = [torch.as_tensor(a[mine], device=device)
         for a in (bases, lens, self_id)]
    vol = torch.as_tensor(db.codes, device=device)
    shard = index_shard(idx, grid, device)

    def step() -> None:
        sharded_overlap_step(*q, vol, shard, idx.read_starts,
                             idx.read_lengths, idx.max_occ_cutoff, grid,
                             **CFG)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        barrier()

    step()                                  # warm-up (and kernel build)
    dp0 = dp_kernel.launches()
    times = []
    for _ in range(n_batches):
        t0 = time.time()
        step()
        times.append(time.time() - t0)
    return float(np.median(times)), dp_kernel.launches_since(dp0)


def scaling_report(mesh_shapes: Optional[List[Tuple[int, int]]] = None,
                   batch: int = 64, n_batches: int = 4, n_reads: int = 64,
                   genome_n: int = 60_000, emit=print, device="cuda",
                   timeout: float = 900.0) -> List[dict]:
    """Measure the sharded overlap step across meshes; one dict per
    (n_data, n_hash) mesh that divides ``batch``, then the hash-overhead
    rows (see the module text).  Each emitted line is JSON."""
    from ..parallel.dist import launch_ranks

    device = torch.device(device)
    meshes = [tuple(m) for m in (mesh_shapes or DEFAULT_MESHES)
              if batch % (m[0] * m[1]) == 0]
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    virtual = device.type == "cpu" or max(
        (d * h for d, h in meshes), default=1) > n_cards
    rows: List[dict] = []
    t1 = None
    for n_data, n_hash in meshes:
        n_dev = n_data * n_hash
        devices = ([f"cuda:{r % n_cards}" for r in range(n_dev)]
                   if device.type == "cuda" else [str(device)] * n_dev)
        with tempfile.TemporaryDirectory(prefix="scaling_") as work:
            logs = launch_ranks(
                "mecat_tpu_torch.utils.scaling", n_dev, work,
                ["--mesh", f"{n_data}x{n_hash}", "--batch", str(batch),
                 "--n-batches", str(n_batches), "--n-reads", str(n_reads),
                 "--genome-n", str(genome_n)],
                devices=devices, timeout=timeout)
        found = [json.loads(ln.split(" ", 1)[1])
                 for log in logs for ln in log.splitlines()
                 if ln.startswith("SCALING_RANK ")]
        if len(found) != n_dev:
            raise RuntimeError(f"mesh {n_data}x{n_hash}: {len(found)} of "
                               f"{n_dev} ranks reported a step time")
        t = max(f["median_s"] for f in found)
        if t1 is None:
            t1 = t * n_dev  # normalise to a 1-device-equivalent reference
        row = {
            "n_data": n_data, "n_hash": n_hash, "n_devices": n_dev,
            "step_seconds": t,
            "speedup_vs_1dev": round(t1 / t, 3) if t > 0 else None,
            "scaling_efficiency": round(t1 / (n_dev * t), 3)
            if t > 0 else None,
            "platform": device.type,
            "virtual_mesh": virtual,
            "dp_launches": sum(f["dp_launches"] for f in found),
            "dp_launches_extend": sum(f["dp_launches_extend"]
                                      for f in found),
        }
        rows.append(row)
        if emit:
            emit(json.dumps({"scaling": row}))

    # hash-axis collective overhead: same device count, hash=2 vs hash=1
    by = {(r["n_data"], r["n_hash"]): r for r in rows}
    for d, h in list(by):
        if h == 2 and (2 * d, 1) in by:
            base = by[(2 * d, 1)]["step_seconds"]
            ovh = by[(d, 2)]["step_seconds"] / base - 1 if base > 0 else None
            row = {"n_devices": 2 * d,
                   "hash_collective_overhead": round(ovh, 3)
                   if ovh is not None else None}
            rows.append(row)
            if emit:
                emit(json.dumps({"scaling": row}))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mecat_tpu_torch.utils.scaling",
        description="strong-scaling report of the sharded overlap step")
    p.add_argument("--device", default="cuda",
                   help="cuda (ranks round-robin over the cards) or cpu")
    # set by the report for each rank
    for flag in ("--rank", "--world", "--batch", "--n-batches", "--n-reads",
                 "--genome-n"):
        p.add_argument(flag, type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--mesh", default=None, help=argparse.SUPPRESS)
    p.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("scaling: no CUDA device on this machine", file=sys.stderr)
        return 2
    if args.rank is not None:
        return _rank_main(args, device)

    rows = scaling_report(device=device)
    eff_rows = [r for r in rows if r.get("scaling_efficiency") is not None]
    best_at_max = None
    if eff_rows:
        n_max = max(r["n_devices"] for r in eff_rows)
        best_at_max = max(r["scaling_efficiency"] for r in eff_rows
                          if r["n_devices"] == n_max)
    print(json.dumps({
        "metric": "sharded overlap step strong-scaling report",
        "value": best_at_max,
        "unit": "efficiency@max_devices",
        "rows": rows,
    }), flush=True)
    return 0


def _rank_main(args, device: torch.device) -> int:
    import torch.distributed as dist

    from ..parallel.dist import init_distributed

    torch.set_num_threads(1)
    n_data, n_hash = (int(x) for x in args.mesh.split("x"))
    init_distributed(device, rank=args.rank, world_size=args.world,
                     init_method=args.init_method)
    try:
        median, launches = rank_median_step(
            device, n_data, n_hash, args.batch, args.n_batches, args.n_reads,
            args.genome_n)
        print("SCALING_RANK " + json.dumps(
            {"rank": args.rank, "median_s": median,
             "dp_launches": launches["dp_launches"],
             "dp_launches_extend": launches["dp_launches_extend"]}),
            flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
