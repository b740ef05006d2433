"""Sharded mecat2pw on ``torch.distributed``, with per-rank shard files.

Port of ``mecat_tpu.parallel.dist``.  Every rank runs :func:`run_pw_dist`
on the same reads.  One rank is one device; the ranks form a (data, hash)
grid (:class:`Grid`, rank = d * n_hash + h, the flat order of the
reference's ``P(("data", "hash"))``).  Queries are split over ``data``,
the k-mer index over ``hash``, and the hits cross each hash group once
(``parallel.sharded``).  Each rank writes the M4 records of its own query
rows to ``<wrk>/pw_shard_p{rank}.m4``; after a barrier rank 0 concatenates
the shards in rank order.  That merge needs a filesystem every rank sees.

The compute is the fused route's (``pipeline.pw``): its batch plan,
survivor filter, M4 columns and span-max dedup, so the merged records
equal the single-device ``run_pw(route="fused")`` records.

Starting the ranks: :func:`init_distributed` reads ``RANK`` /
``WORLD_SIZE`` / ``LOCAL_RANK`` as ``torchrun`` sets them (with
``MASTER_ADDR`` / ``MASTER_PORT`` for its ``env://`` store), or takes
rank, world size and an init method (``tcp://`` or ``file://``) as
arguments.  A world of one with no init method creates no process group.
The backend is ``nccl`` when every rank has a card of its own and
``gloo`` on the CPU or when ranks share a card.
"""
from __future__ import annotations

import datetime
import os
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..index.kmer_index import build_index
from ..io.packed_db import PackedDB
from ..pipeline.common import max_segs_for, oriented_batch, pad_to_batch
from ..pipeline.pw import (PwOptions, PwStats, _bucket_k, append_m4_columns,
                           finalize_m4_text, new_m4_cols, plan_fused_batches)
from ..utils.log import get_logger
from .sharded import index_shard, sharded_extend_step, sharded_probe_step

log = get_logger("dist")

#: seconds a collective waits for the other ranks before it fails
TIMEOUT_S = 300


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=TIMEOUT_S)


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name, "")
    return int(value) if value else default


def rank_device(device) -> torch.device:
    """The device of this rank: ``cuda`` without an index is card
    ``LOCAL_RANK`` modulo the cards, so torchrun's ranks go round-robin."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device on this machine")
        device = torch.device("cuda", _env_int("LOCAL_RANK", 0) % n)
    return device


def choose_backend(device, world: int) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo`` (the
    CPU, or ranks sharing a card: NCCL refuses two ranks on one device).
    The ranks of this host are ``LOCAL_WORLD_SIZE`` (default: the world)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local = _env_int("LOCAL_WORLD_SIZE", world)
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def init_distributed(device, *, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None,
                     backend: Optional[str] = None) -> Tuple[int, int]:
    """Join the process group (once); returns (rank, world size).

    Rank and world size come from the arguments, else from ``RANK`` /
    ``WORLD_SIZE``.  With a world of one and no init method nothing is
    created and (0, 1) comes back: the single-device path.  On ``cuda`` the
    rank's card (:func:`rank_device`) becomes the current device.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    rank = _env_int("RANK", 0) if rank is None else rank
    world = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
    if world == 1 and init_method is None:
        return 0, 1
    device = torch.device(device)
    backend = backend or choose_backend(device, world)
    bound = None
    if device.type == "cuda":
        torch.cuda.set_device(rank_device(device))
        if backend == "nccl":
            bound = rank_device(device)
    log.info("dist: rank %d of %d joins over %s on %s", rank, world,
             backend, device)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world, timeout=_timeout(),
                            device_id=bound)
    return rank, world


@dataclass(frozen=True)
class Grid:
    """The (data, hash) grid of the ranks; rank = d * n_hash + h."""

    n_data: int
    n_hash: int
    rank: int
    #: the process group of this rank's hash group; None without exchange
    hash_group: object = None

    @property
    def world(self) -> int:
        return self.n_data * self.n_hash

    @property
    def d(self) -> int:
        return self.rank // self.n_hash

    @property
    def h(self) -> int:
        return self.rank % self.n_hash


def make_grid(n_data: Optional[int] = None, n_hash: int = 1) -> Grid:
    """The grid over the current process group (or the one process).

    Every rank creates the group of every hash group, in the same order,
    as ``new_group`` demands.  Raises ValueError unless n_data * n_hash is
    the world size.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data is None:
        n_data = max(1, world // n_hash)
    if n_data * n_hash != world:
        raise ValueError(f"a {n_data} x {n_hash} grid needs "
                         f"{n_data * n_hash} ranks, the world has {world}")
    hash_group = None
    if n_hash > 1:
        for d in range(n_data):
            group = dist.new_group([d * n_hash + h for h in range(n_hash)],
                                   timeout=_timeout())
            if d == rank // n_hash:
                hash_group = group
    return Grid(n_data, n_hash, rank, hash_group)


def collective_device(device) -> torch.device:
    """Where this process's collective tensors live: its card under NCCL,
    else the data's own device."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _all_reduce_int(local: int, op, device) -> int:
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return int(local)
    t = torch.tensor([int(local)], dtype=torch.int64,
                     device=collective_device(device))
    dist.all_reduce(t, op=op)
    return int(t.item())


def global_max(local: int, device) -> int:
    """Max of a host integer over every rank (every rank must call)."""
    return _all_reduce_int(local, dist.ReduceOp.MAX, device)


def global_min(local: int, device) -> int:
    """Min of a host integer over every rank (every rank must call)."""
    return _all_reduce_int(local, dist.ReduceOp.MIN, device)


def global_sum(local: int, device) -> int:
    """Sum of a host integer over every rank (every rank must call)."""
    return _all_reduce_int(local, dist.ReduceOp.SUM, device)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's [rows, ...] block of x, concatenated in rank order, on
    x's device (every rank must call, with equal shapes; bool travels as
    uint8)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return x
    dtype = x.dtype
    y = x.to(torch.uint8) if dtype == torch.bool else x
    y = y.to(collective_device(x.device)).contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, y)
    return torch.cat(parts).to(device=x.device, dtype=dtype)


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def merge_shards(out_path: str, shard_paths) -> None:
    """Concatenate the ranks' shard files in rank order (rank 0 only, after
    the barrier).  A shard that rank 0 cannot see raises
    FileNotFoundError: the working directory must be shared by all ranks."""
    with open(out_path, "wb") as out:
        for sp in shard_paths:
            if not os.path.exists(sp):
                raise FileNotFoundError(
                    f"rank 0 cannot see shard file {sp}: the working "
                    "directory must be on a filesystem every rank shares "
                    "(each rank's own output is complete in its shard)")
            with open(sp, "rb") as fh:
                out.write(fh.read())


def launch_ranks(module: str, world: int, work: str, args, *, devices,
                 timeout: float) -> list:
    """Start ``world`` ranks of ``python -m <module> --rank R --world N
    --init-method file://<work>/... --device <devices[R]> <args>`` (each
    pinned to one thread, logging to ``<work>/rank<R>.log``) and wait for
    them.  When one fails or ``timeout`` seconds pass, every rank is killed
    and RuntimeError names the first failure with the end of its log, so a
    fault never leaves ranks waiting on a collective.  Returns the logs."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    store = os.path.join(work, f"pg_store_{time.time_ns()}")
    logs = [os.path.join(work, f"rank{r}.log") for r in range(world)]
    procs = []
    failed = None
    try:
        for r in range(world):
            with open(logs[r], "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", module, "--rank", str(r),
                     "--world", str(world), "--init-method",
                     "file://" + store, "--device", str(devices[r]),
                     *args], env=env, stdout=fh, stderr=subprocess.STDOUT))
        deadline = time.time() + timeout
        while failed is None:
            codes = [pr.poll() for pr in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = (bad[0], f"exit {codes[bad[0]]}")
            elif all(c == 0 for c in codes):
                break
            elif time.time() > deadline:
                failed = (0, f"no end within {timeout:.0f} s")
            else:
                time.sleep(0.2)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
            pr.wait()
    text = []
    for path in logs:
        with open(path) as fh:
            text.append(fh.read())
    if failed is not None:
        r, why = failed
        raise RuntimeError(f"rank {r} of {world} failed ({why}):\n"
                           f"{text[r][-4000:]}")
    return text


def run_pw_dist(reads_path: str, out_path: str, wrk_dir: str,
                opts: Optional[PwOptions] = None,
                n_data: Optional[int] = None, n_hash: int = 2,
                db: Optional[PackedDB] = None, *, device) -> PwStats:
    """Grid-sharded all-vs-all overlaps -> one merged M4 file (``-j 1``).

    Every rank calls this with the same reads and options; ``device`` is
    this rank's (see :func:`rank_device`).  The returned PwStats are this
    rank's own rows'; the ranks' ``overlaps`` add up to the merged file's
    records.  Record for record equal to ``run_pw(route="fused")``; the
    order of the file differs.
    """
    opts = opts or PwOptions(task=1)
    if opts.task != 1:
        raise ValueError("run_pw_dist computes -j 1 only")
    os.makedirs(wrk_dir, exist_ok=True)
    rank, world = init_distributed(device)
    device = rank_device(device)
    grid = make_grid(n_data, n_hash)
    if db is None:
        db = PackedDB.from_fasta(reads_path)
    stats = PwStats(reads=db.n_reads)
    vols = db.split_volumes(opts.volume_bases)
    log.info("dist pw: %d reads, grid data=%d hash=%d, %d volume(s), rank "
             "%d of %d on %s", db.n_reads, grid.n_data, grid.n_hash,
             len(vols), rank, world, device)
    t0 = time.time()
    shard_path = os.path.join(wrk_dir, f"pw_shard_p{rank}.m4")
    with open(shard_path + ".tmp", "w") as fh:
        for vi, (va, vb) in enumerate(vols):
            vol_db = db.subset(range(va, vb))
            index = build_index(vol_db.codes, vol_db.starts, vol_db.lengths,
                                k=opts.kmer_size,
                                freq_cutoff_abs=opts.index_cutoff,
                                device=device)
            shard = index_shard(index, grid, device)
            vol = (torch.as_tensor(vol_db.codes, device=device),
                   index.read_starts, index.read_lengths)
            cutoff = index.max_occ_cutoff
            del index
            vol_max = int(vol_db.lengths.max())
            for vj in range(vi, len(vols)):
                qa, qb = vols[vj]
                for qids, b_eff, L_q, L_t in plan_fused_batches(
                        db, qa, qb, vol_max, opts):
                    fh.write(_pw_dist_batch(
                        db, va, vb, vol_db, vol, shard, cutoff, grid, qids,
                        b_eff, L_q, L_t, opts, stats, device))
                log.info("dist pw: volume %d vs %d done (%d overlaps on "
                         "rank %d)", vi, vj, stats.overlaps, rank)
    os.replace(shard_path + ".tmp", shard_path)
    barrier()
    if rank == 0:
        merge_shards(out_path, [os.path.join(wrk_dir, f"pw_shard_p{p}.m4")
                                for p in range(world)])
    stats.seconds = time.time() - t0
    return stats


def _pw_dist_batch(db: PackedDB, va: int, vb: int, vol_db: PackedDB, vol,
                   shard, cutoff: int, grid: Grid, qids, b_eff: int,
                   L_q: int, L_t: int, opts: PwOptions, stats: PwStats,
                   device) -> str:
    """One fused batch over the grid -> this rank's M4 text.

    The batch pads to a multiple of the world size with rows of length 0
    and self id -1; survivors of pad rows are dropped.  Every rank takes
    part in each strand's exchange and in the global survivor count, and
    every rank skips the strand when that count is 0.
    """
    vol_codes, read_starts, read_lengths = vol
    N = opts.num_candidates
    S, W = opts.align_segment, opts.align_band
    n_rows = len(qids)
    B_pad = -(-max(b_eff, n_rows) // grid.world) * grid.world
    Bh = B_pad // grid.world
    Bl = B_pad // grid.n_data
    fwd, rev, lens = oriented_batch(db, qids, L_q)
    fwd_p, rev_p, lens_p = pad_to_batch([fwd, rev, lens], B_pad)
    lens_p = lens_p.copy()
    lens_p[n_rows:] = 0
    qids_pad = np.zeros(B_pad, np.int64)
    qids_pad[:n_rows] = qids
    self_ids = np.where((qids_pad >= va) & (qids_pad < vb), qids_pad - va,
                        -1).astype(np.int32)
    self_ids[n_rows:] = -1
    msegs = max_segs_for(max(L_q, L_t), S)
    mine = slice(grid.d * Bl, (grid.d + 1) * Bl)
    lens_l = torch.as_tensor(lens_p[mine].astype(np.int32), device=device)
    self_l = torch.as_tensor(self_ids[mine], device=device)
    cols = new_m4_cols()
    for strand, oriented in ((0, fwd_p), (1, rev_p)):
        bases_l = torch.as_tensor(oriented[mine], device=device)
        tgt_f, score_f, qseed_f, tseed_f, surv_f = sharded_probe_step(
            bases_l, lens_l, self_l, vol_codes, shard, read_starts,
            read_lengths, cutoff, grid, k=opts.kmer_size,
            stride=opts.scan_stride, max_occ=opts.max_occ,
            num_candidates=N, diag_bin=opts.diag_bin, L_target=L_t, S=S,
            W=W, min_block_score=opts.min_block_score)
        sel = np.flatnonzero(surv_f.cpu().numpy())
        sel = sel[(grid.rank * Bh * N + sel) // N < n_rows]
        gmax = global_max(len(sel), device)
        if gmax == 0 or len(sel) == 0:
            continue
        K = _bucket_k(gmax)
        m = len(sel)
        sel_pad = np.zeros(K, np.int64)
        sel_pad[:m] = sel
        res, win0 = sharded_extend_step(
            bases_l, lens_l, vol_codes, read_starts, read_lengths, tgt_f,
            qseed_f, tseed_f, torch.as_tensor(sel_pad, device=device),
            torch.as_tensor(np.arange(K) < m, device=device), grid, N=N,
            L_target=L_t, S=S, W=W, max_segs=msegs)
        tgt, score, qseed, tseed = (x.cpu().numpy()[sel] for x in
                                    (tgt_f, score_f, qseed_f, tseed_f))
        ident, qbeg, qend, tbeg, tend, w0 = (
            x[:m].cpu().numpy() for x in (res.identity, res.qbeg, res.qend,
                                          res.tbeg, res.tend, win0))
        rows = grid.rank * Bh + sel // N
        stats.candidates += m
        stats.extended += m
        append_m4_columns(
            cols, opts, strand=strand, vol_base=va, qids=qids_pad[rows],
            qsize=lens_p[rows], tgt=tgt, tlens=vol_db.lengths, ident=ident,
            score=score, qbeg=qbeg, qend=qend, tbeg=tbeg + w0,
            tend=tend + w0, qseed=qseed, tseed=tseed)
    return finalize_m4_text(cols, opts, stats)
