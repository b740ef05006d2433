"""Template-sharded mecat2cns on ``torch.distributed``.

Port of ``mecat_tpu.parallel.cns_dist``.  Every rank runs
:func:`run_cns_dist` on the same reads and candidates; the ranks form one
``data`` axis over the templates.  Each table slice of T templates is cut
into world-size blocks of T_loc = ceil(T / world) slots: rank r owns slots
[r * T_loc, (r + 1) * T_loc), holds their tag tables on its own device,
aligns the (template, support) pairs of its slots (``make_cns_chunk``, the
move-writing DP kernel) and votes them (``call_tables``).  Templates are
independent piles and integer tag adds commute, so every template's
corrected reads equal the single-device ``run_cns``'s.  Each rank writes
its own corrected reads to ``<wrk>/cns_shard_p{rank}.fasta``; after a
barrier rank 0 concatenates the shards in rank order.

Rounds > 1: each draft round gathers the int8 emit arrays, the coverage
and the support flags of every rank (``all_gather``), so that every rank
derives the same drafts, appends them to its copy of the reads and of the
device volume, and remaps the seeds; the final round runs as a single
round does.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from .. import constants as C
from ..io.fasta import format_fasta
from ..io.packed_db import PackedDB
from ..ops.consensus import emit_to_draft
from ..ops.consensus_device import call_tables, split_called
from ..pipeline.cns import (CnsOptions, CnsStats, DeviceVolume,
                            _gather_rows_dev, append_device_volume,
                            append_drafts, device_volume, load_supports,
                            make_cns_chunk, plan_pairs, plan_table_slices,
                            seg_bucket, table_cap)
from ..pipeline.common import bucket_length, max_segs_for
from ..utils.log import get_logger
from .dist import (all_gather_rows, barrier, global_max, global_min,
                   init_distributed, make_grid, merge_shards, rank_device)

log = get_logger("cns_dist")


def _slice_tables(grid, db: PackedDB, templates: List[int], by_template,
                  opts: CnsOptions, stats: CnsStats, dev_vol: DeviceVolume,
                  draft_mode: bool = False, gather: bool = False):
    """Fold one slice's support chunks and vote, sharded over the ranks.

    Returns (emit int8 [rows, L_t, m], cov_ok bool [rows, L_t], has bool
    [rows], row0): this rank's T_loc rows (row0 = rank * T_loc), or with
    ``gather`` all T_pad rows of every rank (row0 = 0), their emit cut to
    the global deepest insertion slot.  Every rank builds the same pair
    plan from the same host data, so the chunk rounds (the most any rank
    needs) and each round's segment budgets (from the pairs of all ranks in
    that round) agree everywhere; a rank with no pairs in a round still
    takes part with dead lanes.
    """
    world, rank = grid.world, grid.rank
    vol_cat, starts_d, lengths_d, n_bases = dev_vol
    dev = vol_cat.device
    T = len(templates)
    T_loc = -(-T // world)
    L_t = bucket_length(max(int(db.lengths[t]) for t in templates),
                        pow2=True)
    L_s = bucket_length(min(int(db.lengths.max()), 3 * L_t), pow2=True)
    S, W = opts.align_segment, opts.align_band
    msegs = max_segs_for(min(max(L_t, L_s), int(1.4 * L_t) + 2 * S), S)
    P_b = opts.extend_batch
    D1 = C.MAX_INS_DELTA + 1

    plan = plan_pairs(db, templates, by_template, opts, L_t, msegs)
    counts = torch.zeros((T_loc, L_t, D1, 5), dtype=torch.int32, device=dev)
    cov_diff = torch.zeros((T_loc, L_t + 1), dtype=torch.int32, device=dev)
    has = torch.zeros(T_loc, dtype=torch.bool, device=dev)
    if plan is not None:
        # each pair goes to the rank that owns its slot; the budget order
        # of the plan holds within every rank's list
        owner = plan["slot"] // T_loc
        idx_by_rank = [np.nonzero(owner == r)[0] for r in range(world)]
        n_rounds = max(-(-len(ix) // P_b) for ix in idx_by_rank)
        pairs_a = plan["pairs"]
        for r in range(n_rounds):
            used_all = np.concatenate([ix[r * P_b:(r + 1) * P_b]
                                       for ix in idx_by_rank])
            part = idx_by_rank[rank][r * P_b:(r + 1) * P_b]
            n = len(part)
            cols = {k: np.zeros(P_b, np.int32)
                    for k in ("s", "t", "qlen", "tlen", "qs", "ts", "slot",
                              "dir")}
            cols["s"][:n] = pairs_a[part, 1]
            cols["t"][:n] = pairs_a[part, 0]
            cols["dir"][:n] = pairs_a[part, 2]
            for k in ("qlen", "tlen", "qs", "ts"):
                cols[k][:n] = plan[k][part]
            cols["slot"][:n] = plan["slot"][part] % T_loc
            real = np.arange(P_b) < n
            chunk = make_cns_chunk(
                L_s=L_s, L_t=L_t, S=S, W=W,
                max_segs=seg_bucket(int(plan["segs_r"][used_all].max()),
                                    msegs),
                max_segs_left=seg_bucket(
                    int(plan["segs_l"][used_all].max()), msegs),
                min_identity=opts.min_identity,
                min_align_size=opts.min_align_size,
                min_mapping_ratio=opts.min_mapping_ratio)
            chunk(counts, cov_diff, has, vol_cat, starts_d, lengths_d,
                  n_bases,
                  *(torch.as_tensor(cols[k], device=dev)
                    for k in ("s", "t", "qlen", "tlen", "qs", "ts", "slot",
                              "dir")),
                  torch.as_tensor(real, device=dev))
            stats.supports_aligned += n
    stats.table_slices += 1

    mine = list(templates[rank * T_loc:(rank + 1) * T_loc])
    tmpl_ids = np.zeros(T_loc, np.int32)
    tmpl_ids[:len(mine)] = mine
    tmpl_len = np.zeros(T_loc, np.int32)
    tmpl_len[:len(mine)] = np.minimum(db.lengths[np.asarray(mine, int)],
                                      L_t)
    tmpl = _gather_rows_dev(vol_cat, starts_d, lengths_d,
                            torch.as_tensor(tmpl_ids, device=dev), L_t)
    emit, cov_ok = call_tables(counts, cov_diff, tmpl,
                               torch.as_tensor(tmpl_len, device=dev), has,
                               opts.min_coverage, draft_mode=draft_mode,
                               vote=opts.vote_params())
    # the delta axis cut to the deepest used insertion slot (the dropped
    # slots are all -1); the gathered blocks take the global depth
    max_ins = int((emit[:, :, 1:] >= 0).sum(dim=2).max())
    if gather:
        max_ins = global_max(max_ins, dev)
    emit = emit[:, :, :max_ins + 1].to(torch.int8)
    if gather:
        return (all_gather_rows(emit), all_gather_rows(cov_ok),
                all_gather_rows(has), 0)
    return emit, cov_ok, has, rank * T_loc


def correct_slice_sharded(grid, db: PackedDB, templates: List[int],
                          by_template, opts: CnsOptions, stats: CnsStats,
                          dev_vol: DeviceVolume):
    """One table slice, template-sharded over the ranks (a GENERATOR of
    (name, bases) for this rank's templates only).

    With ``opts.rounds`` > 1 the draft rounds run first: every rank
    gathers all ranks' draft emit arrays, derives the same drafts, appends
    them (``append_drafts``) and extends its device volume with them
    (``append_device_volume``: ``n_bases`` stays the original volume's).
    """
    rounds = max(1, int(opts.rounds))
    cur_db, cur_ids, cur_by, cur_vol = db, list(templates), by_template, \
        dev_vol
    for _ in range(rounds - 1):
        scratch = CnsStats()
        emit, _, has, _ = _slice_tables(grid, cur_db, cur_ids, cur_by, opts,
                                        scratch, cur_vol, draft_mode=True,
                                        gather=True)
        stats.supports_aligned += scratch.supports_aligned
        emit_h = emit.cpu().numpy()
        has_h = has.cpu().numpy()
        drafts = {t: emit_to_draft(emit_h[i][:int(cur_db.lengths[t])])
                  for i, t in enumerate(cur_ids) if has_h[i]}
        if not drafts:
            break
        cur_db, cur_ids, cur_by, n_old = append_drafts(
            cur_db, cur_ids, cur_by, drafts)
        if cur_db.n_reads > n_old:
            cur_vol = append_device_volume(cur_vol, cur_db, n_old)

    emit, cov_ok, has, row0 = _slice_tables(grid, cur_db, cur_ids, cur_by,
                                            opts, stats, cur_vol)
    emit, cov_ok, has = (x.cpu().numpy() for x in (emit, cov_ok, has))
    for i in range(emit.shape[0]):
        row = row0 + i
        if row >= len(cur_ids):
            break
        t = cur_ids[row]
        stats.templates += 1
        if not has[i]:
            continue
        for k, seg in enumerate(split_called(emit[i], cov_ok[i],
                                             int(cur_db.lengths[t]),
                                             opts.min_length)):
            stats.corrected_reads += 1
            stats.corrected_bases += len(seg)
            yield (f"{cur_db.name(t)}_{k}", seg)


def run_cns_dist(input_path: str, reads_path: str, out_path: str,
                 wrk_dir: str, opts: Optional[CnsOptions] = None,
                 db: Optional[PackedDB] = None, *, device,
                 cap: Optional[int] = None) -> CnsStats:
    """Template-sharded mecat2cns -> one merged corrected FASTA.

    Every rank calls this with the same inputs; ``device`` is this rank's.
    ``cap`` is the table-bytes cap of a slice (default: the least
    ``table_cap`` over the ranks, so that every rank plans the same
    slices); the output does not depend on it.  The returned CnsStats are
    this rank's; the ranks' ``corrected_reads`` add up to the merged
    file's records, which equal ``run_cns``'s record for record (the order
    of the file differs).
    """
    opts = opts or CnsOptions()
    os.makedirs(wrk_dir, exist_ok=True)
    t0 = time.time()
    rank, world = init_distributed(device)
    device = rank_device(device)
    grid = make_grid(n_data=world, n_hash=1)
    if db is None:
        db = PackedDB.from_fasta(reads_path)
    if cap is None:
        cap = global_min(table_cap(device), device)
    stats = CnsStats()
    by_template = load_supports(input_path, db, opts.input_type)
    templates = sorted(by_template)
    dev_vol = device_volume(db, device)
    log.info("dist cns: %d reads, %d templates, rank %d of %d on %s",
             db.n_reads, len(templates), rank, world, device)
    shard_path = os.path.join(wrk_dir, f"cns_shard_p{rank}.fasta")
    with open(shard_path, "wb") as fh:
        for ofs in range(0, len(templates), opts.partition_size):
            batch = templates[ofs:ofs + opts.partition_size]
            for sl in plan_table_slices(db, batch, cap):
                for name, seg in correct_slice_sharded(
                        grid, db, sl, by_template, opts, stats, dev_vol):
                    fh.write(format_fasta(name, seg))
            log.info("dist cns: %d/%d templates, %d corrected on rank %d",
                     min(ofs + opts.partition_size, len(templates)),
                     len(templates), stats.corrected_reads, rank)
    barrier()
    if rank == 0:
        merge_shards(out_path, [os.path.join(wrk_dir,
                                             f"cns_shard_p{p}.fasta")
                                for p in range(world)])
    stats.seconds = time.time() - t0
    return stats
