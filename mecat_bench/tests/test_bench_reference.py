"""The plain reference against the port's CPU path, at a tiny size."""
import numpy as np
import pytest
import torch

from mecat_bench.gen.reads import simulate
from mecat_bench.reference import pw as ref
from mecat_bench.tests.conftest import TINY, TINY_PW


def _port_text(sim, opts_d, k_plan):
    from mecat_tpu_torch.index.kmer_index import build_index
    from mecat_tpu_torch.io.packed_db import PackedDB
    from mecat_tpu_torch.pipeline import pw as P
    db = PackedDB(codes=sim.codes, starts=sim.starts, lengths=sim.lengths,
                  names=[])
    opts = P.PwOptions(**opts_d)
    idx = build_index(db.codes, db.starts, db.lengths, k=opts.kmer_size,
                      device="cpu")
    stats = P.PwStats()
    qids, rows, lq, lt = k_plan
    if opts.task == 1:
        pend = P.dispatch_query_batch_fused(
            db, 0, idx, torch.as_tensor(db.codes), qids, opts, db, stats,
            lq, lt, batch_rows=rows)
        return P.collect_query_batch_fused(pend, 0, db, opts, stats)
    return P.process_query_batch(db, 0, idx, qids, opts, db, stats, lq,
                                 lt)[1]


@pytest.mark.parametrize("task", [1, 0])
def test_reference_equals_port_cpu(task):
    sim = simulate(TINY, 987654321012, "cpu")
    opts = dict(TINY_PW, task=task)
    reads = ref.Reads(sim.codes, sim.starts, sim.lengths)
    plan = ref.plan(reads.lengths, opts)
    index = ref.build_index(reads, 0, len(reads.lengths), opts["kmer_size"],
                            None, "cpu")
    k = len(plan) - 1
    want = (ref.batch_m4(reads, index, 0, len(reads.lengths), *plan[k][::2],
                         plan[k][3], opts) if task == 1 else
            ref.batch_candidates(reads, index, 0, len(reads.lengths),
                                 plan[k][0], plan[k][2], opts))
    got = _port_text(sim, opts, plan[k])
    assert want.count("\n") > 10
    assert got == want


def test_reference_plan_equals_port_plan():
    from mecat_tpu_torch.io.packed_db import PackedDB
    from mecat_tpu_torch.pipeline import pw as P
    sim = simulate(dict(TINY, coverage=40), 5, "cpu")
    db = PackedDB(codes=sim.codes, starts=sim.starts, lengths=sim.lengths,
                  names=[])
    opts = dict(TINY_PW, num_candidates=100, scan_batch=256, task=1)
    vol_max = int(db.lengths.max())
    want = [tuple(b) for b in P.plan_fused_batches(
        db, 0, db.n_reads, vol_max, P.PwOptions(**opts))]
    assert ref.plan(sim.lengths, opts) == want


def test_dp_matches_stored_rows():
    """The running-best endpoint equals the best over all stored rows."""
    g = torch.Generator().manual_seed(3)
    B, S, W = 6, 64, 32
    q = torch.randint(0, 4, (B, S), generator=g, dtype=torch.uint8)
    t = torch.randint(0, 4, (B, S + W), generator=g, dtype=torch.uint8)
    t[:, :S] = torch.where(torch.rand(B, S, generator=g) < 0.8, q, t[:, :S])
    tmax = torch.tensor([S, S // 2, 3, 0, S + W // 2, 10], dtype=torch.int32)
    seg_q = torch.tensor([S, S, S // 3, 1, S, 0], dtype=torch.int32)
    active = torch.tensor([True, True, True, True, True, False])
    tpad = torch.cat([torch.full((B, W // 2), ref.T_SENTINEL,
                                 dtype=torch.uint8), t], dim=1)[:, :S + W]
    got = ref._dp_best(q, tpad, tmax, seg_q, active, W)
    from mecat_tpu_torch.ops.align import dp_segment_best_plain
    want = dp_segment_best_plain(q, tpad, tmax, seg_q, active, S, W)
    for a, b in zip(got, (want[0], want[2], want[3], want[4])):
        assert torch.equal(a, b)


def test_cns_reference_equals_port_cpu():
    """Sampled templates of a table slice, recomputed alone, equal the
    port's correction of the whole slice; the slice's DP tally equals the
    port's useful lane-segments."""
    import json
    import os

    from mecat_bench.gen.candidates import truth_candidates
    from mecat_bench.reference import cns as rcns
    from mecat_tpu_torch.io.packed_db import PackedDB
    from mecat_tpu_torch.pipeline import cns as P

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = json.load(open(os.path.join(here, "configs", "yeast-ont.json")))
    cfg.update(genome_size=12000, coverage=20, mean_len=3000, min_len=2000)
    opts = dict(cfg["cns_options"], align_segment=256, align_band=64)
    sim = simulate(cfg, 2 ** 33 + 7, "cpu", keep_map=True)
    cands = truth_candidates(sim, opts["min_align_size"])
    cap = 32 * 4096 * 16 * 5 * 4
    db = PackedDB(codes=sim.codes, starts=sim.starts, lengths=sim.lengths,
                  names=[])
    t1, c1, t2, c2 = P._sides_from_columns(cands, 0)
    n = len(t1)
    table = P.SupportTable(np.concatenate([t1, t2]),
                           np.concatenate([c1, c2]),
                           tiebreak=np.concatenate([2 * np.arange(n),
                                                    2 * np.arange(n) + 1]))
    slices = P.plan_table_slices(db, sorted(table), cap)
    reads = rcns.Reads(sim.codes, sim.starts, sim.lengths, "cpu")
    rtable = rcns.support_table(cands)
    assert rcns.plan_table_slices(reads, sorted(rtable), cap) == slices
    sl = slices[-1]
    stats = P.CnsStats()
    got = dict(P.correct_batch_device(db, sl, table, P.CnsOptions(**opts),
                                      stats, device="cpu", cap=cap))
    sample = list(sl[::max(1, len(sl) // 5)])
    want = rcns.correct_templates(reads, rtable, opts, list(sl), sample)
    n_segs = 0
    for t in sample:
        mine = [got[f"{t}_{k}"] for k in range(len(want[t]))]
        assert f"{t}_{len(want[t])}" not in got
        assert all(np.array_equal(a, b) for a, b in zip(mine, want[t]))
        n_segs += len(want[t])
    assert n_segs >= 3
    tally = rcns.slice_tally(reads, rtable, opts, list(sl))
    assert tally.lane_segments == stats.dp_lane_segs_useful
