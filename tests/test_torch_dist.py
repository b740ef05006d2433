"""The port's sharded pw drivers on four ``gloo`` ranks vs the JAX package.

Four CPU ranks (``mecat_tpu_torch.testing`` started by ``run_ranks``, one
thread each, joined through a ``file://`` store) run the sharded overlap
step on (n_data, n_hash) = (2, 2) and (1, 4), and ``run_pw_dist`` on both
grids.  Their overlaps equal the port's single-device ``overlap_step`` as
canonical sets, and the merged M4 records equal the fused single-device
``run_pw`` and the JAX ``run_pw_dist(n_data=4, n_hash=2)`` (8 virtual CPU
devices in this process) as sorted full records.  A rank that fails ends
the run at once; the toy dry run passes on four ranks.
"""
import glob
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread is as fast, and several test workers share the cores
torch.set_num_threads(1)

from mecat_tpu.parallel.dist import run_pw_dist as ref_run_pw_dist
from mecat_tpu.pipeline.pw import PwOptions as RefPwOptions
from mecat_tpu_torch.index.kmer_index import build_index
from mecat_tpu_torch.parallel import dist as port_dist
from mecat_tpu_torch.pipeline.device_step import overlap_step
from mecat_tpu_torch.pipeline.pw import PwOptions, run_pw
from mecat_tpu_torch.testing import (DIST_PW, SHARDED_CFG, dist_reads,
                                     m4_records, rank_reports, run_ranks,
                                     sharded_case, valid_set)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS = ["collectives", "overlap-2x2", "overlap-1x4", "pw-2x2", "pw-1x4"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("ranks"))
    _, reads = dist_reads(work)
    with open(os.path.join(work, "inputs.json"), "w") as fh:
        json.dump({"pw_reads": reads}, fh)
    # the ranks run while this process computes the references
    pool = ThreadPoolExecutor(1)
    done = pool.submit(run_ranks, 4, work, TASKS, timeout=300)
    pool.shutdown(wait=False)

    def rec():
        done.result()
        return rank_reports(work, TASKS, 4)
    return work, reads, rec


@pytest.mark.parametrize("grid", ["2x2", "1x4"])
def test_sharded_overlap_step_matches_overlap_step(ranks, grid):
    _, _, rec = ranks
    db, bases, lens, self_id = sharded_case()
    idx = build_index(db.codes, db.starts, db.lengths, k=SHARDED_CFG["k"],
                      device="cpu")
    single = valid_set(overlap_step(
        torch.as_tensor(bases), torch.as_tensor(lens),
        torch.as_tensor(self_id), torch.as_tensor(db.codes), idx.offsets,
        idx.pos_rid, idx.pos_loc, idx.read_starts, idx.read_lengths,
        idx.max_occ_cutoff, **SHARDED_CFG))
    mine = rec()[f"overlap-{grid}"]
    got = {tuple(o) for r in mine for o in r["overlaps"]}
    assert len(single) > 0
    assert got == single
    # every rank scored its own 4 rows with the hits of every shard
    assert [r["rows"] for r in mine] == [4] * 4
    assert all(r["exchange_bytes"] > 0 for r in mine)


def test_run_pw_dist_matches_fused_and_jax(ranks, monkeypatch):
    work, reads, rec = ranks
    fused = os.path.join(work, "fused.m4")
    run_pw(reads, fused, os.path.join(work, "wf"), PwOptions(**DIST_PW),
           device="cpu", route="fused")
    want = m4_records(fused)
    jax_out = os.path.join(work, "jax_dist.m4")
    ref_run_pw_dist(reads, jax_out, os.path.join(work, "wj"),
                    RefPwOptions(**DIST_PW), n_data=4, n_hash=2)
    assert m4_records(jax_out) == want
    assert len(want) > 0
    rec = rec()
    for grid in ("2x2", "1x4"):
        got = m4_records(os.path.join(work, "out", f"pw-{grid}.m4"))
        assert got == want, grid
        # each rank counts its own rows' records
        assert sum(r["overlaps"] for r in rec[f"pw-{grid}"]) == len(got)
        shards = glob.glob(os.path.join(work, "out", f"wpw-{grid}",
                                        "pw_shard_p*.m4"))
        assert len(shards) == 4


def test_collectives_on_four_gloo_ranks(ranks):
    _, _, rec = ranks
    assert [r["backend"] for r in rec()["collectives"]] == ["gloo"] * 4


def test_a_failing_rank_ends_the_run(tmp_path):
    work = str(tmp_path)
    with open(os.path.join(work, "inputs.json"), "w") as fh:
        json.dump({}, fh)
    t0 = time.time()
    with pytest.raises(RuntimeError, match="of 4 failed"):
        run_ranks(4, work, ["failon-2"], timeout=120)
    assert time.time() - t0 < 90
    with open(os.path.join(work, "rank2.log")) as fh:
        assert "rank 2 fails on purpose" in fh.read()


def test_grid_and_backend_without_a_group():
    assert port_dist.init_distributed("cpu") == (0, 1)
    grid = port_dist.make_grid()
    assert (grid.n_data, grid.n_hash, grid.rank, grid.hash_group) == (
        1, 1, 0, None)
    with pytest.raises(ValueError):
        port_dist.make_grid(n_data=2, n_hash=2)
    assert port_dist.choose_backend("cpu", 4) == "gloo"
    assert port_dist.global_max(7, "cpu") == 7


def test_dryrun_toy_on_four_ranks():
    proc = subprocess.run(
        [sys.executable, "-m", "mecat_tpu_torch.parallel.dryrun", "4",
         "--device", "cpu", "--toy", "--timeout", "240"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("DRYRUN ")]
    found = json.loads(line[-1][len("DRYRUN "):])
    assert found["grid"] == [2, 2] and found["batch"] == 8
    assert found["overlaps"] > 0 and found["survivors"] > 0
    assert found["templates"] == 8 and found["segments"] > 0
    assert found["exchange_bytes"] > 0
