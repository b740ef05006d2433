"""The port's template-sharded ``run_cns_dist`` on four ``gloo`` ranks vs
the port's ``run_cns`` and the JAX ``run_cns_dist``.

On the pile of ``tests/test_cns_dist.py`` four CPU ranks run one round,
one round under a 4 MiB table cap (several slices, a different number of
templates on each rank) and two rounds (draft emit gathered to every
rank).  Each merged FASTA is record-exact to the single-device ``run_cns``
and to the JAX ``run_cns_dist`` on 8 virtual CPU devices.
"""
import json
import os
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread is as fast, and several test workers share the cores
torch.set_num_threads(1)

from mecat_tpu.parallel.cns_dist import run_cns_dist as ref_run_cns_dist
from mecat_tpu.pipeline.cns import CnsOptions as RefCnsOptions
from mecat_tpu_torch.pipeline.cns import CnsOptions, run_cns
from mecat_tpu_torch.testing import (CNS_DIST_OPTS, cns_dist_pile,
                                     fasta_records, rank_reports, run_ranks)

CAP = 1 << 22
TASKS = ["cns-r1", f"cns-r1-c{CAP}", "cns-r2"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("cns_ranks"))
    _, reads, cand = cns_dist_pile(work, device="cpu")
    with open(os.path.join(work, "inputs.json"), "w") as fh:
        json.dump({"cns_reads": reads, "cns_cand": cand,
                   "cns_opts": CNS_DIST_OPTS}, fh)
    # the ranks run while this process computes the references
    pool = ThreadPoolExecutor(1)
    done = pool.submit(run_ranks, 4, work, TASKS, timeout=400)
    pool.shutdown(wait=False)

    def rec():
        done.result()
        return rank_reports(work, TASKS, 4)
    return work, reads, cand, rec


@pytest.mark.parametrize("task,rounds,n_data", [
    ("cns-r1", 1, 8), (f"cns-r1-c{CAP}", 1, 4), ("cns-r2", 2, 8)])
def test_run_cns_dist_matches_run_cns_and_jax(ranks, monkeypatch, task,
                                              rounds, n_data):
    work, reads, cand, rec = ranks
    single = os.path.join(work, f"single_{task}.fasta")
    run_cns(cand, reads, single, CnsOptions(rounds=rounds, **CNS_DIST_OPTS),
            device="cpu")
    want = fasta_records(single)
    assert len(want) > 0
    if "-c" in task:
        monkeypatch.setenv("MECAT_TPU_CNS_TABLE_BYTES", str(CAP))
    jax_out = os.path.join(work, f"jax_{task}.fasta")
    ref_run_cns_dist(cand, reads, jax_out, os.path.join(work, "wj" + task),
                     RefCnsOptions(rounds=rounds, **CNS_DIST_OPTS),
                     n_data=n_data)
    assert fasta_records(jax_out) == want
    mine = rec()[task]
    got = fasta_records(os.path.join(work, "out", task + ".fasta"))
    assert got == want
    assert sum(r["corrected_reads"] for r in mine) == len(got)
    if "-c" in task:
        # the cap cuts the batch into several slices on every rank
        assert min(r["table_slices"] for r in mine) > 1


def test_two_rounds_bind(ranks):
    work, _, _, rec = ranks
    rec()
    one = fasta_records(os.path.join(work, "out", "cns-r1.fasta"))
    two = fasta_records(os.path.join(work, "out", "cns-r2.fasta"))
    assert one.keys() == two.keys() and one != two
