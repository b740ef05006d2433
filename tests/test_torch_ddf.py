"""Port DDF candidate scan (mecat_tpu_torch.ops.ddf) vs the JAX package.

Candidates must be equal element by element, in top-k order: the port
emulates the four-key ``lax.sort`` with two packed int64 keys and
``lax.top_k``'s lower-index-first tie order with a stable sort.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread is as fast, and several test workers share the cores
torch.set_num_threads(1)
jnp = pytest.importorskip("jax.numpy")

from mecat_tpu.index.kmer_index import build_index
from mecat_tpu.io.fasta import FastaRecord
from mecat_tpu.io.packed_db import PackedDB
from mecat_tpu.ops import ddf as ref
from mecat_tpu.utils.sim import mutate, random_genome, simulate_reads
from mecat_tpu_torch.index.kmer_index import index_from_numpy
from mecat_tpu_torch.ops import ddf as port

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "reads.fasta")


def _scan_both(db, read_ids, L, *, k, stride, max_occ, n, diag_bin=256,
               strand=0):
    idx = build_index(db.codes, db.starts, db.lengths, k=k, device=False)
    bases, lens = db.padded_batch(read_ids, pad_to=L)
    if strand:
        bases = np.ascontiguousarray(bases[:, ::-1])
    self_id = np.asarray(read_ids, dtype=np.int32)
    want = ref.scan_candidates(
        jnp.asarray(bases), jnp.asarray(lens), jnp.asarray(idx.offsets),
        jnp.asarray(idx.pos_rid), jnp.asarray(idx.pos_loc),
        jnp.int32(idx.max_occ_cutoff), jnp.asarray(self_id), k=k,
        stride=stride, max_occ=max_occ, num_candidates=n, diag_bin=diag_bin)
    pidx = index_from_numpy(idx, "cpu")
    got = port.scan_candidates(
        torch.as_tensor(bases), torch.as_tensor(lens), pidx.offsets,
        pidx.pos_rid, pidx.pos_loc, pidx.max_occ_cutoff,
        torch.as_tensor(self_id), k=k, stride=stride, max_occ=max_occ,
        num_candidates=n, diag_bin=diag_bin)
    return got, want


def _assert_candidates_equal(got, want):
    for name, g, w in zip(want._fields, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("strand", [0, 1])
def test_scan_matches_jax_golden_shapes(strand):
    db = PackedDB.from_fasta(GOLDEN)
    got, want = _scan_both(db, list(range(8)), 4096, k=9, stride=4,
                           max_occ=32, n=12, strand=strand)
    assert bool(got.valid.any())
    _assert_candidates_equal(got, want)


def test_scan_matches_jax_bench_shapes():
    genome = random_genome(30000, seed=31)
    db, _ = simulate_reads(genome, 24, mean_len=3000, min_len=1500, seed=32,
                           error_rate=0.12)
    got, want = _scan_both(db, list(range(8)), 8192, k=13, stride=10,
                           max_occ=16, n=16)
    assert bool(got.valid.any())
    _assert_candidates_equal(got, want)


def test_scan_tied_scores_keep_lower_index_first():
    """Identical target copies give runs of equal score: both sides must
    keep the lowest-sorted runs, in the same order, when top-n cuts a tie."""
    rng = np.random.default_rng(41)
    src = rng.integers(0, 4, 1500, dtype=np.uint8)
    recs = [FastaRecord("q", mutate(src, rng, 0.01, 0.01, 0.01))]
    recs += [FastaRecord(f"copy{i}", src) for i in range(5)]
    recs += [FastaRecord("other", rng.integers(0, 4, 1500, dtype=np.uint8))]
    db = PackedDB.from_records(recs)
    got, want = _scan_both(db, [0], 2048, k=9, stride=4, max_occ=32, n=3)
    scores = got.score[0].tolist()
    assert scores[0] == scores[1] == scores[2] > 0
    _assert_candidates_equal(got, want)
    assert got.target[0].tolist() == [1, 2, 3]


def test_pair_key_orders_like_int32_pairs():
    rng = np.random.default_rng(5)
    hi = rng.integers(-2 ** 31, 2 ** 31, 4000, dtype=np.int64)
    lo = rng.integers(-2 ** 31, 2 ** 31, 4000, dtype=np.int64)
    hi[:5] = [2 ** 31 - 1, -2 ** 31, 0, 2 ** 31 - 1, -2 ** 31]
    lo[:5] = [2 ** 31 - 1, -2 ** 31, -1, -2 ** 31, 2 ** 31 - 1]
    hi[5:2000:2] = hi[6:2001:2]          # ties on the high key
    key = port._pair_key(torch.as_tensor(hi.astype(np.int32)),
                         torch.as_tensor(lo.astype(np.int32)))
    np.testing.assert_array_equal(
        torch.sort(key, stable=True).indices.numpy(),
        np.lexsort((lo, hi)))
