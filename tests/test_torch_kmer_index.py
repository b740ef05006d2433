"""Port k-mer index (mecat_tpu_torch.index) vs the JAX package: exact equality."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread is as fast, and several test workers share the cores
torch.set_num_threads(1)
jnp = pytest.importorskip("jax.numpy")

from mecat_tpu.index import kmer_index as ref
from mecat_tpu.io.fasta import FastaRecord
from mecat_tpu.io.packed_db import PackedDB
from mecat_tpu.utils.sim import random_genome, simulate_reads
from mecat_tpu_torch.index import kmer_index as port


@pytest.fixture(scope="module")
def small_db():
    db, _ = simulate_reads(random_genome(4000, seed=11), 12, mean_len=400,
                           min_len=100, seed=12)
    # an empty read and one shorter than k exercise the read-boundary mask
    rng = np.random.default_rng(13)
    extra = [FastaRecord("empty", np.zeros(0, np.uint8)),
             FastaRecord("short", rng.integers(0, 4, 5, dtype=np.uint8))]
    recs = [FastaRecord(db.name(i), db.read(i)) for i in range(6)]
    recs += extra + [FastaRecord(db.name(i), db.read(i))
                     for i in range(6, db.n_reads)]
    return PackedDB.from_records(recs)


def _np(t):
    return t.cpu().numpy()


def _assert_index_equal(got, want):
    assert got.k == want.k
    assert got.max_occ_cutoff == want.max_occ_cutoff
    for name in ("offsets", "pos_rid", "pos_loc", "read_starts",
                 "read_lengths"):
        g = _np(getattr(got, name))
        w = np.asarray(getattr(want, name))
        assert g.dtype == np.int32, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("k,cutoff_abs", [(6, None), (9, None), (8, 3)])
def test_build_index_matches_numpy_build(small_db, k, cutoff_abs):
    db = small_db
    want = ref.build_index(db.codes, db.starts, db.lengths, k=k,
                           freq_cutoff_abs=cutoff_abs, device=False)
    got = port.build_index(db.codes, db.starts, db.lengths, k=k,
                           freq_cutoff_abs=cutoff_abs, device="cpu")
    _assert_index_equal(got, want)


def test_kmer_codes_match_jnp():
    rng = np.random.default_rng(3)
    bases = rng.integers(0, 4, (5, 301), dtype=np.uint8)
    for k in (7, 13):
        want = np.asarray(ref.kmer_codes_jnp(jnp.asarray(bases), k))
        got = port.kmer_codes(torch.as_tensor(bases), k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("cutoff,max_occ", [(4, 3), (1000, 8)])
def test_probe_index_matches_jax(small_db, cutoff, max_occ):
    db = small_db
    k = 6
    idx = ref.build_index(db.codes, db.starts, db.lengths, k=k, device=False)
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 1 << (2 * k), (3, 50), dtype=np.int32)
    # also probe k-mers that are certainly present
    codes[:, :10] = ref.kmer_codes_np(db.read(0), k)[:10].astype(np.int32)
    valid = rng.random((3, 50)) < 0.8
    want = ref.probe_index(jnp.asarray(idx.offsets), jnp.asarray(idx.pos_rid),
                           jnp.asarray(idx.pos_loc), jnp.asarray(codes),
                           jnp.asarray(valid), jnp.int32(cutoff),
                           max_occ=max_occ)
    pidx = port.index_from_numpy(idx, "cpu")
    got = port.probe_index(pidx.offsets, pidx.pos_rid, pidx.pos_loc,
                           torch.as_tensor(codes), torch.as_tensor(valid),
                           cutoff, max_occ=max_occ)
    assert bool(got[2].any())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_index_from_numpy_round_trip(small_db):
    db = small_db
    want = ref.build_index(db.codes, db.starts, db.lengths, k=7, device=False)
    carried = port.index_from_numpy(want, "cpu")
    _assert_index_equal(carried, want)
    built = port.build_index(db.codes, db.starts, db.lengths, k=7,
                             device="cpu")
    for name in ("offsets", "pos_rid", "pos_loc"):
        assert torch.equal(getattr(carried, name), getattr(built, name))
