"""The port's CPU path against the JAX package at a band past 3072.

On the card a DP lane past ``ops.dp_kernel.BAND_BLOCK_MAX`` = 3072 is a
thread-block cluster (``csrc/dp_segment.cu``); the walks, the deposit and
the tag fold take such a band too.  Their plain versions, the port's CPU
path, must equal the reference there.  At W = 4096 (S = 64 or 128, a few
pairs), exact equality:

* ``extend_pair_batch`` (counts) and ``extend_pair_batch_with_ops``, on the
  pairs of ``testing.pair_inputs`` with their edge lanes;
* ``traceback_rows`` / ``traceback_ops`` on the DP's moves and on random
  words with the edge lanes of ``testing.walk_inputs``;
* the deposit scan on the rows of that walk and on random rows, and
  ``banded_accumulate_tags`` on a pile;
* ``run_ref`` at ``align_band`` 4096: the same SAM bytes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread is as fast, and several test workers share the
# cores
torch.set_num_threads(1)
jnp = pytest.importorskip("jax.numpy")

from mecat_tpu import constants as ref_C
from mecat_tpu.ops import align as ref_align
from mecat_tpu.ops import consensus_banded as ref_cb
from mecat_tpu.pipeline import ref as ref_ref
from mecat_tpu_torch.io.fasta import write_fasta
from mecat_tpu_torch.ops import align as port_align
from mecat_tpu_torch.ops import consensus_banded as port_cb
from mecat_tpu_torch.ops import dp_kernel
from mecat_tpu_torch.pipeline import ref as port_ref
from mecat_tpu_torch.testing import (deposit_inputs, dp_inputs, pair_inputs,
                                     walk_inputs)
from mecat_tpu_torch.utils.sim import mutate, random_genome, simulate_reads

W = 4096
IDENT = ref_C.MIN_SEGMENT_IDENTITY
D1 = ref_C.MAX_INS_DELTA + 1


def _t(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(np.asarray(a)) for a in arrays]


def _equal(got, want, names):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_band_is_past_a_block_and_taken():
    """W = 4096 takes the cluster route on the card: a lane of two blocks."""
    assert dp_kernel.BAND_BLOCK_MAX < W <= dp_kernel.BAND_MAX
    dp_kernel.check_band(W)


@pytest.mark.parametrize("form", ["counts", "ops"])
def test_extend_pair_batch_equals_jax(form):
    S = 128
    args = pair_inputs(8, 900, seed=61)
    kw = dict(S=S, W=W, max_segs=8)
    if form == "counts":
        got = port_align.extend_pair_batch(*_t(*args), **kw)
        want = ref_align.extend_pair_batch(*_j(*args), **kw)
        _equal(got, want, want._fields)
        assert int((got.identity > 0).sum()) >= 5
        return
    got = port_align.extend_pair_batch_with_ops(*_t(*args), **kw,
                                                max_segs_left=5)
    want = ref_align.extend_pair_batch_with_ops(*_j(*args), **kw,
                                                max_segs_left=5)
    _equal(got[0], want[0], want[0]._fields)
    n_ok = 0
    for side in (1, 2):
        ok = np.asarray(want[side][-1])
        G = got[side][0].shape[0]
        assert not ok[G:].any()
        np.testing.assert_array_equal(got[side][-1].numpy(), ok[:G])
        n_ok += int(ok.sum())
        for i, (g, w) in enumerate(zip(got[side][:-1], want[side][:-1])):
            w = np.asarray(w)[:G]
            assert g.numpy().dtype == w.dtype, (side, i)
            np.testing.assert_array_equal(g.numpy()[ok[:G]], w[ok[:G]],
                                          err_msg=f"{side} {i}")
    assert n_ok >= 8


def _walk_cases(S):
    """The plain DP's moves and endpoints on dp_inputs lanes, and random
    words with walk_inputs' edge lanes."""
    q, tpad, tmax, seg_q, _ = dp_inputs(S, W, 16, seed=71)
    moves, r, w = port_align.dp_segment_best_plain(
        *_t(q, tpad, tmax, seg_q), torch.ones(16, dtype=torch.bool), S, W,
        want_moves=True)[:3]
    return [("dp", (moves, r, w)),
            ("random", _t(*walk_inputs(S, W, 16, seed=72)))]


@pytest.mark.parametrize("source", ["dp", "random"])
def test_walks_and_deposit_equal_jax(source):
    S = 64
    moves, seg_qlen, w_end = dict(_walk_cases(S))[source]
    ref_moves = jnp.asarray(moves.numpy().transpose(1, 2, 0))  # [S, W/16, N]
    got = port_align.traceback_rows(moves, seg_qlen, w_end, W)
    want = ref_align.traceback_rows(ref_moves, *_j(seg_qlen, w_end), W)
    _equal(got, want, ("mv", "h", "w_out", "w0"))
    assert int((got[0] >= 0).sum()) > 50
    maxc = port_align.max_tape_cols(S, W, IDENT)
    got_c = port_align.traceback_ops(moves, seg_qlen, w_end, W, maxc)
    want_c = ref_align.traceback_ops(ref_moves, *_j(seg_qlen, w_end), W,
                                     max_cols=maxc)
    _equal(got_c, want_c, ("ops", "qi", "tj", "n_cols"))
    assert int(got_c[3].max()) > 0
    walk = [a.numpy() for a in got[:3]]
    for rows in (deposit_inputs(S, W, 16, seed=73, walk=walk),
                 deposit_inputs(S, W, 16, seed=74)):
        _equal(port_cb._deposit_scan(*_t(*rows), W),
               ref_cb._deposit_scan(*_j(*rows), W),
               ("val0", "ipack", "icnt"))


def test_banded_accumulate_tags_equals_jax():
    """A pile of supports mutated from slices of one template (the pile of
    tests/test_torch_cns_banded.py), the row walks of both packages."""
    S, G, B, L_t, L_s, T = 64, 4, 12, 260, 300, 4
    rng = np.random.default_rng(81)
    tmpl = random_genome(L_t - 7, seed=82)
    q = np.zeros((B, L_s), np.uint8)
    t = np.zeros((B, L_t), np.uint8)
    qlen, tlen, qs, ts = (np.zeros(B, np.int32) for _ in range(4))
    for b in range(B):
        a = int(rng.integers(0, len(tmpl) - 50))
        sup = mutate(tmpl[a:int(rng.integers(a + 30, len(tmpl) + 1))], rng,
                     0.1, 0.1, 0.1)[:L_s]
        t[b, :len(tmpl)], q[b, :len(sup)] = tmpl, sup
        qlen[b], tlen[b] = len(sup), len(tmpl)
        mid = int(rng.integers(0, max(len(sup) - 1, 1)))
        qs[b], ts[b] = mid, min(a + mid, len(tmpl) - 1)
    t_slot = rng.integers(0, T, size=B).astype(np.int32)
    kw = dict(S=S, W=W, max_segs=G, max_segs_left=G)
    pa, rr, lr = ref_align.extend_pair_batch_rows(
        *_j(q, t, qlen, tlen, qs, ts), **kw)
    pair_ok = np.asarray((pa.identity >= 60.0) & ((pa.tend - pa.tbeg) >= 20))
    assert pair_ok.sum() > 3
    want_c, want_v = ref_cb.banded_accumulate_tags(
        jnp.zeros((T, L_t, D1, 5), jnp.int32),
        jnp.zeros((T, L_t + 1), jnp.int32), rr, lr, *_j(qs, ts, q, tlen,
                                                        t_slot, pair_ok),
        pa.tbeg, pa.tend, L_t=L_t, S=S, W=W)
    pa2, rr2, lr2 = port_align.extend_pair_batch_rows(
        *_t(q, t, qlen, tlen, qs, ts), **kw)
    np.testing.assert_array_equal(pa2.identity.numpy(),
                                  np.asarray(pa.identity))
    got_c, got_v = port_cb.banded_accumulate_tags(
        torch.zeros((T, L_t, D1, 5), dtype=torch.int32),
        torch.zeros((T, L_t + 1), dtype=torch.int32), rr2, lr2,
        *_t(qs, ts, q, tlen, t_slot, pair_ok), pa2.tbeg, pa2.tend, L_t=L_t,
        S=S, W=W)
    assert int(np.asarray(want_c).sum()) > 100
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_run_ref_sam_equals_jax(tmp_path):
    """The 20 kb contig and 8 reads of tests/test_ref.py and its junk read,
    mapped at align_band 4096: the same SAM bytes."""
    genome = random_genome(20000, seed=82)
    ref = str(tmp_path / "genome.fasta")
    write_fasta(ref, [("chr2", genome)])
    db, _ = simulate_reads(genome, 8, mean_len=2000, min_len=1000, seed=84,
                           error_rate=0.08)
    seqs = [(f"c2_{i}", db.read(i)) for i in range(db.n_reads)]
    seqs.append(("junk", random_genome(1500, seed=99)))
    reads = str(tmp_path / "reads.fasta")
    write_fasta(reads, seqs)
    opts = dict(num_candidates=8, num_extend=3, min_align_size=400,
                kmer_size=10, scan_stride=5, scan_batch=16, extend_batch=32,
                align_segment=128, align_band=W)
    got, want = str(tmp_path / "port.sam"), str(tmp_path / "jax.sam")
    stats = port_ref.run_ref(reads, ref, got, str(tmp_path / "wp"),
                             port_ref.RefOptions(output_format="sam",
                                                 **opts), device="cpu")
    ref_ref.run_ref(reads, ref, want, str(tmp_path / "wj"),
                    ref_ref.RefOptions(output_format="sam", **opts))
    with open(got, "rb") as fh, open(want, "rb") as gh:
        assert fh.read() == gh.read()
    assert stats.mapped == len(seqs) - 1
