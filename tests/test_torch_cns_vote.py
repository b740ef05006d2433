"""The port's consensus vote (mecat_tpu_torch.ops.consensus_device) vs the
JAX package: exact equality of ``call_tables`` on seeded random tag tables
full of ties, with the default vote and with the window-pooled insertion
rule on; ``split_called``; and the float32 pair gates of the cns chunk on
pairs that sit on the thresholds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread is as fast, and several test workers share the cores
torch.set_num_threads(1)
jnp = pytest.importorskip("jax.numpy")

from mecat_tpu.ops import consensus as ref_cons
from mecat_tpu.ops import consensus_device as ref
from mecat_tpu_torch.ops import consensus as port_cons
from mecat_tpu_torch.ops import consensus_device as port
from mecat_tpu_torch.pipeline.cns import _keep_pairs

D1 = 16


def _tables(seed, T=4, L=160, depth=9):
    """Random tag tables: small counts (so plurality ties are common),
    homopolymer-rich templates, one row without support, one short row."""
    rng = np.random.default_rng(seed)
    template = rng.integers(0, 4, (T, L)).astype(np.uint8)
    runs = rng.random((T, L)) < 0.45          # extend the previous letter
    for i in range(1, L):
        template[:, i] = np.where(runs[:, i], template[:, i - 1],
                                  template[:, i])
    tlen = np.array([L, L - 17, L // 2, L][:T], np.int32)
    counts = rng.integers(0, 4, (T, L, D1, 5)).astype(np.int32)
    # most votes agree with the template; GAP and insertions stay sparse
    counts[:, :, 0, :] += (depth * (np.arange(5)[None, None, :]
                                    == template[:, :, None])).astype(np.int32)
    counts[:, :, 0, 4] *= rng.integers(0, 4, (T, L)).astype(np.int32)
    counts[:, :, 1:, :] *= (rng.random((T, L, D1 - 1, 1)) < 0.25)
    counts[:, :, 1:, 4] = 0
    counts[:, :, 3:, :] //= 3
    cov_diff = np.zeros((T, L + 1), np.int32)
    for t in range(T):
        for k in range(depth + 3):
            a, b = sorted(rng.integers(0, L + 1, 2))
            if k % 2:                         # every other span is long
                a, b = a // 3, L - (L - b) // 3
            cov_diff[t, a] += 1
            cov_diff[t, b] -= 1
    has = np.ones(T, bool)
    has[-1] = False
    return counts, cov_diff, template, tlen, has


VOTES = {
    "default": None,
    "window": dict(del_bias100=50, ins_bias100=70, pool_min_cov=5,
                   pool_min_cov_ins=5, win_radius=4, win_mass_frac100=40,
                   win_peak_frac100=20),
    "window_loose": dict(del_bias100=65, ins_bias100=60, pool_min_cov=2,
                         pool_min_cov_ins=2, win_radius=2,
                         win_mass_frac100=10, win_peak_frac100=5),
}


@pytest.mark.parametrize("vote", sorted(VOTES))
@pytest.mark.parametrize("seed,min_cov", [(1, 4), (2, 1), (3, 6)])
def test_call_tables_matches_jax(vote, seed, min_cov):
    counts, cov_diff, template, tlen, has = _tables(seed)
    kw = VOTES[vote]
    want_emit, want_ok = ref.call_tables(
        jnp.asarray(counts), jnp.asarray(cov_diff), jnp.asarray(template),
        jnp.asarray(tlen), jnp.asarray(has), jnp.int32(min_cov),
        vote=ref_cons.VoteParams(**kw) if kw else None)
    got_emit, got_ok = port.call_tables(
        torch.as_tensor(counts.copy()), torch.as_tensor(cov_diff),
        torch.as_tensor(template), torch.as_tensor(tlen),
        torch.as_tensor(has), min_cov,
        vote=port_cons.VoteParams(**kw) if kw else None)
    want_emit = np.asarray(want_emit)
    assert got_emit.dtype == torch.int32 and got_ok.dtype == torch.bool
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(got_emit.numpy(), want_emit)
    # the tables really exercise the rules: bases, deletions and insertions
    # are emitted, and the unsupported row emits nothing
    assert (want_emit[:-1, :, 0] >= 0).sum() > 100
    assert (want_emit[:, :, 1:] >= 0).sum() > 5
    assert (want_emit[-1] == -1).all()


def test_window_rule_binds():
    counts, cov_diff, template, tlen, has = _tables(2)
    args = lambda: (torch.as_tensor(counts.copy()), torch.as_tensor(cov_diff),
                    torch.as_tensor(template), torch.as_tensor(tlen),
                    torch.as_tensor(has), 1)
    off, _ = port.call_tables(*args())
    on, _ = port.call_tables(
        *args(), vote=port_cons.VoteParams(**VOTES["window_loose"]))
    assert not torch.equal(off, on)


def test_call_tables_adds_self_votes_in_place():
    counts, cov_diff, template, tlen, has = _tables(4)
    c = torch.as_tensor(counts.copy())
    port.call_tables(c, torch.as_tensor(cov_diff), torch.as_tensor(template),
                     torch.as_tensor(tlen), torch.as_tensor(has), 4)
    added = c.numpy() - counts
    assert added[:, :, 1:].sum() == 0
    want = ((np.arange(160)[None, :] < tlen[:, None]) & has[:, None])
    np.testing.assert_array_equal(added[:, :, 0, :].sum(axis=2), want)


def test_first_argmax_takes_the_first_of_equal_maxima():
    x = np.array([[3, 3, 1, 3], [0, 0, 0, 0], [1, 2, 2, 0], [0, 1, 0, 1]],
                 np.int32)
    got = port._first_argmax(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(x), 1)))
    np.testing.assert_array_equal(got.numpy(), [0, 0, 1, 1])


def test_vote_params_defaults_equal_reference():
    assert tuple(port_cons.default_vote_params()) == \
        tuple(ref_cons.VoteParams(65, 60, 5, 8))
    assert port_cons.VoteParams._fields == ref_cons.VoteParams._fields
    assert port_cons.GAP == ref_cons.GAP


@pytest.mark.parametrize("min_length", [1, 12])
def test_split_called_matches_reference(min_length):
    rng = np.random.default_rng(6)
    L, k = 90, 3
    emit = rng.integers(-1, 4, (L, k)).astype(np.int8)
    emit[:, 2] = -1
    cov_ok = rng.random(L) < 0.9
    emit[~cov_ok] = -1
    want = ref.split_called(emit, cov_ok, 80, min_length)
    got = port.split_called(emit, cov_ok, 80, min_length)
    assert len(got) == len(want) and len(want) >= 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert port.split_called(np.full((L, k), -1, np.int8), cov_ok, 80, 1) == []


def test_pair_gates_are_float32_on_the_thresholds():
    """ratio = int32 / int32 in float32 against the float32 threshold: 9/10
    passes 0.9 (in float64 the float32 quotient would fall just short), and
    identity 70.0 passes 70.0; one step below either fails."""
    i32 = lambda *v: np.array(v, np.int32)
    qbeg = i32(0, 0, 0, 0, 0, 0)
    qend = i32(9, 899, 9, 9, 9, 9)          # aligned query span
    qs_c = i32(5, 500, 5, 5, 5, 5)
    ts = i32(5, 500, 5, 5, 5, 5)
    full = i32(10, 1000, 10, 10, 10, 10)    # extent = 5 + 5, 500 + 500
    tlen = full.copy()
    tbeg = i32(0, 0, 0, 0, 0, 0)
    tend = i32(9, 899, 9, 9, 7, 9)          # lane 4 fails the span gate
    identity = np.array([70.0, 99.0, np.nextafter(np.float32(70.0),
                                                  np.float32(0)),
                         99.0, 99.0, 99.0], np.float32)
    real = np.array([1, 1, 1, 1, 1, 0], bool)
    kw = dict(min_identity=70.0, min_align_size=8, min_mapping_ratio=0.9)
    extent = (jnp.minimum(qs_c, ts) + jnp.minimum(full - qs_c, tlen - ts))
    ratio = (jnp.asarray(qend) - jnp.asarray(qbeg)) / jnp.maximum(1, extent)
    want = (jnp.asarray(real) & (jnp.asarray(identity) >= kw["min_identity"])
            & ((jnp.asarray(tend) - jnp.asarray(tbeg))
               >= kw["min_align_size"])
            & (ratio >= kw["min_mapping_ratio"]))
    got = _keep_pairs(*(torch.as_tensor(a) for a in (
        qbeg, qend, tbeg, tend, identity, real, qs_c, ts, full, tlen)), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  [True, False, False, True, False, False])
    assert np.float64(np.float32(9) / np.float32(10)) < 0.9   # the trap
