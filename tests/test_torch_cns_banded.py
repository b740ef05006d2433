"""Banded tag emission of the port vs the JAX package: exact equality.

``banded_accumulate_tags`` must give the same ``counts`` and ``cov_diff`` as
the JAX function on the same piles, both when it is fed the port's own row
walks and when it is fed the JAX package's; and one whole cns chunk with
window-clipped supports (support reads longer than the seed-centred window)
must give the same ``counts``, ``cov_diff`` and ``has`` for both
orientations.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread is as fast, and several test workers share the cores
torch.set_num_threads(1)
jnp = pytest.importorskip("jax.numpy")

from mecat_tpu import constants as ref_C
from mecat_tpu.ops import align as ref_align
from mecat_tpu.ops import consensus_banded as ref
from mecat_tpu.pipeline import cns as ref_cns
from mecat_tpu_torch.ops import align as port_align
from mecat_tpu_torch.ops import consensus_banded as port
from mecat_tpu_torch.pipeline import cns as port_cns
from mecat_tpu_torch.utils.sim import mutate, random_genome

D1 = ref_C.MAX_INS_DELTA + 1


def _pile(S, W, G, B, L_t, L_s, T, err, seed, ins_heavy=False):
    """Supports mutated from slices of one template, seeds near the true
    diagonal (the pile of tests/test_cns_banded.py)."""
    rng = np.random.default_rng(seed)
    tmpl = random_genome(L_t - int(rng.integers(1, 40)), seed=seed + 1)
    q = np.zeros((B, L_s), np.uint8)
    t = np.zeros((B, L_t), np.uint8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    qs = np.zeros(B, np.int32)
    ts = np.zeros(B, np.int32)
    t_slot = rng.integers(0, T, size=B).astype(np.int32)
    for b in range(B):
        a = int(rng.integers(0, max(len(tmpl) - 50, 1)))
        bb = int(rng.integers(a + 30, len(tmpl) + 1))
        pins = err * (3.0 if ins_heavy else 1.0)
        sup = mutate(tmpl[a:bb], rng, err, pins, err)[:L_s]
        t[b, :len(tmpl)] = tmpl
        q[b, :len(sup)] = sup
        qlen[b], tlen[b] = len(sup), len(tmpl)
        mid = int(rng.integers(0, max(len(sup) - 1, 1)))
        qs[b] = mid
        ts[b] = min(max(a + mid, 0), len(tmpl) - 1)
    return q, t, qlen, tlen, qs, ts, t_slot


def _tt(a):
    return torch.as_tensor(np.array(a))


def _rows_to_torch(rows):
    return tuple(_tt(x) for x in rows)


@pytest.mark.parametrize("left", [False, True])
def test_run_deltas_matches_jax(left):
    rng = np.random.default_rng(5)
    mv = rng.choice([-1, 0, 1, 2, 2, 2], size=(3, 7, 40)).astype(np.int32)
    h = rng.choice([0, 0, 0, 1, 3], size=(3, 7, 40)).astype(np.int32)
    want = ref.run_deltas(jnp.asarray(mv), jnp.asarray(h), left=left)
    got = port.run_deltas(_tt(mv), _tt(h), left=left)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


PILES = [
    dict(S=64, W=32, G=4, B=32, L_t=256, L_s=320, T=8, err=0.12, seed=11),
    dict(S=64, W=32, G=6, B=48, L_t=320, L_s=512, T=6, err=0.15, seed=12,
         ins_heavy=True),
    dict(S=32, W=32, G=8, B=32, L_t=300, L_s=400, T=6, err=0.2, seed=40,
         ins_heavy=True),
]


@pytest.mark.parametrize("kw", PILES)
@pytest.mark.parametrize("rows_from", ["port", "jax"])
def test_banded_accumulate_tags_matches_jax(kw, rows_from):
    S, W, G, T, L_t = kw["S"], kw["W"], kw["G"], kw["T"], kw["L_t"]
    q, t, qlen, tlen, qs, ts, t_slot = _pile(**kw)
    pa, rr, lr = ref_align.extend_pair_batch_rows(
        *(jnp.asarray(a) for a in (q, t, qlen, tlen, qs, ts)),
        S=S, W=W, max_segs=G, max_segs_left=G)
    pair_ok = np.asarray((pa.identity >= 60.0) & ((pa.tend - pa.tbeg) >= 20))
    assert 3 < pair_ok.sum()
    want_c, want_v = ref.banded_accumulate_tags(
        jnp.zeros((T, L_t, D1, 5), jnp.int32),
        jnp.zeros((T, L_t + 1), jnp.int32), rr, lr, jnp.asarray(qs),
        jnp.asarray(ts), jnp.asarray(q), jnp.asarray(tlen),
        jnp.asarray(t_slot), jnp.asarray(pair_ok), pa.tbeg, pa.tend,
        L_t=L_t, S=S, W=W)

    if rows_from == "port":
        pa2, rr2, lr2 = port_align.extend_pair_batch_rows(
            *(_tt(a) for a in (q, t, qlen, tlen, qs, ts)),
            S=S, W=W, max_segs=G, max_segs_left=G)
        np.testing.assert_array_equal(pa2.identity.numpy(),
                                      np.asarray(pa.identity))
        tbeg, tend = pa2.tbeg, pa2.tend
    else:
        rr2, lr2 = _rows_to_torch(rr), _rows_to_torch(lr)
        tbeg, tend = _tt(pa.tbeg), _tt(pa.tend)
    counts = torch.zeros((T, L_t, D1, 5), dtype=torch.int32)
    cov = torch.zeros((T, L_t + 1), dtype=torch.int32)
    got_c, got_v = port.banded_accumulate_tags(
        counts, cov, rr2, lr2, _tt(qs), _tt(ts), _tt(q), _tt(tlen),
        _tt(t_slot), _tt(pair_ok), tbeg, tend, L_t=L_t, S=S, W=W)
    assert got_c is counts and got_v is cov            # tallied in place
    assert got_c.dtype == torch.int32 and got_v.dtype == torch.int32
    assert int(np.asarray(want_c).sum()) > 100
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    # a second chunk adds on top of the first (duplicates in the scatters)
    port.banded_accumulate_tags(
        counts, cov, rr2, lr2, _tt(qs), _tt(ts), _tt(q), _tt(tlen),
        _tt(t_slot), _tt(pair_ok), tbeg, tend, L_t=L_t, S=S, W=W)
    np.testing.assert_array_equal(counts.numpy(), 2 * np.asarray(want_c))
    np.testing.assert_array_equal(cov.numpy(), 2 * np.asarray(want_v))


def test_global_planes_match_jax():
    kw = PILES[1]
    S, W, G, L_t = kw["S"], kw["W"], kw["G"], kw["L_t"]
    q, t, qlen, tlen, qs, ts, _ = _pile(**kw)
    _, rr, lr = ref_align.extend_pair_batch_rows(
        *(jnp.asarray(a) for a in (q, t, qlen, tlen, qs, ts)),
        S=S, W=W, max_segs=G, max_segs_left=G)
    want = ref.banded_global_planes(rr, lr, jnp.asarray(q), jnp.asarray(qs),
                                    jnp.asarray(ts), L_t=L_t, S=S, W=W)
    got = port.banded_global_planes(_rows_to_torch(rr), _rows_to_torch(lr),
                                    _tt(q), _tt(qs), _tt(ts),
                                    L_t=L_t, S=S, W=W)
    for name, g, w in zip(("val0", "ipack", "icnt"), got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert int((np.asarray(want[2]) > 0).sum()) > 5    # insertions landed


def test_cns_chunk_clipped_windows_matches_jax():
    """Window-clipped supports (qlen > L_s, w0 > 0), both orientations: one
    chunk's counts, cov_diff and has."""
    import jax

    P, L_t, L_s = 16, 1024, 2048
    S, W, G = 256, 64, 6
    T = 4
    rng = np.random.default_rng(9)
    tmpl = random_genome(L_t - 40, seed=43)
    sup_list = []
    for p in range(P):
        a = int(rng.integers(0, len(tmpl) // 2))
        b = int(rng.integers(a + 500, len(tmpl) + 1))
        core = mutate(tmpl[a:b], rng, 0.04, 0.05, 0.04)
        lf = random_genome(int(rng.integers(1500, 2500)), seed=1000 + p)
        rf = random_genome(int(rng.integers(1500, 2500)), seed=2000 + p)
        sup_list.append((np.concatenate([lf, core, rf]),
                         len(lf) + (b - a) // 2, a + (b - a) // 2))
    qlen = np.array([len(s[0]) for s in sup_list], np.int32)
    assert qlen.max() > L_s  # windows really clip
    reads = [tmpl] + [s[0] for s in sup_list]
    lens_v = np.array([len(r) for r in reads], np.int64)
    starts_v = np.concatenate([[0], np.cumsum(lens_v)[:-1]])
    n_bases = int(lens_v.sum())
    fwd = np.concatenate(reads)
    vol_cat = np.concatenate(
        [fwd, (3 - fwd[::-1]), np.zeros(L_s + 1024, np.uint8)])
    s_ids = np.arange(1, P + 1, dtype=np.int32)
    t_ids = np.zeros(P, np.int32)
    t_slot = (np.arange(P) % T).astype(np.int32)
    tlen = np.full(P, len(tmpl), np.int32)
    qs = np.array([s[1] for s in sup_list], np.int32)
    ts = np.array([min(s[2], len(tmpl) - 1) for s in sup_list], np.int32)
    real = np.ones(P, bool)
    real[-1] = False                       # a padding lane votes nothing
    kw = dict(L_s=L_s, L_t=L_t, S=S, W=W, max_segs=G, max_segs_left=G,
              min_identity=60.0, min_align_size=200, min_mapping_ratio=0.05)
    ref_chunk = jax.jit(ref_cns.make_cns_chunk(**kw, tags="banded"))
    port_chunk = port_cns.make_cns_chunk(**kw)
    for sd in (0, 1):
        sdir = np.full(P, sd, np.int32)
        want = ref_chunk(
            jnp.zeros((T, L_t, D1, 5), jnp.int32),
            jnp.zeros((T, L_t + 1), jnp.int32), jnp.zeros(T, bool),
            jnp.asarray(vol_cat), jnp.asarray(starts_v.astype(np.int32)),
            jnp.asarray(lens_v.astype(np.int32)), np.int32(n_bases),
            *(jnp.asarray(a) for a in (s_ids, t_ids, qlen, tlen, qs, ts,
                                       t_slot, sdir, real)))
        tally = []
        got = port_chunk(
            torch.zeros((T, L_t, D1, 5), dtype=torch.int32),
            torch.zeros((T, L_t + 1), dtype=torch.int32),
            torch.zeros(T, dtype=torch.bool), _tt(vol_cat), _tt(starts_v),
            _tt(lens_v.astype(np.int32)), n_bases,
            *(_tt(a) for a in (s_ids, t_ids, qlen, tlen, qs, ts, t_slot,
                               sdir, real)), tally=tally)
        if sd == 0:
            assert int(np.asarray(want[0]).sum()) > 10_000  # real tag mass
        for name, g, w in zip(("counts", "cov_diff", "has"), got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{name} sdir={sd}")
        issued, useful = tally[0]
        assert 0 < int(useful) <= issued <= 2 * G * P
