"""Port aligner (mecat_tpu_torch.ops.align) vs the JAX package: bit equality.

The plain DP version must equal ``banded_dp_segment`` + ``pick_end_local``
and the segmented extension must equal ``extend_pair_batch`` on every
``PairAlignment`` field.  The Hopper kernel is held against the plain
version in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from mecat_tpu.ops import align as ref
from mecat_tpu.utils.sim import mutate
from mecat_tpu_torch.ops import align as port
from mecat_tpu_torch.ops import dp_kernel
from mecat_tpu_torch.testing import dp_inputs


def _ref_best(q, tpad, tmax, seg_q, W):
    half = W // 2
    rows, _ = ref.banded_dp_segment(jnp.asarray(q),
                                    jnp.asarray(tpad[:, half:]),
                                    jnp.asarray(tmax), W)
    return [np.asarray(x) for x in ref.pick_end_local(
        rows, jnp.asarray(seg_q), jnp.asarray(tmax), W)]


@pytest.mark.parametrize("S,W", [(128, 64), (512, 128)])
def test_dp_segment_plain_matches_jax(S, W):
    q, tpad, tmax, seg_q, _ = dp_inputs(S, W, 48, seed=S + W)
    seg_q[4] = S // 3                  # endpoint restricted to early rows
    want = _ref_best(q, tpad, tmax, seg_q, W)
    got = port.dp_segment_best_plain(
        *(torch.as_tensor(a) for a in (q, tpad, tmax, seg_q)),
        torch.ones(48, dtype=torch.bool), S, W)
    for name, g, w in zip(("r", "w", "j", "d", "ind"), got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    # lanes 11 (tmax=-1) and 13 (seg_q=-1) have no valid cell and take
    # pick_end_local's all-masked argmax; lane 7 (tmax=0, seg_q=0) keeps
    # exactly one valid cell, (r=0, j=0)
    r, w, j, d, _ = got
    assert (r[[7, 11, 13]] == 0).all() and (j[7] == 0) and (d[7] == 0)
    assert (w[[11, 13]] == 0).all() and (d[[11, 13]] == port.INF).all()


def test_dp_segment_plain_inactive_record():
    S, W = 128, 64
    q, tpad, tmax, seg_q, _ = dp_inputs(S, W, 16, seed=9)
    active = np.ones(16, bool)
    active[[0, 5, 6]] = False
    args = [torch.as_tensor(a) for a in (q, tpad, tmax, seg_q)]
    masked = port.dp_segment_best_plain(*args, torch.as_tensor(active), S, W)
    full = port.dp_segment_best_plain(*args, torch.ones(16, dtype=torch.bool),
                                      S, W)
    for m, f in zip(masked, full):
        assert torch.equal(m[active], f[active])
    r, w, j, d, ind = (x[~torch.as_tensor(active)] for x in masked)
    assert (r == 0).all() and (w == W // 2).all() and (j == 0).all()
    assert (d == port.INF).all() and (ind == 0).all()


def test_dp_segment_best_dispatches_on_tensor_device():
    S, W = 128, 64
    args = [torch.as_tensor(a) for a in dp_inputs(S, W, 8, seed=3)]
    before = dp_kernel.LAUNCHES
    got = port.dp_segment_best(*args, S, W)
    want = port.dp_segment_best_plain(*args, S, W)
    assert dp_kernel.LAUNCHES == before      # CPU tensors: plain version
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):          # the kernel takes CUDA only
        dp_kernel.dp_segment_best_cuda(*args, S, W)


def pair_inputs(n, L, seed):
    """Query/target pairs around a shared source with seeds near the true
    diagonal, plus edge lanes: seed at 0 and at the end, empty query, a
    seed far off the diagonal, a random (junk) target, and a target longer
    than its row."""
    rng = np.random.default_rng(seed)
    q = np.zeros((n, L), np.uint8)
    t = np.zeros((n, L), np.uint8)
    qlen = np.zeros(n, np.int32)
    tlen = np.zeros(n, np.int32)
    qseed = np.zeros(n, np.int32)
    tseed = np.zeros(n, np.int32)
    for b in range(n):
        m = int(rng.integers(L // 3, L * 3 // 4))
        src = rng.integers(0, 4, m, dtype=np.uint8)
        a = mutate(src, rng, 0.03, 0.06, 0.03)[:L]
        c = mutate(src, rng, 0.03, 0.06, 0.03)[:L]
        if b == 5:
            c = rng.integers(0, 4, len(c), dtype=np.uint8)
        q[b, :len(a)], t[b, :len(c)] = a, c
        qlen[b], tlen[b] = len(a), len(c)
        s = int(rng.integers(0, len(a)))
        qseed[b] = s
        tseed[b] = min(int(s * len(c) / len(a)), len(c) - 1)
    qseed[1], tseed[1] = 0, 0
    qseed[2], tseed[2] = qlen[2], tlen[2] - 1
    qlen[3] = 0
    qseed[3] = 0
    tseed[4] = (tseed[4] + tlen[4] // 2) % tlen[4]
    # a target longer than its row (a truncated target window): the seed
    # lies past the row, so the reverse direction starts at a negative
    # offset, which lax.dynamic_slice wraps before it clamps
    tlen[6] = L + 300
    tseed[6] = L + 100
    return q, t, qlen, tlen, qseed, tseed


def test_slice_rows_matches_vmapped_dynamic_slice():
    import jax

    rows = np.arange(6 * 40, dtype=np.int32).reshape(6, 40) % 251
    starts = np.array([-50, -7, -1, 0, 31, 45], np.int32)
    want = jax.vmap(lambda r, o: jax.lax.dynamic_slice(r, (o,), (9,)))(
        jnp.asarray(rows), jnp.asarray(starts))
    got = port._slice_rows(torch.as_tensor(rows), torch.as_tensor(starts), 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("S,W,max_segs", [(128, 64, 40), (512, 128, 8)])
def test_extend_pair_batch_matches_jax(S, W, max_segs):
    args = pair_inputs(16, 2048, seed=S)
    want = ref.extend_pair_batch(*(jnp.asarray(a) for a in args), S=S, W=W,
                                 max_segs=max_segs)
    got = port.extend_pair_batch(*(torch.as_tensor(a) for a in args), S=S,
                                 W=W, max_segs=max_segs)
    assert int(got.n_segs.sum()) > 16
    for name, g, w in zip(want._fields, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)

