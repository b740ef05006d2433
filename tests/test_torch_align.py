"""Port aligner (mecat_tpu_torch.ops.align) vs the JAX package: bit equality.

The plain DP version must equal ``banded_dp_segment`` + ``pick_end_local``
and the segmented extension must equal ``extend_pair_batch`` on every
``PairAlignment`` field.  The Hopper kernel is held against the plain
version in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread is as fast, and several test workers share the cores
torch.set_num_threads(1)
jnp = pytest.importorskip("jax.numpy")

from mecat_tpu.ops import align as ref
from mecat_tpu_torch.ops import align as port
from mecat_tpu_torch.ops import dp_kernel
from mecat_tpu_torch.testing import dp_inputs, pair_inputs


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

