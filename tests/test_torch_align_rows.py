"""The move-writing side of the port's aligner vs the JAX package: equality.

The plain DP version's packed moves must equal ``banded_dp_segment``'s after
a transpose ([B, S, W/16] here, [S, W/16, B] there), ``traceback_rows`` must
give the same row walk, and ``extend_pair_batch_rows`` the same
``PairAlignment``, ``ok`` flags and, where ``ok`` holds, row outputs.  The
Hopper kernel is held against the plain version in tests/test_torch_cuda.py.
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


def _ref_segment(q, tpad, tmax, seg_q, W):
    rows, moves = ref.banded_dp_segment(
        jnp.asarray(q), jnp.asarray(tpad[:, W // 2:]), jnp.asarray(tmax), W)
    best = ref.pick_end_local(rows, jnp.asarray(seg_q), jnp.asarray(tmax), W)
    return moves, best


@pytest.mark.parametrize("S,W", [(128, 64), (64, 32), (256, 128)])
def test_plain_moves_match_jax(S, W):
    q, tpad, tmax, seg_q, _ = dp_inputs(S, W, 40, seed=S + W)
    want_moves, want = _ref_segment(q, tpad, tmax, seg_q, W)
    got = port.dp_segment_best_plain(
        *(torch.as_tensor(a) for a in (q, tpad, tmax, seg_q)),
        torch.ones(40, dtype=torch.bool), S, W, want_moves=True)
    moves = got[0]
    assert moves.dtype == torch.int32 and moves.shape == (40, S, W // 16)
    # every word of every row, invalid cells and the sign-bit slot included
    np.testing.assert_array_equal(
        moves.numpy(), np.asarray(want_moves).transpose(2, 0, 1))
    assert bool((moves < 0).any())       # slot 15 really reaches the sign bit
    for g, w in zip(got[1:], want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_plain_moves_inactive_lanes_are_zero_and_dispatch_is_by_device():
    S, W = 128, 64
    args = [torch.as_tensor(a) for a in dp_inputs(S, W, 128, seed=5)]
    active = args[4]
    assert not bool(active.all())
    before = dp_kernel.LAUNCHES_MOVES
    got = port.dp_segment_best(*args, S, W, want_moves=True)
    assert dp_kernel.LAUNCHES_MOVES == before   # CPU tensors: plain version
    want = port.dp_segment_best_plain(*args, S, W, want_moves=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not bool(got[0][~active].any())
    assert bool(got[0][active].any())
    counts_only = port.dp_segment_best(*args, S, W)
    for g, w in zip(got[1:], counts_only):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):              # the kernel takes CUDA only
        dp_kernel.dp_segment_best_moves_cuda(*args, S, W)


@pytest.mark.parametrize("S,W", [(128, 64), (128, 32)])
def test_traceback_rows_matches_jax(S, W):
    q, tpad, tmax, seg_q, _ = dp_inputs(S, W, 48, seed=3 * S + W)
    moves, (r_end, w_end, _, d, _) = _ref_segment(q, tpad, tmax, seg_q, W)
    want = ref.traceback_rows(moves, r_end, w_end, W)
    got = port.traceback_rows(
        torch.as_tensor(np.asarray(moves).transpose(2, 0, 1).copy()),
        torch.as_tensor(np.array(r_end)), torch.as_tensor(np.array(w_end)),
        W)
    assert int((np.asarray(d) < port.INF).sum()) > 30
    for name, g, w in zip(("mv", "h", "w_out", "w0"), got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_traceback_rows_vert_out_of_the_last_column():
    """A VERT in the last band column empties the reference's one-hot row,
    which then reads as column 0; the port's integer column must agree on
    such (broken) paths too."""
    S, W, N = 6, 32, 3
    rng = np.random.default_rng(1)
    moves = rng.integers(-(1 << 31), 1 << 31, (N, S, W // 16)).astype(np.int32)
    moves[0, S - 1, -1] = np.int32(-(1 << 31))          # cell 31 = VERT (2)
    r_end = np.array([S, S, S - 2], np.int32)
    w_end = np.array([W - 1, 7, 20], np.int32)
    want = ref.traceback_rows(jnp.asarray(moves.transpose(1, 2, 0)),
                              jnp.asarray(r_end), jnp.asarray(w_end), W)
    got = port.traceback_rows(torch.as_tensor(moves), torch.as_tensor(r_end),
                              torch.as_tensor(w_end), W)
    assert int(np.asarray(want[0])[0, S - 1]) == port.MOVE_VERT
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("S,W,max_segs,max_segs_left",
                         [(128, 64, 24, 0), (128, 64, 16, 8),
                          (256, 128, 8, 8)])
def test_extend_pair_batch_rows_matches_jax(S, W, max_segs, max_segs_left):
    args = pair_inputs(12, 1536, seed=S + max_segs)
    want_pa, want_r, want_l = ref.extend_pair_batch_rows(
        *(jnp.asarray(a) for a in args), S=S, W=W, max_segs=max_segs,
        max_segs_left=max_segs_left)
    got_pa, got_r, got_l = port.extend_pair_batch_rows(
        *(torch.as_tensor(a) for a in args), S=S, W=W, max_segs=max_segs,
        max_segs_left=max_segs_left)
    for name, g, w in zip(want_pa._fields, got_pa, want_pa):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    n_ok = 0
    for side, got, want in (("right", got_r, want_r), ("left", got_l, want_l)):
        want = [np.asarray(x) for x in want]
        got = [x.numpy() for x in got]
        G = got[0].shape[0]
        assert 1 <= G <= want[0].shape[0]
        ok = want[6]
        # the port stops once no lane is active: the reference's remaining
        # segments are all not ok
        assert not ok[G:].any(), side
        np.testing.assert_array_equal(got[6], ok[:G], err_msg=side)
        n_ok += int(ok.sum())
        for name, g, w in zip(("mv", "h", "wo", "w0", "qoff", "toff"),
                              got, want):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g[ok[:G]], w[:G][ok[:G]],
                                          err_msg=f"{side} {name}")
    assert n_ok > 24
