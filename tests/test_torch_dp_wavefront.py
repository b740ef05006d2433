"""The evaluation order of the Hopper DP kernel, modelled on the CPU.

``mecat_tpu_torch.testing.dp_segment_best_wavefront`` walks a segment the
way ``csrc/dp_segment.cu`` does (anti-diagonal steps, parity classes, the
sequential horizontal term, value-based move codes, a per-band-cell best
with a strict ``>``).  It must equal the plain version, which scans each
row, on all five outputs and on every move word of rows 1..r_best, and the
JAX package's ``banded_dp_segment`` + ``pick_end_local``.  Exact equality.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread is as fast, and several test workers share the cores
torch.set_num_threads(1)

from mecat_tpu_torch.ops import align as port
from mecat_tpu_torch.testing import (dp_inputs, dp_inputs_full,
                                     dp_segment_best_wavefront)

NAMES = ("r", "w", "j", "d", "ind")


def _readable(moves, r_best, S):
    row = torch.arange(1, S + 1)[None, :, None]
    return torch.where(row <= r_best[:, None, None], moves, 0)


@pytest.mark.parametrize("S,W", [(64, 64), (128, 64), (256, 128)])
def test_wavefront_matches_plain(S, W):
    """dp_inputs carries the edge lanes: tmax / seg_q of 0 and -1, inactive
    lanes; lane 4 has its endpoint restricted to early rows."""
    q, tpad, tmax, seg_q, active = dp_inputs(S, W, 100, seed=3 * S + W)
    seg_q[4] = S // 3
    args = [torch.as_tensor(a) for a in (q, tpad, tmax, seg_q, active)]
    got = dp_segment_best_wavefront(*args, S, W, want_moves=True)
    want = port.dp_segment_best_plain(*args, S, W, want_moves=True)
    for name, g, w in zip(NAMES, got[1:], want[1:]):
        assert g.dtype == torch.int32, name
        assert torch.equal(g, w), name
    r_best = got[1]
    assert int((r_best > 0).sum()) > 80
    assert torch.equal(_readable(got[0], r_best, S),
                       _readable(want[0], r_best, S))
    assert not bool(got[0][~args[4]].any())   # an inactive lane writes none
    for g, w in zip(port.traceback_rows(got[0], r_best, got[2], W),
                    port.traceback_rows(want[0], r_best, got[2], W)):
        assert torch.equal(g, w)
    counts = dp_segment_best_wavefront(*args, S, W)
    for g, w in zip(counts, want[1:]):
        assert torch.equal(g, w)


def test_wavefront_zeroes_rows_past_the_last():
    S, W = 64, 64
    q, tpad, tmax, seg_q, active = dp_inputs(S, W, 24, seed=5)
    seg_q[3], tmax[6] = 20, 3
    args = [torch.as_tensor(a) for a in (q, tpad, tmax, seg_q, active)]
    moves = dp_segment_best_wavefront(*args, S, W, want_moves=True)[0]
    assert bool(moves[3, :20].any()) and not bool(moves[3, 20:].any())
    assert not bool(moves[6, 3 + W // 2:].any())


def test_wavefront_full_length_lanes_match_plain():
    S, W = 128, 64
    q, tpad, tmax, seg_q = dp_inputs_full(S, W, 32, seed=8)
    assert (seg_q == S).all() and int(tmax.max()) == S + W // 2
    args = [torch.as_tensor(a) for a in (q, tpad, tmax, seg_q)]
    args.append(torch.ones(32, dtype=torch.bool))
    got = dp_segment_best_wavefront(*args, S, W, want_moves=True)
    want = port.dp_segment_best_plain(*args, S, W, want_moves=True)
    for name, g, w in zip(NAMES, got[1:], want[1:]):
        assert torch.equal(g, w), name
    assert torch.equal(_readable(got[0], got[1], S),
                       _readable(want[0], got[1], S))


def test_wavefront_matches_jax():
    jnp = pytest.importorskip("jax.numpy")
    from mecat_tpu.ops import align as ref

    S, W = 128, 64
    half = W // 2
    q, tpad, tmax, seg_q, _ = dp_inputs(S, W, 48, seed=S + W + 1)
    rows, moves = ref.banded_dp_segment(
        jnp.asarray(q), jnp.asarray(tpad[:, half:]), jnp.asarray(tmax), W)
    want = [np.asarray(x) for x in ref.pick_end_local(
        rows, jnp.asarray(seg_q), jnp.asarray(tmax), W)]
    got = dp_segment_best_wavefront(
        *(torch.as_tensor(a) for a in (q, tpad, tmax, seg_q)),
        torch.ones(48, dtype=torch.bool), S, W, want_moves=True)
    assert len(want) == len(NAMES)
    for name, g, w in zip(NAMES, got[1:], want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    # the JAX package packs [S, W/16, lanes]
    want_moves = torch.as_tensor(np.array(moves)).permute(2, 0, 1)
    assert torch.equal(_readable(got[0], got[1], S),
                       _readable(want_moves, got[1], S))
