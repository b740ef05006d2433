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
from mecat_tpu_torch.ops.dp_kernel import BAND_MAX
from mecat_tpu_torch.testing import (BLOCK_W, dp_inputs, dp_inputs_full,
                                     dp_segment_best_wavefront,
                                     move_rows_ring)

NAMES = ("r", "w", "j", "d", "ind")


def _readable(moves, r_best, S):
    row = torch.arange(1, S + 1)[None, :, None]
    return torch.where(row <= r_best[:, None, None], moves, 0)


@pytest.mark.parametrize("S,W", [(64, 64), (128, 64), (256, 128), (64, 16),
                                 (96, 48), (128, 96), (128, 160),
                                 (128, 208), (128, 256), (64, 272),
                                 (64, 384), (48, 512), (48, 528),
                                 (48, 1024), (48, 1040), (48, 2048),
                                 (48, 3088), (48, 4096), (48, 6160),
                                 (40, BAND_MAX)])
def test_wavefront_matches_plain(S, W):
    """dp_inputs carries the edge lanes: tmax / seg_q of 0 and -1, inactive
    lanes; lane 4 has its endpoint restricted to early rows.  Past 512 the
    lane is a warp a 512-cell slice (the border exchange, the slices' move
    rings, the reduction across slices): 528 adds a slice of 16 real cells,
    1040 a third, 1024 and 2048 are whole slices; 32 lanes there keep every
    kind of edge lane.  Past 3072 the lane is a cluster of blocks (the
    exchange across a block border, each block's staged windows, the
    reduction over the blocks in rank order): 3088 two blocks of four
    slices, the last one padding, 4096 two of four whole ones, 6160 three
    of five, BAND_MAX eight of six; 21 lanes there keep every kind of edge
    lane, fewer as the model takes a step a band cell."""
    n = 100 if W <= 512 else 32 if W <= BLOCK_W else 21
    q, tpad, tmax, seg_q, active = dp_inputs(S, W, n, seed=3 * S + W)
    seg_q[4] = S // 3
    args = [torch.as_tensor(a) for a in (q, tpad, tmax, seg_q, active)]
    got = dp_segment_best_wavefront(*args, S, W, want_moves=True)
    want = port.dp_segment_best_plain(*args, S, W, want_moves=True)
    for name, g, w in zip(NAMES, got[1:], want[1:]):
        assert g.dtype == torch.int32, name
        assert torch.equal(g, w), name
    r_best = got[1]
    assert int((r_best > 0).sum()) > 0.8 * n
    assert torch.equal(_readable(got[0], r_best, S),
                       _readable(want[0], r_best, S))
    assert not bool(got[0][~args[4]].any())   # an inactive lane writes none
    # every row up to the last computed equals the plain version's
    last = torch.minimum(args[3].clamp(max=S), args[2] + W // 2)
    last = torch.where(args[2] < 0, 0, last).clamp(min=0)
    row = torch.arange(1, S + 1)[None, :, None]
    assert torch.equal(got[0], torch.where(
        (row <= last[:, None, None]) & args[4][:, None, None], want[0], 0))
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


def _packed(codes, last, W):
    words = np.zeros((codes.shape[0], W // 16), np.int64)
    for c in range(16):
        words |= codes[:, c::16] << (2 * c)
    words[last:] = 0
    return (words & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("W", list(range(16, 513, 16)) + [
    528, 1024, 1040, 2048, 3088, 4096, 6160, BAND_MAX])
def test_move_ring_assembles_every_row_at_every_band(W):
    """The kernel's move bytes: nibbles joined across iterations and
    threads, a ring of 128 rows (160 at W > 192, up to 288 at W > 448)
    flushed every 32 rows, the rest after the last row and zeros past it,
    for each band width the kernels take up to 512, at lasts around the
    flush and ring boundaries; past 512 a ring of 288 rows for each warp's
    slice, flushed on the slice's own schedule, and partial slices (528,
    1040) written word by word; past 3072 the slices of every block of a
    cluster lane, 3088's padding slice writing nothing."""
    S = 512
    rng = np.random.default_rng(W)
    for last in (0, 1, 31, 32, 33, 127, 160, 161, 287, 288, 289, 300, S):
        codes = rng.integers(0, 4, (S, W))
        np.testing.assert_array_equal(move_rows_ring(codes, last, S, W),
                                      _packed(codes, last, W),
                                      err_msg=f"last={last}")
