"""The move-writing segment loop of both extension directions, lane by lane.

On CUDA tensors ``ops.align._extend_both_with_moves`` is one launch of the
move loop (``csrc/dp_segment.cu``, ``extend_kernel`` with moves): every
direction lane of the 2B-lane batch runs its own segments to its end and
writes each into its slot, and ``ops.align.slots_to_raw`` cuts the slots
to what the host loop of each direction gives.  Here, on the CPU:

* ``extend_moves_plain`` (each lane alone through the plain host loop, in
  the kernel's slots) followed by ``slots_to_raw`` equals the host loop of
  both directions on every slot < G of all six raw arrays and on both
  ExtensionResults, with unequal budgets, at (S, W) = (128, 64) and
  (512, 128) with 1 and 16 segments, on pairs with the edge lanes of
  ``testing.extend_inputs``;
* its slots equal the JAX package's ``_extend_direction_impl(collect_ops=
  True)`` where ``ok`` holds;
* ``rows_from_moves`` / ``ops_from_moves`` on those slots give the JAX
  ``extend_pair_batch_rows`` / ``_with_ops`` results;
* the plain row extension equals the JAX package at band widths 32, 48, 96,
  160, 256, 384 and 512, and the kernels' width check takes exactly the
  multiples of 16 in [16, 512];
* the move loop's wrapper refuses CPU tensors before anything is built.

The kernel is held against the host loop on the card in
tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread is as fast, and several test workers share the
# cores
torch.set_num_threads(1)
jnp = pytest.importorskip("jax.numpy")

from mecat_tpu.ops import align as ref
from mecat_tpu_torch.ops import align as port
from mecat_tpu_torch.ops import cuda_build, dp_kernel
from mecat_tpu_torch.testing import extend_inputs, pair_inputs

#: (S, W) -> the pairs' row width
ROW = {(128, 64): 2560, (512, 128): 2048}
N_PAIRS = 16
#: the left direction's budget for each right one: unequal
LEFT = {1: 2, 16: 5}
IDENT = port.C.MIN_SEGMENT_IDENTITY
RAW = ("moves", "r_end", "w_end", "qoff_before", "toff_before", "ok")


def _pairs(S, W, max_segs):
    return [torch.as_tensor(a) for a in extend_inputs(
        N_PAIRS, ROW[(S, W)], S, seed=S + max_segs + 7)]


def _model(pairs, S, W, max_segs, max_left):
    lanes = port.direction_lanes(*pairs, S, W)
    loop = port.extend_moves_plain(
        *lanes, S=S, W=W, max_segs=max_segs, min_seg_identity=IDENT,
        split=pairs[0].shape[0], max_segs_b=max_left)
    return lanes, loop


@pytest.mark.parametrize("max_segs", [1, 16])
@pytest.mark.parametrize("S,W", list(ROW))
def test_lane_model_equals_the_host_loop_and_jax(S, W, max_segs):
    pairs = _pairs(S, W, max_segs)
    max_left = LEFT[max_segs]
    before = dp_kernel.launches()
    left, right, raw2, G = port._extend_both_with_moves(
        *pairs, S=S, W=W, max_segs=max_segs, min_seg_identity=IDENT,
        max_segs_left=max_left, dp=port.dp_segment_best)
    assert dp_kernel.launches() == before      # CPU tensors: the host loop
    lanes, (final, slots) = _model(pairs, S, W, max_segs, max_left)
    nsegs = final[5]

    # the kernel writes slot k of lane b for k < nsegs[b] only: the model
    # leaves poison in the others, and the cut must not read it
    G_all = slots[0].shape[0]
    assert G_all == max(max_segs, max_left)
    dead = torch.arange(G_all)[:, None] >= nsegs[None, :]
    assert bool((slots[1][dead] == -1).all()) and bool(slots[5][dead].all())
    got_left, got_right, got_raw2, got_G = port.slots_to_raw(
        final, slots, N_PAIRS, W)

    assert got_G == G == max(1, int(nsegs[:N_PAIRS].max()))
    assert raw2[0].shape[0] - G == max(1, int(nsegs[N_PAIRS:].max()))
    for name, g, w in zip(RAW, got_raw2, raw2):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
    for side, g_res, w_res in (("left", got_left, left),
                               ("right", got_right, right)):
        for name, g, w in zip(port.ExtensionResult._fields, g_res, w_res):
            assert torch.equal(g, w), (side, name)
    # edge lanes: no segment for an empty read; where the rows are long
    # enough, lanes at each direction's budget
    assert int(right.n_segs[0]) == int(right.n_segs[1]) == 0
    assert int(left.n_segs.max()) <= max_left
    if max_segs * S < ROW[(S, W)]:
        assert int(right.n_segs.max()) == max_segs
        assert int(left.n_segs.max()) == max_left

    # the JAX package's scan, each direction with its budget, where ok
    n_ok = 0
    for h, budget in ((slice(0, N_PAIRS), max_segs),
                      (slice(N_PAIRS, 2 * N_PAIRS), max_left)):
        res, want = ref._extend_direction_impl(
            *(jnp.asarray(x[h].numpy()) for x in lanes), S=S, W=W,
            max_segs=budget, min_seg_identity=IDENT, collect_ops=True)
        for name, g, w in zip(port.ExtensionResult._fields, final, res):
            np.testing.assert_array_equal(g[h].numpy(), np.asarray(w),
                                          err_msg=name)
        want = [np.asarray(x) for x in want]
        want[0] = want[0].transpose(0, 3, 1, 2)     # [G, S, W/16, B] there
        ok = want[5]
        n = nsegs[h].numpy()
        assert not ok[(np.arange(budget)[:, None] >= n[None, :])].any()
        n_ok += int(ok.sum())
        for name, g, w in zip(RAW, slots, want):
            g = g[:budget, h].numpy()
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g[ok], w[ok], err_msg=name)
    assert n_ok >= N_PAIRS


def _assert_like_jax(got, want, min_ok):
    """The (pa, right, left) of the port equal the JAX package's: the
    PairAlignment, the ok flags, and the per-segment fields where ok."""
    got_pa, got_r, got_l = got
    want_pa, want_r, want_l = want
    for name, g, w in zip(want_pa._fields, got_pa, want_pa):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    n_ok = 0
    for side, got, want in (("right", got_r, want_r), ("left", got_l, want_l)):
        want = [np.asarray(x) for x in want]
        got = [x.numpy() for x in got]
        G = got[0].shape[0]
        ok = want[-1]
        assert 1 <= G <= ok.shape[0] and not ok[G:].any(), side
        np.testing.assert_array_equal(got[-1], ok[:G], err_msg=side)
        n_ok += int(ok.sum())
        for i, (g, w) in enumerate(zip(got[:-1], want[:-1])):
            assert g.dtype == w.dtype, (side, i)
            np.testing.assert_array_equal(g[ok[:G]], w[:G][ok[:G]],
                                          err_msg=f"{side} {i}")
    assert n_ok >= min_ok


@pytest.mark.parametrize("form", ["rows", "ops"])
def test_rows_and_tapes_from_the_slots_equal_jax(form):
    S, W, max_segs, max_left = 128, 64, 12, 5
    args = pair_inputs(12, 1536, seed=41)
    pairs = [torch.as_tensor(a) for a in args]
    _, (final, slots) = _model(pairs, S, W, max_segs, max_left)
    moved = port.slots_to_raw(final, slots, 12, W)
    kw = dict(S=S, W=W, max_segs=max_segs, max_segs_left=max_left)
    if form == "rows":
        got = port.rows_from_moves(pairs[4], pairs[5], S, W, *moved)
        want = ref.extend_pair_batch_rows(*(jnp.asarray(a) for a in args),
                                          **kw)
    else:
        got = port.ops_from_moves(pairs[4], pairs[5], S, W, IDENT, *moved)
        want = ref.extend_pair_batch_with_ops(
            *(jnp.asarray(a) for a in args), **kw)
    _assert_like_jax(got, want, 12)


@pytest.mark.parametrize("W", [32, 48, 96, 160, 256, 384, 512, 528, 1024,
                               2048])
def test_plain_rows_equal_jax_at_every_band(W):
    S = 128 if W <= 256 else 64 if W <= 512 else 32
    args = pair_inputs(12, 1024, seed=W)
    kw = dict(S=S, W=W, max_segs=10)
    got = port.extend_pair_batch_rows(*(torch.as_tensor(a) for a in args),
                                      **kw)
    want = ref.extend_pair_batch_rows(*(jnp.asarray(a) for a in args), **kw)
    _assert_like_jax(got, want, 6)


def test_band_check_takes_the_multiples_of_16_up_to_band_max():
    """Every multiple of 16 up to BAND_MAX, which a cluster of eight blocks
    of six 36 KB move rings a lane sets at 24,576; nothing else, past it or
    not a multiple of 16."""
    assert dp_kernel.BAND_MAX == 24576
    for W in range(16, dp_kernel.BAND_MAX + 1, 16):
        dp_kernel.check_band(W)
    for W in (0, -16, 8, 24, 40, 100, 255, 520, dp_kernel.BAND_MAX + 16):
        with pytest.raises(ValueError, match=str(dp_kernel.BAND_MAX)):
            dp_kernel.check_band(W)


def test_move_loop_wrapper_refuses_cpu_tensors_before_building(monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("the wrapper built the kernel library")

    monkeypatch.setattr(cuda_build, "build", no_build)
    monkeypatch.setattr(dp_kernel, "_lib", None)
    q, t, qlen, tlen, _, _ = extend_inputs(16, 256, 128, seed=3)
    zeros = torch.zeros(16, dtype=torch.int32)
    before = dp_kernel.launches()
    with pytest.raises(ValueError, match="CUDA"):
        dp_kernel.extend_moves_cuda(
            torch.as_tensor(q), torch.as_tensor(t), zeros, zeros,
            torch.as_tensor(qlen), torch.as_tensor(tlen), S=128, W=64,
            max_segs=4, min_seg_identity=0.65, split=8, max_segs_b=2)
    assert dp_kernel.launches() == before
