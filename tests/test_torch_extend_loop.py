"""The counts-only segment loop of ``ops.align._extend_direction_impl``,
lane by lane.

The segment-loop kernel (``csrc/dp_segment.cu``, ``extend_counts_kernel``)
runs each lane to its own end; the plain version runs the loop over every
lane of a batch at once.  Here, on the CPU: each direction lane extended
alone (a batch of one lane) through the port's plain loop equals the
batched plain loop on every field, ``n_segs`` included, and the batch
equals the JAX package's ``extend_pair_batch``, at (S, W) = (128, 64) and
(512, 128) with 1 and 16 segments, on pairs with the edge lanes of
``testing.extend_inputs``.  The kernel is held against the plain loop on
the card in tests/test_torch_cuda.py.
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
from mecat_tpu_torch.pipeline import ref as port_ref
from mecat_tpu_torch.testing import DpTally, extend_inputs

#: (S, W) -> the pairs' row width: at (128, 64) lanes run 16 segments
ROW = {(128, 64): 2560, (512, 128): 2048}
N_PAIRS = 24


def _pairs(S, W, max_segs):
    return [torch.as_tensor(a) for a in extend_inputs(
        N_PAIRS, ROW[(S, W)], S, seed=S + max_segs)]


@pytest.mark.parametrize("max_segs", [1, 16])
@pytest.mark.parametrize("S,W", list(ROW))
def test_each_lane_alone_equals_the_batch_and_jax(S, W, max_segs):
    pairs = _pairs(S, W, max_segs)
    before = dp_kernel.launches()
    both = port.extend_both_directions(*pairs, S=S, W=W, max_segs=max_segs)
    assert dp_kernel.launches() == before      # CPU tensors: the plain loop
    lanes = port.direction_lanes(*pairs, S, W)
    for i in range(2 * N_PAIRS):
        one, raw = port._extend_direction_impl(
            *(x[i:i + 1] for x in lanes), S=S, W=W, max_segs=max_segs,
            min_seg_identity=port.C.MIN_SEGMENT_IDENTITY)
        assert raw is None
        for name, g, w in zip(port.ExtensionResult._fields, one, both):
            assert g.dtype == torch.int32, name
            assert int(g[0]) == int(w[i]), (name, i)

    got = port.pair_alignment(both, pairs[4], pairs[5])
    want = ref.extend_pair_batch(*(jnp.asarray(a.numpy()) for a in pairs),
                                 S=S, W=W, max_segs=max_segs)
    for name, g, w in zip(want._fields, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)

    # the edge lanes take the paths they are made for (right lanes first)
    right = port.ExtensionResult(*(x[:N_PAIRS] for x in both))
    assert right.n_segs[0] == right.n_segs[1] == 0       # qlen / tlen 0
    assert right.n_segs[7] == 1 and right.q_adv[7] == 0  # identity gate
    m, a = int(right.matches[8]), int(right.align_len[8])
    assert right.q_adv[8] > 0 and a < 32 and m / a < 0.65  # the escape
    if max_segs * S < ROW[(S, W)]:          # the rows are long enough that
        assert int(both.n_segs.max()) == max_segs      # lanes hit the cap


@pytest.mark.parametrize("S,W,max_segs", [(128, 64, 16), (512, 128, 1)])
def test_issued_lane_segments_equal_the_tally(S, W, max_segs):
    """2B * max(n_segs) is what the host loop issues: the count mapping's
    phase A takes from the result equals what a wrapper of the segment
    function counts on the same call."""
    pairs = _pairs(S, W, max_segs)
    tally = DpTally()
    both = port.extend_both_directions(*pairs, S=S, W=W, max_segs=max_segs,
                                       dp=tally)
    assert tally.lane_segs == both.n_segs.numel() * int(both.n_segs.max())
    assert tally.lane_segs > 0

    # mapping's phase-A chunk: a genome window for each read
    rng = np.random.default_rng(S)
    genome = rng.integers(0, 4, 6000, dtype=np.uint8)
    P, L_win, L_q = 12, 2048, 1024
    g0 = rng.integers(0, 6000 - L_win, P).astype(np.int32)
    qlen = rng.integers(S // 2, L_q, P).astype(np.int32)
    qlen[3] = 0
    fwd = np.zeros((P, L_q), np.uint8)
    for b in range(P):
        fwd[b, :qlen[b]] = genome[g0[b] + 100:g0[b] + 100 + qlen[b]]
    fwd[5, ::7] = (fwd[5, ::7] + 1) % 4
    rev = np.ascontiguousarray(3 - fwd[:, ::-1])
    qs = (qlen // 2).astype(np.int32)
    args = [torch.as_tensor(a) for a in (
        fwd, rev, genome, np.arange(P, dtype=np.int32), np.zeros(P, np.int32),
        g0, np.full(P, L_win, np.int32), qlen, qs, qs + 100)]
    kw = dict(L_win=L_win, S=S, W=W, max_segs=max_segs)
    tally = DpTally()
    pa_t, issued_t = port_ref._ref_count_chunk(*args, **kw, dp=tally)
    pa, issued = port_ref._ref_count_chunk(*args, **kw)
    assert int(issued) == int(issued_t) == tally.lane_segs > 0
    for name, g, w in zip(pa._fields, pa, pa_t):
        assert torch.equal(g, w), name

    # phase B (the move-writing extension of the winners): what the chunk
    # counts from its result is what the host loop issues
    tally = DpTally()
    got_t = port_ref._ref_extend_chunk(*args, **kw, L_q=L_q, dp=tally)
    got = port_ref._ref_extend_chunk(*args, **kw, L_q=L_q)
    assert got[3] == got_t[3] == tally.lane_segs > 0
    for name, g, w in zip(got[0]._fields, got[0], got_t[0]):
        assert torch.equal(g, w), name


def test_loop_kernel_wrapper_refuses_cpu_tensors_before_building(
        monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("the wrapper built the kernel library")

    monkeypatch.setattr(cuda_build, "build", no_build)
    monkeypatch.setattr(dp_kernel, "_lib", None)
    q, t, qlen, tlen, _, _ = extend_inputs(16, 256, 128, seed=3)
    zeros = torch.zeros(16, dtype=torch.int32)
    before = dp_kernel.launches()
    with pytest.raises(ValueError):
        dp_kernel.extend_counts_cuda(
            torch.as_tensor(q), torch.as_tensor(t), zeros, zeros,
            torch.as_tensor(qlen), torch.as_tensor(tlen), S=128, W=64,
            max_segs=4, min_seg_identity=0.65)
    assert dp_kernel.launches() == before
