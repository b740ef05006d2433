"""The Hopper kernels on the card, held against their plain PyTorch versions.

Every test needs a CUDA device with nvcc and skips elsewhere.  The GPU
machine has no JAX and tests/conftest.py imports it, so run this file
there without the conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mecat_tpu_torch.index.kmer_index import build_index
from mecat_tpu_torch.io.packed_db import PackedDB
from mecat_tpu_torch.ops import (align, consensus_banded, dp_kernel,
                                 roll_micro, walk_kernel)
from mecat_tpu_torch.pipeline.device_step import overlap_step
from mecat_tpu_torch.pipeline.pw import PwOptions, run_pw
from mecat_tpu_torch.testing import (GOLDEN_J1, deposit_rows_inputs,
                                     dp_inputs, dp_inputs_full, extend_inputs,
                                     fold_case,
                                     moves_as_the_kernels_leave_them,
                                     roll_micro_inputs, walk_inputs)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the kernels run only on a CUDA device")
    return torch.device("cuda")


def _deposit_case(dev, S, W, n, seed, walk=None, source="walk"):
    """The deposit's inputs (plane_inputs' arguments but S and W) on
    ``dev`` for n lanes: 3 right and 2 left segments of n // 5 pairs, on the
    rows of a walk (``walk`` = its mv, h, wo tensors) or generated ones."""
    if walk is not None:
        walk = [a.cpu().numpy() for a in walk]
    rr, lr, q, qseed = deposit_rows_inputs(S, W, n // 5, 3 * S, seed,
                                           source=source, walk=walk)
    on = lambda a: torch.as_tensor(np.array(a), device=dev)
    return (tuple(on(a) for a in rr), tuple(on(a) for a in lr), on(q),
            on(qseed))


def _flat(out):
    return [t for x in out for t in (x if isinstance(x, tuple) else (x,))]


def _assert_deposit_matches_plain(case, S, W):
    """The deposit kernel (plane_inputs on the card) against the plain
    composition, every element of the planes and side arrays."""
    got = _flat(consensus_banded.plane_inputs(*case, S, W))
    want = _flat(consensus_banded.plane_inputs_plain(*case, S, W))
    torch.cuda.synchronize()
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), k


@pytest.mark.parametrize("S,W", [(128, 64), (512, 128), (1024, 64)])
def test_dp_kernel_matches_plain(cuda, S, W):
    args = [torch.as_tensor(a, device=cuda)
            for a in dp_inputs(S, W, 1024, seed=11)]
    before = dp_kernel.LAUNCHES
    got = align.dp_segment_best(*args, S, W)
    want = align.dp_segment_best_plain(*args, S, W)
    torch.cuda.synchronize()
    assert dp_kernel.LAUNCHES == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("S,W", [(128, 64), (512, 128), (1024, 64)])
def test_dp_moves_kernel_matches_plain(cuda, S, W):
    """(r, w, j, d, ind) on every lane; the packed words of every row the
    traceback can read (rows <= r_best of active lanes); the row walks of
    both move matrices on every lane.  dp_inputs carries inactive lanes and
    lanes with no valid cell."""
    args = [torch.as_tensor(a, device=cuda)
            for a in dp_inputs(S, W, 1024, seed=17)]
    active = args[4]
    before = dp_kernel.LAUNCHES_MOVES, dp_kernel.LAUNCHES
    got = align.dp_segment_best(*args, S, W, want_moves=True)
    want = align.dp_segment_best_plain(*args, S, W, want_moves=True)
    torch.cuda.synchronize()
    assert dp_kernel.LAUNCHES_MOVES == before[0] + 1
    assert dp_kernel.LAUNCHES == before[1]
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    moves, r_best, w_best = got[0], got[1], got[2]
    assert moves.shape == (1024, S, W // 16) and moves.dtype == torch.int32
    row = torch.arange(1, S + 1, device=cuda)[None, :, None]
    readable = (row <= r_best[:, None, None]) & active[:, None, None]
    assert bool(readable.any())
    assert torch.equal(torch.where(readable, moves, 0),
                       torch.where(readable, want[0], 0))
    assert not bool(moves[~active].any())     # an inactive lane writes none
    for g, w in zip(align.traceback_rows(moves, r_best, w_best, W),
                    align.traceback_rows(want[0], r_best, w_best, W)):
        assert torch.equal(g, w)


def _assert_kernels_match_plain(args, S, W):
    """Both kernels on these lanes: (r, w, j, d, ind) on every lane, the
    move words of rows 1..r_best, zeros above the lane's last row."""
    want = align.dp_segment_best_plain(*args, S, W, want_moves=True)
    got = align.dp_segment_best(*args, S, W)
    got_m = align.dp_segment_best(*args, S, W, want_moves=True)
    torch.cuda.synchronize()
    for g, gm, w in zip(got, got_m[1:], want[1:]):
        assert torch.equal(g, w) and torch.equal(gm, w)
    tmax, seg_q, active = args[2:]
    row = torch.arange(1, S + 1, device=tmax.device)[None, :, None]
    readable = (row <= got_m[1][:, None, None]) & active[:, None, None]
    assert torch.equal(torch.where(readable, got_m[0], 0),
                       torch.where(readable, want[0], 0))
    last = torch.minimum(seg_q, tmax + W // 2).clamp(min=0)
    last = torch.where(active & (tmax >= 0), last, 0)
    assert not bool(torch.where(row > last[:, None, None], got_m[0], 0).any())
    return got_m


@pytest.mark.parametrize("lanes,live", [(4096, 64), (128, 1), (128, 64)])
def test_dp_kernels_with_few_live_lanes(cuda, lanes, live):
    """The launches the paths make: full-length segments, most lanes
    inactive, the live ones scattered."""
    S, W = 512, 128
    q, tpad, tmax, seg_q = dp_inputs_full(S, W, lanes, seed=31)
    mask = np.zeros(lanes, bool)
    mask[np.random.default_rng(lanes + live).choice(lanes, live,
                                                    replace=False)] = True
    args = [torch.as_tensor(a, device=cuda)
            for a in (q, tpad, tmax, seg_q, mask)]
    got = _assert_kernels_match_plain(args, S, W)
    assert int((got[1] > S // 2).sum()) == live
    assert not bool(got[0][~args[4]].any())


@pytest.mark.parametrize("S,W", [(128, 64), (512, 128)])
def test_dp_kernels_short_lane_next_to_full_lanes(cuda, S, W):
    """Lanes of one block (four neighbours) that end on different rows: a
    short query, a short target, an empty one, between full-length lanes."""
    q, tpad, tmax, seg_q = dp_inputs_full(S, W, 64, seed=37)
    seg_q[1::4] = np.arange(16) * (S // 16) + 1       # 1 .. S - S/16 + 1
    tmax[2:32:4] = np.arange(8) * 5                   # the band leaves t
    tmax[34] = -1
    seg_q[38] = 0
    args = [torch.as_tensor(a, device=cuda)
            for a in (q, tpad, tmax, seg_q, np.ones(64, bool))]
    got = _assert_kernels_match_plain(args, S, W)
    assert bool((got[1][0::4] > S // 2).all())        # the full lanes


def test_dp_moves_kernel_writes_every_word_of_an_uninitialised_buffer(
        cuda, monkeypatch):
    """The wrapper allocates the move buffer with torch.empty; the kernel
    must write zeros into every row it does not compute.  Here torch.empty
    hands out buffers full of ones."""
    S, W = 512, 128
    q, tpad, tmax, seg_q, active = dp_inputs(S, W, 256, seed=41)
    seg_q[3], seg_q[8], tmax[9] = 17, 300, 40
    args = [torch.as_tensor(a, device=cuda)
            for a in (q, tpad, tmax, seg_q, active)]
    real_empty = torch.empty
    asked = []

    def ones_empty(*size, **kw):
        asked.append(size)
        return real_empty(*size, **kw).fill_(1)

    monkeypatch.setattr(torch, "empty", ones_empty)
    moves, r_best, _, _ = dp_kernel.dp_segment_best_moves_cuda(*args, S, W)
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert ((256, S, W // 16),) in asked
    tmax, seg_q, active = args[2:]
    last = torch.minimum(seg_q, tmax + W // 2).clamp(min=0)
    last = torch.where(active & (tmax >= 0), last, 0)
    assert bool((r_best <= last).all())
    row = torch.arange(1, S + 1, device=cuda)[None, :, None]
    assert not bool(torch.where(row > last[:, None, None], moves, 0).any())
    want = align.dp_segment_best_plain(*args, S, W, want_moves=True)[0]
    readable = (row <= r_best[:, None, None]) & active[:, None, None]
    assert torch.equal(torch.where(readable, moves, 0),
                       torch.where(readable, want, 0))


def test_dp_moves_kernel_rejects_what_it_does_not_take(cuda):
    S, W = 128, 64
    q, tpad, tmax, seg_q, active = (torch.as_tensor(a, device=cuda)
                                    for a in dp_inputs(S, W, 64, seed=2))
    W_off = dp_kernel.BAND_MAX + 16
    with pytest.raises(ValueError):                 # a band it does not take
        dp_kernel.dp_segment_best_moves_cuda(
            q, tpad.new_zeros(64, S + W_off), tmax, seg_q, active, S, W_off)
    with pytest.raises(TypeError):
        dp_kernel.dp_segment_best_moves_cuda(q, tpad, tmax.long(), seg_q,
                                             active, S, W)


def test_run_cns_golden_bytes_on_cuda(cuda):
    from mecat_tpu_torch.pipeline.cns import CnsOptions, run_cns
    from mecat_tpu_torch.testing import GOLDEN_CNS

    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "corrected.fasta")
        before = dp_kernel.launches()
        run_cns(os.path.join(GOLDEN, "candidates.txt"),
                os.path.join(GOLDEN, "reads.fasta"), out,
                CnsOptions(**GOLDEN_CNS), device=cuda)
        launched = dp_kernel.launches_since(before)
        assert launched["dp_launches_extend_moves"] > 0
        assert launched["dp_launches_moves"] == 0
        with open(out, "rb") as fh, \
                open(os.path.join(GOLDEN, "corrected.fasta"), "rb") as gh:
            assert fh.read() == gh.read()


def test_dp_kernel_rejects_what_it_does_not_take(cuda):
    S, W = 128, 64
    q, tpad, tmax, seg_q, active = (torch.as_tensor(a, device=cuda)
                                    for a in dp_inputs(S, W, 64, seed=2))
    with pytest.raises(TypeError):
        dp_kernel.dp_segment_best_cuda(q.int(), tpad, tmax, seg_q, active,
                                       S, W)
    W_off = dp_kernel.BAND_MAX + 16
    with pytest.raises(ValueError):                 # a band it does not take
        dp_kernel.dp_segment_best_cuda(q, tpad.new_zeros(64, S + W_off),
                                       tmax, seg_q, active, S, W_off)
    S_big = 32768            # 4 lanes of q and t overflow 227 KB of smem
    with pytest.raises(ValueError):
        dp_kernel.dp_segment_best_cuda(
            q.new_zeros(64, S_big), tpad.new_zeros(64, S_big + W), tmax,
            seg_q, active, S_big, W)
    with pytest.raises(ValueError):
        dp_kernel.dp_segment_best_cuda(q, tpad.T.contiguous().T, tmax, seg_q,
                                       active, S, W)


def _pairs(cuda, S, W, source, n=512):
    """Pairs on the card: ``extend_inputs`` pairs (rows of 20 S bases at
    12 % noise, with its edge lanes), or the ``dp_inputs`` lanes as pairs
    seeded at 0 (lanes with nothing to extend among them)."""
    if source == "pairs":
        pairs = extend_inputs(n, 20 * S, S, seed=S + W)
    else:
        q, tpad, tmax, seg_q, _ = dp_inputs(S, W, n, seed=S + 3)
        zeros = np.zeros(n, np.int32)
        pairs = (q, np.ascontiguousarray(tpad[:, W // 2:]), seg_q, tmax,
                 zeros, zeros)
    return [torch.as_tensor(a, device=cuda) for a in pairs]


def _extend_lanes(cuda, S, W, source, n=512):
    """The 2n direction lanes of :func:`_pairs`."""
    return [x.contiguous() for x in align.direction_lanes(
        *_pairs(cuda, S, W, source, n), S, W)]


@pytest.mark.parametrize("max_segs", [1, 16])
@pytest.mark.parametrize("source", ["pairs", "dp"])
@pytest.mark.parametrize("S,W", [(128, 64), (512, 128)])
def test_extend_loop_kernel_matches_plain(cuda, S, W, source, max_segs):
    """The segment-loop kernel against the plain host loop: all six
    outputs on every lane, one launch and no per-segment launch."""
    lanes = _extend_lanes(cuda, S, W, source)
    kw = dict(S=S, W=W, max_segs=max_segs, min_seg_identity=0.65)
    before = dp_kernel.launches()
    got, _ = align._extend_direction_impl(*lanes, **kw)
    assert dp_kernel.launches_since(before) == {
        "dp_launches": 0, "dp_launches_moves": 0, "dp_launches_extend": 1,
        "dp_launches_extend_moves": 0}
    want, _ = align._extend_direction_impl(
        *lanes, **kw, dp=align.dp_segment_best_plain)
    torch.cuda.synchronize()
    for name, g, w in zip(align.ExtensionResult._fields, got, want):
        assert torch.equal(g, w), name
    assert int(want.n_segs.max()) == max_segs or source == "dp"


def test_extend_loop_kernel_writes_every_output_of_an_uninitialised_buffer(
        cuda, monkeypatch):
    S, W = 128, 64
    lanes = _extend_lanes(cuda, S, W, "pairs", n=64)
    kw = dict(S=S, W=W, max_segs=16, min_seg_identity=0.65)
    real_empty = torch.empty

    def ones_empty(*size, **kwargs):
        return real_empty(*size, **kwargs).fill_(1)

    monkeypatch.setattr(torch, "empty", ones_empty)
    got = dp_kernel.extend_counts_cuda(*lanes, **kw)
    monkeypatch.undo()
    want, _ = align._extend_direction_impl(
        *lanes, **kw, dp=align.dp_segment_best_plain)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_extend_loop_kernel_rejects_what_it_does_not_take(cuda):
    S, W = 128, 64
    lanes = _extend_lanes(cuda, S, W, "pairs", n=16)
    kw = dict(S=S, max_segs=4, min_seg_identity=0.65)
    fn = dp_kernel.extend_counts_cuda
    with pytest.raises(ValueError):                 # a band it does not take
        fn(*lanes, W=dp_kernel.BAND_MAX + 16, **kw)
    with pytest.raises(ValueError):                 # rows narrower than S + W
        fn(lanes[0], lanes[1][:, :S + W - 1].contiguous(), *lanes[2:], W=W,
           **kw)
    with pytest.raises(TypeError):                  # dtype
        fn(*lanes[:2], lanes[2].long(), *lanes[3:], W=W, **kw)
    with pytest.raises(ValueError):                 # shape
        fn(*lanes[:5], lanes[5][:-1], W=W, **kw)
    S_big = 32768             # 4 lanes of windows overflow 227 KB of smem
    with pytest.raises(ValueError):
        fn(lanes[0].new_zeros(32, S_big), lanes[1].new_zeros(32, 2 * S_big),
           *(x[:32] for x in lanes[2:]), W=W, S=S_big, max_segs=4,
           min_seg_identity=0.65)


def _assert_move_loop_matches_plain(pairs, S, W, max_segs, max_left):
    """The move loop (one launch for both directions) against the host
    loop on the plain DP: both ExtensionResults and every element of the
    six raw arrays of every slot < G, the plain moves past each segment's
    last row set to zero as the kernels leave them."""
    kw = dict(S=S, W=W, max_segs=max_segs, min_seg_identity=0.65,
              max_segs_left=max_left)
    before = dp_kernel.launches()
    got = align._extend_both_with_moves(*pairs, **kw, dp=align.dp_segment_best)
    assert dp_kernel.launches_since(before) == {
        "dp_launches": 0, "dp_launches_moves": 0, "dp_launches_extend": 0,
        "dp_launches_extend_moves": 1}
    want = align._extend_both_with_moves(*pairs, **kw,
                                         dp=align.dp_segment_best_plain)
    torch.cuda.synchronize()
    for side, g_res, w_res in zip(("left", "right"), got[:2], want[:2]):
        for name, g, w in zip(align.ExtensionResult._fields, g_res, w_res):
            assert torch.equal(g, w), (side, name)
    assert got[3] == want[3]
    lanes = align.direction_lanes(*pairs, S, W)
    want_raw = moves_as_the_kernels_leave_them(want[2], want[3], lanes[4],
                                               lanes[5], S, W)
    for i, (g, w) in enumerate(zip(got[2], want_raw)):
        assert g.shape == w.shape and torch.equal(g, w), i
    return got


@pytest.mark.parametrize("max_segs", [1, 16])
@pytest.mark.parametrize("source", ["pairs", "dp"])
@pytest.mark.parametrize("S,W", [(128, 64), (512, 128)])
def test_extend_moves_kernel_matches_plain(cuda, S, W, source, max_segs):
    pairs = _pairs(cuda, S, W, source)
    got = _assert_move_loop_matches_plain(pairs, S, W, max_segs,
                                          max(1, max_segs // 3))
    assert int(got[1].n_segs.max()) == max_segs or source == "dp"


def test_extend_moves_kernel_writes_every_slot_it_reaches(cuda,
                                                          monkeypatch):
    """Slots k < nsegs[b] of an uninitialised buffer are all written; the
    rest are filled by the cut, whatever the buffer held."""
    S, W = 128, 64
    pairs = _pairs(cuda, S, W, "pairs", n=64)
    real_empty = torch.empty

    def ones_empty(*size, **kwargs):
        return real_empty(*size, **kwargs).fill_(1)

    monkeypatch.setattr(torch, "empty", ones_empty)
    lanes = [x.contiguous() for x in align.direction_lanes(*pairs, S, W)]
    final, slots = dp_kernel.extend_moves_cuda(
        *lanes, S=S, W=W, max_segs=16, min_seg_identity=0.65, split=64,
        max_segs_b=7)
    monkeypatch.undo()
    plain_final, plain_slots = align.extend_moves_plain(
        *lanes, S=S, W=W, max_segs=16, min_seg_identity=0.65, split=64,
        max_segs_b=7)
    torch.cuda.synchronize()
    for name, g, w in zip(align.ExtensionResult._fields, final, plain_final):
        assert torch.equal(g, w), name
    got = align.slots_to_raw(final, slots, 64, W)
    plain = align.slots_to_raw(plain_final, plain_slots, 64, W)
    want_raw = moves_as_the_kernels_leave_them(
        plain[2], plain[3], lanes[4], lanes[5], S, W)
    for g, w in zip(got[2], want_raw):
        assert torch.equal(g, w)


def test_extend_moves_kernel_rejects_what_it_does_not_take(cuda):
    S, W = 128, 64
    lanes = _extend_lanes(cuda, S, W, "pairs", n=16)
    kw = dict(S=S, max_segs=4, min_seg_identity=0.65)
    fn = dp_kernel.extend_moves_cuda
    with pytest.raises(ValueError):                 # a band it does not take
        fn(*lanes, W=dp_kernel.BAND_MAX + 16, **kw)
    with pytest.raises(ValueError):                 # rows narrower than S + W
        fn(lanes[0], lanes[1][:, :S + W - 1].contiguous(), *lanes[2:], W=W,
           **kw)
    with pytest.raises(TypeError):                  # dtype
        fn(*lanes[:2], lanes[2].long(), *lanes[3:], W=W, **kw)


@pytest.mark.parametrize("W", [32, 48, 96, 160, 256, 272, 384, 512, 528,
                               1024, 2048, 3088, 4096, 8192,
                               dp_kernel.BAND_MAX])
def test_dp_family_kernels_match_plain_at_every_band(cuda, W):
    """Each band width the reference computes: the two per-segment DP
    kernels, the counts and the move loop, the row and the column walk on
    the move kernel's words and the deposit on the rows of that walk, on
    random rows and on walk-shaped edge rows, each against its plain
    version.  Past 512 a lane is
    several warps (528: a second warp of one real thread, 1024 and 2048:
    two and four whole slices); past 3072 a thread-block cluster (3088:
    two blocks of four slices, the last one padding; 4096: two of four;
    8192: three of six, the last two padding; BAND_MAX: eight of six), and
    each of the four DP kernels' launches goes the cluster route."""
    S = 128
    cluster0 = dp_kernel.LAUNCHES_CLUSTER
    args = [torch.as_tensor(a, device=cuda)
            for a in dp_inputs(S, W, 256, seed=W)]
    got = align.dp_segment_best(*args, S, W)
    want = align.dp_segment_best_plain(*args, S, W, want_moves=True)
    for g, w in zip(got, want[1:]):
        assert torch.equal(g, w)
    moves, r_best, w_best = align.dp_segment_best(*args, S, W,
                                                  want_moves=True)[:3]
    last = torch.minimum(args[3].clamp(max=S), args[2] + W // 2)
    last = torch.where(args[2] < 0, 0, last).clamp(min=0)
    row = torch.arange(1, S + 1, device=cuda)[None, :, None]
    assert torch.equal(moves, torch.where(
        (row <= last[:, None, None]) & args[4][:, None, None], want[0], 0))
    rows = align.traceback_rows(moves, r_best, w_best, W)
    for g, w in zip(rows, align.traceback_rows_plain(moves, r_best, w_best,
                                                     W)):
        assert torch.equal(g, w)
    for dep in (_deposit_case(cuda, S, W, 255, W, walk=rows[:3]),
                _deposit_case(cuda, S, W, 255, W + 1, source="random"),
                _deposit_case(cuda, S, W, 255, W + 2)):
        _assert_deposit_matches_plain(dep, S, W)
    TC = align.max_tape_cols(S, W, 0.65)
    for g, w in zip(align.traceback_ops(moves, r_best, w_best, W, TC),
                    align.traceback_ops_plain(moves, r_best, w_best, W, TC)):
        assert torch.equal(g, w)
    lanes = _extend_lanes(cuda, S, W, "pairs", n=128)
    kw = dict(S=S, W=W, max_segs=8, min_seg_identity=0.65)
    got, _ = align._extend_direction_impl(*lanes, **kw)
    want, _ = align._extend_direction_impl(*lanes, **kw,
                                           dp=align.dp_segment_best_plain)
    for name, g, w in zip(align.ExtensionResult._fields, got, want):
        assert torch.equal(g, w), name
    _assert_move_loop_matches_plain(_pairs(cuda, S, W, "pairs", n=128), S, W,
                                    8, 3)
    assert dp_kernel.LAUNCHES_CLUSTER - cluster0 == (
        4 if W > dp_kernel.BAND_BLOCK_MAX else 0)


def test_kernels_refuse_past_band_max_before_a_build(cuda, monkeypatch):
    """BAND_MAX + 16 (and BAND_MAX + 8): every DP and walk wrapper raises
    ValueError naming the ceiling before anything is built."""
    from mecat_tpu_torch.ops import cuda_build

    def no_build(*a, **k):
        raise AssertionError("a kernel was built for a band it refuses")

    monkeypatch.setattr(cuda_build, "build", no_build)
    monkeypatch.setattr(dp_kernel, "_lib", None)
    monkeypatch.setattr(walk_kernel, "_libs", {})
    S = 64
    for W in (dp_kernel.BAND_MAX + 16, dp_kernel.BAND_MAX + 8):
        q, tpad, tmax, seg_q, active = (
            torch.as_tensor(a, device=cuda) for a in dp_inputs(S, 64, 16,
                                                               seed=4))
        tpad = tpad.new_zeros(16, S + W)
        match = str(dp_kernel.BAND_MAX)
        for fn in (dp_kernel.dp_segment_best_cuda,
                   dp_kernel.dp_segment_best_moves_cuda):
            with pytest.raises(ValueError, match=match):
                fn(q, tpad, tmax, seg_q, active, S, W)
        lanes = _extend_lanes(cuda, S, 64, "pairs", n=16)
        lanes[1] = lanes[1].new_zeros(32, lanes[1].shape[1] + W)
        for fn in (dp_kernel.extend_counts_cuda, dp_kernel.extend_moves_cuda):
            with pytest.raises(ValueError, match=match):
                fn(*lanes, S=S, W=W, max_segs=4, min_seg_identity=0.65)
        moves = torch.zeros((16, S, W // 16), dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match=match):
            walk_kernel.traceback_rows_cuda(moves, seg_q, tmax, W)
        with pytest.raises(ValueError, match=match):
            walk_kernel.traceback_ops_cuda(moves, seg_q, tmax, W, 64)


def test_overlap_step_kernel_matches_plain(cuda):
    db = PackedDB.from_fasta(os.path.join(GOLDEN, "reads.fasta"))
    cfg = dict(k=9, stride=4, max_occ=32, num_candidates=12, diag_bin=256,
               L_target=4096, S=128, W=64, max_segs=40, min_align_size=400)
    idx = build_index(db.codes, db.starts, db.lengths, k=9, device=cuda)
    bases, lens = db.padded_batch(range(16), pad_to=4096)
    args = (torch.as_tensor(bases, device=cuda),
            torch.as_tensor(lens, device=cuda),
            torch.arange(16, dtype=torch.int32, device=cuda),
            torch.as_tensor(db.codes, device=cuda), idx.offsets, idx.pos_rid,
            idx.pos_loc, idx.read_starts, idx.read_lengths,
            idx.max_occ_cutoff)
    got = overlap_step(*args, **cfg)
    want = overlap_step(*args, **cfg, dp=align.dp_segment_best_plain)
    assert bool(got.valid.any())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_run_pw_golden_bytes_on_cuda(cuda):
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "out.m4")
        before = dp_kernel.launches()
        # the golden bytes are the staged route's; -j 1 on cuda takes the
        # fused route unless asked
        run_pw(os.path.join(GOLDEN, "reads.fasta"), out, os.path.join(d, "w"),
               PwOptions(**GOLDEN_J1), device=cuda, route="staged")
        launched = dp_kernel.launches_since(before)
        assert launched["dp_launches_extend"] > 0
        assert launched["dp_launches"] == 0
        with open(out, "rb") as fh, \
                open(os.path.join(GOLDEN, "overlaps.m4"), "rb") as gh:
            assert fh.read() == gh.read()


def test_fused_run_pw_on_cuda_matches_cpu_bytes(cuda):
    reads = os.path.join(GOLDEN, "reads.fasta")
    with tempfile.TemporaryDirectory() as d:
        got = {}
        for dev in (cuda, "cpu"):
            out = os.path.join(d, f"{dev}.m4")
            before = dp_kernel.LAUNCHES_EXTEND
            stats = run_pw(reads, out, os.path.join(d, f"w{dev}"),
                           PwOptions(**GOLDEN_J1), device=dev,
                           route="fused")
            with open(out, "rb") as fh:
                got[str(dev)] = (fh.read(), stats.overlaps, stats.cells,
                                 stats.cells_useful,
                                 dp_kernel.LAUNCHES_EXTEND - before)
        assert got["cuda"][:4] == got["cpu"][:4]
        assert got["cuda"][1] > 0
        assert got["cuda"][4] > 0 and got["cpu"][4] == 0


@pytest.mark.parametrize("seed", range(3))
def test_strand_merge_on_cuda_matches_cpu(cuda, seed):
    """The -j 0 device merge: the same buffer and count on the card as on
    the CPU, on candidates heavy with ties and invalid rows."""
    from mecat_tpu_torch.ops.ddf import (Candidates,
                                         merge_strand_candidates_device)

    rng = np.random.default_rng(seed)
    B, N = 128, 16
    strands = [[rng.integers(0, 300, (B, N)), rng.integers(0, 6, (B, N)),
                rng.integers(0, 8000, (B, N)), rng.integers(0, 8000, (B, N))]
               for _ in range(2)]
    valid = [rng.random((B, N)) < 0.7 for _ in range(2)]
    got = {}
    for dev in (cuda, torch.device("cpu")):
        cands = [Candidates(*(torch.as_tensor(a, dtype=torch.int32,
                                              device=dev) for a in s),
                            torch.as_tensor(v, device=dev))
                 for s, v in zip(strands, valid)]
        merged, count = merge_strand_candidates_device(
            *cands, 2, B - 5, n_keep=N)
        got[dev.type] = (merged.cpu(), int(count))
    assert got["cuda"][1] == got["cpu"][1] > 0
    assert torch.equal(got["cuda"][0], got["cpu"][0])


@pytest.mark.parametrize("name", list(roll_micro.VARIANTS))
@pytest.mark.parametrize("S,W", [(64, 32), (128, 64), (512, 128)])
def test_roll_micro_kernel_matches_plain(cuda, name, S, W):
    """All 8 output rows on every lane: the tool's lanes, lanes with varied
    tmax and segq, a lane with no valid cell (the wrapped elem key)."""
    rolls, best = roll_micro.VARIANTS[name]
    args = [torch.as_tensor(a, device=cuda)
            for a in roll_micro_inputs(S, W, 512, seed=S + W)]
    before = roll_micro.LAUNCHES
    got = roll_micro.roll_micro(*args, S, W, rolls, best)
    want = roll_micro.roll_micro_plain(*args, S, W, rolls, best)
    torch.cuda.synchronize()
    assert roll_micro.LAUNCHES == before + 1
    assert got.shape == (512, 8) and got.dtype == torch.int32
    assert torch.equal(got, want)


def test_roll_micro_kernel_rejects_what_it_does_not_take(cuda):
    S, W = 128, 64
    q, t, tmax, segq = (torch.as_tensor(a, device=cuda)
                        for a in roll_micro_inputs(S, W, 64, seed=2))
    with pytest.raises(ValueError):      # not one of the five variants
        roll_micro.roll_micro_cuda(q, t, tmax, segq, S, W, False, "elem")
    with pytest.raises(ValueError):
        roll_micro.roll_micro_cuda(q, t.new_zeros(64, S + 96), tmax, segq, S,
                                   96, True, "log")
    with pytest.raises(TypeError):
        roll_micro.roll_micro_cuda(q, t, tmax.long(), segq, S, W, True, "log")
    with pytest.raises(ValueError):
        roll_micro.roll_micro_cuda(q, t, tmax, segq, S, W, True, "best")


@pytest.mark.parametrize("S,W", [(128, 64), (512, 128)])
def test_column_traceback_of_kernel_moves_matches_plain(cuda, S, W):
    """traceback_ops reads the kernel's move words like the plain version's
    wherever the segment has an endpoint (the rows above r_best are not
    written by the kernel and not read by the walk)."""
    args = [torch.as_tensor(a, device=cuda)
            for a in dp_inputs(S, W, 512, seed=23)]
    got = align.dp_segment_best(*args, S, W, want_moves=True)
    want = align.dp_segment_best_plain(*args, S, W, want_moves=True)
    r_best, w_best, d_best = got[1], got[2], got[4]
    TC = align.max_tape_cols(S, W, 0.7)
    reach = d_best < align.INF
    assert int(reach.sum()) > 400
    for g, w in zip(align.traceback_ops(got[0], r_best, w_best, W, TC),
                    align.traceback_ops(want[0], r_best, w_best, W, TC)):
        assert torch.equal(g[reach], w[reach])


def test_run_ref_on_cuda_matches_cpu_bytes(cuda):
    from mecat_tpu_torch.io.fasta import write_fasta
    from mecat_tpu_torch.pipeline.ref import RefOptions, run_ref
    from mecat_tpu_torch.utils.sim import random_genome, simulate_reads

    opts = dict(num_candidates=8, num_extend=3, min_align_size=400,
                kmer_size=10, scan_stride=5, scan_batch=16, extend_batch=32,
                align_segment=128, align_band=64)
    genome = random_genome(30000, seed=81)
    db, _ = simulate_reads(genome, 12, mean_len=2000, min_len=1000, seed=83,
                           error_rate=0.08)
    with tempfile.TemporaryDirectory() as d:
        ref, reads = os.path.join(d, "g.fasta"), os.path.join(d, "r.fasta")
        write_fasta(ref, [("chr1", genome)])
        write_fasta(reads, [(db.name(i), db.read(i))
                            for i in range(db.n_reads)])
        for fmt in ("sam", "m4"):
            outs = {}
            for dev in ("cuda", "cpu"):
                out = os.path.join(d, f"{dev}.{fmt}")
                stats = run_ref(reads, ref, out, os.path.join(d, f"w{dev}"),
                                RefOptions(output_format=fmt, **opts),
                                device=dev)
                with open(out, "rb") as fh:
                    outs[dev] = fh.read()
                if dev == "cuda":
                    assert stats.dp_launches_extend > 0
                    assert stats.dp_launches == stats.dp_launches_moves == 0
                    assert ((stats.dp_launches_extend_moves > 0)
                            == (fmt == "sam"))
                    assert stats.mapped == db.n_reads
            assert outs["cuda"] == outs["cpu"] and len(outs["cpu"]) > 200


@pytest.mark.parametrize("rounds", [2, 3])
def test_run_cns_rounds_on_cuda_match_cpu_bytes(cuda, rounds):
    """Draft rounds on the card: the appended volume, the remapped seeds and
    the draft vote give the CPU's corrected reads byte for byte."""
    from mecat_tpu_torch.pipeline.cns import CnsOptions, run_cns
    from mecat_tpu_torch.testing import PILE_CNS, cns_pile

    with tempfile.TemporaryDirectory() as d:
        _, reads, cand = cns_pile(d, device="cuda")
        outs, aligned = {}, {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(d, f"{dev}.fasta")
            before = dp_kernel.launches()
            stats = run_cns(cand, reads, out,
                            CnsOptions(rounds=rounds, **PILE_CNS), device=dev)
            launched = dp_kernel.launches_since(before)
            assert ((launched["dp_launches_extend_moves"] > 0)
                    == (dev == "cuda"))
            assert launched["dp_launches_moves"] == 0
            aligned[dev] = stats.supports_aligned
            with open(out, "rb") as fh:
                outs[dev] = fh.read()
        assert outs["cuda"] == outs["cpu"] and outs["cpu"].count(b">") > 10
        assert aligned["cuda"] == aligned["cpu"]


@pytest.mark.parametrize("genome_len,n,tile_max", [(6000, 7, None),
                                                   (24000, 29, 8192)])
def test_polish_on_cuda_matches_cpu_and_the_host_route(cuda, monkeypatch,
                                                       genome_len, n,
                                                       tile_max):
    """The tiled device polish on the card, one tile and several: equal to
    the same on the CPU, to the host route, and under a table cap that holds
    one tile."""
    from mecat_tpu_torch.assembly import ctgcns
    from mecat_tpu_torch.testing import polish_case

    if tile_max:
        monkeypatch.setattr(ctgcns, "_TILE_L_MAX", tile_max)
    opts = ctgcns.CtgCnsOptions(extend_batch=8, align_segment=128,
                                align_band=64)
    with tempfile.TemporaryDirectory() as d:
        db, tig, backbone = polish_case(d, genome_len, n, seed=77)
    before = dp_kernel.launches()
    got = ctgcns._polish_contig_device(db, tig, backbone, opts, device=cuda)
    launched = dp_kernel.launches_since(before)
    assert launched["dp_launches_extend_moves"] > 0
    assert launched["dp_launches_moves"] == 0
    assert not np.array_equal(got, backbone)
    for other in (
            ctgcns._polish_contig_device(db, tig, backbone, opts,
                                         device="cpu"),
            ctgcns._polish_contig_device(db, tig, backbone, opts,
                                         device=cuda, cap=1),
            ctgcns._polish_contig_host(db, tig, backbone, opts, device=cuda)):
        np.testing.assert_array_equal(got, other)


def _walk_case(cuda, S, W, source, n=1024):
    """(moves, seg_qlen, w_end) on the card: the move-writing DP kernel's
    words and endpoints on the dp_inputs lanes, or random words with the
    edge lanes of testing.walk_inputs."""
    if source == "dp":
        args = [torch.as_tensor(a, device=cuda)
                for a in dp_inputs(S, W, n, seed=S + W)]
        moves, r_best, w_best = align.dp_segment_best(
            *args, S, W, want_moves=True)[:3]
        return moves, r_best, w_best
    return [torch.as_tensor(a, device=cuda)
            for a in walk_inputs(S, W, n, seed=S + 2 * W)]


@pytest.mark.parametrize("source", ["dp", "random"])
@pytest.mark.parametrize("S,W", [(128, 64), (512, 128), (512, 512),
                                 (100, 48), (128, 2048)])
def test_walk_kernels_match_plain(cuda, S, W, source):
    """The row walk, the column walk (at the mapping path's MAXC, at the
    unconditional 2S + W, and cut short at 64 and 61 columns, in the middle
    of rows, with tape words shared between lanes at 61) and the deposit
    with its row information on the rows of the kernel's own walk and on
    random rows: every output element of every lane.  The random words carry the edge lanes
    of testing.walk_inputs (seg_qlen -1, 0, S, S + 3 by w_end -1, 0, W - 1,
    W) and runs of horizontal moves across rows."""
    moves, seg_qlen, w_end = _walk_case(cuda, S, W, source)
    before = walk_kernel.launches()
    got = align.traceback_rows(moves, seg_qlen, w_end, W)
    want = align.traceback_rows_plain(moves, seg_qlen, w_end, W)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool((got[0] >= 0).any())
    for maxc in (align.max_tape_cols(S, W, 0.65), 2 * S + W, 64, 61):
        got_c = align.traceback_ops(moves, seg_qlen, w_end, W, maxc)
        want_c = align.traceback_ops_plain(moves, seg_qlen, w_end, W, maxc)
        torch.cuda.synchronize()
        for g, w in zip(got_c, want_c):
            assert torch.equal(g, w)
        assert int(got_c[3].max()) > 0
        if maxc in (64, 61):                  # walks longer than the tape
            assert int(got_c[3].max()) == maxc
    for dep in (_deposit_case(cuda, S, W, 1020, S, walk=got[:3]),
                _deposit_case(cuda, S, W, 1020, S + 1, source="random")):
        _assert_deposit_matches_plain(dep, S, W)
    assert walk_kernel.launches_since(before) == {
        "walk_launches_rows": 1, "walk_launches_deposit": 2,
        "walk_launches_cols": 4, "walk_launches_planes": 0,
        "walk_launches_fold": 0}


@pytest.mark.parametrize("S,W", [(512, 128), (100, 48)])
def test_walk_kernels_write_every_element_of_uninitialised_buffers(
        cuda, monkeypatch, S, W):
    """The wrappers allocate their outputs with torch.empty; here
    torch.empty hands out buffers full of ones, and each kernel's outputs
    must still equal the plain version's everywhere (at S = 100 the row
    walk stores its rows word by word, and the deposit's planes start off
    16-byte words)."""
    moves, seg_qlen, w_end = _walk_case(cuda, S, W, "random", n=256)
    dep = _deposit_case(cuda, S, W, 255, 5, source="random")
    maxc = align.max_tape_cols(S, W, 0.65)
    real_empty = torch.empty

    def ones_empty(*size, **kw):
        return real_empty(*size, **kw).fill_(1)

    monkeypatch.setattr(torch, "empty", ones_empty)
    got = (walk_kernel.traceback_rows_cuda(moves, seg_qlen, w_end, W),
           walk_kernel.traceback_ops_cuda(moves, seg_qlen, w_end, W, maxc),
           _flat(walk_kernel.deposit_rows_cuda(*dep, S=S, W=W)))
    monkeypatch.undo()
    torch.cuda.synchronize()
    ops_plain = align.traceback_ops_plain(moves, seg_qlen, w_end, W, maxc)
    want = (align.traceback_rows_plain(moves, seg_qlen, w_end, W),
            (ops_plain[0], ops_plain[3]),
            _flat(consensus_banded.plane_inputs_plain(*dep, S, W)))
    for g_set, w_set in zip(got, want):
        for g, w in zip(g_set, w_set):
            assert torch.equal(g, w)


def test_walk_kernels_reject_what_they_do_not_take(cuda):
    S, W = 128, 64
    moves, seg_qlen, w_end = _walk_case(cuda, S, W, "random", n=64)
    rr, lr, q, qseed = _deposit_case(cuda, S, W, 65, 3)
    rows_fn = walk_kernel.traceback_rows_cuda
    cols_fn = walk_kernel.traceback_ops_cuda
    dep_fn = lambda rr, lr, q, qseed, W=W: walk_kernel.deposit_rows_cuda(
        rr, lr, q, qseed, S=S, W=W)
    with pytest.raises(TypeError):                  # dtype
        rows_fn(moves, seg_qlen.long(), w_end, W)
    with pytest.raises(TypeError):
        cols_fn(moves.to(torch.int16), seg_qlen, w_end, W, 192)
    with pytest.raises(TypeError):
        dep_fn(rr, (*lr[:6], lr[6].to(torch.int32)), q, qseed)
    with pytest.raises(ValueError):                 # shape
        rows_fn(moves, seg_qlen, w_end, 2 * W)
    with pytest.raises(ValueError):
        cols_fn(moves, seg_qlen[:-1], w_end, W, 192)
    with pytest.raises(ValueError):
        dep_fn((rr[0][:, :, :-1], *rr[1:]), lr, q, qseed)
    W_off = dp_kernel.BAND_MAX + 16
    with pytest.raises(ValueError):                 # a W the kernels refuse
        rows_fn(moves.new_zeros(64, S, W_off // 16), seg_qlen, w_end, W_off)
    with pytest.raises(ValueError):
        cols_fn(moves.new_zeros(64, S, W_off // 16), seg_qlen, w_end, W_off,
                192)
    with pytest.raises(ValueError):                 # device
        rows_fn(moves, seg_qlen.cpu(), w_end, W)
    with pytest.raises(ValueError):
        cols_fn(moves.cpu(), seg_qlen, w_end, W, 192)
    with pytest.raises(ValueError):
        dep_fn(rr, lr, q, qseed.cpu())
    with pytest.raises(ValueError):                 # not contiguous
        rows_fn(moves.transpose(0, 1).contiguous().transpose(0, 1),
                seg_qlen, w_end, W)
    with pytest.raises(ValueError):
        cols_fn(moves, seg_qlen, torch.stack([w_end, w_end], 1)[:, 0], W,
                192)
    with pytest.raises(ValueError):
        dep_fn((rr[0], rr[1].transpose(0, 1).contiguous().transpose(0, 1),
                *rr[2:]), lr, q, qseed)
    with pytest.raises(ValueError):                 # an odd W
        dep_fn(rr, lr, q, qseed, W=W + 1)
    # moves that start off a 16-byte boundary: taken, word by word
    odd = moves.reshape(-1)[1:1 + moves.numel() - moves[0].numel()].view(
        63, S, W // 16)
    for g, w in zip(rows_fn(odd, seg_qlen[:63], w_end[:63], W),
                    align.traceback_rows_plain(odd, seg_qlen[:63],
                                               w_end[:63], W)):
        assert torch.equal(g, w)



def _on(dev, a):
    return torch.as_tensor(np.array(a), device=dev)

@pytest.mark.parametrize("S,W,L_t,source", [
    (512, 128, 4096, "path"), (512, 128, 2000, "edge"), (128, 64, 2048,
                                                           "path"),
    (128, 64, 1200, "edge"), (128, 1024, 900, "edge"),
    (128, 2048, 700, "edge"), (128, 3088, 900, "edge"),
    (128, 4096, 900, "edge"), (128, 8192, 700, "edge"),
    (128, dp_kernel.BAND_MAX, 700, "edge")])
def test_tag_fold_kernels_match_plain(cuda, S, W, L_t, source):
    """The planes kernel and the fold kernel against their plain versions,
    every element (planes, counts, cov_diff), one launch each; at the band
    widths past 3072 too, where the deposit planes are S + W/2 - 1 wide."""
    plane_args, fold_args = fold_case(cuda, S, W, L_t, source)
    before = walk_kernel.launches()
    got = consensus_banded.global_planes(*plane_args, L_t=L_t, S=S, W=W)
    want = consensus_banded.banded_global_planes_plain(*plane_args, L_t=L_t,
                                                       S=S, W=W)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    counts, cov = fold_args[0].clone(), fold_args[1].clone()
    consensus_banded.fold_tags(counts, cov, *got, *fold_args[2:], L_t)
    consensus_banded.fold_tags_plain(fold_args[0], fold_args[1], *want,
                                     *fold_args[2:], L_t)
    torch.cuda.synchronize()
    assert torch.equal(counts, fold_args[0]) and torch.equal(cov, fold_args[1])
    assert int(counts.sum()) > 1000
    assert walk_kernel.launches_since(before) == {
        "walk_launches_rows": 0, "walk_launches_deposit": 0,
        "walk_launches_cols": 0, "walk_launches_planes": 1,
        "walk_launches_fold": 1}


def _select_pairs(plane_args, fold_args, idx):
    """The tag fold's arguments of pairs ``idx`` alone (contiguous)."""
    pick = lambda t, dim: t.index_select(dim, idx).contiguous()
    planes_r, planes_l, side_r, side_l, lj_end, tseed = plane_args
    return ([tuple(pick(t, 1) for t in planes_r),
             tuple(pick(t, 1) for t in planes_l),
             tuple(pick(t, 1) for t in side_r),
             tuple(pick(t, 1) for t in side_l), pick(lj_end, 1),
             pick(tseed, 0)],
            [*fold_args[:2], *(pick(t, 0) for t in fold_args[2:])])


@pytest.mark.parametrize("case", ["one pair", "ragged tile", "tile + 1",
                                  "deep pile", "one slot", "many segments",
                                  "many pairs"])
def test_tag_fold_kernels_match_plain_at_tile_edges(cuda, case):
    """The planes kernel's tiles of 1,024 columns and the fold at their
    edges, every element against the plain versions:
    one pair of a path chunk; an L_t of 2,500 (a last tile of 452
    columns), whose edge pairs put side-band cells at tile 0's last and
    tile 1's first column; an L_t of 1,025 (a last tile of one column,
    which holds a side-band cell); the path pairs of a chunk on 4 slots;
    every edge pair on one slot; 40 right and 36 left segments (more than
    a warp's lanes: the planes kernel lists them in rounds); 600 edge
    pairs on 3 slots."""
    S, W = 512, 128
    if case in ("one pair", "deep pile"):
        L_t = 4096
        plane_args, fold_args = fold_case(cuda, S, W, L_t, "path", B=128,
                                          T=4 if case == "deep pile" else 16)
        if case == "one pair":
            kept = int(torch.nonzero(fold_args[4])[0])
            plane_args, fold_args = _select_pairs(
                plane_args, fold_args, torch.tensor([kept], device=cuda))
    else:
        L_t = {"ragged tile": 2500, "tile + 1": 1025, "one slot": 2048,
               "many segments": 3000, "many pairs": 1500}[case]
        plane_args, fold_args = fold_case(
            cuda, S, W, L_t, "edge", B=600 if case == "many pairs" else 64,
            T={"one slot": 1, "many pairs": 3}.get(case, 16),
            segs=(40, 36) if case == "many segments" else (6, 5))
    got = consensus_banded.global_planes(*plane_args, L_t=L_t, S=S, W=W)
    want = consensus_banded.banded_global_planes_plain(*plane_args, L_t=L_t,
                                                       S=S, W=W)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    counts, cov = fold_args[0].clone(), fold_args[1].clone()
    consensus_banded.fold_tags(counts, cov, *got, *fold_args[2:], L_t)
    consensus_banded.fold_tags_plain(fold_args[0], fold_args[1], *want,
                                     *fold_args[2:], L_t)
    torch.cuda.synchronize()
    assert torch.equal(counts, fold_args[0]) and torch.equal(cov, fold_args[1])
    assert int(counts.sum()) > 100


def test_planes_kernel_writes_every_element_of_uninitialised_buffers(
        cuda, monkeypatch):
    """torch.empty hands the planes kernel buffers full of ones; its planes
    must still equal the plain version's everywhere."""
    plane_args, _ = fold_case(cuda, 256, 64, 1200, "edge", B=32)
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *size, **kw: real_empty(*size, **kw).fill_(1))
    got = walk_kernel.global_planes_cuda(*plane_args, L_t=1200, S=256, W=64)
    monkeypatch.undo()
    want = consensus_banded.banded_global_planes_plain(*plane_args, L_t=1200,
                                                       S=256, W=64)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _chunk_case(dev, P=24, L_t=1500, S=128, W=64, T=4, seed=13):
    """One cns chunk's arguments: supports mutated from slices of one
    template, seeds on the true diagonal, one padding lane."""
    from mecat_tpu_torch.utils.sim import mutate, random_genome

    rng = np.random.default_rng(seed)
    tmpl = random_genome(L_t - 20, seed=seed)
    sups, qs, ts = [], [], []
    for _ in range(P):
        a = int(rng.integers(0, len(tmpl) // 2))
        b = int(rng.integers(a + 300, len(tmpl) + 1))
        sups.append(mutate(tmpl[a:b], rng, 0.04, 0.08, 0.04))
        qs.append(len(sups[-1]) // 2)
        ts.append(min(a + (b - a) // 2, len(tmpl) - 1))
    reads = [tmpl] + sups
    lens = np.array([len(r) for r in reads], np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    L_s = int(lens.max()) + 64
    fwd = np.concatenate(reads)
    vol = np.concatenate([fwd, 3 - fwd[::-1], np.zeros(L_s + 64, np.uint8)])
    real = np.ones(P, bool)
    real[-1] = False
    kw = dict(L_s=L_s, L_t=L_t, S=S, W=W, max_segs=12, max_segs_left=12,
              min_identity=60.0, min_align_size=100, min_mapping_ratio=0.05)
    arrays = (np.arange(1, P + 1, dtype=np.int32), np.zeros(P, np.int32),
              lens[1:], np.full(P, len(tmpl), np.int32),
              np.array(qs, np.int32), np.array(ts, np.int32),
              (np.arange(P) % T).astype(np.int32), np.zeros(P, np.int32),
              real)
    args = (torch.zeros((T, L_t, 16, 5), dtype=torch.int32, device=dev),
            torch.zeros((T, L_t + 1), dtype=torch.int32, device=dev),
            torch.zeros(T, dtype=torch.bool, device=dev), _on(dev, vol),
            _on(dev, starts), _on(dev, lens), int(lens.sum()),
            *(_on(dev, a) for a in arrays))
    return kw, args


def test_cns_chunk_on_cuda_launches_planes_and_fold_once(cuda):
    """One make_cns_chunk on the card: one launch each of the deposit, the
    planes and the fold, and the CPU run's counts, cov_diff and has."""
    from mecat_tpu_torch.pipeline.cns import make_cns_chunk

    kw, args = _chunk_case(cuda)
    before = walk_kernel.launches()
    got = make_cns_chunk(**kw)(*args)
    torch.cuda.synchronize()
    launched = walk_kernel.launches_since(before)
    assert launched["walk_launches_planes"] == 1
    assert launched["walk_launches_fold"] == 1
    assert launched["walk_launches_deposit"] == 1
    _, cpu_args = _chunk_case("cpu")
    want = make_cns_chunk(**kw)(*cpu_args)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int(want[0].sum()) > 10_000


def test_tag_fold_kernels_reject_what_they_do_not_take(cuda):
    """What only the card can refuse: a CPU tensor among CUDA ones, and a
    width the planes entry point refuses.  Dtype, shape and contiguity go
    through planes_args / fold_args, which the CPU tests hold."""
    plane_args, fold_args = fold_case(cuda, 128, 64, 600, "edge", B=16,
                                       T=3)
    planes_fn = walk_kernel.global_planes_cuda
    fold_fn = walk_kernel.fold_tags_cuda
    planes = planes_fn(*plane_args, L_t=600, S=128, W=64)
    bad = list(plane_args)
    bad[4] = bad[4].cpu()
    with pytest.raises(ValueError):                 # device
        planes_fn(*bad, L_t=600, S=128, W=64)
    with pytest.raises(ValueError):
        fold_fn(fold_args[0], fold_args[1].cpu(), *planes, *fold_args[2:],
                600)
    with pytest.raises(ValueError):                 # a W the kernel refuses
        planes_fn(*plane_args, L_t=600, S=128, W=63)


_BAD_SLOT = """
import torch
from mecat_tpu_torch.ops import walk_kernel
from mecat_tpu_torch.testing import fold_case

dev = torch.device("cuda")
plane_args, fold_args = fold_case(dev, 128, 64, 600, "edge", B=16, T=3)
planes = walk_kernel.global_planes_cuda(*plane_args, L_t=600, S=128, W=64)
slot = fold_args[3].clone()
slot[int(torch.nonzero(fold_args[4])[0])] = 3
walk_kernel.fold_tags_cuda(*fold_args[:2], *planes, fold_args[2], slot,
                           *fold_args[4:], 600)
try:
    torch.cuda.synchronize()
except RuntimeError as err:
    print("raised:", err)
else:
    print("no error")
"""


def test_fold_kernel_skips_a_masked_pair_and_traps_on_a_kept_one(cuda):
    """A pair without pair_ok touches nothing and its t_slot is not read,
    even one outside [0, T); a kept pair's slot outside [0, T) stops the
    kernel, and the next synchronisation raises (in a process of its own:
    the trap ends the CUDA context)."""
    import subprocess
    import sys

    plane_args, fold_args = fold_case(cuda, 128, 64, 600, "edge", B=16, T=3)
    masked = int(torch.nonzero(~fold_args[4])[0])
    planes = walk_kernel.global_planes_cuda(*plane_args, L_t=600, S=128,
                                            W=64)
    slot = fold_args[3].clone()
    slot[masked] = 1 << 20
    counts, cov = fold_args[0].clone(), fold_args[1].clone()
    walk_kernel.fold_tags_cuda(counts, cov, *planes, fold_args[2], slot,
                               *fold_args[4:], 600)
    consensus_banded.fold_tags_plain(fold_args[0], fold_args[1], *planes,
                                     *fold_args[2:], 600)
    torch.cuda.synchronize()
    assert torch.equal(counts, fold_args[0]) and torch.equal(cov, fold_args[1])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", _BAD_SLOT], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert "raised:" in run.stdout, (run.stdout, run.stderr)
