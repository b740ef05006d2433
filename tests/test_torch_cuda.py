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
from mecat_tpu_torch.ops import align, dp_kernel, roll_micro
from mecat_tpu_torch.pipeline.device_step import overlap_step
from mecat_tpu_torch.pipeline.pw import PwOptions, run_pw
from mecat_tpu_torch.testing import (GOLDEN_J1, dp_inputs, dp_inputs_full,
                                     roll_micro_inputs)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the kernels run only on a CUDA device")
    return torch.device("cuda")


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
    with pytest.raises(ValueError):
        dp_kernel.dp_segment_best_moves_cuda(
            q, tpad.new_zeros(64, S + 96), tmax, seg_q, active, S, 96)
    with pytest.raises(TypeError):
        dp_kernel.dp_segment_best_moves_cuda(q, tpad, tmax.long(), seg_q,
                                             active, S, W)


def test_run_cns_golden_bytes_on_cuda(cuda):
    from mecat_tpu_torch.pipeline.cns import CnsOptions, run_cns
    from mecat_tpu_torch.testing import GOLDEN_CNS

    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "corrected.fasta")
        before = dp_kernel.LAUNCHES_MOVES
        run_cns(os.path.join(GOLDEN, "candidates.txt"),
                os.path.join(GOLDEN, "reads.fasta"), out,
                CnsOptions(**GOLDEN_CNS), device=cuda)
        assert dp_kernel.LAUNCHES_MOVES > before
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
    with pytest.raises(ValueError):
        dp_kernel.dp_segment_best_cuda(q, tpad, tmax, seg_q, active, S, 96)
    S_big = 8192             # 4 lanes of q and t overflow 48 KB of smem
    with pytest.raises(ValueError):
        dp_kernel.dp_segment_best_cuda(
            q.new_zeros(64, S_big), tpad.new_zeros(64, S_big + W), tmax,
            seg_q, active, S_big, W)
    with pytest.raises(ValueError):
        dp_kernel.dp_segment_best_cuda(q, tpad.T.contiguous().T, tmax, seg_q,
                                       active, S, W)


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
        before = dp_kernel.LAUNCHES
        run_pw(os.path.join(GOLDEN, "reads.fasta"), out, os.path.join(d, "w"),
               PwOptions(**GOLDEN_J1), device=cuda)
        assert dp_kernel.LAUNCHES > before
        with open(out, "rb") as fh, \
                open(os.path.join(GOLDEN, "overlaps.m4"), "rb") as gh:
            assert fh.read() == gh.read()


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
                    assert stats.dp_launches > 0
                    assert (stats.dp_launches_moves > 0) == (fmt == "sam")
                    assert stats.mapped == db.n_reads
            assert outs["cuda"] == outs["cpu"] and len(outs["cpu"]) > 200
