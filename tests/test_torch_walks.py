"""The device scans of correction and mapping on the CPU: the plain
versions of the three walk kernels against the JAX package, exact.

``traceback_rows_plain`` and ``traceback_ops_plain`` are held against
``mecat_tpu.ops.align.traceback_rows`` / ``traceback_ops`` on random move
words (every code, negative words, walks that break) with lanes whose
seg_qlen is -1, 0, S or S + 3 and whose w_end is -1, 0, W - 1 or W;
``deposit_scan_plain`` against ``mecat_tpu.ops.consensus_banded.
_deposit_scan`` on the rows of real walks and on random rows, at band
widths up to 2048 (a DP lane of several warps past 512).  NumPy models of
the kernels' orders (``testing.walk_rows_words``, ``walk_cols_rows``,
``deposit_scan_warp``) are held against the plain versions.  The public
names take the plain versions for CPU tensors without touching
``ops/walk_kernel``.  The kernels themselves are held against these plain
versions in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread is as fast, and several test workers share the cores
torch.set_num_threads(1)
jnp = pytest.importorskip("jax.numpy")

from mecat_tpu.ops import align as ref_align
from mecat_tpu.ops import consensus_banded as ref_cb
from mecat_tpu_torch.ops import align, walk_kernel
from mecat_tpu_torch.ops import consensus_banded as cb
from mecat_tpu_torch.testing import (deposit_inputs, deposit_rows_inputs,
                                     deposit_scan_warp, walk_cols_rows,
                                     walk_inputs, walk_rows_words)

SHAPES = [(24, 32), (40, 64), (32, 128), (24, 384), (16, 512), (24, 528),
          (16, 1024), (16, 2048)]


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _ref_moves(moves):
    return jnp.asarray(moves.transpose(1, 2, 0))     # [S, W/16, N] there


def _assert_equal(got, want, names):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("S,W", SHAPES)
def test_traceback_rows_plain_matches_jax_on_random_words(S, W):
    moves, seg_qlen, w_end = walk_inputs(S, W, 48, seed=S + W)
    want = ref_align.traceback_rows(_ref_moves(moves), jnp.asarray(seg_qlen),
                                    jnp.asarray(w_end), W)
    got = align.traceback_rows_plain(*_t(moves, seg_qlen, w_end), W)
    _assert_equal(got, want, ("mv", "h", "w_out", "w0"))
    mv = got[0].numpy()
    # the edge lanes: nothing visited at seg_qlen -1 or 0, row S at S, S + 3
    assert (mv[:8] == -1).all() and (mv[8:16, -1] >= 0).any()
    # some walk broke below its start, some left a row vertically
    visited = mv >= 0
    assert (visited[:, 1:] & ~visited[:, :-1]).any()
    assert (mv == align.MOVE_VERT).any()


@pytest.mark.parametrize("S,W", SHAPES)
@pytest.mark.parametrize("max_cols", [0, 64, 30])
def test_traceback_ops_plain_matches_jax_on_random_words(S, W, max_cols):
    moves, seg_qlen, w_end = walk_inputs(S, W, 48, seed=2 * S + W)
    want = ref_align.traceback_ops(_ref_moves(moves), jnp.asarray(seg_qlen),
                                   jnp.asarray(w_end), W, max_cols=max_cols)
    got = align.traceback_ops_plain(*_t(moves, seg_qlen, w_end), W,
                                    max_cols=max_cols)
    _assert_equal(got, want, ("ops", "qi", "tj", "n_cols"))
    n_cols = got[3].numpy()
    maxc = max_cols or 2 * S + W
    assert got[0].shape == (48, maxc)
    assert n_cols[0] == 0 and (n_cols == maxc).any() and (n_cols < maxc).any()
    # the column-walk kernel's row steps, on the same words
    model = walk_cols_rows(moves, seg_qlen, w_end, W, max_cols)
    np.testing.assert_array_equal(model[0], np.asarray(want[0]))
    np.testing.assert_array_equal(model[1], np.asarray(want[3]))


@pytest.mark.parametrize("S,W", [(40, 64), (32, 128), (24, 384), (16, 512),
                                 (16, 528), (24, 1024), (16, 2048)])
@pytest.mark.parametrize("rows_from", ["walk", "random"])
def test_deposit_scan_plain_matches_jax(S, W, rows_from):
    walk = None
    if rows_from == "walk":
        moves, seg_qlen, w_end = walk_inputs(S, W, 40, seed=3 * S + W)
        walk = [a.numpy() for a in align.traceback_rows_plain(
            *_t(moves, seg_qlen, w_end), W)[:3]]
    args = deposit_inputs(S, W, 40, seed=S + 7 * W, walk=walk)
    want = ref_cb._deposit_scan(*(jnp.asarray(a) for a in args), W)
    got = cb.deposit_scan_plain(*_t(*args), W)
    assert got[0].shape == (40, S + W // 2 - 1)
    _assert_equal(got, want, ("val0", "ipack", "icnt"))
    val0, ipack, icnt = (g.numpy() for g in got)
    assert (val0 == cb.GAP).any() and (val0 >= 0).any() and (val0 == -1).any()
    assert icnt.max() > cb.MAXD                # a run too long to pack
    if rows_from == "random":
        assert (ipack < 0).any()               # vbase << 28 wrapped
        wo, aw, h, mv = args[:4]
        assert ((wo + h >= W) & (mv >= 0)).any() and (aw == W).any()


@pytest.mark.parametrize("S,W", SHAPES + [(40, 16), (40, 48), (40, 80),
                                          (72, 160), (24, 272)])
def test_row_walk_kernel_model_matches_plain(S, W):
    """The row-walk kernel's step (w's own word masked at w, else the word
    below it, else a search down the lower words) on random words with the
    edge lanes, which break paths and run them sideways across words, at
    row widths of 1 to 32 words."""
    args = walk_inputs(S, W, 48, seed=5 * S + W)
    got = walk_rows_words(*args, W)
    want = align.traceback_rows_plain(*_t(*args), W)
    for name, g, w in zip(("mv", "h", "w_out", "w0"), got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    assert (got[0] == align.MOVE_VERT).any()


@pytest.mark.parametrize("S,W", SHAPES + [(40, 16), (40, 48), (40, 80),
                                          (72, 160), (24, 272), (30, 1040)])
@pytest.mark.parametrize("max_cols", [0, 64, 30, 61])
def test_col_walk_kernel_model_matches_plain(S, W, max_cols):
    """The column-walk kernel's row steps (the row's exit by the two-word
    test, its run of horizontal codes and the exit emitted at once, the
    slow step's flat, clipped reads down the rows below, row 0's leading
    deletions, the cut after exactly MAXC columns, tape words shared with
    the next lane where MAXC % 4 != 0) on random words with the edge lanes,
    which break paths and run them sideways across rows, and on walks
    longer than MAXC.  Lane 47's words are all horizontal: its run passes
    row 1 into word 0 read again and again, to the cut."""
    moves, seg_qlen, w_end = walk_inputs(S, W, 48, seed=7 * S + W)
    moves[47] = -1
    seg_qlen[47], w_end[47] = S, W // 2
    got = walk_cols_rows(moves, seg_qlen, w_end, W, max_cols)
    want = align.traceback_ops_plain(*_t(moves, seg_qlen, w_end), W,
                                     max_cols=max_cols)
    np.testing.assert_array_equal(got[0], want[0].numpy(), err_msg="ops")
    np.testing.assert_array_equal(got[1], want[3].numpy(), err_msg="n_cols")
    maxc = max_cols or 2 * S + W
    assert got[1][47] == maxc and (got[1] < maxc).any()


@pytest.mark.parametrize("S,W", [(40, 64), (100, 64), (72, 128), (24, 384),
                                 (24, 1024)])
@pytest.mark.parametrize("rows_from", ["walk", "random"])
def test_deposit_kernel_model_matches_plain(S, W, rows_from):
    """The deposit kernel's order (passes of 32 rows, keys with the base's
    byte below them, gap cells shared out over the warp by a prefix sum and
    a binary search) on the rows of real walks and on random rows."""
    walk = None
    if rows_from == "walk":
        moves, seg_qlen, w_end = walk_inputs(S, W, 24, seed=S + W)
        walk = walk_rows_words(moves, seg_qlen, w_end, W)[:3]
    args = deposit_inputs(S, W, 24, seed=3 * S + W, walk=walk)
    got = deposit_scan_warp(*args, W)
    want = cb.deposit_scan_plain(*_t(*args), W)
    for name, g, w in zip(("val0", "ipack", "icnt"), got, want):
        assert g.dtype == w.numpy().dtype, name
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    if rows_from == "random":              # some pass had over 32 gap cells
        wo, _, h, mv = args[:4]
        cells = np.where(mv >= 0, np.clip(np.minimum(wo + h, W - 1) - wo, 0,
                                          None), 0)
        assert cells[:, :32].sum(axis=1).max() > 32


def _rows():
    """The deposit's inputs (plane_inputs' arguments but S and W) as CPU
    tensors."""
    rr, lr, q, qseed = deposit_rows_inputs(24, 64, 20, 60, seed=1)
    return tuple(_t(*rr)), tuple(_t(*lr)), *_t(q, qseed)


def _flat(out):
    """plane_inputs' nested result as one list of tensors."""
    return [t for x in out for t in (x if isinstance(x, tuple) else (x,))]


SCANS = {
    "traceback_rows": lambda a: align.traceback_rows(
        *_t(*walk_inputs(24, 64, 20, seed=1)), 64),
    "traceback_ops": lambda a: align.traceback_ops(
        *_t(*walk_inputs(24, 64, 20, seed=1)), 64, max_cols=64),
    "_deposit_scan": lambda a: cb._deposit_scan(
        *_t(*deposit_inputs(24, 64, 20, seed=1)), 64),
    "plane_inputs": lambda a: _flat(cb.plane_inputs(*_rows(), 24, 64)),
}
PLAIN = {
    "traceback_rows": lambda a: align.traceback_rows_plain(
        *_t(*walk_inputs(24, 64, 20, seed=1)), 64),
    "traceback_ops": lambda a: align.traceback_ops_plain(
        *_t(*walk_inputs(24, 64, 20, seed=1)), 64, max_cols=64),
    "_deposit_scan": lambda a: cb.deposit_scan_plain(
        *_t(*deposit_inputs(24, 64, 20, seed=1)), 64),
    "plane_inputs": lambda a: _flat(cb.plane_inputs_plain(*_rows(), 24, 64)),
}


@pytest.mark.parametrize("name", list(SCANS))
def test_cpu_tensors_take_the_plain_version(name, monkeypatch):
    """The public name on CPU tensors: the plain version's result, no
    kernel wrapper called, no counter moved."""
    def refuse(*a, **kw):
        raise AssertionError("a walk kernel was reached from CPU tensors")

    for fn in ("_load", "traceback_rows_cuda", "deposit_rows_cuda",
               "traceback_ops_cuda"):
        monkeypatch.setattr(walk_kernel, fn, refuse)
    before = walk_kernel.launches()
    got = SCANS[name](None)
    assert walk_kernel.launches() == before
    for g, w in zip(got, PLAIN[name](None)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["rows", "ops", "deposit"])
def test_kernel_wrappers_refuse_cpu_tensors(name):
    moves, seg_qlen, w_end = _t(*walk_inputs(24, 64, 20, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        if name == "rows":
            walk_kernel.traceback_rows_cuda(moves, seg_qlen, w_end, 64)
        elif name == "ops":
            walk_kernel.traceback_ops_cuda(moves, seg_qlen, w_end, 64, 64)
        else:
            rr, lr, q, qseed = deposit_rows_inputs(24, 64, 20, 60, seed=1)
            walk_kernel.deposit_rows_cuda(
                tuple(_t(*rr)), tuple(_t(*lr)), *_t(q, qseed), S=24, W=64)
