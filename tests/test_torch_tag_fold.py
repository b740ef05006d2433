"""The tag fold's kernels on the CPU: their NumPy models against the plain
versions and the JAX package, exact equality.

``testing.deposit_rows_warp`` makes the deposit's row information as the
deposit kernel (``csrc/cns_walk.cu``) does, in passes of 32 rows with
carries, and is held against ``direction_rowinfo`` and the plain
``plane_inputs`` on walk-shaped and random rows with edge lanes.

``testing.global_planes_tiled`` makes the global planes in the planes
kernel's order (a tile at a time: the tile's segments listed, each output
column's last writer found among them, the side-band chains of the tile's
cells in order), ``testing.global_planes_pairwise`` the same a pair at a
time; ``testing.fold_tags_cells`` folds them as the fold kernel does (one
add a present cell).  Each is held element for element against the port's plain version (``banded_global_planes_plain``,
``fold_tags_plain``) and against ``mecat_tpu.ops.consensus_banded.
banded_global_planes`` / ``banded_accumulate_tags``: on the correction piles
of ``test_torch_cns_banded._pile`` (rows from the JAX extension) and on the
edge inputs of ``testing.fold_inputs``, whose planes reach the JAX functions
through their own deposit hooks.  CPU tensors take the plain versions and
never build or load the fold library.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread is as fast, and several test workers share cores
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from mecat_tpu import constants as ref_C
from mecat_tpu.ops import align as ref_align
from mecat_tpu.ops import consensus_banded as ref
from mecat_tpu_torch.ops import consensus_banded as port
from mecat_tpu_torch.ops import cuda_build, walk_kernel
from mecat_tpu_torch.pipeline import cns as port_cns
from mecat_tpu_torch.testing import (FOLD_KEYS, PLANE_KEYS, PLANES_TILE,
                                     deposit_rows_inputs, deposit_rows_warp,
                                     fold_inputs, fold_tags_cells,
                                     global_planes_pairwise,
                                     global_planes_tiled)
from test_torch_cns_banded import _pile

D1 = ref_C.MAX_INS_DELTA + 1

#: (S, W) of the piles: the golden and wide cns shapes, and a band past 512
PILE_WIDTHS = [(256, 64), (512, 128), (512, 640)]
#: (S, W, L_t) of the edge inputs; W = 1024 is a band past 512
EDGE_WIDTHS = [(64, 32, 300), (256, 64, 1200), (512, 128, 2000),
               (128, 1024, 900)]
#: (S, W) of the deposit's row-information model: one pass and a ragged
#: last pass of 32 rows, the cns cell's shape, a band past 512
ROWINFO_WIDTHS = [(64, 32), (100, 48), (512, 128), (128, 1024)]
#: tiles of the tiled planes model: boundaries inside every window (64,
#: 300; the edge pairs' side-band cells a column before and after one) and
#: the kernel's own
PLANE_TILES = [64, 300, PLANES_TILE]


def _tt(a):
    if isinstance(a, tuple):
        return tuple(_tt(x) for x in a)
    return torch.as_tensor(np.array(a))


def _jj(a):
    if isinstance(a, tuple):
        return tuple(_jj(x) for x in a)
    return jnp.asarray(np.array(a))


@functools.lru_cache(maxsize=None)
def _pile_case(S, W):
    """A correction pile at (S, W), its JAX row walks and the fold's pair
    arrays, as numpy."""
    G, B, T = 3, 10, 3
    L_t = 4 * S
    q, t, qlen, tlen, qs, ts, t_slot = _pile(
        S=S, W=W, G=G, B=B, L_t=L_t, L_s=L_t + S, T=T, err=0.06,
        seed=S + W, ins_heavy=True)
    pa, rr, lr = ref_align.extend_pair_batch_rows(
        *(jnp.asarray(a) for a in (q, t, qlen, tlen, qs, ts)),
        S=S, W=W, max_segs=G, max_segs_left=G)
    pair_ok = np.asarray((pa.identity >= 60.0) & ((pa.tend - pa.tbeg) >= 20))
    rows = tuple(tuple(np.asarray(x) for x in r) for r in (rr, lr))
    return dict(q=q, qs=qs, ts=ts, tlen=tlen, t_slot=t_slot,
                pair_ok=pair_ok, tbeg=np.asarray(pa.tbeg),
                tend=np.asarray(pa.tend), rows=rows, L_t=L_t, T=T)


def _assert_planes_equal(got, want, what):
    for name, g, w in zip(("g0", "gpack", "gcnt"), got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, (what, name)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("S,W", PILE_WIDTHS)
def test_global_planes_on_piles_match_jax(S, W):
    c = _pile_case(S, W)
    rr, lr = c["rows"]
    want = ref.banded_global_planes(_jj(rr), _jj(lr), jnp.asarray(c["q"]),
                                    jnp.asarray(c["qs"]),
                                    jnp.asarray(c["ts"]), L_t=c["L_t"], S=S,
                                    W=W)
    got = port.banded_global_planes(_tt(rr), _tt(lr), _tt(c["q"]),
                                    _tt(c["qs"]), _tt(c["ts"]), L_t=c["L_t"],
                                    S=S, W=W)
    _assert_planes_equal(got, want, "plain vs JAX")
    inputs = port.plane_inputs(_tt(rr), _tt(lr), _tt(c["q"]), _tt(c["qs"]),
                               S, W)
    for model in (global_planes_pairwise, global_planes_tiled):
        got = model(*(tuple(t.numpy() for t in x) for x in inputs[:4]),
                    inputs[4].numpy(), c["ts"], c["L_t"], S, W)
        _assert_planes_equal(got, want, f"{model.__name__} vs JAX")
    got = global_planes_tiled(
        *(tuple(t.numpy() for t in x) for x in inputs[:4]),
        inputs[4].numpy(), c["ts"], c["L_t"], S, W, tile=S // 2 + 7)
    _assert_planes_equal(got, want, "tiles of S/2 + 7 vs JAX")
    assert int((np.asarray(want[2]) > 0).sum()) > 5     # insertions landed


@pytest.mark.parametrize("S,W", PILE_WIDTHS)
def test_accumulate_tags_on_piles_match_jax(S, W):
    c = _pile_case(S, W)
    rr, lr = c["rows"]
    T, L_t = c["T"], c["L_t"]
    assert 3 < c["pair_ok"].sum()
    want_c, want_v = ref.banded_accumulate_tags(
        jnp.zeros((T, L_t, D1, 5), jnp.int32),
        jnp.zeros((T, L_t + 1), jnp.int32), _jj(rr), _jj(lr),
        jnp.asarray(c["qs"]), jnp.asarray(c["ts"]), jnp.asarray(c["q"]),
        *(jnp.asarray(c[k]) for k in FOLD_KEYS), L_t=L_t, S=S, W=W)
    counts = torch.zeros((T, L_t, D1, 5), dtype=torch.int32)
    cov = torch.zeros((T, L_t + 1), dtype=torch.int32)
    got_c, got_v = port.banded_accumulate_tags(
        counts, cov, _tt(rr), _tt(lr), _tt(c["qs"]), _tt(c["ts"]),
        _tt(c["q"]), *(_tt(c[k]) for k in FOLD_KEYS), L_t=L_t, S=S, W=W)
    assert got_c is counts and got_v is cov            # tallied in place
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    planes = port.banded_global_planes(_tt(rr), _tt(lr), _tt(c["q"]),
                                       _tt(c["qs"]), _tt(c["ts"]), L_t=L_t,
                                       S=S, W=W)
    model_c, model_v = fold_tags_cells(
        np.zeros((T, L_t, D1, 5), np.int32),
        np.zeros((T, L_t + 1), np.int32), *(p.numpy() for p in planes),
        *(c[k] for k in FOLD_KEYS), L_t)
    np.testing.assert_array_equal(model_c, np.asarray(want_c))
    np.testing.assert_array_equal(model_v, np.asarray(want_v))
    assert int(np.asarray(want_c).sum()) > 1000


def _jax_planes_from(fi, L_t, S, W, monkeypatch):
    """JAX ``banded_global_planes`` on the planes of ``fold_inputs``: its row
    info and its deposit are replaced by these planes, the rest (the lead
    marks, the window scan, the placement, the side-band chains) is the
    JAX package's own code, run without jit."""
    G_r, G_l = fi["side_r"][0].shape[0], fi["side_l"][0].shape[0]
    B = len(fi["tseed"])

    def rowinfo(rows, q, qseed, S_, W_, left):
        side = fi["side_l" if left else "side_r"]
        G = G_l if left else G_r
        info = {k: jnp.zeros((G, B, S), jnp.int32)
                for k in ("wo", "aw", "h", "mv", "vbase", "delta",
                          "keep_ins")}
        toff, ok, lead, bp, bc = (jnp.asarray(a) for a in side)
        j_end = jnp.asarray(fi["lj_end"]) if left else None
        return info, bp, bc, toff, j_end, lead, ok

    def deposit(*args):
        return tuple(jnp.concatenate(
            [jnp.asarray(r.reshape(-1, r.shape[-1])),
             jnp.asarray(l.reshape(-1, l.shape[-1]))], axis=0)
            for r, l in zip(fi["planes_r"], fi["planes_l"]))

    monkeypatch.setattr(ref, "direction_rowinfo", rowinfo)
    monkeypatch.setattr(ref, "_deposit_scan", deposit)
    rows = lambda side: (None,) * 6 + (jnp.asarray(side[1]),)
    with jax.disable_jit():
        return ref.banded_global_planes(
            rows(fi["side_r"]), rows(fi["side_l"]), jnp.zeros((B, 1)), None,
            jnp.asarray(fi["tseed"]), L_t=L_t, S=S, W=W)


@pytest.mark.parametrize("S,W,L_t", EDGE_WIDTHS)
def test_global_planes_on_edge_inputs_match_jax(S, W, L_t, monkeypatch):
    fi = fold_inputs(S, W, 24, L_t, 5, seed=S + W)
    want = _jax_planes_from(fi, L_t, S, W, monkeypatch)
    got = port.banded_global_planes_plain(
        *(_tt(fi[k]) for k in PLANE_KEYS), L_t=L_t, S=S, W=W)
    _assert_planes_equal(got, want, "plain vs JAX")
    model = global_planes_pairwise(*(fi[k] for k in PLANE_KEYS), L_t, S, W)
    _assert_planes_equal(model, want, "model vs JAX")


@pytest.mark.parametrize("S,W,L_t", EDGE_WIDTHS)
def test_fold_on_edge_inputs_matches_jax(S, W, L_t, monkeypatch):
    fi = fold_inputs(S, W, 24, L_t, 5, seed=S + W + 1)
    planes = port.banded_global_planes_plain(
        *(_tt(fi[k]) for k in PLANE_KEYS), L_t=L_t, S=S, W=W)
    monkeypatch.setattr(ref, "banded_global_planes",
                        lambda *a, **kw: tuple(jnp.asarray(p.numpy())
                                               for p in planes))
    want_c, want_v = ref.banded_accumulate_tags(
        jnp.asarray(fi["counts"]), jnp.asarray(fi["cov_diff"]), None, None,
        None, None, None, *(jnp.asarray(fi[k]) for k in FOLD_KEYS),
        L_t=L_t, S=S, W=W)
    counts, cov = _tt(fi["counts"]), _tt(fi["cov_diff"])
    port.fold_tags_plain(counts, cov, *planes,
                         *(_tt(fi[k]) for k in FOLD_KEYS), L_t)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(cov.numpy(), np.asarray(want_v))
    model_c, model_v = fold_tags_cells(
        fi["counts"], fi["cov_diff"], *(p.numpy() for p in planes),
        *(fi[k] for k in FOLD_KEYS), L_t)
    np.testing.assert_array_equal(model_c, np.asarray(want_c))
    np.testing.assert_array_equal(model_v, np.asarray(want_v))
    # the edges of the fold: gcnt past 15 deltas, b == L_t
    assert int(planes[2].max()) > 15
    slot = fi["t_slot"][9]
    assert int(want_v[slot, L_t]) < int(fi["cov_diff"][slot, L_t])


@pytest.mark.parametrize("tile", PLANE_TILES)
@pytest.mark.parametrize("S,W,L_t", EDGE_WIDTHS)
def test_tiled_planes_model_matches_plain(S, W, L_t, tile):
    """The planes kernel's tiles, modelled: per-tile segment lists and
    side-band groups against the plain version, on edge pairs placed for
    these tiles (side-band cells at a tile's first and last column, a seed
    inside a tile)."""
    fi = fold_inputs(S, W, 24, L_t, 5, seed=S + W + tile, tile=tile)
    want = port.banded_global_planes_plain(
        *(_tt(fi[k]) for k in PLANE_KEYS), L_t=L_t, S=S, W=W)
    got = global_planes_tiled(*(fi[k] for k in PLANE_KEYS), L_t, S, W, tile)
    _assert_planes_equal(got, want, f"tiles of {tile} vs plain")


@pytest.mark.parametrize("T", [5, 2, 1])
@pytest.mark.parametrize("S,W,L_t", EDGE_WIDTHS)
def test_fold_model_on_shared_slots_matches_plain(S, W, L_t, T):
    """The fold kernel's adds, modelled, against the plain version from the
    same tables where pairs share slots: several kept pairs on a slot with
    a masked one between them, a slot whose first pair is masked (T >= 2),
    every pair on one slot (T = 1).  A masked pair's slot is never read,
    even one outside [0, T); the plain version raises on a kept one."""
    fi = fold_inputs(S, W, 24, L_t, T, seed=S + W + T)
    planes = port.banded_global_planes_plain(
        *(_tt(fi[k]) for k in PLANE_KEYS), L_t=L_t, S=S, W=W)
    counts, cov = _tt(fi["counts"]), _tt(fi["cov_diff"])
    port.fold_tags_plain(counts, cov, *planes,
                         *(_tt(fi[k]) for k in FOLD_KEYS), L_t)
    args = [*(p.numpy() for p in planes), *(fi[k] for k in FOLD_KEYS)]
    slot = args[4] = fi["t_slot"].copy()
    slot[13] = 1 << 20                          # pair 13 is masked
    got_c, got_v = fold_tags_cells(fi["counts"], fi["cov_diff"], *args, L_t)
    np.testing.assert_array_equal(got_c, counts.numpy())
    np.testing.assert_array_equal(got_v, cov.numpy())
    slot[13], slot[12] = 0, T                   # pair 12 is kept
    with pytest.raises((IndexError, RuntimeError)):
        port.fold_tags_plain(_tt(fi["counts"]), _tt(fi["cov_diff"]),
                             *planes, *(_tt(a) for a in args[3:]), L_t)


@pytest.mark.parametrize("source", ["walk", "random"])
@pytest.mark.parametrize("S,W", ROWINFO_WIDTHS)
def test_deposit_rowinfo_model_matches_plain(S, W, source):
    """The deposit kernel's row information, modelled (passes of 32 rows,
    up a right lane and down a left one, run starts and ends carried
    across passes; j_end by a reduction pass first; the wrapped and clamped
    slice start; the side arrays as warp reductions), against
    ``direction_rowinfo`` row for row and against the plain
    ``plane_inputs`` on every element of the planes and side arrays.  The
    edges of ``deposit_rows_inputs``: runs across a pass border, at row 0
    and row S - 1, side-band runs at j == 0 and j == j_end longer than 15,
    lanes not ok, slice starts that wrap and clamp, 13 pairs of 3 and 2
    segments (65 lanes, not a whole number of 8-warp blocks)."""
    B, L_s = 13, 3 * S
    rr, lr, q, qseed = deposit_rows_inputs(S, W, B, L_s, seed=S + W,
                                           source=source)
    infos, got = deposit_rows_warp(rr, lr, q, qseed, S, W)
    for left, rows, info in ((False, rr, infos[0]), (True, lr, infos[1])):
        want = port.direction_rowinfo(_tt(rows), _tt(q), _tt(qseed), S, W,
                                      left=left)
        for k, w in want[0].items():
            assert info[k].dtype == w.numpy().dtype, k
            np.testing.assert_array_equal(info[k], w.numpy(),
                                          err_msg=f"left={left}: {k}")
    want = port.plane_inputs(_tt(rr), _tt(lr), _tt(q), _tt(qseed), S, W)
    names = ("planes_r", "planes_l", "side_r", "side_l")
    for name, w_set, g_set in zip(names, want[:4], got[:4]):
        for k, (w, g) in enumerate(zip(w_set, g_set)):
            assert g.dtype == w.numpy().dtype, (name, k)
            np.testing.assert_array_equal(g, w.numpy(),
                                          err_msg=f"{name}[{k}]")
    np.testing.assert_array_equal(got[4], want[4].numpy(), err_msg="j_end")
    if source == "walk":
        # the edges happened: long runs and side-band runs on both sides,
        # insertions deposited, lanes not ok
        assert all(int(i["delta"].max()) > 15 for i in infos)
        assert int(got[2][4][0, 0]) == 18 and int(got[3][4][0, 1]) == 18
        assert int(got[3][4][0, 1]) == int(want[3][4][0, 1])
        assert int(got[0][2].max()) > 0 and int(got[1][2].max()) > 0
        assert not rr[6][0, 5] and not lr[6][0, 5]


def test_deposit_argument_checks_refuse_what_the_kernel_does_not_take():
    rr, lr, q, qseed = (_tt(a) for a in deposit_rows_inputs(
        64, 32, 6, 200, seed=9))
    cpu = torch.device("cpu")
    kw = dict(S=64, W=32, device=cpu)
    assert walk_kernel.deposit_rows_args(rr, lr, q, qseed, **kw) == (
        6, 200, 3, 2)
    with pytest.raises(TypeError):                       # q not uint8
        walk_kernel.deposit_rows_args(rr, lr, q.to(torch.int32), qseed,
                                      **kw)
    with pytest.raises(TypeError):                       # int64 qseed
        walk_kernel.deposit_rows_args(rr, lr, q, qseed.long(), **kw)
    bad = (rr[0], rr[1].transpose(0, 1).contiguous().transpose(0, 1),
           *rr[2:])
    with pytest.raises(ValueError, match="contiguous"):
        walk_kernel.deposit_rows_args(bad, lr, q, qseed, **kw)
    with pytest.raises(ValueError):                      # the wrong S
        walk_kernel.deposit_rows_args(rr, lr, q, qseed, S=63, W=32,
                                      device=cpu)
    with pytest.raises(ValueError):                      # an odd W
        walk_kernel.deposit_rows_args(rr, lr, q, qseed, S=64, W=33,
                                      device=cpu)
    with pytest.raises(TypeError):                       # ok not bool
        walk_kernel.deposit_rows_args(rr, (*lr[:6], lr[6].to(torch.int32)),
                                      q, qseed, **kw)
    with pytest.raises(ValueError):                      # left of 7 pairs
        walk_kernel.deposit_rows_args(
            rr, tuple(torch.cat([a, a[:, :1]], 1) for a in lr), q, qseed,
            **kw)


def test_fold_inputs_reach_every_edge():
    """The edge pairs of ``fold_inputs`` do what its docstring says: the
    clamped windows, the non-ok segment, the boundary chains and their
    writes (the chain's count on top of the cell's run count, nothing on
    an unconsumed anchor), tend past tlen and b == L_t."""
    S, W, L_t = 256, 64, 1200
    LP = S + W // 2 - 1
    LG = L_t + LP + S
    fi = fold_inputs(S, W, 24, L_t, 5, seed=3)
    toff_r, ok_r = fi["side_r"][:2]
    assert list(fi["tseed"][:3]) == [0, L_t, L_t + 7]
    assert not ok_r[1, 3] and ok_r[0, 3] and ok_r[2, 3]
    assert not fi["side_l"][1][1, 3] and fi["side_l"][1][2, 3]
    assert toff_r[0, 4] < 0 and toff_r[-1, 4] > LG - LP
    g0, gp, gc = port.banded_global_planes_plain(
        *(_tt(fi[k]) for k in PLANE_KEYS), L_t=L_t, S=S, W=W)
    for b, want in ((5, 3 + 4 + 5 + 2), (6, 13 + 2 + 3 + 2),
                    (10, 10 + 5 + 3 + 2), (7, 3)):
        col = int(fi["tseed"][b]) - 1
        assert int(gc[b, col]) == want, b
    assert int(g0[7, int(fi["tseed"][7]) - 1]) < 0
    assert fi["tend"][8] > fi["tlen"][8] and fi["pair_ok"][8]
    assert min(fi["tlen"][9], fi["tend"][9]) > L_t and fi["pair_ok"][9]
    assert not fi["pair_ok"][11]
    # the slots: 12-14 on slot 0 kept, masked, kept; pair 11 (masked) the
    # first of slot T - 1, which pair 17 shares
    slot, ok = fi["t_slot"], fi["pair_ok"]
    assert list(slot[12:15]) == [0, 0, 0] and list(ok[12:15]) == [1, 0, 1]
    assert slot[11] == 4 and 4 not in slot[:11] and slot[17] == 4 and ok[17]
    # the tiles of 1024: the chain at the last column of tile 0 and at the
    # first of tile 1; a seed inside a tile (tile 1 ends past L_t)
    for b, col in ((15, 1023), (16, 1024)):
        assert int(fi["tseed"][b]) - 1 == col
        assert int(gc[b, col]) == 3 + 4 + 5 + 2, b
    assert fi["tseed"][17] == L_t // 2
    small = fold_inputs(S, W, 24, 600, 1, seed=3)
    assert list(small["tseed"][15:17]) == [600, 1]      # one tile
    assert not small["t_slot"].any()                    # every pair on one


def _small_chunk():
    """One cns chunk's arguments on the CPU (a pile of 12 supports)."""
    P, L_t, L_s, S, W, T = 12, 600, 900, 128, 64, 3
    rng = np.random.default_rng(21)
    q, t, qlen, tlen, qs, ts, t_slot = _pile(
        S=S, W=W, G=4, B=P, L_t=L_t, L_s=L_s, T=T, err=0.1, seed=21)
    reads = [t[0, :tlen[0]]] + [q[b, :qlen[b]] for b in range(P)]
    lens = np.array([len(r) for r in reads], np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    fwd = np.concatenate(reads)
    vol = np.concatenate([fwd, 3 - fwd[::-1], np.zeros(L_s + 64, np.uint8)])
    kw = dict(L_s=L_s, L_t=L_t, S=S, W=W, max_segs=4, max_segs_left=4,
              min_identity=60.0, min_align_size=100, min_mapping_ratio=0.05)
    args = (torch.zeros((T, L_t, D1, 5), dtype=torch.int32),
            torch.zeros((T, L_t + 1), dtype=torch.int32),
            torch.zeros(T, dtype=torch.bool), _tt(vol), _tt(starts),
            _tt(lens), int(lens.sum()),
            *(_tt(a) for a in (np.arange(1, P + 1, dtype=np.int32),
                               np.zeros(P, np.int32), qlen, tlen, qs, ts,
                               t_slot, np.zeros(P, np.int32),
                               rng.random(P) < 0.9)))
    return kw, args


def test_cpu_chunk_never_loads_the_fold_library(monkeypatch):
    """A CPU chunk runs the plain versions: no build, no load, no launch;
    and the tensors the chunk hands to the deposit, the planes and the fold
    pass the kernels' own argument checks (dtype, shape, contiguity,
    alignment)."""
    def no_build(name, verbose=False):
        raise AssertionError(f"the CPU route built {name}")

    monkeypatch.setattr(cuda_build, "build", no_build)
    checked = []
    deposit_plain, planes_plain, fold_plain = (
        port.plane_inputs_plain, port.banded_global_planes_plain,
        port.fold_tags_plain)

    def deposit(*a):
        checked.append(walk_kernel.deposit_rows_args(
            *a[:4], S=a[4], W=a[5], device=a[2].device))
        return deposit_plain(*a)

    def planes(*a, **kw):
        dense = [tuple(t.contiguous() for t in x) if isinstance(x, tuple)
                 else x.contiguous() for x in a]
        checked.append(walk_kernel.planes_args(*dense, **kw,
                                               device=a[-1].device))
        return planes_plain(*a, **kw)

    def fold(*a):
        dense = [x.contiguous() if torch.is_tensor(x) else x for x in a]
        checked.append(walk_kernel.fold_args(*dense, device=a[0].device))
        return fold_plain(*a)

    monkeypatch.setattr(port, "plane_inputs_plain", deposit)
    monkeypatch.setattr(port, "banded_global_planes_plain", planes)
    monkeypatch.setattr(port, "fold_tags_plain", fold)
    before = walk_kernel.launches()
    kw, args = _small_chunk()
    counts, cov, has = port_cns.make_cns_chunk(**kw)(*args)
    assert walk_kernel.launches() == before
    assert "mecat_fold" not in walk_kernel._libs
    assert len(checked) == 3 and int(counts.sum()) > 1000
    assert checked[0][:2] == (12, kw["L_s"])
    assert checked[0][2:] == checked[1][1:3]
    B, G_r, G_l = checked[1][:3]
    assert B == 12 and 1 <= G_r <= 4 and 1 <= G_l <= 4
    assert checked[2][:2] == (12, 3)


def test_fold_wrappers_refuse_cpu_tensors_before_any_build(monkeypatch):
    def no_build(name, verbose=False):
        raise AssertionError(f"{name} was built for a CPU tensor")

    monkeypatch.setattr(cuda_build, "build", no_build)
    fi = fold_inputs(64, 32, 16, 300, 3, seed=4)
    with pytest.raises(ValueError, match="CUDA"):
        walk_kernel.global_planes_cuda(*(_tt(fi[k]) for k in PLANE_KEYS),
                                       L_t=300, S=64, W=32)
    planes = port.banded_global_planes_plain(
        *(_tt(fi[k]) for k in PLANE_KEYS), L_t=300, S=64, W=32)
    with pytest.raises(ValueError, match="CUDA"):
        walk_kernel.fold_tags_cuda(_tt(fi["counts"]), _tt(fi["cov_diff"]),
                                   *planes, *(_tt(fi[k]) for k in FOLD_KEYS),
                                   300)


def test_fold_argument_checks_refuse_what_the_kernels_do_not_take():
    fi = fold_inputs(64, 32, 16, 300, 3, seed=5)
    cpu = torch.device("cpu")
    args = [_tt(fi[k]) for k in PLANE_KEYS]
    assert walk_kernel.planes_args(*args, L_t=300, S=64, W=32,
                                   device=cpu)[:3] == (16, 6, 5)
    bad = list(args)
    bad[5] = bad[5].long()                               # int64 tseed
    with pytest.raises(TypeError):
        walk_kernel.planes_args(*bad, L_t=300, S=64, W=32, device=cpu)
    bad = list(args)
    bad[2] = (bad[2][0].t().contiguous().t(), *bad[2][1:])  # strided toff
    with pytest.raises(ValueError, match="contiguous"):
        walk_kernel.planes_args(*bad, L_t=300, S=64, W=32, device=cpu)
    with pytest.raises(ValueError):                      # the wrong LP
        walk_kernel.planes_args(*args, L_t=300, S=64, W=64, device=cpu)
    with pytest.raises(ValueError):
        walk_kernel.planes_args(*args, L_t=300, S=64, W=33, device=cpu)
    planes = port.banded_global_planes_plain(*args, L_t=300, S=64, W=32)
    fargs = [_tt(fi["counts"]), _tt(fi["cov_diff"]),
             *(p.contiguous() for p in planes),
             *(_tt(fi[k]) for k in FOLD_KEYS)]
    assert walk_kernel.fold_args(*fargs, 300, cpu)[:2] == (16, 3)
    with pytest.raises(ValueError):                      # counts of L_t 299
        walk_kernel.fold_args(*fargs, 299, cpu)
    bad = list(fargs)
    bad[7] = bad[7].to(torch.int32)                      # pair_ok not bool
    with pytest.raises(TypeError):
        walk_kernel.fold_args(*bad, 300, cpu)
