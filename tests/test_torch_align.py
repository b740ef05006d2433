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



def test_extend_pair_batch_matches_the_scalar_oracle():
    """The C++ scalar engine (native/src/scalar_baseline.cpp) is the
    algorithm-level oracle of the JAX ``extend_pair_batch``; the port's is
    held to it the same way: every integer field of every pair bit-equal on
    real candidate pairs, identity within 1e-3.  Needs the native library
    (the test may load it; the port never does)."""
    try:
        from mecat_tpu.native.scalar import ScalarEngine
    except Exception as exc:               # no toolchain, no library
        pytest.skip(f"native scalar engine not built: {exc}")
    from mecat_tpu import constants as C
    from mecat_tpu.utils.sim import random_genome, simulate_reads

    db, _ = simulate_reads(random_genome(40000, seed=17), 48, mean_len=1800,
                           min_len=1000, seed=18, error_rate=0.1)
    try:
        eng = ScalarEngine(db.codes, db.starts, db.lengths, k=13)
    except Exception as exc:
        pytest.skip(f"native scalar engine not built: {exc}")
    cutoff = eng.cutoff()
    S, W, max_segs = 128, 64, 40
    pairs = []
    for r in range(db.n_reads):
        tgt, score, qseed, tseed = eng.scan_read(
            db.read(r), r, cutoff=cutoff, stride=10, max_occ=16, diag_bin=256,
            n_cand=12)
        pairs += [(r, int(tgt[j]), int(qseed[j]), int(tseed[j]))
                  for j in range(len(tgt)) if score[j] >= C.MIN_BLOCK_SCORE]
    pairs = pairs[:96]
    assert len(pairs) >= 32
    B, L = len(pairs), 4096
    q_b, t_b = (np.zeros((B, L), np.uint8) for _ in range(2))
    qlen, tlen, qs, ts = (np.zeros(B, np.int32) for _ in range(4))
    for i, (r, t, q0, t0) in enumerate(pairs):
        qr, tr = db.read(r), db.read(t)
        q_b[i, :len(qr)], t_b[i, :len(tr)] = qr, tr
        qlen[i], tlen[i], qs[i], ts[i] = len(qr), len(tr), q0, t0
    res = port.extend_pair_batch(
        *(torch.as_tensor(a) for a in (q_b, t_b, qlen, tlen, qs, ts)),
        S=S, W=W, max_segs=max_segs)
    fields = ("qbeg", "qend", "tbeg", "tend", "dist", "matches", "align_len")
    got = {f: getattr(res, f).numpy() for f in fields}
    ident = res.identity.numpy()
    for i, (r, t, q0, t0) in enumerate(pairs):
        d = eng.extend_pair(db.read(r), db.read(t), q0, t0, S=S, W=W,
                            max_segs=max_segs, penalty=C.ALIGN_TRIM_PENALTY,
                            min_seg_identity=C.MIN_SEGMENT_IDENTITY)
        want = (d["qbeg"], d["qend"], d["tbeg"], d["tend"], d["dist"],
                d["matches"], d["alen"])
        assert tuple(int(got[f][i]) for f in fields) == want, (i, pairs[i])
        assert abs(d["identity"] - float(ident[i])) < 1e-3
