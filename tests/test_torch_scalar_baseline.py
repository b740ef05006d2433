"""The port's scalar C++ engine (mecat_tpu_torch.native.scalar) as an oracle
for the port's own index, scan and extension.

The checks of ``tests/test_scalar_baseline.py`` with the port's
``build_index``, ``scan_candidates`` and ``extend_pair_batch`` (on the CPU,
so through the plain DP) in place of the JAX ones, on the same workload;
and the port's ``overlap_range`` counts equal to the JAX package's engine
(the same C++ source, built apart).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

from mecat_tpu.native.scalar import ScalarEngine as RefEngine
from mecat_tpu_torch import constants as C
from mecat_tpu_torch.index.kmer_index import build_index
from mecat_tpu_torch.io.packed_db import revcomp
from mecat_tpu_torch.native.scalar import ScalarEngine
from mecat_tpu_torch.ops.align import extend_pair_batch
from mecat_tpu_torch.ops.ddf import scan_candidates
from mecat_tpu_torch.utils.sim import random_genome, simulate_reads

SCAN = dict(stride=10, max_occ=16, diag_bin=256, n_cand=12)
RANGE = dict(stride=SCAN["stride"], max_occ=SCAN["max_occ"],
             diag_bin=SCAN["diag_bin"], n_cand=SCAN["n_cand"],
             min_block_score=C.MIN_BLOCK_SCORE, S=128, W=64,
             penalty=C.ALIGN_TRIM_PENALTY,
             min_seg_identity=C.MIN_SEGMENT_IDENTITY, min_identity=65.0,
             min_align_size=300)


@pytest.fixture(scope="module")
def workload():
    g = random_genome(40000, seed=17)
    db, _ = simulate_reads(g, 48, mean_len=1800, min_len=1000, seed=18,
                           error_rate=0.1)
    eng = ScalarEngine(db.codes, db.starts, db.lengths, k=13)
    idx = build_index(db.codes, db.starts, db.lengths, k=13, device="cpu")
    return db, eng, idx


def test_scalar_index_matches_port_index(workload):
    """Occurrence counts and the cutoff equal the port's build_index."""
    _, eng, idx = workload
    assert eng.n_valid == idx.pos_rid.numel()
    assert eng.n_distinct == int(torch.count_nonzero(torch.diff(idx.offsets)))
    assert eng.cutoff() == idx.max_occ_cutoff


def test_scalar_scan_matches_port_scan(workload):
    """Candidates (target, score, qseed, tseed) equal scan_candidates."""
    db, eng, idx = workload
    cutoff = eng.cutoff()
    ids = list(range(db.n_reads))
    bases, lens = db.padded_batch(ids, pad_to=4096)
    cand = scan_candidates(
        torch.as_tensor(bases), torch.as_tensor(lens), idx.offsets,
        idx.pos_rid, idx.pos_loc, cutoff,
        torch.arange(db.n_reads, dtype=torch.int32), k=13,
        stride=SCAN["stride"], max_occ=SCAN["max_occ"],
        num_candidates=SCAN["n_cand"], diag_bin=SCAN["diag_bin"])
    tgt, score, qseed, tseed, valid = (
        x.numpy() for x in (cand.target, cand.score, cand.qseed, cand.tseed,
                            cand.valid))
    for r in ids:
        s_tgt, s_score, s_qseed, s_tseed = eng.scan_read(
            db.read(r), r, cutoff=cutoff, **SCAN)
        n_valid = int(valid[r].sum())
        # the port emits n_cand rows, the invalid tail below the score cut;
        # the scalar emits one row per real run: the valid prefix agrees
        assert n_valid <= len(s_tgt)
        np.testing.assert_array_equal(s_tgt[:n_valid], tgt[r, :n_valid])
        np.testing.assert_array_equal(s_score[:n_valid], score[r, :n_valid])
        np.testing.assert_array_equal(s_qseed[:n_valid], qseed[r, :n_valid])
        np.testing.assert_array_equal(s_tseed[:n_valid], tseed[r, :n_valid])
        assert all(s < C.MIN_BLOCK_SCORE for s in s_score[n_valid:])


def test_scalar_extend_matches_port_extend(workload):
    """Extension integer fields equal extend_pair_batch on real pairs,
    identity within 1e-3."""
    db, eng, _ = workload
    cutoff = eng.cutoff()
    S, W, max_segs = 128, 64, 40
    pairs = []
    for r in range(db.n_reads):
        s_tgt, s_score, s_qseed, s_tseed = eng.scan_read(
            db.read(r), r, cutoff=cutoff, **SCAN)
        pairs += [(r, int(s_tgt[j]), int(s_qseed[j]), int(s_tseed[j]))
                  for j in range(len(s_tgt))
                  if s_score[j] >= C.MIN_BLOCK_SCORE]
    pairs = pairs[:96]
    assert len(pairs) >= 32
    L, B = 4096, len(pairs)
    q_b = np.zeros((B, L), np.uint8)
    t_b = np.zeros((B, L), np.uint8)
    qlen, tlen, qs, ts = (np.zeros(B, np.int32) for _ in range(4))
    for i, (r, t, q0, t0) in enumerate(pairs):
        qr, tr = db.read(r), db.read(t)
        q_b[i, :len(qr)] = qr
        t_b[i, :len(tr)] = tr
        qlen[i], tlen[i], qs[i], ts[i] = len(qr), len(tr), q0, t0
    res = extend_pair_batch(
        *(torch.as_tensor(a) for a in (q_b, t_b, qlen, tlen, qs, ts)),
        S=S, W=W, max_segs=max_segs)
    for i, (r, t, q0, t0) in enumerate(pairs):
        d = eng.extend_pair(db.read(r), db.read(t), q0, t0, S=S, W=W,
                            max_segs=max_segs, penalty=C.ALIGN_TRIM_PENALTY,
                            min_seg_identity=C.MIN_SEGMENT_IDENTITY)
        got = (d["qbeg"], d["qend"], d["tbeg"], d["tend"], d["dist"],
               d["matches"], d["alen"])
        want = tuple(int(getattr(res, f)[i]) for f in
                     ("qbeg", "qend", "tbeg", "tend", "dist", "matches",
                      "align_len"))
        assert got == want, (i, pairs[i], got, want)
        assert abs(d["identity"] - float(res.identity[i])) < 1e-3


def test_scalar_overlap_range_consistent_and_equal_to_reference(workload):
    """The timed driver's counts agree with the primitive-by-primitive
    path, and with the JAX package's engine on the same reads."""
    db, eng, _ = workload
    cutoff = eng.cutoff()
    total = 0
    for q in range(db.n_reads):
        fwd = db.read(q)
        merged = []
        for bases in (fwd, revcomp(fwd)):
            _, score, _, _ = eng.scan_read(bases, q, cutoff=cutoff, **SCAN)
            merged += [s for s in score if s >= C.MIN_BLOCK_SCORE]
        total += min(len(merged), SCAN["n_cand"])
    ref = RefEngine(db.codes, db.starts, db.lengths, k=13)
    assert ref.cutoff() == cutoff
    keys = ("candidates", "extended", "overlaps", "dp_segments", "passed")
    for task, strands in ((0, 2), (1, 2), (1, 1)):
        r = eng.overlap_range(0, db.n_reads, task=task, cutoff=cutoff,
                              strands=strands, **RANGE)
        w = ref.overlap_range(0, db.n_reads, task=task, cutoff=cutoff,
                              strands=strands, **RANGE)
        assert {k: r[k] for k in keys} == {k: w[k] for k in keys}
        if strands == 2:
            assert r["candidates"] == total
        if task == 1:
            assert r["extended"] == r["candidates"]
            assert 0 < r["overlaps"] <= r["extended"]
