"""Port mecat2ref path (mecat_tpu_torch) on CPU vs the JAX package: equality.

The column traceback, the tape form of the row walk, the both-direction
extension with op tapes, the op-stream compaction and the window gather are
compared function by function on the same numpy inputs; ``run_ref`` (SAM,
M4, ``best_n=2``) and the CLI are compared byte for byte on the data of
``tests/test_ref.py``.  No tolerance anywhere.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread is as fast, and several test workers share the cores
torch.set_num_threads(1)
jnp = pytest.importorskip("jax.numpy")

from mecat_tpu.ops import align as ref_align
from mecat_tpu.ops import consensus_device as ref_cd
from mecat_tpu.ops import ddf as ref_ddf
from mecat_tpu.pipeline import ref as ref_ref
from mecat_tpu_torch.index.kmer_index import kmer_codes
from mecat_tpu_torch.io.fasta import write_fasta
from mecat_tpu_torch.ops import align as port_align
from mecat_tpu_torch.ops import consensus_device as port_cd
from mecat_tpu_torch.ops import ddf as port_ddf
from mecat_tpu_torch.ops import dp_kernel
from mecat_tpu_torch.pipeline import ref as port_ref
from mecat_tpu_torch.testing import dp_inputs, pair_inputs
from mecat_tpu_torch.utils.sim import random_genome, simulate_reads

OPTS = dict(num_candidates=8, num_extend=3, min_align_size=400,
            kmer_size=10, scan_stride=5, scan_batch=16, extend_batch=32,
            align_segment=128, align_band=64)


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _segment_moves(S, W, n, seed):
    """Plain-version moves and endpoints of n DP lanes (port layout)."""
    q, tpad, tmax, seg_q, _ = dp_inputs(S, W, n, seed=seed)
    moves, r, w, _, _, _ = port_align.dp_segment_best_plain(
        *_t(q, tpad, tmax, seg_q), torch.ones(n, dtype=torch.bool), S, W,
        want_moves=True)
    return moves, r, w


@pytest.mark.parametrize("S,W,max_cols", [(128, 64, 0), (64, 32, 0),
                                          (128, 64, 192)])
def test_traceback_ops_matches_jax(S, W, max_cols):
    moves, r, w = _segment_moves(S, W, 48, seed=3 * S + W)
    # also walks that leave the band: ends in the first and the last column
    w = w.clone()
    w[1::7] = 0
    w[2::7] = W - 1
    got = port_align.traceback_ops(moves, r, w, W, max_cols=max_cols)
    want = ref_align.traceback_ops(
        jnp.asarray(moves.numpy().transpose(1, 2, 0)), jnp.asarray(r.numpy()),
        jnp.asarray(w.numpy()), W, max_cols=max_cols)
    assert got[0].dtype == torch.int8
    assert got[0].shape == (48, max_cols or 2 * S + W)
    assert int(got[3].max()) > S // 2
    for name, g, x in zip(("ops", "qi", "tj", "n_cols"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x), err_msg=name)


def test_read_move_indexes_the_lane_flat_and_floors():
    """w = W reads the next row's first word, w = -1 the previous row's
    last one, i = 0 clips to word 0; the shift takes w % 16 floored."""
    S, W = 4, 32
    words = np.arange(1, 1 + S * 2, dtype=np.int32).reshape(1, S * 2) * 0x1B
    words[0, 3] = -(1 << 30)                       # sign bit: slot 15 = 3
    flat = torch.as_tensor(words)
    i = torch.tensor([2, 2, 0, 2, 2], dtype=torch.int32)
    w = torch.tensor([W, -1, 5, 31, 17], dtype=torch.int32)
    for k in range(5):
        got = port_align._read_move(flat, i[k:k + 1], w[k:k + 1], S, W)
        want = ref_align._read_move(jnp.asarray(words.T), jnp.asarray(
            i[k:k + 1].numpy()), jnp.asarray(w[k:k + 1].numpy()), S, W)
        assert int(got) == int(want[0]), k
    assert int(port_align._read_move(flat, i[3:4], w[3:4], S, W)) == 3


def test_rows_to_tape_matches_jax_and_the_column_walk():
    S, W = 128, 64
    moves, r, w = _segment_moves(S, W, 48, seed=77)
    mv, h, _, w0 = port_align.traceback_rows(moves, r, w, W)
    TC = port_align.max_tape_cols(S, W, 0.7)
    assert TC == ref_align.max_tape_cols(S, W, 0.7)
    got = port_align.rows_to_tape(mv, h, w0, W, TC)
    want = ref_align.rows_to_tape(jnp.asarray(mv.numpy()),
                                  jnp.asarray(h.numpy()),
                                  jnp.asarray(w0.numpy()), W, TC)
    for name, g, x in zip(("ops", "qi", "tj", "n_cols"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x), err_msg=name)
    # where the column walk fits the tape, both walks give the same tape
    col = port_align.traceback_ops(moves, r, w, W, max_cols=TC)
    fits = (col[3] < TC) & (r > 0)
    assert int(fits.sum()) > 30
    for g, x in zip(got, col):
        assert torch.equal(g[fits], x[fits])


@pytest.fixture(scope="module")
def tapes():
    """extend_pair_batch_with_ops of both packages on the same pairs."""
    S, W, segs = 128, 64, 12
    q, t, qlen, tlen, qseed, tseed = pair_inputs(12, 1024, seed=31)
    got = port_align.extend_pair_batch_with_ops(
        *_t(q, t, qlen, tlen, qseed, tseed), S=S, W=W, max_segs=segs,
        max_segs_left=segs - 2)
    want = ref_align.extend_pair_batch_with_ops(
        *(jnp.asarray(a) for a in (q, t, qlen, tlen, qseed, tseed)),
        S=S, W=W, max_segs=segs, max_segs_left=segs - 2)
    return got, want, (qseed, tseed)


def test_extend_pair_batch_with_ops_matches_jax(tapes):
    (pa, right, left), (pa_w, right_w, left_w), _ = tapes
    for f in pa._fields:
        g, x = getattr(pa, f).numpy(), np.asarray(getattr(pa_w, f))
        assert g.dtype == x.dtype, f
        np.testing.assert_array_equal(g, x, err_msg=f)
    n_ok = 0
    for got, want in ((right, right_w), (left, left_w)):
        G = got[0].shape[0]
        assert 1 <= G <= want[0].shape[0]
        ok = got[6].numpy()
        np.testing.assert_array_equal(ok, np.asarray(want[6])[:G])
        assert not np.asarray(want[6])[G:].any()   # segments that never ran
        # n_cols is masked by ok: equal everywhere, zero past G
        np.testing.assert_array_equal(got[3].numpy(),
                                      np.asarray(want[3])[:G])
        assert not np.asarray(want[3])[G:].any()
        for k, name in ((0, "ops"), (1, "qi"), (2, "tj"), (4, "qoff"),
                        (5, "toff")):
            np.testing.assert_array_equal(
                got[k].numpy()[ok], np.asarray(want[k])[:G][ok], err_msg=name)
        n_ok += int(ok.sum())
    assert n_ok > 40


def test_ops_stream_matches_jax_everywhere(tapes):
    (_, right, left), (_, right_w, left_w), (qseed, tseed) = tapes
    CW = 2304
    got = port_cd._build_streams(right, left, *_t(qseed, tseed), CW)
    want = ref_cd._build_streams(right_w, left_w, jnp.asarray(qseed),
                                 jnp.asarray(tseed), CW)
    for name, g, x in zip(("ops", "qpos", "tpos"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x), err_msg=name)
    ops = port_cd.ops_stream(right, left, *_t(qseed, tseed), CW)
    assert ops.dtype == torch.int8
    np.testing.assert_array_equal(ops.numpy(), np.asarray(
        ref_cd.ops_stream(right_w, left_w, jnp.asarray(qseed),
                          jnp.asarray(tseed), CW)))
    assert int((ops >= 0).sum(1).max()) > 600
    # a stream narrower than the alignment drops the overflow, as drop mode
    narrow = port_cd.ops_stream(right, left, *_t(qseed, tseed), 256)
    np.testing.assert_array_equal(narrow.numpy(), np.asarray(
        ref_cd.ops_stream(right_w, left_w, jnp.asarray(qseed),
                          jnp.asarray(tseed), 256)))


def test_ref_gather_qt_matches_jax():
    rng = np.random.default_rng(5)
    fwd = rng.integers(0, 4, (6, 64), dtype=np.uint8)
    rev = rng.integers(0, 4, (6, 64), dtype=np.uint8)
    genome = rng.integers(0, 4, 500, dtype=np.uint8)
    rowi = np.array([0, 5, 2, 2, 0, 0], np.int32)
    strand = np.array([0, 1, 1, 0, 0, 0], np.int32)
    g0 = np.array([0, 436, 499, 100, 0, 0], np.int32)   # windows past the end
    wlen = np.array([64, 64, 1, 40, 0, 0], np.int32)    # padding lanes: 0
    got = port_ref._ref_gather_qt(*_t(fwd, rev, genome, rowi, strand, g0,
                                      wlen), 64)
    want = ref_ref._ref_gather_qt(*(jnp.asarray(a) for a in (
        fwd, rev, genome, rowi, strand, g0, wlen)), 64)
    for g, x in zip(got, want):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


@pytest.fixture(scope="module")
def ref_setup(tmp_path_factory):
    """The reference and reads of tests/test_ref.py: 30 kb + 20 kb contigs,
    12 + 8 simulated reads and one junk read."""
    tmp = tmp_path_factory.mktemp("torch_ref")
    g1 = random_genome(30000, seed=81)
    g2 = random_genome(20000, seed=82)
    ref = str(tmp / "genome.fasta")
    write_fasta(ref, [("chr1", g1), ("chr2", g2)])
    db, _ = simulate_reads(g1, 12, mean_len=2000, min_len=1000, seed=83,
                           error_rate=0.08)
    db2, _ = simulate_reads(g2, 8, mean_len=2000, min_len=1000, seed=84,
                            error_rate=0.08)
    seqs = [(f"c1_{i}", db.read(i)) for i in range(db.n_reads)]
    seqs += [(f"c2_{i}", db2.read(i)) for i in range(db2.n_reads)]
    seqs.append(("junk", random_genome(1500, seed=99)))
    reads = str(tmp / "reads.fasta")
    write_fasta(reads, seqs)
    return tmp, reads, ref, seqs


@pytest.mark.parametrize("fmt", ["sam", "m4"])
def test_run_ref_cpu_matches_jax_bytes(ref_setup, fmt):
    tmp, reads, ref, seqs = ref_setup
    got, want = str(tmp / f"port.{fmt}"), str(tmp / f"jax.{fmt}")
    before = (dp_kernel.LAUNCHES, dp_kernel.LAUNCHES_MOVES)
    stats = port_ref.run_ref(
        reads, ref, got, str(tmp / f"wp_{fmt}"),
        port_ref.RefOptions(output_format=fmt, **OPTS), device="cpu")
    ref_stats = ref_ref.run_ref(
        reads, ref, want, str(tmp / f"wj_{fmt}"),
        ref_ref.RefOptions(output_format=fmt, **OPTS))
    assert _read(got) == _read(want)
    assert (stats.reads, stats.mapped) == (ref_stats.reads, ref_stats.mapped)
    assert stats.mapped == len(seqs) - 1
    # CPU tensors take the plain version: no kernel launch, yet the DP ran
    assert (dp_kernel.LAUNCHES, dp_kernel.LAUNCHES_MOVES) == before
    assert stats.dp_launches == 0 and stats.dp_launches_moves == 0
    assert stats.dp_lane_segs_issued >= stats.dp_lane_segs_useful > 0
    if fmt == "sam":
        lines = [ln.split("\t") for ln in _read(got).decode().splitlines()
                 if not ln.startswith("@")]
        assert len(lines) == len(seqs)
        assert [f[1] for f in lines if f[0] == "junk"] == ["4"]


def test_run_ref_best_n_2_matches_jax_bytes(tmp_path):
    """A duplicated genome segment: a secondary (FLAG 256) at the other
    copy and a collapsed MAPQ, the same bytes in both packages."""
    seg = random_genome(8000, seed=91)
    uniq = random_genome(20000, seed=92)
    genome = np.concatenate([seg, uniq, seg])
    ref = str(tmp_path / "genome.fasta")
    write_fasta(ref, [("chr1", genome)])
    reads = str(tmp_path / "reads.fasta")
    write_fasta(reads, [("rep", genome[1000:4000]),
                        ("unq", genome[12000:15000])])
    got, want = str(tmp_path / "port.sam"), str(tmp_path / "jax.sam")
    port_ref.run_ref(reads, ref, got, str(tmp_path / "wp"),
                     port_ref.RefOptions(output_format="sam", best_n=2,
                                         **OPTS), device="cpu")
    ref_ref.run_ref(reads, ref, want, str(tmp_path / "wj"),
                    ref_ref.RefOptions(output_format="sam", best_n=2, **OPTS))
    assert _read(got) == _read(want)
    flags = [int(ln.split("\t")[1]) for ln in _read(got).decode().splitlines()
             if ln.startswith("rep\t")]
    assert len(flags) == 2 and sum(1 for f in flags if f & 256) == 1


def test_ref_cli_on_cpu_matches_the_api(ref_setup, capsys):
    tmp, reads, ref, seqs = ref_setup
    from mecat_tpu_torch.cli.mecat2ref import main

    api = str(tmp / "api.sam")
    port_ref.run_ref(reads, ref, api, str(tmp / "w_api"),
                     port_ref.RefOptions(output_format="sam", **OPTS),
                     device="cpu")
    out = str(tmp / "cli.sam")
    rc = main(["-d", reads, "-r", ref, "-w", str(tmp / "w_cli"), "-o", out,
               "-x", "1", "-n", "8", "-b", "3", "-a", "400", "--kmer-size",
               "10", "--scan-stride", "5", "--scan-batch", "16",
               "--extend-batch", "32", "--align-segment", "128",
               "--align-band", "64", "--device", "cpu"])
    assert rc == 0
    assert _read(out) == _read(api)
    summary = [ln for ln in capsys.readouterr().err.splitlines()
               if '"event": "summary"' in ln and '"component": "ref"' in ln]
    assert summary and '"dp_launches": 0' in summary[-1]
    with pytest.raises(SystemExit) as exc:
        main(["-d", reads, "-r", ref, "-w", str(tmp / "w_no"), "-o", out,
              "--device", "cuda:7"])
    assert exc.value.code == 2


def test_run_ref_refuses_a_genome_past_int32(monkeypatch, ref_setup):
    tmp, reads, ref, _ = ref_setup
    monkeypatch.setattr(port_ref, "MAX_GENOME_BASES", 40000)
    with pytest.raises(ValueError, match="int32"):
        port_ref.run_ref(reads, ref, str(tmp / "no.sam"), str(tmp / "w_no2"),
                         device="cpu")


def _synthetic_index(big_off, k=10, stride=5, L=2000, seed=7):
    """One read and a fabricated CSR index whose occurrences sit at genome
    offset ``big_off`` (tests/test_ref.py:_synthetic_scan)."""
    rng = np.random.default_rng(seed)
    read = rng.integers(0, 4, L).astype(np.uint8)
    codes = kmer_codes(torch.as_tensor(read), k).numpy()
    qpos = np.arange(0, L, stride)
    qpos = qpos[qpos + k <= L]
    vcodes = codes[qpos]
    all_codes = np.concatenate([vcodes, vcodes])
    all_rid = np.concatenate([np.zeros_like(qpos), np.ones_like(qpos)])
    all_loc = np.concatenate([big_off + qpos,
                              big_off + 7919 * qpos % (1 << 29)])
    order = np.argsort(all_codes, kind="stable")
    n_slots = 1 << (2 * k)
    offsets = np.zeros(n_slots + 1, dtype=np.int64)
    np.cumsum(np.bincount(all_codes, minlength=n_slots), out=offsets[1:])
    return (qpos, read[None, :], np.array([L], np.int32),
            offsets.astype(np.int32), all_rid[order].astype(np.int32),
            all_loc[order].astype(np.int32))


@pytest.mark.parametrize("big_off", [1_024, (1 << 27) + 123_392,
                                     (1 << 28) + 50_000_128])
def test_scan_diag_binning_beyond_128mb_matches_jax(big_off):
    """Contig offsets past GENOME_DIAG_SHIFT give negative diagonal sums:
    int32 and floor-divided, the candidates equal the JAX package's."""
    k, stride = 10, 5
    qpos, read, lens, offsets, rid, loc = _synthetic_index(big_off, k, stride)
    kw = dict(k=k, stride=stride, max_occ=4, num_candidates=4)
    no_self = np.array([-1], np.int32)
    got = port_ddf.scan_candidates(
        *_t(read, lens, offsets, rid, loc), 1 << 30, torch.as_tensor(no_self),
        diag_shift=port_ref.GENOME_DIAG_SHIFT, **kw)
    want = ref_ddf.scan_candidates(
        *(jnp.asarray(a) for a in (read, lens, offsets, rid, loc)),
        jnp.int32(1 << 30), jnp.asarray(no_self),
        diag_shift=ref_ref.GENOME_DIAG_SHIFT, **kw)
    for f in got._fields:
        g, x = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == x.dtype, f
        np.testing.assert_array_equal(g, x, err_msg=f)
    assert bool(got.valid[0, 0]) and int(got.score[0, 0]) == len(qpos)
    assert int(got.score[0, 1]) < len(qpos) // 4
    hits = port_ddf.probe_hits(
        *_t(read, lens, offsets, rid, loc), 1 << 30, torch.as_tensor(no_self),
        k=k, stride=stride, max_occ=4,
        diag_shift=port_ref.GENOME_DIAG_SHIFT)
    assert hits[1].dtype == torch.int32
    if big_off > 1 << 27:
        assert int(hits[1][hits[4]].min()) < 0      # the bins are negative
