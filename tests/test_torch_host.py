"""The port's copies of the host layer (mecat_tpu_torch.constants, io, utils,
the NumPy index sharding of parallel.sharded) against the JAX package's
originals: equal values, arrays and bytes.

Both packages take their native C++ layers here (the port's by default,
the original's where its toolchain builds it); ``tests/test_torch_native.py``
holds the port's native functions to their plain versions.
"""
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from mecat_tpu import constants as ref_C
from mecat_tpu.index.kmer_index import build_index as ref_build_index
from mecat_tpu.io import fasta as ref_fasta
from mecat_tpu.io import m4 as ref_m4
from mecat_tpu.io import sam as ref_sam
from mecat_tpu.io.packed_db import PackedDB as RefDB
from mecat_tpu.ops import consensus as ref_consensus
from mecat_tpu.parallel import sharded as ref_sharded
from mecat_tpu.pipeline import common as ref_common
from mecat_tpu.utils import accuracy as ref_accuracy
from mecat_tpu.utils import sim as ref_sim
from mecat_tpu_torch import constants as C
from mecat_tpu_torch.index.kmer_index import build_index
from mecat_tpu_torch.io import fasta, m4, sam
from mecat_tpu_torch.io.packed_db import PackedDB, revcomp
from mecat_tpu_torch.ops import consensus
from mecat_tpu_torch.parallel.sharded import shard_index_by_hash
from mecat_tpu_torch.pipeline import common
from mecat_tpu_torch.testing import sharded_case
from mecat_tpu_torch.utils import accuracy, sim

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
READS = os.path.join(GOLDEN, "reads.fasta")


def _assert_db_equal(got, want):
    for name in ("codes", "starts", "lengths"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert list(got.names) == list(want.names)


def test_constants_equal_reference():
    names = [n for n in dir(C) if n.isupper()]
    assert len(names) >= 28
    for n in names:
        assert getattr(C, n) == getattr(ref_C, n), n


def test_cns_presets_and_vote_defaults_equal_reference():
    assert C.CNS_TECH_PRESETS == ref_C.CNS_TECH_PRESETS
    assert sorted(C.CNS_TECH_PRESETS) == [C.TECH_PACBIO, C.TECH_NANOPORE]
    assert consensus.GAP == ref_consensus.GAP
    assert consensus.VoteParams._fields == ref_consensus.VoteParams._fields
    assert (consensus.VoteParams._field_defaults
            == ref_consensus.VoteParams._field_defaults)
    # the builtin defaults, whatever the environment of this process says
    assert tuple(consensus.default_vote_params()) == (65, 60, 5, 8, 0, 50, 25)


@pytest.mark.parametrize("pow2", [False, True])
def test_bucket_length_matches_reference(pow2):
    for n in (0, 1, 1023, 1024, 1025, 1536, 1537, 3000, 3073, 6144, 6145,
              8192, 8193, 12288, 12289, 50000, 131072, 131073):
        assert (common.bucket_length(n, pow2=pow2)
                == ref_common.bucket_length(n, pow2=pow2)), n
        assert (common.bucket_length(n, minimum=4096, pow2=pow2)
                == ref_common.bucket_length(n, minimum=4096, pow2=pow2)), n
    assert common.max_segs_for(9000, 512) == ref_common.max_segs_for(9000, 512)


def test_record_parsers_match_reference(tmp_path):
    for name, read, ref_read in (
            ("candidates.txt", m4.read_candidates, ref_m4.read_candidates),
            ("overlaps.m4", m4.read_m4, ref_m4.read_m4)):
        path = os.path.join(GOLDEN, name)
        got, want = list(read(path)), list(ref_read(path))
        assert len(got) == len(want) > 100
        for g, w in zip(got, want):
            assert vars(g) == vars(w)
    # -g 1 lines carry the seed columns; blank lines are skipped; a float
    # score is cut to its integer; short lines are refused
    line = "3 9 81.25 44.0 0 10 900 1000 1 5 880 950 77 66"
    g, w = m4.M4Record.parse(line), ref_m4.M4Record.parse(line)
    assert vars(g) == vars(w) and (g.qext, g.sext, g.score) == (77, 66, 44)
    assert m4.M4Record.parse(g.format()) == g
    p = tmp_path / "c.txt"
    p.write_text("\n1 2 30.0 1 40 500 0 60 700\n\n")
    assert ([vars(r) for r in m4.read_candidates(str(p))]
            == [vars(r) for r in ref_m4.read_candidates(str(p))])
    for cls, bad in ((m4.M4Record, "1 2 3"), (m4.CandidateRecord, "1 2 3")):
        with pytest.raises(ValueError):
            cls.parse(bad)


def test_format_fasta_matches_reference():
    rng = np.random.default_rng(12)
    for n in (0, 1, 79, 80, 81, 400):
        codes = rng.integers(0, 4, n, dtype=np.uint8)
        assert (fasta.format_fasta("r/1_0", codes)
                == ref_fasta.format_fasta("r/1_0", codes))


def test_packed_db_matches_reference():
    got, want = PackedDB.from_fasta(READS), RefDB.from_fasta(READS)
    _assert_db_equal(got, want)
    assert got.split_volumes(25000) == want.split_volumes(25000)
    ids = [5, 0, 17, 3]
    _assert_db_equal(got.subset(ids), want.subset(ids))
    for pad_to in (None, 1024, 4096):
        for g, w in zip(got.padded_batch(ids, pad_to=pad_to),
                        want.padded_batch(ids, pad_to=pad_to)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_fastq_and_fasta_writer_match_reference(tmp_path):
    rng = np.random.default_rng(4)
    recs = [(f"r{i}", rng.integers(0, 4, int(rng.integers(0, 300)),
                                   dtype=np.uint8)) for i in range(7)]
    a, b = tmp_path / "port.fa", tmp_path / "ref.fa"
    fasta.write_fasta(str(a), recs, width=60)
    ref_fasta.write_fasta(str(b), recs, width=60)
    assert a.read_bytes() == b.read_bytes()
    fq = tmp_path / "r.fq"
    fq.write_bytes(b"@x one\nACGTNacgt\n+\nIIIIIIIII\n\n@y\nTTGA\n+\nIIII\n")
    for path in (str(a), str(fq)):
        got = list(fasta.iter_fasta(path))
        want = list(ref_fasta.iter_fasta(path))
        assert [r.name for r in got] == [r.name for r in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.codes, w.codes)


@pytest.mark.parametrize("print_ext", [False, True])
def test_m4_text_matches_reference(print_ext):
    rng = np.random.default_rng(8)
    rows = []
    for _ in range(40):
        v = [int(x) for x in rng.integers(0, 90000, 11)]
        ident = float(np.float32(rng.uniform(60, 100)))
        rows.append(dict(qid=v[0] + 1, sid=v[1] + 1, identity=ident,
                         score=v[2], qstrand=0, qstart=v[3], qend=v[4],
                         qsize=v[5], sstrand=v[6] % 2, sstart=v[7],
                         send=v[8], ssize=v[9],
                         qext=v[10] if print_ext else None,
                         sext=v[3] if print_ext else None))
    got = m4.format_block([m4.M4Record(**r) for r in rows])
    want = ref_m4.format_block([ref_m4.M4Record(**r) for r in rows])
    assert got == want and got.count("\n") == 40


def test_candidate_columns_match_reference():
    rng = np.random.default_rng(9)
    cols = {f: rng.integers(0, 1 << 20, 50)
            for f in ("qid", "sid", "score", "qdir", "qext", "qsize", "sdir",
                      "sext", "ssize")}
    assert (m4.format_candidate_columns(cols)
            == ref_m4.format_candidate_columns(cols))
    empty = {f: v[:0] for f, v in cols.items()}
    assert m4.format_candidate_columns(empty) == ""


def test_simulator_matches_reference():
    genome = sim.random_genome(20000, seed=91)
    np.testing.assert_array_equal(genome, ref_sim.random_genome(20000, seed=91))
    got, got_truth = sim.simulate_reads(genome, 12, mean_len=3000,
                                        min_len=1000, seed=92)
    want, want_truth = ref_sim.simulate_reads(genome, 12, mean_len=3000,
                                              min_len=1000, seed=92)
    _assert_db_equal(got, want)
    assert ([(t.start, t.end, t.strand) for t in got_truth]
            == [(t.start, t.end, t.strand) for t in want_truth])


def test_sam_text_matches_reference():
    contigs = [("chr1", 30000), ("chr2", 20000)]
    assert sam.sam_header(contigs) == ref_sam.sam_header(contigs)
    assert "@PG\tID:mecat_tpu\tPN:mecat2ref\tVN:0.1.0" in sam.sam_header([])
    rng = np.random.default_rng(21)
    cases = [(np.zeros(0, np.int8), 0, 0, 5), (np.zeros(0, np.int8), 0, 0, 0),
             (np.array([0, 0, 1, 2, 0, 3, 3, 0], np.int32), 2, 8, 10)]
    for n in (1, 7, 400):
        ops = rng.choice(4, n, p=[0.7, 0.1, 0.1, 0.1]).astype(np.int8)
        nq = int((ops != 3).sum())
        cases.append((ops, 3, 3 + nq, 3 + nq + 4))
        cases.append((ops, 0, nq, nq))
    for ops, qb, qe, qsize in cases:
        assert (sam.cigar_from_ops(ops, qb, qe, qsize)
                == ref_sam.cigar_from_ops(ops, qb, qe, qsize))
    assert sam.cigar_from_ops(cases[2][0], 2, 8, 10) == "2S3M1I1M2D1M2S"
    for codes in (rng.integers(0, 4, 50, dtype=np.uint8),
                  np.zeros(0, np.uint8)):
        assert (sam.sam_line("r1", 16, "chr2", 1233, 37, "10M", codes,
                             tags="NM:i:3\tAS:i:40")
                == ref_sam.sam_line("r1", 16, "chr2", 1233, 37, "10M", codes,
                                    tags="NM:i:3\tAS:i:40"))
        assert (sam.sam_line("r1", 0, "chr1", 0, 60, "*", codes)
                == ref_sam.sam_line("r1", 0, "chr1", 0, 60, "*", codes))
        assert (sam.sam_unmapped("junk", codes)
                == ref_sam.sam_unmapped("junk", codes))


def test_pack_2bit_matches_reference():
    from mecat_tpu.io import packed_db as ref_pdb
    from mecat_tpu_torch.io import packed_db as pdb

    rng = np.random.default_rng(17)
    for n in (0, 1, 3, 4, 5, 1023):
        codes = rng.integers(0, 4, n, dtype=np.uint8)
        packed = pdb.pack_2bit(codes)
        assert packed.dtype == np.uint8 and len(packed) == (n + 3) // 4
        np.testing.assert_array_equal(packed, ref_pdb.pack_2bit(codes))
        np.testing.assert_array_equal(pdb.unpack_2bit(packed, n), codes)
        np.testing.assert_array_equal(pdb.unpack_2bit(packed, n),
                                      ref_pdb.unpack_2bit(packed, n))


def _random_tags(rng, L, n):
    pos = rng.integers(0, L, n).astype(np.int32)
    delta = np.where(rng.random(n) < 0.8, 0,
                     rng.integers(1, 4, n)).astype(np.int32)
    base = np.where(delta > 0, rng.integers(0, 4, n),
                    rng.integers(0, 5, n)).astype(np.int32)
    return pos, delta, base


@pytest.mark.parametrize("seed,depth,window", [(1, 8, False), (2, 14, True),
                                               (3, 5, False)])
def test_cns_table_matches_reference(seed, depth, window):
    """The host vote: the same tags into both tables, then ``call``,
    ``call_draft`` and ``call_polished`` give the same arrays."""
    rng = np.random.default_rng(seed)
    L = 300
    template = rng.integers(0, 4, L).astype(np.uint8)
    runs = rng.random(L) < 0.5
    for i in range(1, L):
        if runs[i]:
            template[i] = template[i - 1]
    kw = dict(del_bias100=50, ins_bias100=70, pool_min_cov=3,
              pool_min_cov_ins=3, win_radius=3, win_mass_frac100=30,
              win_peak_frac100=10)
    votes = ((consensus.VoteParams(**kw), ref_consensus.VoteParams(**kw))
             if window else (None, ref_consensus.VoteParams(65, 60, 5, 8)))

    def tables():
        got, want = consensus.CnsTable(template), ref_consensus.CnsTable(
            template)
        r = np.random.default_rng(seed + 10)
        for _ in range(depth):
            a, b = sorted(int(x) for x in r.integers(-10, L + 10, 2))
            pos, delta, base = _random_tags(r, L, 4 * (b - a) // 3)
            # most supports agree with the template
            agree = r.random(len(pos)) < 0.7
            base = np.where(agree & (delta == 0), template[pos], base)
            for t in (got, want):
                t.add_tags(pos, delta, base, (a, b))
        return got, want

    got, want = tables()
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.coverage, want.coverage)
    np.testing.assert_array_equal(got.call_polished(min_coverage=2),
                                  want.call_polished(min_coverage=2))
    for t in (got, want):
        t.add_template_votes()
    gs = got.call(min_coverage=3, min_length=5, vote=votes[0])
    ws = want.call(min_coverage=3, min_length=5, vote=votes[1])
    assert len(gs) == len(ws) >= (depth > 5)
    for g, w in zip(gs, ws):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got.call_draft(min_coverage=3, vote=votes[0]),
                    want.call_draft(min_coverage=3, vote=votes[1])):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_tapes_to_columns_and_tags_match_reference():
    """Op tapes of the port's aligner (torch tensors) through the port's
    copy, the same tapes as NumPy arrays through the original."""
    import torch

    from mecat_tpu_torch.ops.align import extend_pair_batch_with_ops
    from mecat_tpu_torch.testing import pair_inputs

    torch.set_num_threads(1)
    q, t, qlen, tlen, qseed, tseed = pair_inputs(8, 700, seed=23)
    _, right_t, left_t = extend_pair_batch_with_ops(
        *(torch.as_tensor(a) for a in (q, t, qlen, tlen, qseed, tseed)),
        S=128, W=64, max_segs=8, max_segs_left=6)
    got = consensus.tapes_to_columns(right_t, left_t, torch.as_tensor(qseed),
                                     tseed, n_pairs=7)
    want = ref_consensus.tapes_to_columns(
        [x.numpy() for x in right_t], [x.numpy() for x in left_t], qseed,
        tseed, n_pairs=7)
    assert len(got) == len(want) == 7
    n_cols = 0
    for b, (g, w) in enumerate(zip(got, want)):
        for ga, wa in zip(g, w):
            assert ga.dtype == wa.dtype
            np.testing.assert_array_equal(ga, wa)
        n_cols += len(g[0])
        for max_delta in (15, 1):
            gt = consensus.columns_to_tags(*g, support=q[b],
                                           tlen=int(tlen[b]),
                                           max_delta=max_delta)
            wt = ref_consensus.columns_to_tags(*w, support=q[b],
                                               tlen=int(tlen[b]),
                                               max_delta=max_delta)
            for ga, wa in zip(gt, wt):
                assert ga.dtype == wa.dtype
                np.testing.assert_array_equal(ga, wa)
    assert n_cols > 1000
    empty = consensus.columns_to_tags(*(np.zeros(0, np.int32),) * 3,
                                      support=q[0], tlen=5)
    assert [len(x) for x in empty] == [0, 0, 0]


@pytest.mark.parametrize("mode", [0, 1])
def test_edit_stats_matches_reference(mode):
    rng = np.random.default_rng(41 + mode)
    for band in (4, 64):
        for _ in range(30):
            a = rng.integers(0, 4, int(rng.integers(0, 300)), dtype=np.uint8)
            b = sim.mutate(a, rng, 0.05, 0.05, 0.05) if rng.random() < 0.7 \
                else rng.integers(0, 4, int(rng.integers(0, 300)),
                                  dtype=np.uint8)
            want = ref_accuracy.edit_stats(a, b, band=band, mode=mode)
            assert accuracy.edit_stats(a, b, band=band, mode=mode) == want
            assert ref_accuracy._edit_stats_numpy(a, b, band, mode) == want
            assert (accuracy.identity_pct(want, len(a))
                    == ref_accuracy.identity_pct(want, len(a)))


def test_corrected_accuracy_matches_reference(tmp_path):
    genome = sim.random_genome(12000, seed=95)
    db, truths = sim.simulate_reads(genome, 10, mean_len=1500, min_len=800,
                                    seed=96)
    rng = np.random.default_rng(97)
    recs = []
    for i in range(db.n_reads):
        if i == 3:
            continue                               # a missing read
        t = truths[i]
        seg = genome[t.start:t.end]
        seg = sim.mutate(seg, rng, 0.01, 0.01, 0.01)
        if t.strand:
            seg = revcomp(seg)
        recs.append((f"sim_{i}_0", seg))
        if i == 5:
            recs.append((f"sim_{i}_1", seg[:100]))  # a split read
    path = str(tmp_path / "corrected.fasta")
    fasta.write_fasta(path, recs)
    got = accuracy.corrected_accuracy(path, genome, truths, band=128)
    want = ref_accuracy.corrected_accuracy(path, genome, truths, band=128)
    assert [vars(r) for r in got.per_read] == [vars(r) for r in want.per_read]
    assert got.summary() == want.summary()
    assert (got.split_reads, got.missing_reads) == (1, 1)
    assert got.summary()["median_identity"] > 95.0


def test_shard_index_by_hash_matches_jax():
    db, *_ = sharded_case()
    want_idx = ref_build_index(db.codes, db.starts, db.lengths, k=7,
                               device=False)
    port_idx = build_index(db.codes, db.starts, db.lengths, k=7,
                           device="cpu")
    for n_hash in (2, 4):
        want = ref_sharded.shard_index_by_hash(want_idx, n_hash)
        for got in (shard_index_by_hash(port_idx, n_hash),
                    shard_index_by_hash(want_idx, n_hash)):
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
