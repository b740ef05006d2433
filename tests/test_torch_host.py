"""The port's copies of the host layer (mecat_tpu_torch.constants, io, utils)
against the JAX package's originals: equal values, arrays and bytes.

The originals take their native C++ fast paths where the toolchain builds
them, so these tests also hold the pure-NumPy copies to the native bytes.
"""
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from mecat_tpu import constants as ref_C
from mecat_tpu.io import fasta as ref_fasta
from mecat_tpu.io import m4 as ref_m4
from mecat_tpu.io.packed_db import PackedDB as RefDB
from mecat_tpu.utils import sim as ref_sim
from mecat_tpu_torch import constants as C
from mecat_tpu_torch.io import fasta, m4
from mecat_tpu_torch.io.packed_db import PackedDB
from mecat_tpu_torch.utils import sim

READS = os.path.join(os.path.dirname(__file__), "golden", "reads.fasta")


def _assert_db_equal(got, want):
    for name in ("codes", "starts", "lengths"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert list(got.names) == list(want.names)


def test_constants_equal_reference():
    names = [n for n in dir(C) if n.isupper()]
    assert len(names) >= 18
    for n in names:
        assert getattr(C, n) == getattr(ref_C, n), n


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
