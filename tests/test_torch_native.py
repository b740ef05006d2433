"""The port's native C++ host layer (mecat_tpu_torch.native) against its plain
Python versions and against the JAX package's native and Python paths.

Every comparison is exact: arrays equal, text and files byte for byte.  The
inputs are those of ``tests/test_native.py`` and the partition case of
``tests/test_cns.py`` (60 simulated reads, ``-j 0`` candidates, partitions
of 11 templates), plus one input for each of the reference's rules: a
14-column (``-g 1``) M4 block takes the Python writer, a short row takes
the Python parser (which then raises as the reference's does), and ``.gz``
input takes the Python reader.
"""
import gzip
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

from mecat_tpu import native as ref_native
from mecat_tpu.assembly.ovstore import OverlapStore as RefStore
from mecat_tpu.io import fasta as ref_fasta
from mecat_tpu.io import m4 as ref_m4
from mecat_tpu.io.packed_db import PackedDB as RefDB
from mecat_tpu.pipeline import cns as ref_cns
from mecat_tpu.pipeline import pw as ref_pw
from mecat_tpu.pipeline import trim as ref_trim
from mecat_tpu.utils import accuracy as ref_accuracy
from mecat_tpu_torch import native
from mecat_tpu_torch.assembly.ovstore import OverlapStore
from mecat_tpu_torch.io import fasta, m4
from mecat_tpu_torch.io import packed_db as pdb
from mecat_tpu_torch.io.packed_db import PackedDB
from mecat_tpu_torch.pipeline import cns, pw, trim
from mecat_tpu_torch.utils import accuracy
from mecat_tpu_torch.utils.sim import mutate, random_genome, simulate_reads

#: the options of the partition case (tests/test_cns.py)
PW_OPTS = dict(num_candidates=20, min_align_size=500, kmer_size=8,
               scan_stride=4, scan_batch=16, extend_batch=64,
               align_segment=128, align_band=64, diag_bin=128)


def _in_a_thread(fn):
    """fn() in a thread of its own, its exception raised here.  The JAX
    package's native layer keeps its last error in a thread-local string
    that nothing clears, and then fails its next parse of an empty file in
    that thread; a reference call expected to fail runs here, so its error
    ends with the thread and no later test of this worker meets it."""
    out = {}

    def run():
        try:
            fn()
        except Exception as e:         # handed to the caller below
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    if "error" in out:
        raise out["error"]


def _write(tmp_path, name, data: bytes) -> str:
    p = tmp_path / name
    p.write_bytes(data)
    return str(p)


def _db_arrays(db):
    return (db.codes, db.starts, db.lengths)


def _assert_db_equal(got, want):
    assert got.names == want.names
    for g, w in zip(_db_arrays(got), _db_arrays(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


FASTA = (b">read_one extra stuff\nACGTacgtNN\nGGTT\n"
         b">read_two\n" + b"ACGT" * 300 + b"\n"
         b">empty\n"
         b">last\nTTTT\n")
FASTQ = b"@q1 desc\nACGTN\n+\nIIIII\n@q2\nGGCC\n+ q2\n!!!!\n"


@pytest.mark.parametrize("data,names", [
    (FASTA, ["read_one", "read_two", "empty", "last"]),
    (FASTQ, ["q1", "q2"])])
def test_parse_matches_plain_and_reference(tmp_path, monkeypatch, data,
                                           names):
    path = _write(tmp_path, "t.fa", data)
    nat = PackedDB.from_fasta(path)
    assert nat.names == names
    _assert_db_equal(nat, PackedDB.from_records(fasta.iter_fasta_plain(path)))
    _assert_db_equal(nat, RefDB.from_fasta(path))
    recs, plain = list(fasta.iter_fasta(path)), list(
        fasta.iter_fasta_plain(path))
    assert [r.name for r in recs] == [r.name for r in plain] == names
    for r, p in zip(recs, plain):
        np.testing.assert_array_equal(r.codes, p.codes)
    monkeypatch.setenv("MECAT_TPU_NO_NATIVE", "1")
    _assert_db_equal(nat, RefDB.from_fasta(path))
    # .gz input takes the Python reader, as in the reference
    gz = str(tmp_path / "t.fa.gz")
    with gzip.open(gz, "wb") as fh:
        fh.write(data)
    _assert_db_equal(PackedDB.from_fasta(gz), nat)
    assert [r.name for r in fasta.iter_fasta(gz)] == names


def test_parse_refuses_what_the_reference_refuses(tmp_path):
    path = _write(tmp_path, "bad.txt", b"not a fasta\n")
    with pytest.raises(ValueError):
        PackedDB.from_fasta(path)
    with pytest.raises(ValueError):
        _in_a_thread(lambda: RefDB.from_fasta(path))


def test_pack_unpack_match_plain_and_reference():
    rng = np.random.default_rng(3)
    for n in (0, 1, 3, 4, 5, 1023, 4096):
        codes = rng.integers(0, 4, n).astype(np.uint8)
        packed = pdb.pack_2bit(codes)
        np.testing.assert_array_equal(packed, pdb.pack_2bit_plain(codes))
        np.testing.assert_array_equal(packed,
                                      ref_native.get().pack_2bit(codes))
        np.testing.assert_array_equal(pdb.unpack_2bit(packed, n), codes)
        np.testing.assert_array_equal(pdb.unpack_2bit_plain(packed, n),
                                      codes)


def test_padded_batch_matches_plain_and_reference(monkeypatch):
    rng = np.random.default_rng(4)
    lens = rng.integers(1, 200, 20).astype(np.int32)
    starts = np.zeros(20, dtype=np.int64)
    np.cumsum(lens[:-1].astype(np.int64), out=starts[1:])
    codes = rng.integers(0, 4, int(lens.sum())).astype(np.uint8)
    names = [str(i) for i in range(20)]
    db = PackedDB(codes, starts, lens, names)
    ref = RefDB(codes, starts, lens, names)
    ids = [5, 0, 19, 7, 7]
    for pad_to in (None, 64, 128):
        got = db.padded_batch(ids, pad_to=pad_to)
        for other in (db.padded_batch_plain(ids, pad_to=pad_to),
                      ref.padded_batch(ids, pad_to=pad_to)):
            for g, w in zip(got, other):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    monkeypatch.setenv("MECAT_TPU_NO_NATIVE", "1")
    for g, w in zip(db.padded_batch(ids, pad_to=64),
                    ref.padded_batch(ids, pad_to=64)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(IndexError):
        db.padded_batch([3, 20])
    with pytest.raises(IndexError):
        db.padded_batch([-1])


def _m4_records(n: int, seed: int, print_ext: bool):
    rng = np.random.default_rng(seed)
    return [dict(qid=int(rng.integers(1, 1 << 30)), sid=i + 1,
                 identity=float(np.round(rng.uniform(60, 100), 6)),
                 score=int(rng.integers(0, 9999)), qstrand=0,
                 qstart=int(rng.integers(0, 100)), qend=1000, qsize=2000,
                 sstrand=int(rng.integers(0, 2)), sstart=3, send=999,
                 ssize=1500, qext=i if print_ext else None,
                 sext=2 * i if print_ext else None) for i in range(n)]


@pytest.mark.parametrize("print_ext", [False, True])
def test_m4_block_matches_plain_and_reference(monkeypatch, print_ext):
    rows = _m4_records(500, 5, print_ext)
    got = m4.format_block([m4.M4Record(**r) for r in rows])
    assert got == m4.format_block_plain([m4.M4Record(**r) for r in rows])
    assert got == ref_m4.format_block([ref_m4.M4Record(**r) for r in rows])
    assert got.count("\n") == 500
    assert got.split("\n", 1)[0].count("\t") == (13 if print_ext else 11)
    monkeypatch.setenv("MECAT_TPU_NO_NATIVE", "1")
    assert got == ref_m4.format_block([ref_m4.M4Record(**r) for r in rows])
    assert m4.format_block([]) == ""


def test_candidate_columns_match_plain_and_reference():
    rng = np.random.default_rng(6)
    cols = {f: rng.integers(0, 1 << 20, 300)
            for f in ("qid", "sid", "score", "qdir", "qext", "qsize", "sdir",
                      "sext", "ssize")}
    got = m4.format_candidate_columns(cols)
    assert got == m4.format_candidate_columns_plain(cols)
    assert got == ref_m4.format_candidate_columns(cols)
    assert got.count("\n") == 300
    empty = {f: np.zeros(0, np.int64) for f in cols}
    assert m4.format_candidate_columns(empty) == ""


@pytest.mark.parametrize("width", [80, 60])
def test_write_fasta_matches_plain_and_reference(tmp_path, width):
    rng = np.random.default_rng(6)
    recs = [(f"r{i}", rng.integers(0, 4, int(rng.integers(0, 300)))
             .astype(np.uint8)) for i in range(10)]
    paths = [str(tmp_path / f"{k}.fa") for k in ("nat", "plain", "ref")]
    fasta.write_fasta(paths[0], recs, width)
    fasta.write_fasta_plain(paths[1], recs, width)
    ref_fasta.write_fasta(paths[2], recs, width)
    blobs = [open(p, "rb").read() for p in paths]
    assert blobs[0] == blobs[1] == blobs[2]
    fasta.write_fasta(paths[0], [], width)
    assert open(paths[0], "rb").read() == b""


def test_finalize_m4_text_matches_plain_and_reference():
    rng = np.random.default_rng(12)
    n = 400
    cols = {k: [] for k in pw._M4_COL_NAMES}
    for part in range(2):
        cols["qid"].append(rng.integers(1, 30, n))
        cols["sid"].append(rng.integers(1, 30, n))
        cols["identity"].append(rng.uniform(60, 100, n).astype(np.float32))
        for k in ("score", "qstart", "qend", "qsize", "sstart", "send",
                  "ssize", "span", "qext", "sext"):
            cols[k].append(rng.integers(0, 5000, n))
        cols["qstrand"].append(np.zeros(n, np.int32))
        cols["sstrand"].append(rng.integers(0, 2, n).astype(np.int32))
    for print_ext in (0, 1):
        opts = pw.PwOptions(print_ext=print_ext)
        stats = pw.PwStats()
        got = pw.finalize_m4_text(cols, opts, stats)
        ref_stats = ref_pw.PwStats()
        want = ref_pw.finalize_m4_text(
            cols, ref_pw.PwOptions(print_ext=print_ext), ref_stats)
        assert got == want and stats.overlaps == ref_stats.overlaps > 0
        lines = got.splitlines()
        assert len(lines) == stats.overlaps
        assert len(lines[0].split("\t")) == (14 if print_ext else 12)
    # the plain writer of the deduplicated columns gives the same text
    a = {k: np.concatenate(v) for k, v in cols.items()}
    order = np.lexsort((-a["span"], a["sstrand"], a["sid"], a["qid"]))
    a = {k: v[order] for k, v in a.items()}
    key = np.stack([a["qid"], a["sid"], a["sstrand"]], axis=1)
    first = np.ones(len(key), dtype=bool)
    first[1:] = (key[1:] != key[:-1]).any(axis=1)
    a = {k: v[first] for k, v in a.items()}
    assert (pw.m4_text_plain(a, pw.PwOptions())
            == pw.finalize_m4_text(cols, pw.PwOptions(), pw.PwStats()))


@pytest.fixture(scope="module")
def partition_case(tmp_path_factory):
    """The reads and -j 0 candidates of tests/test_cns.py's partition case,
    and a 14-column M4 file of random records over the same reads."""
    tmp = tmp_path_factory.mktemp("native")
    genome = random_genome(8000, seed=71)
    db, _ = simulate_reads(genome, 60, mean_len=2500, min_len=1500,
                           seed=72, error_rate=0.08)
    reads = str(tmp / "reads.fasta")
    fasta.write_fasta(reads, [(db.name(i), db.read(i))
                              for i in range(db.n_reads)])
    cand = str(tmp / "ovl.i0")
    pw.run_pw(reads, cand, str(tmp / "wrk"), pw.PwOptions(task=0, **PW_OPTS),
              device="cpu")
    rows = _m4_records(300, 13, True)
    rng = np.random.default_rng(14)
    for r in rows:
        r["qid"], r["sid"] = (int(x) for x in rng.integers(1, 61, 2))
    ovl1 = str(tmp / "ovl.i1")
    with open(ovl1, "w") as fh:
        fh.write(m4.format_block([m4.M4Record(**r) for r in rows]))
    return tmp, reads, PackedDB.from_fasta(reads), RefDB.from_fasta(reads), \
        (cand, ovl1)


def _read_files(parts):
    return [(lo, hi, open(p, "rb").read()) for lo, hi, p in parts]


@pytest.mark.parametrize("input_type", [0, 1])
def test_partition_files_match_plain_and_reference(partition_case,
                                                   monkeypatch, input_type):
    tmp, _, db, ref_db, inputs = partition_case
    path = inputs[input_type]
    d = str(tmp / f"parts{input_type}")
    got = _read_files(cns.partition_supports(path, db, input_type,
                                             d + "_nat", 11))
    assert len(got) == 6 and all(blob for _, _, blob in got)
    for other in (
            cns.partition_supports_plain(path, db, input_type,
                                         d + "_plain", 11),
            ref_cns.partition_supports(path, ref_db, input_type,
                                       d + "_ref", 11)):
        assert _read_files(other) == got
    monkeypatch.setenv("MECAT_TPU_NO_NATIVE", "1")
    assert _read_files(ref_cns.partition_supports(
        path, ref_db, input_type, d + "_refpy", 11)) == got


@pytest.mark.parametrize("input_type", [0, 1])
def test_support_columns_match_plain_and_reference(partition_case,
                                                   monkeypatch, input_type):
    path = partition_case[4][input_type]
    got = cns._support_columns(path, input_type)
    assert got.shape[1] == (9 if input_type == 0 else 12) and len(got)
    np.testing.assert_array_equal(got,
                                  cns._support_columns_plain(path, input_type))
    np.testing.assert_array_equal(got,
                                  ref_cns._support_columns(path, input_type))
    monkeypatch.setenv("MECAT_TPU_NO_NATIVE", "1")
    np.testing.assert_array_equal(got,
                                  ref_cns._support_columns(path, input_type))


def test_short_row_takes_the_python_parser(tmp_path):
    """parse_table refuses a short row; the reference then runs its record
    parser, which raises on the same row: so does the port."""
    cand = _write(tmp_path, "short.txt", b"1\t2\t30\t0\t5\t900\t0\t7\t800\n"
                                         b"2\t3\t30\t0\t5\n")
    m4_path = _write(tmp_path, "short.m4", b"1 2 90.00 30 0 5 7\n")
    with pytest.raises(ValueError, match="short row"):
        native.get().parse_table(cand, 9)
    for port_fn, ref_fn in (
            (lambda: cns._support_columns(cand, 0),
             lambda: ref_cns._support_columns(cand, 0)),
            (lambda: trim._m4_span_columns(m4_path),
             lambda: ref_trim._m4_span_columns(m4_path))):
        with pytest.raises(ValueError, match="bad") as got:
            port_fn()
        with pytest.raises(ValueError) as want:
            _in_a_thread(ref_fn)
        assert str(got.value) == str(want.value)


def test_an_error_does_not_stick_to_the_next_parse(tmp_path):
    """After a refused short row, an empty table is a table of no rows, as
    in a process that saw no error (the error message used to outlive the
    call that set it)."""
    short = _write(tmp_path, "short.m4", b"1 2 90.00 30 0 5 7\n")
    empty = _write(tmp_path, "empty.m4", b"")
    lib = native.get()
    with pytest.raises(ValueError, match="short row"):
        lib.parse_table(short, 12)
    got = lib.parse_table(empty, 12)
    assert got.shape == (0, 12)
    np.testing.assert_array_equal(m4.m4_columns(empty),
                                  m4.m4_columns_plain(empty))


def test_m4_columns_ovstore_and_trim_match_reference(partition_case,
                                                     monkeypatch):
    path = partition_case[4][1]
    got = m4.m4_columns(path)
    np.testing.assert_array_equal(got, m4.m4_columns_plain(path))
    np.testing.assert_array_equal(trim._m4_span_columns(path), got)
    np.testing.assert_array_equal(ref_trim._m4_span_columns(path), got)
    store = OverlapStore.from_m4(path, 60)
    for switch in ("", "1"):
        monkeypatch.setenv("MECAT_TPU_NO_NATIVE", switch)
        ref = RefStore.from_m4(path, 60)
        for f in ("a", "b", "flip", "abeg", "aend", "alen", "bbeg", "bend",
                  "blen", "identity", "score", "offsets"):
            g, w = getattr(store, f), getattr(ref, f)
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", [0, 1])
def test_edit_stats_match_plain_and_reference(monkeypatch, mode):
    rng = np.random.default_rng(41 + mode)
    cases = []
    for band in (4, 64, 256):
        for _ in range(20):
            a = rng.integers(0, 4, int(rng.integers(0, 300)), dtype=np.uint8)
            b = (mutate(a, rng, 0.05, 0.05, 0.05) if rng.random() < 0.7
                 else rng.integers(0, 4, int(rng.integers(0, 300)),
                                   dtype=np.uint8))
            cases.append((a, b, band))
    got = [accuracy.edit_stats(a, b, band=bd, mode=mode) for a, b, bd in cases]
    assert got == [accuracy.edit_stats_plain(a, b, bd, mode)
                   for a, b, bd in cases]
    assert got == [ref_accuracy.edit_stats(a, b, bd, mode)
                   for a, b, bd in cases]
    monkeypatch.setenv("MECAT_TPU_NO_NATIVE", "1")
    assert got == [ref_accuracy.edit_stats(a, b, bd, mode)
                   for a, b, bd in cases]


def test_failed_build_raises_with_the_compilers_message(tmp_path):
    """No fallback: a source g++ refuses raises RuntimeError with g++'s
    message."""
    from mecat_tpu_torch.ops.cuda_build import compile_library

    src = _write(tmp_path, "broken.cpp", b"int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on broken.cpp"):
        compile_library(native.api.gxx(), native.api.GXX_FLAGS, src,
                        str(tmp_path / "libbroken.so"))
    assert not os.path.exists(tmp_path / "libbroken.so")
