"""The port's assembler (mecat_tpu_torch.assembly, index.meryl, PackedDB's
disk form) vs the JAX package: arrays equal element by element, files equal
byte for byte.

``PackedDB.append`` / ``save`` / ``load`` (each package loads the other's
store), the k-mer spectrum, the overlap store, the error-rate estimate, the
unitig layouts and the stitched backbone equal the originals'.  The tiled
device polish equals the JAX ``_polish_contig_device`` and the port's own
host route, for one tile and for several, under two table caps.
``run_assembly`` on error-free tiled reads writes the contigs FASTA, the
layout text and the GFA of the JAX run, and a second call re-runs nothing.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread is as fast, and several test workers share the cores
torch.set_num_threads(1)
pytest.importorskip("jax")

from mecat_tpu.assembly import ctgcns as ref_ctgcns
from mecat_tpu.assembly import driver as ref_driver
from mecat_tpu.assembly import erate as ref_erate
from mecat_tpu.assembly import ovstore as ref_ovstore
from mecat_tpu.assembly import unitig as ref_unitig
from mecat_tpu.index import meryl as ref_meryl
from mecat_tpu.io.packed_db import PackedDB as RefDB
from mecat_tpu.pipeline.pw import PwOptions as RefPwOptions
from mecat_tpu_torch.assembly import ctgcns, driver, erate, ovstore, unitig
from mecat_tpu_torch.index import meryl
from mecat_tpu_torch.io.fasta import FastaRecord, write_fasta
from mecat_tpu_torch.io.m4 import format_block
from mecat_tpu_torch.io.packed_db import PackedDB
from mecat_tpu_torch.pipeline.pw import PwOptions
from mecat_tpu_torch.testing import (db_from, m4_record, perfect_overlaps,
                                     polish_case, tiled_reads)
from mecat_tpu_torch.utils.sim import random_genome

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
STORE_COLS = ("a", "b", "flip", "abeg", "aend", "alen", "bbeg", "bend",
              "blen", "identity", "score", "offsets")


def _ref_db(db):
    return RefDB(db.codes, db.starts, db.lengths, list(db.names))


def _assert_db_equal(got, want):
    for name in ("codes", "starts", "lengths"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert list(got.names) == list(want.names)


def _assert_stores_equal(got, want):
    assert got.n_reads == want.n_reads and len(got) == len(want)
    for c in STORE_COLS:
        g, w = getattr(got, c), getattr(want, c)
        assert g.dtype == w.dtype, c
        np.testing.assert_array_equal(g, w, err_msg=c)


def test_packed_db_append_save_load_match_reference(tmp_path):
    reads = os.path.join(GOLDEN, "reads.fasta")
    db, rdb = PackedDB.from_fasta(reads), RefDB.from_fasta(reads)
    rng = np.random.default_rng(3)
    recs = [FastaRecord(f"d{i}", rng.integers(0, 4, n, dtype=np.uint8))
            for i, n in enumerate((501, 3, 1200))]
    got, want = db.append(recs), rdb.append(recs)
    _assert_db_equal(got, want)
    assert got.n_reads == db.n_reads + 3 and db.append([]) is db
    np.testing.assert_array_equal(got.read(db.n_reads + 1), recs[1].codes)
    # unnamed reads get their index as a name once something is appended
    bare = PackedDB(db.codes, db.starts, db.lengths)
    rbare = RefDB(db.codes, db.starts, db.lengths)
    _assert_db_equal(bare.append(recs[:1]), rbare.append(recs[:1]))
    # the same files, and each package loads the other's store
    got.save(str(tmp_path / "port"))
    want.save(str(tmp_path / "ref"))
    for ext in (".pac.npy", ".names.json"):
        assert ((tmp_path / ("port" + ext)).read_bytes()
                == (tmp_path / ("ref" + ext)).read_bytes()), ext
    gi, wi = (np.load(str(tmp_path / (p + ".idx.npz")))
              for p in ("port", "ref"))
    assert sorted(gi.files) == sorted(wi.files)
    for k in wi.files:
        assert gi[k].dtype == wi[k].dtype
        np.testing.assert_array_equal(gi[k], wi[k])
    _assert_db_equal(PackedDB.load(str(tmp_path / "ref")), want)
    _assert_db_equal(RefDB.load(str(tmp_path / "port")), want)
    _assert_db_equal(PackedDB.load(str(tmp_path / "port")), got)


@pytest.mark.parametrize("k", [9, 12, 16])
def test_meryl_matches_reference(k):
    genome = random_genome(3000, seed=13)
    db = db_from([genome, genome[500:2500], genome, genome[:7]])
    rdb = _ref_db(db)
    counts = meryl.kmer_counts(db, k=k)
    np.testing.assert_array_equal(counts, ref_meryl.kmer_counts(rdb, k=k))
    assert counts.sum() == sum(max(int(n) - k + 1, 0) for n in db.lengths)
    hist = meryl.kmer_histogram(db, k=k)
    np.testing.assert_array_equal(hist, ref_meryl.kmer_histogram(rdb, k=k))
    assert hist.dtype == np.int64 and hist[1] == 0 and hist[2] > 0
    for h in (hist, hist * 0, np.arange(200, dtype=np.int64)):
        assert (meryl.pick_freq_cutoff(h) == ref_meryl.pick_freq_cutoff(h))
        assert (meryl.pick_freq_cutoff(h, tail_frac=0.3, min_cutoff=1)
                == ref_meryl.pick_freq_cutoff(h, tail_frac=0.3, min_cutoff=1))


def _random_overlaps(n_reads, n_ov, seed):
    """Overlaps among reads of uneven error: dovetails, containments, both
    strands, identities that follow the two reads' error rates."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(3000, 9000, n_reads)
    e = rng.uniform(0.005, 0.06, n_reads)
    recs = []
    for _ in range(n_ov):
        a, b = (int(x) for x in rng.choice(n_reads, size=2, replace=False))
        span = int(rng.integers(800, min(lens[a], lens[b])))
        qs = (int(lens[a]) - span, int(lens[a])) if rng.random() < 0.7 \
            else (int(rng.integers(0, lens[a] - span)),) * 2
        if qs[0] == qs[1]:
            qs = (qs[0], qs[0] + span)
        ss = (0, span) if rng.random() < 0.7 else \
            (int(lens[b]) - span, int(lens[b]))
        d = rng.binomial(span, e[a] + e[b]) / span
        recs.append(m4_record(a, b, qs, ss, int(lens[a]), int(lens[b]),
                              strand=int(rng.random() < 0.4),
                              ident=100.0 * (1.0 - d),
                              score=int(rng.integers(50, 5000))))
    return recs


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ovs")
    m4p = str(d / "o.m4")
    with open(m4p, "w") as fh:
        fh.write(format_block(_random_overlaps(50, 420, seed=41)))
    return (ovstore.OverlapStore.from_m4(m4p, 50),
            ref_ovstore.OverlapStore.from_m4(m4p, 50), d)


def test_ovstore_matches_reference(stores):
    got, want, d = stores
    _assert_stores_equal(got, want)
    assert len(got) == 840 and got.for_read(7) == want.for_read(7)
    got.save(str(d / "port"))
    want.save(str(d / "ref"))
    assert ((d / "port.ovs.json").read_bytes()
            == (d / "ref.ovs.json").read_bytes())
    _assert_stores_equal(ovstore.OverlapStore.load(str(d / "ref")), want)
    _assert_stores_equal(ref_ovstore.OverlapStore.load(str(d / "port")), want)
    empty = d / "empty.m4"
    empty.write_text("")
    _assert_stores_equal(ovstore.OverlapStore.from_m4(str(empty), 3),
                         ref_ovstore.OverlapStore.from_m4(str(empty), 3))


@pytest.mark.parametrize("iters,cap", [(25, 0.5), (3, 0.04)])
def test_erate_matches_reference_bit_for_bit(stores, iters, cap):
    got_s, want_s, _ = stores
    got = erate.estimate_read_erates(got_s, iters=iters, cap=cap)
    want = ref_erate.estimate_read_erates(want_s, iters=iters, cap=cap)
    for name in ("e", "residual", "adj_identity"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype == np.float32
        assert g.tobytes() == w.tobytes(), name
    assert 0.005 < float(got.e.mean()) < 0.06
    none = erate.estimate_read_erates(ovstore.OverlapStore.from_m4(
        os.devnull, 4))
    assert none.e.tolist() == [0.0] * 4 and len(none.residual) == 0


@pytest.mark.parametrize("adjusted", [False, True])
def test_unitigs_match_reference(stores, adjusted):
    got_s, want_s, _ = stores
    ident = (erate.estimate_read_erates(got_s).adj_identity if adjusted
             else None)
    kw = dict(end_slack=100, min_identity=93.0 if adjusted else 0.0,
              identity=ident)
    for name, g in unitig.classify(got_s, **kw).items():
        np.testing.assert_array_equal(
            g, ref_unitig.classify(want_s, **kw)[name], err_msg=name)
    got = unitig.build_unitigs(got_s, **kw)
    want = ref_unitig.build_unitigs(want_s, **kw)
    np.testing.assert_array_equal(got.contained, want.contained)
    assert got.n_dovetail == want.n_dovetail > 0
    ga = unitig.layouts_to_arrays(got.unitigs)
    wa = ref_unitig.layouts_to_arrays(want.unitigs)
    assert sorted(ga) == sorted(wa)
    for k in wa:
        assert ga[k].dtype == wa[k].dtype, k
        np.testing.assert_array_equal(ga[k], wa[k], err_msg=k)
    assert len(got.unitigs) > 1 and got.contained.any()
    back = unitig.arrays_to_layouts(ga)
    assert [[vars(r) for r in u.rows] for u in back] \
        == [[vars(r) for r in u.rows] for u in got.unitigs]


@pytest.mark.parametrize("flip_every", [0, 2])
def test_stitch_backbone_matches_reference(tmp_path, flip_every):
    genome = random_genome(5000, seed=11)
    read_len, step, n = 1000, 750, 6
    reads, orients = tiled_reads(genome, n, read_len, step, flip_every)
    db = db_from(reads)
    m4p = str(tmp_path / "o.m4")
    with open(m4p, "w") as fh:
        fh.write(format_block(perfect_overlaps(reads, orients, read_len,
                                               step)))
    tig = unitig.build_unitigs(ovstore.OverlapStore.from_m4(m4p, n),
                               end_slack=50).unitigs[0]
    rtig = ref_unitig.build_unitigs(
        ref_ovstore.OverlapStore.from_m4(m4p, n), end_slack=50).unitigs[0]
    got = ctgcns.stitch_backbone(db, tig)
    np.testing.assert_array_equal(
        got, ref_ctgcns.stitch_backbone(_ref_db(db), rtig))
    want = genome[:step * (n - 1) + read_len]
    assert np.array_equal(got, want) or np.array_equal(
        got, (3 - want)[::-1])
    assert len(ctgcns.stitch_backbone(db, unitig.Unitig())) == 0


POLISH_OPTS = dict(extend_batch=8, align_segment=128, align_band=64)


def _ref_tig(tig):
    return ref_unitig.Unitig(rows=[ref_unitig.LayoutRow(**vars(r))
                                   for r in tig.rows])


@pytest.mark.parametrize("genome_len,n,tile_max,tiles", [
    (6000, 7, None, 1), (24000, 29, 8192, 12)])
def test_polish_device_matches_jax_and_the_host_route(
        tmp_path, monkeypatch, genome_len, n, tile_max, tiles):
    """One tile (the 7-read case of tests/test_assembly.py) and several
    tiles (margin 3072 for 1.2 kb reads at S = 128, tiles of 8192, cores of
    2048), each under the default table cap and under one that holds a
    single tile."""
    db, tig, backbone = polish_case(str(tmp_path), genome_len, n, seed=77)
    if tile_max:
        monkeypatch.setattr(ctgcns, "_TILE_L_MAX", tile_max)
        monkeypatch.setattr(ref_ctgcns, "_TILE_L_MAX", tile_max)
    opts = ctgcns.CtgCnsOptions(**POLISH_OPTS)
    stats = ctgcns.PolishStats()
    dev = ctgcns._polish_contig_device(db, tig, backbone, opts, device="cpu",
                                       stats=stats)
    assert stats.tiles == tiles and stats.contigs_device == 1
    small = ctgcns._polish_contig_device(db, tig, backbone, opts,
                                         device="cpu", cap=1)
    np.testing.assert_array_equal(small, dev)
    host = ctgcns._polish_contig_host(db, tig, backbone, opts, device="cpu")
    np.testing.assert_array_equal(host, dev)
    want = ref_ctgcns._polish_contig_device(
        _ref_db(db), _ref_tig(tig), backbone,
        ref_ctgcns.CtgCnsOptions(**POLISH_OPTS))
    np.testing.assert_array_equal(dev, want)
    assert dev.dtype == np.uint8 and len(dev) > 0.95 * len(backbone)
    assert not np.array_equal(dev, backbone)          # the polish binds
    # polish_contig picks the device route by the geometry alone
    picked = ctgcns.polish_contig(db, tig, backbone, opts, device="cpu")
    np.testing.assert_array_equal(picked, dev)


def test_polish_contig_takes_the_host_route_for_long_reads(tmp_path,
                                                           monkeypatch):
    db, tig, backbone = polish_case(str(tmp_path), 6000, 7, seed=77)
    opts = ctgcns.CtgCnsOptions(**POLISH_OPTS)
    assert ctgcns._polish_margin(1200, 128) == 3072
    assert ctgcns._polish_margin(0, 128) == 1024
    monkeypatch.setattr(ctgcns, "_TILE_L_MAX", 6144)   # = 2 * margin
    called = []
    monkeypatch.setattr(ctgcns, "_polish_contig_device",
                        lambda *a, **k: called.append(1))
    stats = ctgcns.PolishStats()
    got = ctgcns.polish_contig(db, tig, backbone, opts, device="cpu",
                               stats=stats)
    assert not called and stats.contigs_host == 1 and stats.tiles == 0
    np.testing.assert_array_equal(
        got, ctgcns._polish_contig_host(db, tig, backbone, opts,
                                        device="cpu"))
    empty = np.zeros(0, np.uint8)
    assert ctgcns._polish_contig_host(db, tig, empty, opts,
                                      device="cpu") is empty


PW = dict(task=1, kmer_size=9, scan_stride=4, min_align_size=400,
          num_candidates=16, scan_batch=16, extend_batch=32,
          align_segment=128, align_band=64)
ASM = dict(do_trim=False, min_read_length=500, min_overlap_length=400,
           min_contig_length=1500)
STAGES = ("gatekeeper", "meryl", "overlap", "ovstore", "erate", "unitig",
          "consensus", "output")


def test_run_assembly_matches_jax_and_resumes(tmp_path):
    """The error-free tiled reads of tests/test_assembly.py through both
    drivers: contigs FASTA, layout text and GFA byte for byte, the arrays
    of every stored stage, and the report's fields."""
    genome = random_genome(12000, seed=12)
    read_len, step = 2000, 1200
    n = (len(genome) - read_len) // step + 1
    reads, _ = tiled_reads(genome, n, read_len, step, flip_every=3)
    db = db_from(reads + [genome[100:400]])       # one read under the floor
    reads_fa = str(tmp_path / "reads.fasta")
    write_fasta(reads_fa, [(db.name(i), db.read(i))
                           for i in range(db.n_reads)])
    wrk, rwrk = str(tmp_path / "asm"), str(tmp_path / "ref_asm")
    pw_opts = PwOptions(**PW)
    opts = driver.AsmOptions(pw=pw_opts, cns=ctgcns.CtgCnsOptions(
        extend_batch=16, align_segment=128, align_band=64), **ASM)
    report = driver.run_assembly(reads_fa, "t", wrk, opts, device="cpu")
    want = ref_driver.run_assembly(
        reads_fa, "t", rwrk, ref_driver.AsmOptions(
            pw=RefPwOptions(**PW), cns=ref_ctgcns.CtgCnsOptions(
                extend_batch=16, align_segment=128, align_band=64), **ASM))
    for name in ("t.contigs.fasta", "t.layout.txt", "t.contigs.gfa",
                 "t.asm.m4", "t.ovs.json", "t.gk.pac.npy",
                 "t.gk.names.json"):
        with open(os.path.join(wrk, name), "rb") as fa, \
                open(os.path.join(rwrk, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    for name in ("t.gk.idx.npz", "t.meryl.npz", "t.ovs.npz", "t.erate.npz",
                 "t.layout.npz"):
        ga = np.load(os.path.join(wrk, name))
        wa = np.load(os.path.join(rwrk, name))
        assert sorted(ga.files) == sorted(wa.files), name
        for k in wa.files:
            assert ga[k].dtype == wa[k].dtype, (name, k)
            assert ga[k].tobytes() == wa[k].tobytes(), (name, k)
    for field in ("stages", "n_reads", "n_overlaps", "n_unitigs",
                  "n_contigs", "total_contig_bases", "max_contig", "n50"):
        assert getattr(report, field) == getattr(want, field), field
    assert report.stages == list(STAGES) and report.n_reads == n
    assert report.n_contigs >= 1 and report.max_contig >= 0.8 * len(genome)
    # the meryl cutoff was written into the caller's PwOptions
    assert pw_opts.index_cutoff == int(
        np.load(os.path.join(wrk, "t.meryl.npz"))["cutoff"])
    with open(os.path.join(wrk, "t.report")) as fh:
        assert json.load(fh)["n50"] == report.n50
    for stage in STAGES:
        with open(os.path.join(wrk, stage + ".done")) as fh:
            assert json.load(fh)["stage"] == stage
    with open(os.path.join(wrk, "consensus.done")) as fh:
        meta = json.load(fh)
    assert meta["contigs_device"] >= 1 and meta["tiles"] >= 1
    # resume: every marker stands, nothing re-runs, the same report
    again = driver.run_assembly(reads_fa, "t", wrk, opts, device="cpu")
    assert again.stages == [] and again.n50 == report.n50
    assert again.n_contigs == report.n_contigs
    # a lost marker re-runs that stage alone, to the same bytes
    os.remove(os.path.join(wrk, "unitig.done"))
    third = driver.run_assembly(reads_fa, "t", wrk, opts, device="cpu")
    assert third.stages == ["unitig"]


def test_run_assembly_without_reads_stops_after_the_gatekeeper(tmp_path):
    reads_fa = str(tmp_path / "short.fasta")
    write_fasta(reads_fa, [("s", random_genome(300, seed=1))])
    report = driver.run_assembly(reads_fa, "e", str(tmp_path / "w"),
                                 driver.AsmOptions(), device="cpu")
    assert report.stages == ["gatekeeper"] and report.n_reads == 0
    assert report.n_contigs == 0 and driver._n50([]) == 0
    assert driver._n50([5, 3, 2]) == 5 and driver._n50([4, 4, 1]) == 4
