"""The port's fused ("two-phase") pw route on CPU vs the JAX package.

``probe_hits`` with a hash shard's code range, ``probe_step`` and
``extend_selected`` are held against the JAX functions field by field, one
batch of ``process_query_batch_fused`` record by record, and
``run_pw(route="fused")`` against the JAX ``run_pw`` forced onto its fused
route, on one volume and on several: the same M4 bytes and the same
``PwStats`` counters.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread is as fast, and several test workers share the cores
torch.set_num_threads(1)
jnp = pytest.importorskip("jax.numpy")

from mecat_tpu.index.kmer_index import build_index
from mecat_tpu.io.packed_db import PackedDB
from mecat_tpu.ops import ddf as ref_ddf
from mecat_tpu.parallel.sharded import shard_index_by_hash
from mecat_tpu.pipeline import device_step as ref_step
from mecat_tpu.pipeline import pw as ref_pw
from mecat_tpu_torch.cli import mecat2pw
from mecat_tpu_torch.index.kmer_index import index_from_numpy
from mecat_tpu_torch.ops import ddf
from mecat_tpu_torch.pipeline import device_step as port_step
from mecat_tpu_torch.pipeline.pw import (PwOptions, PwStats,
                                         process_query_batch_fused, run_pw)
from mecat_tpu_torch.testing import DIST_PW, dist_reads

READS = os.path.join(os.path.dirname(__file__), "golden", "reads.fasta")
STAT_FIELDS = ("reads", "candidates", "extended", "overlaps", "cells",
               "cells_useful")
PROBE = dict(k=9, stride=4, max_occ=16, num_candidates=8, diag_bin=256,
             L_target=4096, S=128, W=64, min_block_score=2)


@pytest.fixture(scope="module")
def golden():
    db = PackedDB.from_fasta(READS)
    idx = build_index(db.codes, db.starts, db.lengths, k=PROBE["k"],
                      device=False)
    bases, lens = db.padded_batch(range(8), pad_to=4096)
    # row 3 stands for a pad row: length 0, self id 0
    lens = lens.copy()
    lens[3] = 0
    self_id = np.asarray([0, 1, 2, 0, 4, 5, 6, 7], np.int32)
    return db, idx, bases, lens, self_id


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    d = tmp_path_factory.mktemp("fused")
    db, reads = dist_reads(str(d))
    return d, reads


@pytest.mark.parametrize("n_hash,shards", [(2, (0, 1)), (4, (0, 1, 3))])
def test_probe_hits_code_range_matches_jax(golden, n_hash, shards):
    db, idx, bases, lens, self_id = golden
    off_sh, rid_sh, loc_sh, lo = shard_index_by_hash(idx, n_hash)
    spp = off_sh.shape[1] - 1
    kw = dict(k=PROBE["k"], stride=PROBE["stride"], max_occ=PROBE["max_occ"],
              diag_bin=PROBE["diag_bin"])
    n_valid = 0
    for h in shards:
        want = ref_ddf.probe_hits(
            jnp.asarray(bases), jnp.asarray(lens), jnp.asarray(off_sh[h]),
            jnp.asarray(rid_sh[h]), jnp.asarray(loc_sh[h]),
            jnp.int32(idx.max_occ_cutoff), jnp.asarray(self_id),
            code_lo=int(lo[h]), code_hi=int(lo[h]) + spp, **kw)
        got = ddf.probe_hits(
            torch.as_tensor(bases), torch.as_tensor(lens),
            torch.as_tensor(off_sh[h]), torch.as_tensor(rid_sh[h]),
            torch.as_tensor(loc_sh[h]), int(idx.max_occ_cutoff),
            torch.as_tensor(self_id), code_lo=int(lo[h]),
            code_hi=int(lo[h]) + spp, **kw)
        for name, g, w in zip(("rid", "dbin", "qpos", "toff", "valid"),
                              got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"shard {h} {name}")
        n_valid += int(got[4].sum())
    assert n_valid > 0


def _step_inputs(golden):
    db, idx, bases, lens, self_id = golden
    pidx = index_from_numpy(idx, "cpu")
    jx = (jnp.asarray(bases), jnp.asarray(lens), jnp.asarray(self_id),
          jnp.asarray(db.codes), jnp.asarray(idx.offsets),
          jnp.asarray(idx.pos_rid), jnp.asarray(idx.pos_loc),
          jnp.asarray(idx.read_starts), jnp.asarray(idx.read_lengths),
          jnp.int32(idx.max_occ_cutoff))
    pt = (torch.as_tensor(bases), torch.as_tensor(lens),
          torch.as_tensor(self_id), torch.as_tensor(db.codes), pidx.offsets,
          pidx.pos_rid, pidx.pos_loc, pidx.read_starts, pidx.read_lengths,
          pidx.max_occ_cutoff)
    return jx, pt


def test_probe_step_and_extend_selected_match_jax(golden):
    jx, pt = _step_inputs(golden)
    want_c, want_s = ref_step.probe_step(*jx, **PROBE)
    got_c, got_s = port_step.probe_step(*pt, **PROBE)
    for name, g, w in zip(want_c._fields, got_c, want_c):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    surv = np.asarray(want_s)
    assert 0 < surv.sum() < surv.size

    sel = np.flatnonzero(surv.reshape(-1)).astype(np.int32)
    K = 32
    sel_pad = np.zeros(K, np.int32)
    sel_pad[:len(sel)] = sel[:K]
    valid = np.arange(K) < len(sel)
    N = PROBE["num_candidates"]
    kw = dict(N=N, L_target=PROBE["L_target"], S=128, W=64, max_segs=40)
    want_r, want_w = ref_step.extend_selected(
        jx[0], jx[1], jx[3], jx[7], jx[8],
        want_c.target.reshape(-1).astype(jnp.int32),
        want_c.qseed.reshape(-1), want_c.tseed.reshape(-1),
        jnp.asarray(sel_pad), jnp.asarray(valid), K=K, **kw)
    got_r, got_w = port_step.extend_selected(
        pt[0], pt[1], pt[3], pt[7], pt[8], got_c.target.reshape(-1),
        got_c.qseed.reshape(-1), got_c.tseed.reshape(-1),
        torch.as_tensor(sel_pad), torch.as_tensor(valid), **kw)
    for name, g, w in zip(want_r._fields, got_r, want_r):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    assert int(got_r.n_segs[:len(sel)].min()) > 0
    assert int(got_r.n_segs[len(sel):].sum()) == 0     # pad lanes are dead


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("volume_bases", [None, 20000])
def test_fused_run_pw_matches_jax(sim, monkeypatch, volume_bases):
    d, reads = sim
    opts = dict(DIST_PW)
    if volume_bases:
        opts["volume_bases"] = volume_bases
    tag = f"v{volume_bases}"
    monkeypatch.setenv("MECAT_TPU_FORCE_FUSED", "1")
    want = str(d / f"ref_{tag}.m4")
    ref_stats = ref_pw.run_pw(reads, want, str(d / f"wref_{tag}"),
                              ref_pw.PwOptions(**opts))
    monkeypatch.delenv("MECAT_TPU_FORCE_FUSED")
    got = str(d / f"port_{tag}.m4")
    stats = run_pw(reads, got, str(d / f"wport_{tag}"), PwOptions(**opts),
                   device="cpu", route="fused")
    assert _read(got) == _read(want)
    assert stats.overlaps > 0
    for f in STAT_FIELDS:
        assert getattr(stats, f) == getattr(ref_stats, f), f
    if volume_bases:
        n_vol = len(PackedDB.from_fasta(reads).split_volumes(volume_bases))
        assert n_vol > 1


def test_fused_route_refuses_candidates(tmp_path):
    with pytest.raises(ValueError):
        run_pw(READS, str(tmp_path / "o"), str(tmp_path / "w"),
               PwOptions(task=0), device="cpu", route="fused")
    with pytest.raises(SystemExit) as e:
        mecat2pw.main(["-j", "0", "-d", READS, "-o", str(tmp_path / "o"),
                       "-w", str(tmp_path / "w"), "--route", "fused",
                       "--device", "cpu"])
    assert e.value.code == 2


def test_process_query_batch_fused_matches_jax():
    db = PackedDB.from_fasta(READS)
    opts = dict(DIST_PW, num_candidates=12, scan_batch=8)
    idx = build_index(db.codes, db.starts, db.lengths, k=opts["kmer_size"],
                      device=False)
    dev = idx.as_device_arrays()
    dev["vol_codes"] = jnp.asarray(db.codes)
    qids = list(range(3, 11))
    ref_stats, stats = ref_pw.PwStats(), PwStats()
    want = ref_pw.process_query_batch_fused(
        db, 0, dev, int(idx.max_occ_cutoff), qids, ref_pw.PwOptions(**opts),
        db, ref_stats, 4096, 8192)
    pidx = index_from_numpy(idx, "cpu")
    got = process_query_batch_fused(
        db, 0, pidx, torch.as_tensor(db.codes), qids, PwOptions(**opts), db,
        stats, 4096, 8192)
    assert len(want) > 0
    assert [r.format() for r in got] == [r.format() for r in want]
    for f in STAT_FIELDS[1:]:
        assert getattr(stats, f) == getattr(ref_stats, f), f
