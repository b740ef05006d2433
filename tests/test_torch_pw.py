"""Port mecat2pw path (mecat_tpu_torch.pipeline) on CPU vs the JAX package.

The golden fixtures pin the end-to-end bytes; overlap_step and the
two-volume run are compared with the JAX package directly.
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
from mecat_tpu.pipeline import device_step as ref_step
from mecat_tpu.pipeline import pw as ref_pw
from mecat_tpu_torch.index.kmer_index import index_from_numpy
from mecat_tpu_torch.pipeline import device_step as port_step
from mecat_tpu_torch.pipeline.pw import PwOptions, run_pw
from mecat_tpu_torch.testing import GOLDEN_J0, GOLDEN_J1

HERE = os.path.join(os.path.dirname(__file__), "golden")
READS = os.path.join(HERE, "reads.fasta")


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("opts,golden", [(GOLDEN_J1, "overlaps.m4"),
                                         (GOLDEN_J0, "candidates.txt")])
def test_run_pw_cpu_matches_golden_bytes(tmp_path, opts, golden):
    out = str(tmp_path / golden)
    stats = run_pw(READS, out, str(tmp_path / "w"), PwOptions(**opts),
                   device="cpu")
    assert _read(out) == _read(os.path.join(HERE, golden))
    assert stats.candidates > 0


def test_overlap_step_matches_jax():
    db = PackedDB.from_fasta(READS)
    B, L = 8, 4096
    cfg = dict(k=9, stride=4, max_occ=32, num_candidates=12, diag_bin=256,
               L_target=L, S=128, W=64, max_segs=40, min_align_size=400,
               min_identity=70.0)
    idx = build_index(db.codes, db.starts, db.lengths, k=cfg["k"],
                      device=False)
    pidx = index_from_numpy(idx, "cpu")
    for bi in range(2):
        ids = list(range(bi * B, (bi + 1) * B))
        bases, lens = db.padded_batch(ids, pad_to=L)
        self_id = np.asarray(ids, dtype=np.int32)
        want = ref_step.overlap_step(
            jnp.asarray(bases), jnp.asarray(lens), jnp.asarray(self_id),
            jnp.asarray(db.codes), jnp.asarray(idx.offsets),
            jnp.asarray(idx.pos_rid), jnp.asarray(idx.pos_loc),
            jnp.asarray(idx.read_starts), jnp.asarray(idx.read_lengths),
            jnp.int32(idx.max_occ_cutoff), **cfg)
        got = port_step.overlap_step(
            torch.as_tensor(bases), torch.as_tensor(lens),
            torch.as_tensor(self_id), torch.as_tensor(db.codes),
            pidx.offsets, pidx.pos_rid, pidx.pos_loc, pidx.read_starts,
            pidx.read_lengths, pidx.max_occ_cutoff, **cfg)
        assert bool(got.valid.any())
        for name, g, w in zip(want._fields, got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)


def test_multi_volume_run_matches_jax_and_resumes(tmp_path):
    opts = dict(GOLDEN_J1, volume_bases=25000)
    want = str(tmp_path / "ref.m4")
    ref_pw.run_pw(READS, want, str(tmp_path / "wref"),
                  ref_pw.PwOptions(**opts))
    got = str(tmp_path / "port.m4")
    wrk = str(tmp_path / "wport")
    run_pw(READS, got, wrk, PwOptions(**opts), device="cpu")
    n_vol = len(PackedDB.from_fasta(READS).split_volumes(25000))
    assert n_vol == 3
    assert len(os.listdir(wrk)) == n_vol * (n_vol + 1) // 2
    assert _read(got) == _read(want)
    # a rerun finds every shard and rewrites the same bytes
    stats = run_pw(READS, got, wrk, PwOptions(**opts), device="cpu")
    assert stats.candidates == 0
    assert _read(got) == _read(want)
