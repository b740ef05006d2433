"""``correct_batch_device`` at the widths the CLIs run, port vs JAX.

The other correction tests run (S, W) = (128, 64); the ``mecat2cns`` CLI,
the pipeline and phase 6 of ``chip_smoke.py`` run the pacbio preset at
(512, 128).  Here 16 templates of a pile of 48 reads of mean 6 kb go
through both packages' device route at those widths with 32 pairs a chunk:
the same corrected reads, in the same order, and the same statistics.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread is as fast, and several test workers share the cores
torch.set_num_threads(1)
pytest.importorskip("jax")

from mecat_tpu.io.packed_db import PackedDB as RefDB
from mecat_tpu.pipeline import cns as ref
from mecat_tpu_torch import constants as C
from mecat_tpu_torch.io.fasta import write_fasta
from mecat_tpu_torch.pipeline import cns as port
from mecat_tpu_torch.pipeline.pw import PwOptions, run_pw
from mecat_tpu_torch.utils.sim import random_genome, simulate_reads


def test_correct_batch_device_pacbio_preset_at_512_128(tmp_path):
    genome = random_genome(24000, seed=401)
    db, _ = simulate_reads(genome, 48, mean_len=6000, min_len=4000,
                           seed=402, error_rate=0.12)
    reads = str(tmp_path / "r.fa")
    write_fasta(reads, [(db.name(i), db.read(i)) for i in range(db.n_reads)])
    cand = str(tmp_path / "c.txt")
    run_pw(reads, cand, str(tmp_path / "w"),
           PwOptions(task=0, num_candidates=16, scan_batch=16), db=db,
           device="cpu")
    ref_db = RefDB.from_fasta(reads)
    by_ref = ref.load_supports(cand, ref_db, 0)
    by_port = port.load_supports(cand, db, 0)
    templates = sorted(by_ref)[:16]
    assert len(templates) == 16
    overrides = dict(extend_batch=32)
    ref_opts = ref.CnsOptions.for_tech(C.TECH_PACBIO, **overrides)
    opts = port.CnsOptions.for_tech(C.TECH_PACBIO, **overrides)
    assert (opts.align_segment, opts.align_band) == (512, 128)
    rs, ps = ref.CnsStats(), port.CnsStats()
    want = list(ref.correct_batch_device(ref_db, templates, by_ref,
                                         ref_opts, rs))
    got = list(port.correct_batch_device(db, templates, by_port, opts, ps,
                                         device="cpu"))
    assert len(want) > 0
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for name in ("templates", "supports_aligned", "corrected_reads",
                 "corrected_bases"):
        assert getattr(ps, name) == getattr(rs, name), name
    assert ps.supports_aligned > 100
