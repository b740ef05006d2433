"""``run_ref`` at its default options, port vs JAX.

The other mapping tests run (S, W) = (128, 64) and k 10; the ``mecat2ref``
CLI and phase 9 of ``chip_smoke.py`` run the defaults: k 13, stride 10,
(S, W) = (512, 128).  Here 24 reads of mean 2.6 kb over two contigs that
share a 6 kb repeat, and one junk read, are mapped by both packages at the
defaults: the SAM files are equal byte for byte.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread is as fast, and several test workers share the cores
torch.set_num_threads(1)
pytest.importorskip("jax")

from mecat_tpu.pipeline import ref as ref_ref
from mecat_tpu_torch.io.fasta import write_fasta
from mecat_tpu_torch.pipeline import ref as port_ref
from mecat_tpu_torch.utils.sim import random_genome, simulate_reads


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_run_ref_default_options_match_jax_bytes(tmp_path):
    repeat = random_genome(6000, seed=411)
    g1 = np.concatenate([random_genome(16000, seed=412), repeat,
                         random_genome(12000, seed=413)])
    g2 = np.concatenate([random_genome(9000, seed=414), repeat,
                         random_genome(8000, seed=415)])
    ref = str(tmp_path / "genome.fasta")
    write_fasta(ref, [("chr1", g1), ("chr2", g2)])
    db1, _ = simulate_reads(g1, 14, mean_len=2600, min_len=2100, seed=416,
                            error_rate=0.1)
    db2, _ = simulate_reads(g2, 10, mean_len=2600, min_len=2100, seed=417,
                            error_rate=0.1)
    seqs = [(f"c1_{i}", db1.read(i)) for i in range(db1.n_reads)]
    seqs += [(f"c2_{i}", db2.read(i)) for i in range(db2.n_reads)]
    seqs.append(("junk", random_genome(3000, seed=418)))
    reads = str(tmp_path / "reads.fasta")
    write_fasta(reads, seqs)
    got, want = str(tmp_path / "port.sam"), str(tmp_path / "jax.sam")
    opts = port_ref.RefOptions()
    assert (opts.align_segment, opts.align_band, opts.kmer_size) == (
        512, 128, 13)
    stats = port_ref.run_ref(reads, ref, got, str(tmp_path / "wp"), opts,
                             device="cpu")
    ref_stats = ref_ref.run_ref(reads, ref, want, str(tmp_path / "wj"),
                                ref_ref.RefOptions())
    assert _read(got) == _read(want)
    assert (stats.reads, stats.mapped) == (ref_stats.reads, ref_stats.mapped)
    assert stats.mapped >= len(seqs) - 2
    lines = [ln.split("\t") for ln in _read(got).decode().splitlines()
             if not ln.startswith("@")]
    assert [f[1] for f in lines if f[0] == "junk"] == ["4"]
