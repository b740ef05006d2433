"""The device-side strand merge of ``-j 0`` (mecat_tpu_torch.ops.ddf.
merge_strand_candidates_device) against the JAX one, and the port's
``-j 0`` run_pw, which goes through it, against the golden candidates and
the JAX run_pw over several volumes.  Exact equality throughout.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jnp = pytest.importorskip("jax.numpy")

from mecat_tpu.ops import ddf as ref_ddf
from mecat_tpu.pipeline import pw as ref_pw
from mecat_tpu_torch.ops.ddf import Candidates, merge_strand_candidates_device
from mecat_tpu_torch.pipeline import pw
from mecat_tpu_torch.testing import GOLDEN_J0

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
READS = os.path.join(GOLDEN, "reads.fasta")


def _candidates(rng, B: int, N: int, max_score: int, p_valid: float):
    """Random candidates, scores from a small range (many ties)."""
    return [rng.integers(0, 40, (B, N)).astype(np.int32),
            rng.integers(0, max_score, (B, N)).astype(np.int32),
            rng.integers(0, 5000, (B, N)).astype(np.int32),
            rng.integers(0, 5000, (B, N)).astype(np.int32),
            rng.random((B, N)) < p_valid]


@pytest.mark.parametrize("seed", range(6))
def test_merge_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, N = int(rng.integers(1, 17)), int(rng.integers(1, 13))
    max_score = int(rng.integers(2, 6))
    p_valid = float(rng.choice([0.0, 0.3, 0.8, 1.0]))
    strands = [_candidates(rng, B, N, max_score, p_valid) for _ in range(2)]
    port = [Candidates(*(torch.as_tensor(a) for a in s)) for s in strands]
    ref = [ref_ddf.Candidates(*(jnp.asarray(a) for a in s))
           for s in strands]
    for n_keep in (1, 3, N, 2 * N + 1):
        for n_valid in (None, 0, B // 2, B, B + 3):
            for min_score in (0, 2):
                merged, count = merge_strand_candidates_device(
                    port[0], port[1], min_score, n_valid, n_keep=n_keep)
                r_merged, r_count = ref_ddf.merge_strand_candidates_device(
                    ref[0], ref[1], jnp.int32(min_score),
                    None if n_valid is None else jnp.int32(n_valid),
                    n_keep=n_keep)
                assert int(count) == int(r_count)
                assert merged.dtype == torch.int32
                np.testing.assert_array_equal(merged.numpy(),
                                              np.asarray(r_merged))
                # the kept prefix equals the host merge, rows < n_valid
                host = pw._merge_strand_candidates(
                    list(enumerate(port)), n_keep, min_score)
                if len(host):
                    host = host[host[:, 0] < (B if n_valid is None
                                              else n_valid)]
                np.testing.assert_array_equal(
                    merged[:int(count)].numpy(), host.reshape(-1, 6))


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_j0_run_pw_matches_golden(tmp_path):
    out = str(tmp_path / "cand.txt")
    stats = pw.run_pw(READS, out, str(tmp_path / "w"),
                      pw.PwOptions(**GOLDEN_J0), device="cpu")
    assert _read(out) == _read(os.path.join(GOLDEN, "candidates.txt"))
    assert stats.candidates == _read(out).count(b"\n") > 0


@pytest.mark.parametrize("volume_bases", [25_000, 12_000])
def test_j0_run_pw_matches_jax_over_volumes(tmp_path, monkeypatch,
                                            volume_bases):
    opts = dict(GOLDEN_J0, volume_bases=volume_bases)
    out = str(tmp_path / "port.txt")
    stats = pw.run_pw(READS, out, str(tmp_path / "wp"), pw.PwOptions(**opts),
                      device="cpu")
    got = _read(out)
    assert len(os.listdir(tmp_path / "wp")) >= 3   # two volumes or more
    for gather in ("0", "1"):   # the JAX host merge, then its device merge
        monkeypatch.setenv("MECAT_TPU_PW_DEV_GATHER", gather)
        ref_out = str(tmp_path / f"ref{gather}.txt")
        ref_pw.run_pw(READS, ref_out, str(tmp_path / f"wr{gather}"),
                      ref_pw.PwOptions(**opts))
        assert got == _read(ref_out)
    assert stats.candidates == got.count(b"\n") > 0
