"""The port's strong-scaling report (mecat_tpu_torch.utils.scaling) with
``gloo`` ranks on the CPU: the shape check of ``tests/test_scaling.py``
(meshes (1, 1), (2, 1), (2, 2); batch 8, 16 reads), the reference's row
keys and its ``t1 = t * n_dev`` normalisation."""
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mecat_tpu_torch.utils.scaling import scaling_report

ROW_KEYS = {"n_data", "n_hash", "n_devices", "step_seconds",
            "speedup_vs_1dev", "scaling_efficiency", "platform",
            "virtual_mesh", "dp_launches", "dp_launches_extend"}


def test_scaling_report_shapes():
    lines = []
    rows = scaling_report(mesh_shapes=[(1, 1), (2, 1), (2, 2), (3, 1)],
                          batch=8, n_batches=2, n_reads=16, genome_n=12_000,
                          emit=lines.append, device="cpu", timeout=240)
    # (3, 1) does not divide the batch: skipped, as in the reference
    cfgs = [r for r in rows if "n_data" in r]
    assert [(r["n_data"], r["n_hash"]) for r in cfgs] == [(1, 1), (2, 1),
                                                          (2, 2)]
    t1 = cfgs[0]["step_seconds"]
    for r in cfgs:
        assert set(r) == ROW_KEYS
        assert r["step_seconds"] > 0
        assert r["n_devices"] == r["n_data"] * r["n_hash"]
        assert r["speedup_vs_1dev"] == round(t1 / r["step_seconds"], 3)
        assert r["scaling_efficiency"] == round(
            t1 / (r["n_devices"] * r["step_seconds"]), 3)
        assert r["platform"] == "cpu"
        assert r["virtual_mesh"] is True  # ranks share the host
        assert r["dp_launches"] == 0      # the plain DP on the CPU
        assert r["dp_launches_extend"] == 0
    assert cfgs[0]["scaling_efficiency"] == 1.0
    # no (4, 1) beside (2, 2): no hash-overhead row
    assert len(rows) == 3
    assert [json.loads(ln)["scaling"] for ln in lines] == rows
