"""The port's row-update micro-benchmark family vs the Pallas original.

``tools/roll_micro.py`` is loaded by path and its ``build_call`` run in
interpret mode (the CPU backend); ``roll_micro_plain`` must give the same 8
output rows on every lane for each of the five variants.  The Pallas family
is band-major ([S, B] inputs, [8, B] output), the port lane-major: the test
transposes.  The Hopper kernel is held against the plain version in
tests/test_torch_cuda.py.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread is as fast, and several test workers share the cores
torch.set_num_threads(1)
jnp = pytest.importorskip("jax.numpy")

from mecat_tpu_torch.ops import roll_micro as rm
from mecat_tpu_torch.tools import roll_micro as tool
from mecat_tpu_torch.testing import roll_micro_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, W, B = 16, 32, 128


@pytest.fixture(scope="module")
def pallas_tool():
    spec = importlib.util.spec_from_file_location(
        "pallas_roll_micro", os.path.join(ROOT, "tools", "roll_micro.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", list(rm.VARIANTS))
def test_plain_matches_pallas_interpret(pallas_tool, name):
    rolls, best = rm.VARIANTS[name]
    assert (rolls, best) == {"full": (True, "log"), "noroll": (False, "log"),
                             "nobest": (True, "none"),
                             "elembest": (True, "elem"),
                             "baremin": (False, "none")}[name]
    q, t, tmax, segq = roll_micro_inputs(S, W, B, seed=3)
    call = pallas_tool.build_call(S, W, B, 128, rolls, best)
    want = np.asarray(call(jnp.asarray(q.T.copy()), jnp.asarray(t.T.copy()),
                           jnp.asarray(tmax[None, :]),
                           jnp.asarray(segq[None, :])))
    got = rm.roll_micro_plain(*(torch.as_tensor(a) for a in (q, t, tmax,
                                                             segq)),
                              S, W, rolls, best)
    assert got.dtype == torch.int32 and got.shape == (B, 8)
    np.testing.assert_array_equal(got.numpy().T, want)
    if rolls:                   # the lanes really differ
        assert len({tuple(r) for r in got.numpy().tolist()}) > 8
    if best == "elem":
        # the lane with no valid cell: every key is -i, the largest is -1
        assert int(tmax[B // 2 + 1]) == -1
        assert got[B // 2 + 1].tolist() == [1, 0, rm.VINF, 0, 0, 0, 0, 0]


def test_elem_key_wraps_in_int32():
    x = torch.tensor([rm._NEG * 1024 - 3, -5, (1 << 31) + 7, -(1 << 31)])
    assert rm._wrap32(x).tolist() == [-3, -5, -(1 << 31) + 7, -(1 << 31)]


def test_dispatch_is_by_device_and_cuda_wrapper_refuses_cpu_tensors():
    q, t, tmax, segq = (torch.as_tensor(a)
                        for a in roll_micro_inputs(S, W, B, seed=3))
    before = rm.LAUNCHES
    got = rm.roll_micro(q, t, tmax, segq, S, W, True, "log")
    assert rm.LAUNCHES == before         # CPU tensors: the plain version
    assert torch.equal(got, rm.roll_micro_plain(q, t, tmax, segq, S, W, True,
                                                "log"))
    with pytest.raises(ValueError):
        rm.roll_micro_cuda(q, t, tmax, segq, S, W, True, "log")


def test_tool_on_cpu_prints_the_originals_json_line(pallas_tool, capsys):
    rc = tool.main(["--b", "8", "--s", "16", "--w", "32", "--reps", "1",
                    "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["lanes"], out["S"], out["W"], out["reps"]) == (8, 16, 32, 1)
    assert out["device"] == "cpu" and out["launches"] == 0
    for name in rm.VARIANTS:
        assert out[name + "_ms"] > 0 and name + "_gcells_s" in out
    with pytest.raises(SystemExit) as exc:
        tool.main(["--device", "cuda:7"])
    assert exc.value.code == 2
    # the tool's lanes are the original tool's (seeds 11 and 7)
    q, t, tmax, segq = tool.make_inputs(4, 512, 128)
    from mecat_tpu.utils.sim import mutate as ref_mutate
    from mecat_tpu.utils.sim import random_genome as ref_genome

    src = ref_genome(640, seed=7)
    mut = ref_mutate(src, np.random.default_rng(11), .01, .01, .01)[:640]
    assert len(mut) == 640
    np.testing.assert_array_equal(q[3], src[:512])
    np.testing.assert_array_equal(t[0], mut)
    assert tmax.tolist() == [576] * 4 and segq.tolist() == [512] * 4
