"""DP row-update cost decomposition on a torch device.

Port of ``tools/roll_micro.py``: the same [S, W, B] row-update loop is timed
in five variants that remove one cost at a time, at the same shapes:

  full     - the counts-only row update with its per-row best cell
  noroll   - the neighbour exchange (vertical shift, closure scan) replaced
             by the cell's own value (not an alignment; timing only)
  nobest   - best-cell tracking (3 reductions a row) removed
  elembest - best tracking as 2 elementwise ops a row on a packed
             (score, -row) key with ONE final reduction
  baremin  - noroll + nobest (the diag/vert/min floor)

Usage:
    python -m mecat_tpu_torch.tools.roll_micro [--b 2048] [--s 512]
        [--w 128] [--reps 16] [--device cuda]

Prints one JSON line: the shape, ``<variant>_ms`` and ``<variant>_gcells_s``
(S*W*B cells a launch) for each variant, the kernel launches made and the
device.  With ``--device cuda`` every variant runs in the Hopper kernel
(``csrc/roll_micro.cu``) and the tool exits non-zero without a card or when
the build fails; ``--device cpu`` runs the plain version, whose times say
nothing about a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..cli.mecat2pw import device_exists
from ..ops import roll_micro as rm
from ..utils.sim import mutate, random_genome


def make_inputs(B: int, S: int, W: int):
    """The tool's lanes: one source (seed 7) as every lane's query, its
    1/1/1 % mutation (seed 11) as every lane's target, tmax = S + W/2,
    segq = S.  Returns numpy (q [B, S], t [B, S + W], tmax [B], segq [B]).
    A mutated target shorter than S + W is padded with zeros."""
    rng = np.random.default_rng(11)
    src = random_genome(S + W, seed=7)
    mut = mutate(src, rng, .01, .01, .01)[:S + W]
    q = np.tile(src[:S], (B, 1)).astype(np.uint8)
    t = np.zeros((B, S + W), np.uint8)
    t[:, :len(mut)] = mut
    return q, t, np.full(B, S + W // 2, np.int32), np.full(B, S, np.int32)


def time_variant(args, S: int, W: int, rolls: bool, best: str,
                 reps: int) -> float:
    """Seconds a call of one variant, mean of ``reps`` after one warm call:
    CUDA events on the card, the host clock on the CPU."""
    rm.roll_micro(*args, S, W, rolls, best)
    if args[0].device.type != "cuda":
        t0 = time.time()
        for _ in range(reps):
            rm.roll_micro(*args, S, W, rolls, best)
        return (time.time() - t0) / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        rm.roll_micro(*args, S, W, rolls, best)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="roll_micro", description="DP row-update cost decomposition")
    ap.add_argument("--b", type=int, default=2048)
    ap.add_argument("--s", type=int, default=512)
    ap.add_argument("--w", type=int, default=128)
    ap.add_argument("--reps", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cuda:N or cpu)")
    a = ap.parse_args(argv)
    if not device_exists(a.device):
        ap.error(f"device {a.device!r} does not exist on this machine")
    dev = torch.device(a.device)
    B, S, W = a.b, a.s, a.w
    args = [torch.as_tensor(x, device=dev) for x in make_inputs(B, S, W)]
    out = {"lanes": B, "S": S, "W": W, "reps": a.reps}
    cells = S * W * B
    launches0 = rm.LAUNCHES
    for name, (rolls, best) in rm.VARIANTS.items():
        dt = time_variant(args, S, W, rolls, best, a.reps)
        out[name + "_gcells_s"] = round(cells / dt / 1e9, 2)
        out[name + "_ms"] = round(dt * 1e3, 3)
    out["launches"] = rm.LAUNCHES - launches0
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
