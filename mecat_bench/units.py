"""Work units of a window and how a run samples them.

A unit is what a cell's window counts: one query batch of ``mecat2pw``,
one table slice of ``mecat2cns``.  Every kind takes its units in a fixed
order that interleaves their lengths (:func:`interleave`), so any stretch
of a window holds the whole length mix, and a run checks a sample of the
completed ones (:func:`sample_units`).
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Any, List


@dataclass
class Unit:
    pos: int          # position in the window
    plan: int         # index in the kind's plan of units
    bases: int        # bases the unit carries (query or template bases)
    text: Any = ""    # what the program returned for it


@dataclass
class Window:
    done: List[Unit]
    attempted: int
    failed: int
    seconds: float


def interleave(n: int) -> List[int]:
    """A fixed order of n length-sorted units in which every stretch holds
    short and long ones: k * s mod n for a stride s near n / phi, coprime
    to n."""
    if n <= 2:
        return list(range(n))
    s = max(1, int(round(n / 1.6180339887)))
    while math.gcd(s, n) != 1:
        s += 1
    return [(k * s) % n for k in range(n)]


def sample_units(done: List[Unit], seed: int, k: int) -> List[Unit]:
    """``k`` completed units drawn from the seed, the one with the most
    bases always among them."""
    if not done:
        return []
    longest = max(done, key=lambda u: (u.bases, -u.pos))
    rest = [u for u in done if u is not longest]
    return [longest] + random.Random(seed).sample(rest,
                                                  min(k - 1, len(rest)))
