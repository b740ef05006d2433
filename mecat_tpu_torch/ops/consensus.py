"""Vote-rule parameters of the pile consensus (NumPy-free host values).

Copy of ``GAP``, ``VoteParams`` and ``default_vote_params`` of
``mecat_tpu.ops.consensus`` with the builtin defaults and no environment
overrides.  The NumPy vote of the host route (``CnsTable``) is not copied:
the port always votes on the device (:mod:`.consensus_device`).
"""
from __future__ import annotations

from typing import NamedTuple

GAP = 4  # vote code for deletion


class VoteParams(NamedTuple):
    """Pooled-rule tuning, per technology; biases in 1/100ths so every rule
    is integer arithmetic.

    ``win_radius`` > 0 enables the window-pooled single-insertion rule: it
    pools insertion votes over +-win_radius positions; at a strict local
    peak with no emitted insertion nearby, window mass above
    ``win_mass_frac100``/100 of coverage and a peak slot above
    ``win_peak_frac100``/100 of coverage emit one insertion of the peak
    slot's letter.
    """

    del_bias100: int
    ins_bias100: int
    pool_min_cov: int
    pool_min_cov_ins: int
    win_radius: int = 0
    win_mass_frac100: int = 50
    win_peak_frac100: int = 25


def default_vote_params() -> VoteParams:
    """Pooled-deletion bias 0.65, pooled-insertion bias 0.6, pooled top-ups
    from mean coverage 5 (deletions) and 8 (insertions)."""
    return VoteParams(65, 60, 5, 8)
