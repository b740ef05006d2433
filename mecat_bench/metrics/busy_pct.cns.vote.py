"""The vote's share of the device's busy time in the window: the device
seconds of the ops launched inside the program's ``cns.vote`` kernel span
(``ops/consensus_device.call_tables``: its scans and reductions)."""

from mecat_bench.spans import busy_pct


def read(ctx):
    return busy_pct(ctx, "cns.vote")
