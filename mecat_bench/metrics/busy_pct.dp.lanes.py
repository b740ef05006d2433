"""The share of the device's busy time in the window spent building the
DP loops' inputs: the device seconds of the ops launched inside the
program's ``dp.lanes`` kernel spans (target windows, row gathers,
``ops/align.direction_lanes``), never the DP loop itself."""

from mecat_bench.spans import busy_pct


def read(ctx):
    return busy_pct(ctx, "dp.lanes")
