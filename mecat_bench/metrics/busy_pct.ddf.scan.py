"""The candidate scan's share of the device's busy time in the window: the
device seconds of the ops launched inside the program's ``ddf.scan``
kernel span (``ops/ddf.scan_candidates``: k-mer probe, sorts, run-length
score, top n)."""

from mecat_bench.spans import busy_pct


def read(ctx):
    return busy_pct(ctx, "ddf.scan")
