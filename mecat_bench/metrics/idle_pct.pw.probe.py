"""Share of the window in which the card is idle while the host launches a
batch's probe: idle time inside the program's ``pw.probe`` spans (the
scan and the one-segment probe of each strand, their kernel spans
included)."""

from mecat_bench.spans import idle_pct


def read(ctx):
    return idle_pct(ctx, "pw.probe")
