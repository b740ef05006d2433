"""Share of the window in which the card is idle while the host plans a
table slice: idle time inside the program's ``cns.plan`` spans (slice
shapes, pair plan, table allocations, template gather)."""

from mecat_bench.spans import idle_pct


def read(ctx):
    return idle_pct(ctx, "cns.plan")
