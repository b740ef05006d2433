"""Share of the window in which the card is idle while the host launches a
slice's vote: idle time inside the program's ``cns.vote`` kernel spans
(``ops/consensus_device.call_tables``, after the tally's sync)."""

from mecat_bench.spans import idle_pct


def read(ctx):
    return idle_pct(ctx, "cns.vote")
