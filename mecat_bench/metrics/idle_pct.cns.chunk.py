"""Share of the window in which the card is idle while the host prepares
and launches a slice's chunks: idle time inside the program's
``cns.chunk`` spans (chunk function, padding, uploads, the chunk's
launches)."""

from mecat_bench.spans import idle_pct


def read(ctx):
    return idle_pct(ctx, "cns.chunk")
