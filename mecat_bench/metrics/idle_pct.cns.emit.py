"""Share of the window in which the card is idle while the host pulls a
slice's emit arrays and splits each template's called bases: idle time
inside the program's ``cns.emit`` spans."""

from mecat_bench.spans import idle_pct


def read(ctx):
    return idle_pct(ctx, "cns.emit")
