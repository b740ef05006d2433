"""Share of the window in which the card is idle while the pw driver
prepares a batch on the host: idle time inside the program's ``pw.prep``
spans (oriented rows, padding, self ids, uploads)."""

from mecat_bench.spans import idle_pct


def read(ctx):
    return idle_pct(ctx, "pw.prep")
