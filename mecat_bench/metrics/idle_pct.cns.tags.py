"""Share of the window in which the card is idle while the host launches a
chunk's tag fold: idle time inside the program's ``cns.tags`` spans
(``ops/consensus_banded.banded_accumulate_tags``: row information,
deposit, planes, fold)."""

from mecat_bench.spans import idle_pct


def read(ctx):
    return idle_pct(ctx, "cns.tags")
