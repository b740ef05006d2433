"""Share of the window the pw driver spends preparing batches on the host
(``PwStats.prep_s``: oriented rows, padding, self ids, uploads)."""


def read(ctx):
    prep = ctx.counters.get("prep_s")
    if prep is None or ctx.window_s <= 0:
        return None
    return 100.0 * prep / ctx.window_s
