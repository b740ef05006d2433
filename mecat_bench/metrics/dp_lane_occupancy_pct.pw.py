"""Useful over issued DP cells of the pw device step over the window
(``PwStats.cells_useful / cells``): how much of the extension lanes'
budget live lanes fill."""


def read(ctx):
    cells = ctx.counters.get("cells")
    if not cells:
        return None
    return 100.0 * ctx.counters["cells_useful"] / cells
