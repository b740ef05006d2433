"""Share of the device's busy time in the window spent in sort kernels:
the candidate scan's stable int64 sorts and the device strand merge's
(by kernel name; no other pw kernel sorts)."""

PATTERN = r"(?i)sort"


def read(ctx):
    if ctx.trace is None:
        return None
    busy = ctx.trace.busy_s
    if busy <= 0:
        return None
    return 100.0 * ctx.trace.op_seconds(PATTERN) / busy
