"""The counts loop's share of its roofline on the checked batches: the
least time of the DP work the reference's extensions of those batches need
(``roofline.dp_least_seconds``) over the device time of the counts-loop
kernel (``extend_kernel<C, false, ...>``) that those batches launched."""

from mecat_bench.roofline import dp_least_seconds, peaks

PATTERN = r"extend_kernel<\d+, false"


def read(ctx):
    tally = ctx.work.get("dp_counts")
    if ctx.trace is None or not tally or not tally["cells"]:
        return None
    t = ctx.trace.op_seconds(PATTERN, units=set(ctx.sample))
    if t <= 0:
        return None
    return 100.0 * dp_least_seconds(tally, peaks(ctx.device_kind)) / t
