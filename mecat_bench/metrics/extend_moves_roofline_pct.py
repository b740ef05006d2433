"""The move loop's share of its roofline on the checked slices: the least
time of the DP work every pair of those slices needs, as the reference's
extensions find it (``reference.cns.slice_tally``,
``roofline.dp_least_seconds``), over the device time of the move-loop
kernel (``extend_kernel<C, true, ...>``) those slices launched."""

from mecat_bench.roofline import dp_least_seconds, peaks

PATTERN = r"extend_kernel<\d+, true"


def read(ctx):
    tally = ctx.work.get("dp_moves")
    if ctx.trace is None or not tally or not tally["cells"]:
        return None
    t = ctx.trace.op_seconds(PATTERN, units=set(ctx.sample))
    if t <= 0:
        return None
    return 100.0 * dp_least_seconds(tally, peaks(ctx.device_kind)) / t
