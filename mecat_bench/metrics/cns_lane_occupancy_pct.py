"""Useful over issued DP lane-segments of the correction chunks over the
window (``CnsStats.dp_lane_segs_useful / dp_lane_segs_issued``)."""


def read(ctx):
    issued = ctx.counters.get("dp_lane_segs_issued")
    if not issued:
        return None
    return 100.0 * ctx.counters["dp_lane_segs_useful"] / issued
