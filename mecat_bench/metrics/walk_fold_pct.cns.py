"""Share of the device's busy time in the window spent in the walk and
fold kernels: the row walk, the deposit scan, the column walk
(``csrc/cns_walk.cu``), the planes and the fold (``csrc/cns_fold.cu``),
by kernel name."""

PATTERN = (r"walk_rows_kernel|walk_deposit_kernel|walk_cols_kernel"
           r"|fold_planes_kernel|fold_tags_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    busy = ctx.trace.busy_s
    if busy <= 0:
        return None
    return 100.0 * ctx.trace.op_seconds(PATTERN) / busy
