"""The t-digest cluster-merge kernels' share of their roofline, in %:
the least time the window's merges could take at the card's published
HBM bandwidth (``pbench.roofline.merge_floor_bytes`` per interval,
reckoned from the traffic's shapes) over the profiler's device time of
the kernels named ``cluster_merge*``.  Nothing when no such kernel
ran."""

from pbench import roofline


def read(ctx):
    if ctx.trace is None or not ctx.intervals:
        return None
    secs = ctx.trace.kernel_seconds(r"cluster_merge")
    if secs <= 0:
        return None
    floor = roofline.floor_seconds(ctx.merge_floor_bytes) * len(ctx.intervals)
    return 100.0 * floor / secs
