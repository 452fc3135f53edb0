"""Device time (kernels, copies and sets on the card, their union) per
interval, in ms, from the profiler's trace of the window."""


def read(ctx):
    if ctx.trace is None or not ctx.intervals:
        return None
    return 1e3 * ctx.trace.busy_s / len(ctx.intervals)
