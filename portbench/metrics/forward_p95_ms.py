"""95th percentile, in ms, of every ``SendMetrics`` in the window, from
the time the generator was due to send it to its acknowledgement (the
generator's clock, shared with the server's)."""

import numpy as np


def read(ctx):
    if not ctx.latencies:
        return None
    return 1e3 * float(np.percentile(np.asarray(ctx.latencies), 95))
