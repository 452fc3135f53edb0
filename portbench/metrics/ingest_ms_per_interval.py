"""Ingest span of a DogStatsD interval, in ms: from the interval's first
``handle_packet_batch`` call to its last return, over every feeder
(the benchmark's own clock), averaged over the window's intervals."""


def read(ctx):
    if not ctx.intervals:
        return None
    return 1e3 * sum(iv.ingest_s for iv in ctx.intervals) / len(ctx.intervals)
