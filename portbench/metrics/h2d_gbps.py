"""Host-to-device copy rate, in GB/s: the bytes the program counts
copying to the card over the window's flushes (its flush records'
``counts["h2d.bytes"]``: the table's copies and the flush's own) over
the seconds of the trace's ``Memcpy HtoD`` entries."""


def read(ctx):
    if ctx.trace is None:
        return None
    counts = [getattr(r, "counts", None) or {} for r in ctx.flush_records]
    if not any("h2d.bytes" in c for c in counts):
        return None
    sec = sum(s for n, s in ctx.trace.by_op.items()
              if n.startswith("Memcpy HtoD"))
    if sec <= 0:
        return None
    return sum(c.get("h2d.bytes", 0) for c in counts) / sec / 1e9
