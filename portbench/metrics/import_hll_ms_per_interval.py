"""The gRPC import's per-item HyperLogLog decode and register fold,
inside the apply, summed over an interval's wires: the program's span
``import.hll``
(``observe/tracer.py``, kept on its flush records), in ms, averaged
over the window's flushes."""

from pbench.spans import ms_per_interval


def read(ctx):
    return ms_per_interval(ctx.flush_records, "import.hll")
