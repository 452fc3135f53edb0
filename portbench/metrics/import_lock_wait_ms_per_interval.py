"""The gRPC import's wait for the server's lock, from asking for it to
holding it, summed over an interval's wires: the program's span
``import.lock_wait``
(``observe/tracer.py``, kept on its flush records), in ms, averaged
over the window's flushes."""

from pbench.spans import ms_per_interval


def read(ctx):
    return ms_per_interval(ctx.flush_records, "import.lock_wait")
