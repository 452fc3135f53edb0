"""The gRPC import's native decode of each ``SendMetrics`` wire,
outside the server's lock, summed over an interval's wires (thread
time: up to 8 handlers overlap): the program's span ``import.decode``
(``observe/tracer.py``, kept on its flush records), in ms, averaged
over the window's flushes."""

from pbench.spans import ms_per_interval


def read(ctx):
    return ms_per_interval(ctx.flush_records, "import.decode")
