"""The interpreter's cyclic collector, every collection of an interval:
the program's span ``gc``
(``observe/tracer.py``, kept on its flush records), in ms, averaged
over the window's flushes."""

from pbench.spans import ms_per_interval


def read(ctx):
    return ms_per_interval(ctx.flush_records, "gc")
