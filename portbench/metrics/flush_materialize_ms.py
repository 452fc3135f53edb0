"""``flush_once``'s build of its return value (a metric object for every
row of the frame): the program's span ``flush.materialize``
(``observe/tracer.py``, kept on its flush records), in ms, averaged
over the window's flushes."""

from pbench.spans import ms_per_interval


def read(ctx):
    return ms_per_interval(ctx.flush_records, "flush.materialize")
