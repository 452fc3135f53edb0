"""The gRPC import's apply under the server's lock
(``apply_import_locked``, which the lock serialises), summed over an
interval's wires: the program's span ``import.apply``
(``observe/tracer.py``, kept on its flush records), in ms, averaged
over the window's flushes."""

from pbench.spans import ms_per_interval


def read(ctx):
    return ms_per_interval(ctx.flush_records, "import.apply")
