"""The flush cycle's ``host_emit`` stage (building the emitted
metrics on the host; ``observe/tracer.py``, kept in
``observe/flushring.py``), in ms, averaged over the window's
flushes."""


def read(ctx):
    recs = [r for r in ctx.flush_records if "host_emit" in r.stages]
    if not recs:
        return None
    return sum(r.stages["host_emit"] for r in recs) / len(recs) / 1e6
