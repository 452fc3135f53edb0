"""The flush cycle's ``device_wait`` stage (the readback's wait on the
card; ``observe/tracer.py``, kept in ``observe/flushring.py``), in
ms, averaged over the window's flushes."""


def read(ctx):
    recs = [r for r in ctx.flush_records if "device_wait" in r.stages]
    if not recs:
        return None
    return sum(r.stages["device_wait"] for r in recs) / len(recs) / 1e6
