"""The program's host spans, as its flush records carry them
(``veneur_tpu_torch/observe/tracer.py``: a record's ``span_ns``, span
name -> total ns over the interval it closed, and ``counts``).  A
program without them (no such field, or the name on no record) reads
as None."""


def ms_per_interval(records: list, name: str):
    """Mean over the records of span ``name``'s total, in ms; an
    interval without the span counts 0."""
    got = [getattr(r, "span_ns", None) for r in records]
    if not any(name in (g or {}) for g in got):
        return None
    return sum((g or {}).get(name, 0) for g in got) / len(got) / 1e6
