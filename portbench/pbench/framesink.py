"""The benchmark's sink: it takes each flush as the server's columnar
frame and keeps the frame's columns, as a deployed sink encodes
straight off them, so the flush builds no object a metric.  The
columns kept for the check are packed for the reference once the
window has closed.

A frame (``core/frame.py``) is read through its public fields only:
``blocks`` (each with ``metas``, ``rows``, ``values``, ``suffix`` and
``tag_table``), ``extra`` (metrics outside the columns, objects with
``name``, ``tags`` and ``value``) and ``common_tags``.  The flusher
makes every block's arrays anew for each flush, so keeping them is
keeping references."""

from __future__ import annotations

import numpy as np


def make_sink():
    """A sink of the port's ``SinkBase`` that keeps every frame."""
    from veneur_tpu_torch.sinks.base import SinkBase

    class FrameSink(SinkBase):
        name = "portbench"

        def __init__(self):
            super().__init__()
            self.frames: list = []

        def flush_frame(self, frame) -> None:
            self.frames.append((list(frame.blocks), list(frame.extra),
                                tuple(frame.common_tags)))

        def flush(self, metrics) -> None:
            # the server's path for a flush that carries no frame
            self.frames.append(([], list(metrics), ()))

        def take(self) -> list:
            got, self.frames = self.frames, []
            return got

    return FrameSink()


def pack(frames) -> tuple[list[str], np.ndarray]:
    """One flush's kept frames as ``reference.compare.flush_values``
    reads them: a key a metric (its sorted tags, then its name, joined
    by NUL) and a value array."""
    keys: list[str] = []
    vals: list[np.ndarray] = []
    for blocks, extra, common in frames:
        for b in blocks:
            table = b.tag_table
            for r in b.rows.tolist():
                meta = b.metas[r]
                tags = table[r] if table is not None else meta.tags + common
                keys.append("\0".join(sorted(tags) + [meta.name + b.suffix]))
            vals.append(np.asarray(b.values, np.float64))
        for m in extra:
            keys.append("\0".join(sorted(m.tags) + [m.name]))
        vals.append(np.fromiter((m.value for m in extra), np.float64,
                                len(extra)))
    return keys, (np.concatenate(vals) if vals else np.empty(0))
