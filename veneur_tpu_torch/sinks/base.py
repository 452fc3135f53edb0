"""Sink contract and routing (port of ``veneur_tpu/sinks/base.py``).

Sinks are host-side and run post-readback at flush.  Metric routing
honours per-metric ``veneursinkonly:<name>`` whitelists
(InterMetric.acceptable_for) and per-sink excluded tags; a flush's
MetricFrame routes itself the same way (``MetricFrame.route``) and
reaches a sink through ``flush_frame``.
"""

from __future__ import annotations

from typing import Iterable, Protocol, runtime_checkable

from veneur_tpu_torch.core.metrics import InterMetric


@runtime_checkable
class MetricSink(Protocol):
    name: str

    def flush(self, metrics: list[InterMetric]) -> None: ...


class SinkBase:
    """Convenience base with excluded-tag stripping."""

    name = "base"

    def __init__(self):
        self.excluded_tags: frozenset[str] = frozenset()

    def set_excluded_tags(self, tags: Iterable[str]) -> None:
        self.excluded_tags = frozenset(tags)

    def strip_tags(self, m: InterMetric) -> InterMetric:
        if not self.excluded_tags:
            return m
        kept = tuple(t for t in m.tags
                     if t.split(":", 1)[0] not in self.excluded_tags)
        if kept == m.tags:
            return m
        return InterMetric(name=m.name, timestamp=m.timestamp,
                           value=m.value, tags=kept, type=m.type,
                           message=m.message, hostname=m.hostname)

    def flush_frame(self, frame) -> None:
        """Columnar entry (``core.frame.MetricFrame``).  The frame is
        already routed for this sink (whitelists and excluded tags
        applied), so the default hands ``flush`` its materialized
        list; a sink that encodes straight off the columns overrides
        this."""
        self.flush(frame.materialize())


def route(metrics: list[InterMetric], sink_name: str,
          sink: SinkBase | None = None) -> list[InterMetric]:
    """Filter a flush batch for one sink: whitelist routing + excluded
    tags (reference sinks.IsAcceptableMetric, sinks/sinks.go:51)."""
    out = []
    for m in metrics:
        if not m.acceptable_for(sink_name):
            continue
        out.append(sink.strip_tags(m) if sink is not None else m)
    return out
