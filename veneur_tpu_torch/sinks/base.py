"""Sink, span-sink and plugin contracts and routing (port of
``veneur_tpu/sinks/base.py``; reference sinks/sinks.go:32 MetricSink,
:85 SpanSink; plugins/plugins.go:16 Plugin).

Sinks are host-side and run post-readback at flush, each on its own
fan-out worker (``sinks/fanout.py``).  Metric routing honours
per-metric ``veneursinkonly:<name>`` whitelists
(InterMetric.acceptable_for) and per-sink excluded tags (reference
server.go:1642-1668 SetExcludedTags); a flush's MetricFrame routes
itself the same way (``MetricFrame.route``) and reaches a sink through
``flush_frame``.
"""

from __future__ import annotations

import logging
from typing import Iterable, Protocol, runtime_checkable

from veneur_tpu_torch.core.metrics import InterMetric

log = logging.getLogger("veneur_tpu_torch.sinks")


def jfloat(v: float) -> str:
    """JSON number text for a float without a per-value json.dumps
    call (the columnar encoders' hot path); non-finite falls back to
    the stdlib spelling (NaN, Infinity) so wire bytes match the
    legacy dict encoders."""
    if v == v and abs(v) != float("inf"):
        return repr(v)
    import json
    return json.dumps(v)


@runtime_checkable
class MetricSink(Protocol):
    name: str

    def start(self) -> None: ...

    def flush(self, metrics: list[InterMetric]) -> None: ...

    def flush_other_samples(self, samples: list) -> None:
        """Events / service checks (reference
        MetricSink.FlushOtherSamples)."""


@runtime_checkable
class SpanSink(Protocol):
    name: str

    def start(self) -> None: ...

    def ingest(self, span) -> None: ...

    def flush(self) -> None: ...


@runtime_checkable
class Plugin(Protocol):
    name: str

    def flush(self, metrics: list[InterMetric], hostname: str) -> None: ...


@runtime_checkable
class DerivedMetricsProcessor(Protocol):
    """Re-injection point for computed samples (reference
    samplers/derived.go:8 ``DerivedMetricsProcessor``): anything that
    synthesizes metrics mid-pipeline — the ssfmetrics span bridge,
    SLI indicator timers — hands them here to enter aggregation like
    any ingested sample.  ``core.Server`` satisfies this."""

    def ingest_parsed(self, sample) -> None: ...

    def bump(self, key: str, n: int = 1) -> None: ...


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

    def start(self) -> None:
        pass

    def flush_frame(self, frame) -> None:
        """Columnar fast path (core.frame.MetricFrame).  The frame
        handed here is already routed for this sink (whitelists +
        excluded tags applied), so the adapter just materializes the
        legacy list for sinks that never learned frames; concrete
        sinks override to encode straight off the columns."""
        self.flush(frame.materialize())

    def flush_other_samples(self, samples: list) -> None:
        pass


class SpanTagExcluder:
    """set_excluded_tags for SPAN sinks (the reference's
    setSinkExcludedTags walks span sinks too, server.go:1658): span
    tags are a dict, filtered at payload-build time so the shared
    span object is never mutated across sinks."""

    excluded_tags: frozenset = frozenset()

    def set_excluded_tags(self, tags: Iterable[str]) -> None:
        self.excluded_tags = frozenset(tags)

    def filter_span_tags(self, tags) -> dict:
        if not self.excluded_tags:
            return dict(tags)
        return {k: v for k, v in tags.items()
                if k not in self.excluded_tags}


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
