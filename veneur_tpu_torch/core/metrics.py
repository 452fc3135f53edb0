"""InterMetric: the flush-time interchange record handed to sinks.

Mirrors the role of the reference's samplers.InterMetric
(samplers/samplers.go:59-100): a flattened, sink-agnostic (name,
timestamp, value, tags, type) tuple produced at flush, with per-metric
sink routing (``veneursinkonly:<sink>`` tags, samplers/samplers.go:110).
"""

from __future__ import annotations

from dataclasses import dataclass, field

GAUGE = "gauge"
COUNTER = "counter"
STATUS = "status"

_SINK_ONLY_PREFIX = "veneursinkonly:"


@dataclass(frozen=True)
class InterMetric:
    name: str
    timestamp: int
    value: float
    tags: tuple[str, ...] = ()
    type: str = GAUGE
    message: str = ""
    hostname: str = ""

    def sink_whitelist(self) -> frozenset[str]:
        """Sinks this metric is restricted to (empty = all sinks);
        reference sinks.IsAcceptableMetric (sinks/sinks.go:51)."""
        return frozenset(t[len(_SINK_ONLY_PREFIX):] for t in self.tags
                         if t.startswith(_SINK_ONLY_PREFIX))

    def acceptable_for(self, sink_name: str) -> bool:
        wl = self.sink_whitelist()
        return not wl or sink_name in wl
