"""Bounded index of recent internal spans, keyed by trace id.

The port's copy of ``veneur_tpu/observe/traceindex.py``.

Cross-tier flush tracing needs each process to be able to answer
"show me trace N" for the last few intervals: the local's flush span
tree, the proxy's route spans, and the global's import/apply spans
all share one trace id once the wire carries context.  Span SINKS
ship spans away; this index keeps a small in-process tail so
``/debug/trace/<trace_id>`` can render the local fragment of the
distributed tree without any external collector.

Only internal spans are indexed (the flush tracer's, the import
handlers', the proxy's route spans) — user traffic never lands here,
so capacity stays tiny: the last ``capacity`` distinct trace ids,
each capped at ``max_spans`` spans, evicted oldest-first.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict

DEFAULT_CAPACITY = 256
MAX_SPANS_PER_TRACE = 512


def span_to_dict(proto) -> dict:
    """Flatten an SSFSpan protobuf to the JSON shape the trace view
    serves (ints as strings: trace ids are 63-bit)."""
    return {
        "name": proto.name,
        "service": proto.service,
        "trace_id": str(proto.trace_id),
        "span_id": str(proto.id),
        "parent_id": str(proto.parent_id),
        "start_ns": proto.start_timestamp,
        "end_ns": proto.end_timestamp,
        "duration_ns": (proto.end_timestamp - proto.start_timestamp
                        if proto.end_timestamp else 0),
        "error": bool(proto.error),
        "tags": dict(proto.tags),
    }


class TraceIndex:
    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 max_spans: int = MAX_SPANS_PER_TRACE):
        self._lock = threading.Lock()
        self._capacity = capacity
        self._max_spans = max_spans
        self._traces: OrderedDict[int, list[dict]] = OrderedDict()

    def add(self, proto) -> None:
        """Index one finished span protobuf under its trace id."""
        tid = int(proto.trace_id)
        if not tid:
            return
        entry = span_to_dict(proto)
        with self._lock:
            spans = self._traces.get(tid)
            if spans is None:
                spans = []
                self._traces[tid] = spans
                while len(self._traces) > self._capacity:
                    self._traces.popitem(last=False)
            else:
                # keep recently-touched traces warm in the LRU order
                self._traces.move_to_end(tid)
            if len(spans) < self._max_spans:
                spans.append(entry)

    def get(self, trace_id: int) -> list[dict]:
        with self._lock:
            return list(self._traces.get(int(trace_id), ()))

    def trace_ids(self) -> list[int]:
        """Oldest -> newest."""
        with self._lock:
            return list(self._traces)

    def to_json(self, trace_id: int) -> bytes:
        spans = self.get(trace_id)
        return json.dumps({"trace_id": str(trace_id),
                           "spans": sorted(
                               spans, key=lambda s: s["start_ns"]),
                           "count": len(spans)},
                          indent=1).encode()
