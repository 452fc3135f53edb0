"""Per-flush-cycle records in a bounded ring.

The port's copy of ``veneur_tpu/observe/flushring.py``.

Every flush cycle leaves one ``FlushRecord`` behind: per-stage wall
times, readback bytes, emit/forward counts, the interval's tally, and
the compile delta.  The last 128 live in a ``FlushRing`` served as
JSON at ``/debug/flushes`` — the evidence an operator (or a perf PR)
reads to attribute a slow interval to a STAGE instead of a total.

The port's records also carry the closed interval's host spans
(``observe/tracer.py``): ``span_ns`` (span name -> total ns:
``import.decode``, ``import.lock_wait``, ``import.apply``,
``import.hll``, ``gc``, ``flush.materialize``) and ``counts``
(``h2d.bytes``; ``import.hll_native`` and ``import.hll_codec``, the
interval's sketches folded natively and handed to the codec).  Each
appears in the JSON only when set, so a record without them reads as
the reference's.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from dataclasses import dataclass, field

DEFAULT_CAPACITY = 128


@dataclass
class FlushRecord:
    seq: int = 0
    start_unix: float = 0.0
    duration_ns: int = 0
    # stage name -> cumulative ns (a stage entered twice accumulates)
    stages: dict[str, int] = field(default_factory=dict)
    readback_bytes: int = 0
    metrics_emitted: int = 0
    forward_rows: int = 0
    tally: dict[str, int] = field(default_factory=dict)
    compiles: int = 0  # compile events observed during this cycle
    error: str = ""
    # trace id of the cycle's span tree — the /debug/flushes ->
    # /debug/trace/<id> link (string in JSON: ids are 63-bit)
    trace_id: int = 0
    # the closed interval's host spans (name -> total ns) and counts
    span_ns: dict[str, int] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {"seq": self.seq, "start_unix": self.start_unix,
             "duration_ns": self.duration_ns,
             "stages_ns": dict(self.stages),
             "readback_bytes": self.readback_bytes,
             "metrics_emitted": self.metrics_emitted,
             "forward_rows": self.forward_rows,
             "tally": dict(self.tally),
             "compiles": self.compiles,
             "error": self.error,
             "trace_id": str(self.trace_id)}
        if self.span_ns:
            d["span_ns"] = dict(self.span_ns)
        if self.counts:
            d["counts"] = dict(self.counts)
        return d


class FlushRing:
    """Thread-safe bounded ring of the most recent flush records."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._ring: deque[FlushRecord] = deque(maxlen=capacity)
        self._seq = 0

    def next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def append(self, record: FlushRecord) -> None:
        with self._lock:
            self._ring.append(record)

    def records(self) -> list[FlushRecord]:
        """Oldest -> newest."""
        with self._lock:
            return list(self._ring)

    def to_json(self, limit: int | None = None) -> bytes:
        """``limit`` bounds the dump to the newest N records (the
        ``?n=`` query param on /debug/flushes)."""
        recs = self.records()
        if limit and limit > 0:
            recs = recs[-limit:]
        return json.dumps([r.to_dict() for r in recs],
                          indent=1).encode()
