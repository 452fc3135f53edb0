"""Flush self-tracing: one nested SSF span tree per flush cycle.

The port's copy of ``veneur_tpu/observe/tracer.py``.

The reference wraps its flush in ``trace.StartSpanFromContext``
(flusher.go:29) and child spans per phase; here ``FlushTracer.cycle``
opens the root ``flush`` span and ``FlushCycle.stage`` hangs one
child per pipeline stage off it:

    flush
      +- flush.snapshot     staging detach + metadata capture under the
      |                     ingest lock (pipelined: O(µs) begin_swap)
      +- flush.swap_apply   final staged apply after the lock drops
      |                     (pipelined mode only)
      +- flush.dispatch     combine/readout launches (async on a card)
      +- flush.device_wait  the readback copies — the d2h sync point
      +- flush.host_emit    InterMetric assembly from row metadata
      +- flush.sink_flush   per-sink fan-out + interval-budget wait
      +- flush.forward      upstream ship (local tier only)

``dispatch`` / ``device_wait`` replaced the old ``device_dispatch`` /
``readback_sync`` names when dispatch and readback stopped running
back-to-back; stage timings are recorded under BOTH the new and old
names (``stage(..., alias=...)``) so dashboards keyed on the old
``veneur.flush.stage_duration_ns`` series keep working.

Spans go through the server's own loopback trace client, so they flow
to span sinks like any user trace (the port has none yet).  Each
cycle also fills a ``FlushRecord`` for the ``/debug/flushes`` ring.

``NULL_CYCLE`` is the no-tracer stand-in for direct ``Flusher.flush``
callers (tests, benches): stages are free, but readback accounting
still reaches the device-cost registry.
"""

from __future__ import annotations

import contextlib
import threading
import time

from veneur_tpu_torch.observe.devicecost import REGISTRY
from veneur_tpu_torch.observe.flushring import FlushRecord, FlushRing


class _NullSpan:
    trace_id = 0
    span_id = 0

    def add_tag(self, key, value):
        pass

    def set_error(self, err=True):
        pass

    def finish(self, client=None):
        return None


class NullCycle:
    """Stage spans are no-ops; readback bytes still count."""

    record = None

    @contextlib.contextmanager
    def stage(self, name: str, alias: str | None = None):
        yield _NullSpan()

    def child(self, parent, name: str, tags=None):
        return _NullSpan()

    def finish(self, span) -> None:
        pass

    def add_readback(self, nbytes: int) -> None:
        REGISTRY.add_readback(nbytes)

    def wire_context(self, span=None) -> tuple[int, int]:
        return 0, 0


NULL_CYCLE = NullCycle()


class FlushCycle:
    def __init__(self, root, client, record: FlushRecord, registry,
                 index=None):
        self.root = root
        self._client = client
        self.record = record
        self._registry = registry
        self._index = index
        self._lock = threading.Lock()

    def wire_context(self, span=None) -> tuple[int, int]:
        """(trace_id, span_id) to stamp onto a forward wire so the
        receiving tier can parent its import span under ours.  Pass
        the stage span actually doing the shipping (e.g. the
        ``forward`` child) to parent under it instead of the root."""
        sp = span if span is not None else self.root
        return sp.trace_id, sp.span_id

    @contextlib.contextmanager
    def stage(self, name: str, alias: str | None = None):
        """Time one pipeline stage as a child span of the flush root.
        Safe to enter from pool threads (the forward stage runs on
        one); re-entering a stage name accumulates its ns.  ``alias``
        records the same ns under a legacy stage name too, so renamed
        stages don't break dashboards keyed on the old series."""
        sp = self.root.child(f"flush.{name}")
        sp.add_tag("stage", name)
        sp.add_tag("veneur.internal", "true")
        t0 = time.monotonic_ns()
        try:
            yield sp
        except BaseException as e:
            sp.set_error(e)
            raise
        finally:
            dt = time.monotonic_ns() - t0
            with self._lock:
                self.record.stages[name] = (
                    self.record.stages.get(name, 0) + dt)
                if alias is not None:
                    self.record.stages[alias] = (
                        self.record.stages.get(alias, 0) + dt)
            sp.finish(self._client)
            if self._index is not None:
                self._index.add(sp.proto)

    def child(self, parent, name: str, tags=None):
        """A live child span under ``parent`` (a stage span), for
        sub-stage work that outlives the stage block — e.g. one span
        per sharded-forward destination, so ``/debug/trace/<id>``
        renders M forward branches instead of M wires sharing the one
        ``flush.forward`` span id.  Callers finish it with
        :meth:`finish` (safe from destination-worker threads)."""
        sp = parent.child(f"flush.{name}")
        sp.add_tag("veneur.internal", "true")
        for k, v in (tags or {}).items():
            sp.add_tag(k, v)
        return sp

    def finish(self, span) -> None:
        """Record a :meth:`child` span to the trace client + debug
        index (mirrors the tail of :meth:`stage`)."""
        span.finish(self._client)
        if self._index is not None:
            self._index.add(span.proto)

    def add_readback(self, nbytes: int) -> None:
        self._registry.add_readback(nbytes)
        with self._lock:
            self.record.readback_bytes += int(nbytes)


class FlushTracer:
    def __init__(self, client, ring: FlushRing, registry=None,
                 service: str = "veneur", index=None):
        self.client = client
        self.ring = ring
        self.registry = registry or REGISTRY
        self.service = service
        self.index = index

    @contextlib.contextmanager
    def cycle(self):
        from veneur_tpu_torch.trace.spans import Span
        record = FlushRecord(seq=self.ring.next_seq(),
                             start_unix=time.time())
        # the internal marker exempts these spans from the user-span
        # throughput counter and the uniqueness sketch (core/spans.py,
        # sinks/ssfmetrics.py) — they still reach every span sink
        root = Span("flush", service=self.service,
                    tags={"veneur.internal": "true"})
        record.trace_id = root.trace_id
        cyc = FlushCycle(root, self.client, record, self.registry,
                         index=self.index)
        compiles0 = self.registry.totals()["compile_total"]
        t0 = time.monotonic_ns()
        try:
            yield cyc
        except BaseException as e:
            root.set_error(e)
            record.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            record.duration_ns = time.monotonic_ns() - t0
            record.compiles = (self.registry.totals()["compile_total"]
                               - compiles0)
            root.add_tag("flush.seq", str(record.seq))
            root.finish(self.client)
            if self.index is not None:
                self.index.add(root.proto)
            self.ring.append(record)
