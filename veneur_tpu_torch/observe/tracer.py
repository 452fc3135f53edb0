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

Host spans.  Besides the stage tree, the tracer keeps the open
interval's host span totals (``HostSpans``: span name -> ns), which any
thread adds to: the gRPC import's ``import.decode``, ``import.lock_wait``,
``import.apply`` and ``import.hll`` (summed over its wires, thread time)
and the collector's ``gc`` (every collection, ``start_gc_spans``), and
its counts: the import's ``import.hll_native`` and ``import.hll_codec``.
The flush takes the interval in its snapshot lock round
(``FlushCycle.take_interval``), the round the ledger closes it in, and
when the cycle ends writes it onto its ``FlushRecord`` as ``span_ns``
and ``counts``, with the cycle's own ``flush.materialize``
(``FlushCycle.host_span``) and ``counts["h2d.bytes"]``, the registry's
host-to-device bytes since the previous cycle.  ``/debug/flushes`` serves both.  While a
``torch.profiler`` runs, each stage and ``flush.materialize`` also open
a ``record_function`` named ``flush.<name>``, so the flush's stages name
its stretches of the device trace (whose clock is the wall clock).
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
import weakref

import torch

from veneur_tpu_torch.observe.devicecost import REGISTRY
from veneur_tpu_torch.observe.flushring import FlushRecord, FlushRing


def profiled(name: str):
    """``torch.profiler.record_function(name)`` while a profiler runs in
    this process, so the range lands in its trace; otherwise a no-op
    that costs one attribute read."""
    if getattr(torch.autograd.profiler, "_is_profiler_enabled", False):
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def _add(into: dict, items) -> None:
    for k, v in items:
        into[k] = into.get(k, 0) + v


class HostSpans:
    """One interval's host span totals (name -> ns) and counts (name ->
    n); any thread adds to them.  The flush that closes the interval
    closes it; an add after that lands in the tracer's interval then
    open (or is dropped without a tracer)."""

    def __init__(self, tracer: "FlushTracer | None" = None):
        self._tracer = tracer
        self._lock = threading.Lock()
        self._closed = False
        self.span_ns: dict[str, int] = {}
        self.counts: dict[str, int] = {}

    def add(self, span_ns: dict, counts: dict | None = None) -> None:
        with self._lock:
            if not self._closed:
                _add(self.span_ns, span_ns.items())
                if counts:
                    _add(self.counts, counts.items())
                return
        if self._tracer is not None:
            self._tracer.interval.add(span_ns, counts)

    def close(self) -> tuple[dict, dict]:
        """No more adds; returns the span totals and the counts."""
        with self._lock:
            self._closed = True
            return self.span_ns, self.counts


class _GcHook:
    """The ``gc.callbacks`` entry of one tracer, holding it weakly: a
    server never shut down leaves only this no-op behind."""

    def __init__(self, tracer: "FlushTracer"):
        self._ref = weakref.ref(tracer)

    def __call__(self, phase: str, info: dict) -> None:
        tr = self._ref()
        if tr is not None:
            tr._on_gc(phase)


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
                 index=None, tracer: "FlushTracer | None" = None):
        self.root = root
        self._client = client
        self.record = record
        self._registry = registry
        self._index = index
        self._lock = threading.Lock()
        self._tracer = tracer
        # the interval this cycle closes (``take_interval``)
        self.interval: HostSpans | None = None

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
            with profiled(f"flush.{name}"):
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

    @contextlib.contextmanager
    def host_span(self, name: str):
        """Time host work inside the cycle that is not a stage (no SSF
        span, no ``stages`` entry) into the record's
        ``span_ns["flush.<name>"]``."""
        t0 = time.monotonic_ns()
        try:
            with profiled(f"flush.{name}"):
                yield
        finally:
            dt = time.monotonic_ns() - t0
            with self._lock:
                _add(self.record.span_ns, ((f"flush.{name}", dt),))

    def take_interval(self) -> None:
        """Close the open interval's host spans onto this cycle's
        record; called in the lock round that closes the ledger's
        interval, so a wire's spans land with its ledger credit."""
        if self._tracer is not None:
            self.interval = self._tracer.swap_interval()

    def close(self) -> None:
        """Add the taken interval's span totals to the record."""
        if self.interval is not None:
            totals, counts = self.interval.close()
            with self._lock:
                _add(self.record.span_ns, totals.items())
                _add(self.record.counts, counts.items())

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
        self._interval_lock = threading.Lock()
        # the open interval's host spans (swapped out by each flush)
        self.interval = HostSpans(self)
        # the collector's ns in all and at the last swap: the gc
        # callback writes them and takes no lock (it may run on a
        # thread that holds one)
        self._gc_hook: _GcHook | None = None
        self._gc_t0 = 0
        self._gc_ns = 0
        self._gc_taken = 0
        # the registry's host-to-device bytes at the last cycle's end
        self._h2d_seen = self.registry.totals()["h2d_bytes_total"]

    def swap_interval(self) -> HostSpans:
        """Open a new interval; return the one it replaces, with the
        collector's ns since the last swap as its ``gc``."""
        with self._interval_lock:
            old, self.interval = self.interval, HostSpans(self)
            now = self._gc_ns
            ns, self._gc_taken = now - self._gc_taken, now
        if ns:
            old.add({"gc": ns})
        return old

    def start_gc_spans(self) -> None:
        """Time every cyclic collection of the interpreter into the
        interval's ``gc`` span."""
        if self._gc_hook is None:
            self._gc_hook = _GcHook(self)
            gc.callbacks.append(self._gc_hook)

    def stop_gc_spans(self) -> None:
        if self._gc_hook is not None:
            gc.callbacks.remove(self._gc_hook)
            self._gc_hook = None

    def _on_gc(self, phase: str) -> None:
        if phase == "start":
            self._gc_t0 = time.monotonic_ns()
        else:
            self._gc_ns += time.monotonic_ns() - self._gc_t0

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
                         index=self.index, tracer=self)
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
            totals = self.registry.totals()
            record.compiles = totals["compile_total"] - compiles0
            h2d = totals["h2d_bytes_total"]
            if h2d != self._h2d_seen:
                record.counts["h2d.bytes"] = h2d - self._h2d_seen
                self._h2d_seen = h2d
            cyc.close()
            root.add_tag("flush.seq", str(record.seq))
            root.finish(self.client)
            if self.index is not None:
                self.index.add(root.proto)
            self.ring.append(record)
