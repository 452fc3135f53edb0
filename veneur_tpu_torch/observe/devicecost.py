"""Device-cost accounting for the hot path's device steps: a launch
registry timed with CUDA events.

The port's counterpart of ``veneur_tpu/observe/devicecost.py``.  The
reference wraps each ``jax.jit`` step and counts compiles, dispatch
time and XLA's ``cost_analysis()`` estimates.  Here each step is a
plain callable of torch ops (and, for the digest merges, the
hand-written kernel), wrapped by ``instrument(name, fn)`` under the
reference's entry names (``table.counter_dense``, ``table.td_<name>``,
``flusher.histo_readout_rows``, ...).  Every call counts:

- ``calls`` and the host ``dispatch_duration_ns`` (launches are
  asynchronous on a card, so this is the host's time to enqueue);
- ``device_duration_ns``: a CUDA event pair recorded around the call on
  the current stream.  Recording never synchronizes: pairs wait in a
  bounded pending list (the oldest dropped and counted past
  ``MAX_PENDING``) and are resolved with ``elapsed_time`` only once the
  end event has completed (``query()``), at ``snapshot()``/``totals()``
  and after the flush's readback, which has synchronized anyway.  On
  CPU tensors there is no event and the entry's device time stays
  ``None`` — never a zero presented as a time;
- ``h2d_bytes``: host bytes copied for the call's operands (callers
  note each copy with ``note_h2d``; the next launch on the thread
  claims them);
- ``est_bytes_accessed_per_call``: the newest call's estimate.  A step
  that ran the cluster merge reports the bytes the merge moves (the
  kernel's bound formula: read both planes and the batch, write both
  planes; see ``ops/cluster_merge.py``), any other step the bytes of
  its tensor operands and results.

There is no JIT in the port.  ``compile_total`` /
``compile_duration_ns`` count builds of the port's native and CUDA
libraries at first use (g++ and nvcc), and ``compile_cache_hits`` /
``compile_cache_misses`` count loads of an already-built ``_build/``
library against builds.  The operator names stay
(``veneur.xla.compile_total``, ...) so dashboards keep working.

``add_readback`` counts the flusher's device-to-host bytes,
``add_reader_batch`` the per-reader ingest counters of the multi-reader
path, and ``note_launch`` the hand-written kernel's launches by route
(``cluster_merge``, ``cluster_merge.wide``), their only count.

``excluded()`` keeps one thread's launches out of the registry while
it runs and hands them to the block instead: the server's warm-up takes
its scratch steps under it, so the live table's counts start from its
own traffic.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

import torch

# event pairs waiting for their end event to complete
MAX_PENDING = 4096

# per-thread notes (host copies, kernel bytes) claimed by the next
# launch on the thread, whichever registry it reports to
_TLS = threading.local()


class _Entry:
    """Counters for one instrumented step (guarded by the registry
    lock)."""

    __slots__ = ("calls", "call_ns", "device_ns", "device_calls",
                 "bytes_accessed", "h2d_bytes")

    def __init__(self):
        self.calls = 0
        self.call_ns = 0
        # None until a CUDA event pair of this step has resolved
        self.device_ns: int | None = None
        self.device_calls = 0
        self.bytes_accessed = 0
        self.h2d_bytes = 0

    def snapshot(self) -> dict:
        return {"calls": self.calls,
                "dispatch_duration_ns": self.call_ns,
                "device_duration_ns": self.device_ns,
                "device_calls": self.device_calls,
                "est_bytes_accessed_per_call": self.bytes_accessed,
                "h2d_bytes": self.h2d_bytes}


class _ReaderEntry:
    """Per-reader-thread ingest counters (multi-reader fused path):
    how much each SO_REUSEPORT reader carried, and whether it ran the
    fused shard or the split path."""

    __slots__ = ("batches", "packets", "samples", "ingest_ns",
                 "fused_batches")

    def __init__(self):
        self.batches = 0
        self.packets = 0
        self.samples = 0
        self.ingest_ns = 0
        self.fused_batches = 0

    def snapshot(self) -> dict:
        return {"batches": self.batches, "packets": self.packets,
                "samples": self.samples,
                "ingest_duration_ns": self.ingest_ns,
                "fused_batches": self.fused_batches}


def _tensor_bytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(_tensor_bytes(o) for o in obj)
    return 0


def _launch_device(args) -> torch.device | None:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return None


class InstrumentedStep:
    """Callable wrapper around one device step."""

    def __init__(self, name: str, fn, registry: "DeviceCostRegistry"):
        self.name = name
        self.__wrapped__ = fn
        self._registry = registry

    def __call__(self, *args, **kwargs):
        reg = self._registry
        dev = _launch_device(args)
        events = None
        if dev is not None and dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record(stream)
        h2d = reg.take_h2d()
        merged0 = reg.kernel_bytes()
        t0 = time.monotonic_ns()
        out = self.__wrapped__(*args, **kwargs)
        dt = time.monotonic_ns() - t0
        if dev is not None and dev.type == "cuda":
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record(stream)
            events = (e0, e1)
        merged = reg.kernel_bytes() - merged0
        est = merged if merged else (_tensor_bytes(args)
                                     + _tensor_bytes(out))
        reg._record(self.name, dt, h2d, est, events)
        return out


class DeviceCostRegistry:
    def __init__(self, max_pending: int = MAX_PENDING):
        self._lock = threading.Lock()
        self._entries: dict[str, _Entry] = {}
        self._readers: dict[str, _ReaderEntry] = {}
        self._pending: deque = deque()
        self._max_pending = max_pending
        self.events_dropped = 0
        self._readback_bytes = 0
        self._compiles = 0
        self._compile_ns = 0
        self._cache_hits = 0
        self._cache_misses = 0
        self._launches: dict[str, int] = {}

    def instrument(self, name: str, fn) -> InstrumentedStep:
        with self._lock:
            self._entries.setdefault(name, _Entry())
        return InstrumentedStep(name, fn, self)

    # -- per-thread notes claimed by the next launch -------------------

    def note_h2d(self, nbytes: int) -> None:
        """A host operand of the next launch on this thread was copied
        to the device."""
        _TLS.h2d = getattr(_TLS, "h2d", 0) + int(nbytes)

    def take_h2d(self) -> int:
        n = getattr(_TLS, "h2d", 0)
        _TLS.h2d = 0
        return n

    def note_kernel_bytes(self, nbytes: int) -> None:
        """A kernel inside the current launch moved ``nbytes`` (its
        bound formula)."""
        _TLS.kbytes = getattr(_TLS, "kbytes", 0) + int(nbytes)

    def kernel_bytes(self) -> int:
        return getattr(_TLS, "kbytes", 0)

    @contextlib.contextmanager
    def excluded(self):
        """Leave this thread's launches, copies and readbacks out of the
        registry while the block runs (library builds still count); the
        block's kernel launches go to the dict it yields instead."""
        prev = getattr(_TLS, "excluded", None)
        tally: dict[str, int] = {}
        _TLS.excluded = tally
        try:
            yield tally
        finally:
            _TLS.excluded = prev
            _TLS.h2d = 0
            _TLS.kbytes = 0

    # -- recording -----------------------------------------------------

    def note_launch(self, name: str) -> None:
        """One launch of a hand-written kernel, by route: the only
        count of it."""
        tally = getattr(_TLS, "excluded", None)
        if tally is not None:
            tally[name] = tally.get(name, 0) + 1
            return
        with self._lock:
            self._launches[name] = self._launches.get(name, 0) + 1

    def launches(self) -> dict:
        with self._lock:
            return dict(self._launches)

    def reset_launches(self) -> None:
        with self._lock:
            self._launches.clear()

    def _record(self, name: str, dt_ns: int, h2d_bytes: int,
                bytes_accessed: int, events) -> None:
        if getattr(_TLS, "excluded", None) is not None:
            return
        with self._lock:
            e = self._entries.setdefault(name, _Entry())
            e.calls += 1
            e.call_ns += dt_ns
            e.h2d_bytes += int(h2d_bytes)
            e.bytes_accessed = int(bytes_accessed)
            if events is not None:
                if len(self._pending) >= self._max_pending:
                    self._pending.popleft()
                    self.events_dropped += 1
                self._pending.append((e, events[0], events[1]))

    def _resolve_locked(self) -> None:
        keep = deque()
        for e, e0, e1 in self._pending:
            if e1.query():
                ns = int(e0.elapsed_time(e1) * 1e6)
                e.device_ns = (e.device_ns or 0) + ns
                e.device_calls += 1
            else:
                keep.append((e, e0, e1))
        self._pending = keep

    def resolve(self) -> None:
        """Fold every completed event pair into its entry's device
        time; pairs still running stay pending (never waits)."""
        with self._lock:
            self._resolve_locked()

    def add_readback(self, nbytes: int) -> None:
        """The flusher's readback bytes; the readback synchronized, so
        the interval's event pairs resolve here."""
        if getattr(_TLS, "excluded", None) is not None:
            return
        with self._lock:
            self._readback_bytes += int(nbytes)
            self._resolve_locked()

    def add_compile(self, duration_ns: int) -> None:
        """A native or CUDA library was built (a cache miss)."""
        with self._lock:
            self._compiles += 1
            self._compile_ns += int(duration_ns)
            self._cache_misses += 1

    def add_cache_hit(self) -> None:
        """An already-built library was loaded."""
        with self._lock:
            self._cache_hits += 1

    def add_reader_batch(self, reader: str, packets: int,
                         samples: int, dt_ns: int,
                         fused: bool = False) -> None:
        """One ingested packet batch attributed to a reader thread
        (keyed by thread name, e.g. ``udp-reader-2``)."""
        with self._lock:
            r = self._readers.setdefault(reader, _ReaderEntry())
            r.batches += 1
            r.packets += int(packets)
            r.samples += int(samples)
            r.ingest_ns += int(dt_ns)
            if fused:
                r.fused_batches += 1

    # ------------------------------------------------------------------

    def _device_total_locked(self) -> int | None:
        times = [e.device_ns for e in self._entries.values()
                 if e.device_ns is not None]
        return sum(times) if times else None

    def totals(self) -> dict:
        """Cross-step totals — what Telemetry deltas per interval."""
        with self._lock:
            self._resolve_locked()
            ents = self._entries.values()
            return {
                "compile_total": self._compiles,
                "compile_duration_ns": self._compile_ns,
                "dispatch_total": sum(e.calls for e in ents),
                "dispatch_duration_ns": sum(e.call_ns for e in ents),
                "device_duration_ns": self._device_total_locked(),
                "h2d_bytes_total": sum(e.h2d_bytes for e in ents),
                "readback_bytes_total": self._readback_bytes,
                "compile_cache_hits": self._cache_hits,
                "compile_cache_misses": self._cache_misses,
            }

    def snapshot(self) -> dict:
        """Full per-step dump for /debug/vars."""
        with self._lock:
            self._resolve_locked()
            ents = self._entries
            return {
                "kernels": {name: e.snapshot()
                            for name, e in ents.items()},
                "launches": dict(self._launches),
                "readers": {name: r.snapshot()
                            for name, r in self._readers.items()},
                "dispatch_total": sum(e.calls for e in ents.values()),
                "device_duration_ns": self._device_total_locked(),
                "h2d_bytes_total": sum(e.h2d_bytes
                                       for e in ents.values()),
                "readback_bytes_total": self._readback_bytes,
                "compile_total": self._compiles,
                "compile_duration_ns": self._compile_ns,
                "compile_cache_hits": self._cache_hits,
                "compile_cache_misses": self._cache_misses,
                "events_pending": len(self._pending),
                "events_dropped": self.events_dropped,
            }


# One process-global registry: the instrumented steps are module-level
# objects (flusher/table steps), so their counters are too.
REGISTRY = DeviceCostRegistry()


def instrument(name: str, fn,
               registry: DeviceCostRegistry | None = None):
    return (registry or REGISTRY).instrument(name, fn)


__all__ = ["DeviceCostRegistry", "REGISTRY", "instrument",
           "InstrumentedStep"]
