"""Span worker: fan SSF spans out to every span sink.

The port's copy of ``veneur_tpu/core/spans.py``.

The reference's SpanWorker (worker.go:575-719): a buffered channel
feeding one goroutine that stamps common tags, validates, then gives
every span sink a bounded chance to ingest (9s timeout each,
worker.go:611); sinks that error or time out are counted, never fatal.
Here: a bounded queue drained by a worker thread, with per-sink ingest
dispatched through a small pool so one wedged sink cannot stall the
others past the timeout.
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor, TimeoutError as FTimeout

log = logging.getLogger("veneur_tpu_torch.spans")

SINK_TIMEOUT = 9.0  # reference worker.go:611 const Timeout


class SpanWorker:
    def __init__(self, sinks: list, common_tags: dict[str, str],
                 capacity: int = 1024, stats_cb=None,
                 workers: int = 1):
        self.sinks = list(sinks)
        self.common_tags = dict(common_tags)
        self.queue: queue.Queue = queue.Queue(maxsize=capacity)
        self._stats_cb = stats_cb or (lambda name, n=1: None)
        # one single-thread executor PER SINK: a wedged sink can only
        # wedge itself — its spans are dropped-and-counted while its
        # ingest hangs, and every other sink keeps flowing (the
        # reference gets the same isolation from per-sink goroutines,
        # worker.go:648).  In-flight work per sink is BOUNDED: with
        # several dispatch threads feeding one serialized sink, a
        # small queue absorbs bursts while a truly wedged sink still
        # sheds load instead of accumulating the interval behind it.
        self._pools = [ThreadPoolExecutor(max_workers=1)
                       for _ in self.sinks]
        self._inflight = [0] * len(self.sinks)
        self._inflight_cap = 128
        # a sink whose ingest TIMED OUT is wedged: later spans skip it
        # instantly (no 9s wait each) until its hung call returns —
        # the reference's skip-busy-sink behavior, kept compatible
        # with multiple dispatch threads
        self._timed_out = [False] * len(self.sinks)
        # RLock: a future that completes before add_done_callback runs
        # executes the callback INLINE in the submitting thread, which
        # already holds this lock
        self._pending_lock = threading.RLock()
        self._shutdown = threading.Event()
        # num_span_workers dispatch threads drain the one queue
        # (reference worker.go:575 SpanWorker set, server.go:892-910)
        self._threads = [
            threading.Thread(target=self._work, daemon=True,
                             name=f"span-worker-{i}")
            for i in range(max(1, workers))]

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def submit(self, span) -> bool:
        """Enqueue; drop-and-count when the buffer is full (the
        reference counts near-capacity, worker.go:614)."""
        try:
            self.queue.put_nowait(span)
            return True
        except queue.Full:
            self._stats_cb("spans_dropped")
            return False

    def _work(self) -> None:
        from veneur_tpu_torch.protocol.wire import valid_trace
        while not self._shutdown.is_set():
            try:
                span = self.queue.get(timeout=0.1)
            except queue.Empty:
                continue
            # common tags fill only missing keys (worker.go:622-628)
            for k, v in self.common_tags.items():
                if k not in span.tags:
                    span.tags[k] = v
            # neither a valid span nor metrics: client error, drop
            # (worker.go:636-646)
            if not valid_trace(span) and len(span.metrics) == 0:
                self._stats_cb("empty_ssf")
                continue
            futs = []
            with self._pending_lock:
                for i, s in enumerate(self.sinks):
                    if ((self._timed_out[i] and self._inflight[i]) or
                            self._inflight[i] >= self._inflight_cap):
                        # the sink is wedged (a timed-out ingest still
                        # hasn't returned) or far behind: shed load
                        # instead of queueing an interval behind it
                        self._stats_cb("span_sink_dropped")
                        continue
                    fut = self._pools[i].submit(s.ingest, span)
                    self._inflight[i] += 1
                    fut.add_done_callback(
                        lambda _f, i=i: self._task_done(i))
                    futs.append((i, s, fut))
            for i, sink, fut in futs:
                try:
                    fut.result(timeout=SINK_TIMEOUT)
                except FTimeout:
                    # the task keeps running on the sink's pool; the
                    # wedged flag sheds later spans instantly while
                    # it's stuck
                    with self._pending_lock:
                        self._timed_out[i] = True
                    self._stats_cb("span_sink_timeouts")
                    log.warning("span sink %s timed out", sink.name)
                except Exception:
                    self._stats_cb("span_sink_errors")
                    log.exception("span sink %s ingest failed",
                                  sink.name)
            # the server's own flush-trace spans ride the same worker
            # (observe/tracer.py) but must not inflate the USER span
            # throughput counter operators alert on
            if span.tags.get("veneur.internal") == "true":
                self._stats_cb("self_spans_processed")
            else:
                self._stats_cb("spans_processed")

    def _task_done(self, i: int) -> None:
        with self._pending_lock:
            self._inflight[i] -= 1
            if self._inflight[i] == 0:
                self._timed_out[i] = False

    def flush(self) -> None:
        """Per-interval sink flush (reference SpanWorker.Flush,
        worker.go:698)."""
        for s in self.sinks:
            try:
                s.flush()
            except Exception:
                log.exception("span sink %s flush failed", s.name)

    def stop(self) -> None:
        self._shutdown.set()
        for t in self._threads:
            if t.is_alive():
                t.join(timeout=1.0)
        for p in self._pools:
            p.shutdown(wait=False)
