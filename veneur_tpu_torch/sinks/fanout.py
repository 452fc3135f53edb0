"""Per-sink flush workers: parallel fan-out with isolation.

The shared-pool flush (server._flush_stages) already runs sinks
concurrently, but a sink that stalls past the interval budget still
holds its pool slot and its future is merely abandoned — repeated
stalls pile abandoned flushes onto the shared executor that ingest
telemetry also rides on.  Here every sink owns ONE worker thread and a
bounded handoff queue:

- a stalled sink times out (counted) without delaying the others —
  its worker is still busy next interval, so the new flush is a
  counted ``busy_drop`` instead of a queue pile-up (mirroring the
  reference's drop-don't-buffer flush stance, flusher.go:536-549)
- transient sink errors retry in-worker with FULL-JITTER exponential
  backoff (destpool.full_jitter_delay — delay ~ U(0, min(base *
  2^attempt, max_delay))), so a flapping backend can't synchronize
  retry storms across sink workers; total in-worker retry time is
  capped at ``retry_budget`` (the interval budget) so retrying can't
  bleed past the next interval
- each sink worker owns a circuit breaker (same machine as the
  forward path's — forward/breaker.py): a backend that fails
  ``threshold`` consecutive flushes stops consuming retries entirely;
  one probe flush per cooldown tests recovery
- per-sink duration/error/timeout/drop/short-circuit counters feed
  ``/debug/vars`` and the flush-cycle trace

Port of ``veneur_tpu/sinks/fanout.py``.  The clock (durations, the
retry budget, the breakers' cooldowns, ``wait``'s deadline) and the
backoff's sleep are injectable, so a caller can drive the retry ladder
and the breaker on a hand-advanced clock.
"""

from __future__ import annotations

import logging
import queue
import threading
import time

from veneur_tpu_torch.forward.breaker import OPEN, BreakerOpen, CircuitBreaker
from veneur_tpu_torch.forward.destpool import full_jitter_delay

log = logging.getLogger("veneur_tpu_torch.sinks.fanout")


class FlushTask:
    __slots__ = ("fn", "done", "error", "duration", "name")

    def __init__(self, name: str, fn):
        self.name = name
        self.fn = fn
        self.done = threading.Event()
        self.error: BaseException | None = None
        self.duration = 0.0


class _SinkWorker:
    def __init__(self, name: str, retries: int, backoff: float,
                 on_error=None, retry_budget: float | None = None,
                 breaker: CircuitBreaker | None = None,
                 clock=time.monotonic, sleep=time.sleep):
        self.name = name
        self._clock = clock
        self._sleep = sleep
        self.retries = max(0, int(retries))
        self.backoff = backoff
        self.retry_budget = retry_budget
        self.budget_exhausted = 0
        self.on_error = on_error
        self.breaker = breaker
        self.short_circuits = 0
        self._stop = False
        # one slot: at most one flush queued behind the running one
        self.queue: queue.Queue = queue.Queue(maxsize=1)
        self.flushes = 0
        self.errors = 0
        self.retry_count = 0
        self.timeouts = 0
        self.busy_drops = 0
        self.last_duration = 0.0
        self.total_duration = 0.0
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"sink-flush-{name}")
        self._thread.start()

    def _fail(self, task: FlushTask, e: BaseException,
              attempts: int) -> None:
        self.errors += 1
        task.error = e
        if isinstance(e, BreakerOpen):
            log.debug("sink %s flush short-circuited: breaker open",
                      self.name)
        else:
            log.warning("sink %s flush failed after %d attempts: %s",
                        self.name, attempts, e)
        if self.on_error is not None:
            try:
                self.on_error(self.name, e)
            except Exception:
                pass

    def _run(self) -> None:
        while True:
            task = self.queue.get()
            if task is None:
                return
            start = self._clock()
            br = self.breaker
            try:
                if br is not None and not br.allow():
                    # dead backend: fail the flush instantly instead
                    # of burning the whole retry ladder against it
                    self.short_circuits += 1
                    self._fail(task, BreakerOpen(self.name), 0)
                    continue
                for attempt in range(self.retries + 1):
                    try:
                        task.fn()
                        if br is not None:
                            br.record_success()
                        break
                    except Exception as e:
                        retry = (attempt < self.retries
                                 and not self._stop)
                        if br is not None:
                            br.record_failure()
                            if br.state == OPEN:
                                # breaker tripped (or the probe
                                # failed): stop retrying now
                                retry = False
                        delay = 0.0
                        if retry:
                            delay = full_jitter_delay(self.backoff,
                                                      attempt)
                            if self.retry_budget is not None and (
                                    self._clock() - start + delay
                                    > self.retry_budget):
                                # retrying would bleed past the
                                # interval budget: fail now so the
                                # error lands THIS interval
                                self.budget_exhausted += 1
                                retry = False
                        if not retry:
                            self._fail(task, e, attempt + 1)
                            break
                        self.retry_count += 1
                        self._sleep(delay)
            finally:
                task.duration = self._clock() - start
                self.flushes += 1
                self.last_duration = task.duration
                self.total_duration += task.duration
                task.done.set()

    def stats(self) -> dict:
        out = {
            "flushes": self.flushes,
            "errors": self.errors,
            "retries": self.retry_count,
            "retry_budget_exhausted": self.budget_exhausted,
            "short_circuits": self.short_circuits,
            "timeouts": self.timeouts,
            "busy_drops": self.busy_drops,
            "last_duration_s": round(self.last_duration, 6),
            "total_duration_s": round(self.total_duration, 6),
        }
        if self.breaker is not None:
            out["breaker"] = self.breaker.stats()
        return out


class SinkFanout:
    """One worker per sink name; ``dispatch`` hands a flush closure to
    the sink's worker, ``wait`` blocks until all handed-off flushes
    finish or the interval budget runs out (timed-out flushes keep
    running on their own worker — isolation, not cancellation)."""

    def __init__(self, names, retries: int = 2, backoff: float = 0.25,
                 on_error=None, retry_budget: float | None = None,
                 breaker_threshold: int = 5,
                 breaker_cooldown: float = 5.0,
                 clock=time.monotonic, sleep=time.sleep):
        self._retries = retries
        self._clock = clock
        self._sleep = sleep
        self._backoff = backoff
        self._on_error = on_error
        self._retry_budget = retry_budget
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_cooldown = float(breaker_cooldown)
        self._lock = threading.Lock()
        self._workers = {}
        for n in names:
            self.ensure(n)

    def _new_worker(self, name: str) -> _SinkWorker:
        return _SinkWorker(
            name, self._retries, self._backoff, self._on_error,
            retry_budget=self._retry_budget,
            breaker=CircuitBreaker(self._breaker_threshold,
                                   self._breaker_cooldown,
                                   clock=self._clock),
            clock=self._clock, sleep=self._sleep)

    def ensure(self, name: str) -> None:
        with self._lock:
            if name not in self._workers:
                self._workers[name] = self._new_worker(name)

    def dispatch(self, name: str, fn) -> FlushTask | None:
        """Queue a flush on the sink's worker; returns None (and
        counts a busy_drop) when the worker is still saturated by the
        previous interval."""
        self.ensure(name)
        w = self._workers[name]
        task = FlushTask(name, fn)
        try:
            w.queue.put_nowait(task)
        except queue.Full:
            w.busy_drops += 1
            log.warning("sink %s still flushing previous interval; "
                        "dropping this flush", name)
            return None
        return task

    def wait(self, tasks, deadline: float) -> list[str]:
        """Wait until every task completes or ``deadline`` (absolute
        time on the fan-out's clock) passes; returns names of sinks
        that timed out."""
        late: list[str] = []
        for task in tasks:
            remaining = deadline - self._clock()
            if not task.done.wait(max(0.0, remaining)):
                self._workers[task.name].timeouts += 1
                late.append(task.name)
        return late

    def stats(self) -> dict:
        with self._lock:
            return {n: w.stats() for n, w in self._workers.items()}

    def breaker_states(self) -> dict:
        with self._lock:
            workers = dict(self._workers)
        return {n: w.breaker.stats() for n, w in workers.items()
                if w.breaker is not None}

    def stop(self) -> None:
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            w._stop = True
            for _ in range(2):
                try:
                    w.queue.put_nowait(None)
                    break
                except queue.Full:
                    try:  # discard the queued flush to make room
                        dropped = w.queue.get_nowait()
                        if dropped is not None:
                            dropped.done.set()
                    except queue.Empty:
                        pass
        for w in workers:
            w._thread.join(timeout=5.0)
