"""Per-destination forward workers: bounded fan-out with isolation.

Port of ``veneur_tpu/forward/destpool.py``.

The proxy used to hand every per-destination send to one shared
``ThreadPoolExecutor(16)``: a single stalled global destination (slow
network, wedged peer) soaks up pool slots until every destination's
forwards queue behind it.  Modeled on ``sinks/fanout.py``, each
destination here owns ONE worker thread and a bounded handoff queue:

- a stalled destination times out on its own worker without delaying
  the others; once its queue fills, new batches for it are counted
  ``busy_drops`` instead of piling onto shared state (the reference's
  drop-don't-buffer stance, flusher.go:536-549)
- transient send errors retry in-worker with FULL-JITTER exponential
  backoff (delay ~ U(0, min(base * 2^attempt, max_delay))), so a blip
  doesn't drop a batch, a dead peer can't block routing, and a
  flapping destination can't synchronize retry storms across workers;
  total in-worker retry time is capped at ``retry_budget`` (the
  interval budget) so retrying can never bleed into the next
  interval's sends
- each worker owns a :class:`~veneur_tpu_torch.forward.breaker.CircuitBreaker`:
  ``threshold`` consecutive failures trip it open and every queued
  batch short-circuits with :class:`BreakerOpen` — zero attempts,
  zero retry-budget burn — until the cooldown elapses and a single
  half-open probe rides through.  Drain handoffs set
  ``bypass_breaker`` so a shutting-down local still attempts its
  final send even to a flapping peer.
- per-destination sent/error/retry/busy-drop/short-circuit counters
  (in ITEMS as well as batches) feed ``/debug/vars`` and the proxy
  ledger

``retire`` drops workers for destinations a discovery refresh removed
from the ring, closing the leak the shared pool never had to think
about; batches still queued for a retired destination are credited
through ``on_result`` with :class:`RetiredDestination` (and counted
``retired_dropped_*``), never silently discarded.
"""

from __future__ import annotations

import logging
import queue
import random
import threading
import time

from .breaker import OPEN, BreakerOpen, CircuitBreaker

log = logging.getLogger("veneur_tpu_torch.destpool")

# upper bound on a single backoff sleep: past ~5 doublings the
# exponent outruns any sane retry budget, and an uncapped 2^attempt
# can compute absurd delays before the budget check rejects them
MAX_RETRY_DELAY = 10.0


def full_jitter_delay(base: float, attempt: int,
                      max_delay: float = MAX_RETRY_DELAY) -> float:
    """AWS-style full jitter: U(0, min(base * 2^attempt, max_delay)).
    Decorrelated enough that N workers retrying the same flapping peer
    spread out instead of stampeding in lockstep; capped so a long
    retry run can't compute unbounded sleeps."""
    return random.uniform(0.0, min(base * (2 ** attempt), max_delay))


class RetiredDestination(Exception):
    """A queued batch was dropped because its destination left the
    ring before the worker got to it — attributed, never silent."""


class _DestWorker:
    def __init__(self, dest: str, queue_size: int, retries: int,
                 backoff: float, on_result=None,
                 retry_budget: float | None = None,
                 breaker: CircuitBreaker | None = None,
                 on_sent=None):
        self.dest = dest
        self.retries = max(0, int(retries))
        self.backoff = backoff
        self.retry_budget = retry_budget
        self.on_result = on_result
        self.breaker = breaker
        self.on_sent = on_sent
        self.budget_exhausted = 0
        self.short_circuit_batches = 0
        self.short_circuit_items = 0
        self.queue: queue.Queue = queue.Queue(
            maxsize=max(1, int(queue_size)))
        self.sent_batches = 0
        self.sent_items = 0
        self.errors = 0
        self.error_items = 0
        self.retry_count = 0
        self.busy_drops = 0
        self.busy_dropped_items = 0
        self.last_duration = 0.0
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"proxy-dest-{dest}")
        self._thread.start()

    def _run(self) -> None:
        while True:
            task = self.queue.get()
            if task is None:
                return
            fn, n_items, on_result, bypass = task
            start = time.perf_counter()
            err = None
            tries = 0
            br = self.breaker
            if br is not None and not bypass and not br.allow():
                # open breaker: fail instantly, zero attempts, zero
                # retry budget consumed
                err = BreakerOpen(self.dest)
                self.short_circuit_batches += 1
                self.short_circuit_items += n_items
            else:
                for attempt in range(self.retries + 1):
                    try:
                        fn()
                        err = None
                        if br is not None:
                            br.record_success()
                        break
                    except Exception as e:
                        err = e
                        if br is not None:
                            br.record_failure()
                            if not bypass and br.state == OPEN:
                                # the breaker just tripped (or the
                                # half-open probe failed): stop
                                # burning retries on a dead peer
                                break
                        if attempt < self.retries and not self._stop:
                            delay = full_jitter_delay(self.backoff,
                                                      attempt)
                            if self.retry_budget is not None and (
                                    time.perf_counter() - start + delay
                                    > self.retry_budget):
                                # retrying would bleed past the interval
                                # budget: fail the batch now so the error
                                # is attributed THIS interval
                                self.budget_exhausted += 1
                                break
                            tries += 1
                            self.retry_count += 1
                            time.sleep(delay)
            self.last_duration = time.perf_counter() - start
            if err is None:
                self.sent_batches += 1
                self.sent_items += n_items
            else:
                self.errors += 1
                self.error_items += n_items
                if isinstance(err, BreakerOpen):
                    log.debug("proxy forward to %s short-circuited: "
                              "breaker open", self.dest)
                else:
                    log.warning("proxy forward to %s failed after %d "
                                "attempts: %s", self.dest,
                                tries + 1, err)
            cb = on_result or self.on_result
            if cb is not None:
                try:
                    cb(self.dest, n_items, err, tries)
                except Exception:
                    pass
            if err is None and self.on_sent is not None:
                # fires AFTER the result callback so ledger credits
                # land before any replay piggybacks on this success
                try:
                    self.on_sent(self.dest)
                except Exception:
                    pass

    def stats(self) -> dict:
        out = {
            "sent_batches": self.sent_batches,
            "sent_items": self.sent_items,
            "errors": self.errors,
            "error_items": self.error_items,
            "retries": self.retry_count,
            "retry_budget_exhausted": self.budget_exhausted,
            "short_circuit_batches": self.short_circuit_batches,
            "short_circuit_items": self.short_circuit_items,
            "busy_drops": self.busy_drops,
            "busy_dropped_items": self.busy_dropped_items,
            "queued": self.queue.qsize(),
            "last_duration_s": round(self.last_duration, 6),
        }
        if self.breaker is not None:
            out["breaker"] = self.breaker.stats()
        return out


class DestinationPool:
    """One worker per destination address; ``submit`` hands a send
    closure to the destination's worker, returning False (and counting
    a busy-drop) when its queue is full — routing never blocks on a
    slow peer."""

    def __init__(self, queue_size: int = 8, retries: int = 2,
                 backoff: float = 0.25, on_result=None,
                 retry_budget: float | None = None,
                 breaker_threshold: int = 5,
                 breaker_cooldown: float = 5.0,
                 on_sent=None):
        self._queue_size = queue_size
        self._retries = retries
        self._backoff = backoff
        self._on_result = on_result
        self._retry_budget = retry_budget
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_cooldown = float(breaker_cooldown)
        self._on_sent = on_sent
        self._workers: dict[str, _DestWorker] = {}
        self._lock = threading.Lock()
        self.retired_dropped_batches = 0
        self.retired_dropped_items = 0

    def submit(self, dest: str, fn, n_items: int = 1,
               on_result=None, bypass_breaker: bool = False) -> bool:
        """Hand a send closure to ``dest``'s worker.  ``on_result``
        (or the pool default) is called as ``(dest, n_items, err,
        retries)`` after the final attempt.  Returns False (counting
        a busy-drop) when the worker's queue is full.
        ``bypass_breaker`` sends even through an open breaker (drain
        handoff: the last word beats circuit hygiene)."""
        with self._lock:
            w = self._workers.get(dest)
            if w is None:
                w = _DestWorker(dest, self._queue_size, self._retries,
                                self._backoff, self._on_result,
                                retry_budget=self._retry_budget,
                                breaker=CircuitBreaker(
                                    self._breaker_threshold,
                                    self._breaker_cooldown),
                                on_sent=self._on_sent)
                self._workers[dest] = w
        try:
            w.queue.put_nowait((fn, n_items, on_result, bypass_breaker))
        except queue.Full:
            w.busy_drops += 1
            w.busy_dropped_items += n_items
            return False
        return True

    def breaker(self, dest: str) -> CircuitBreaker | None:
        """The destination's breaker, or None before its first send."""
        with self._lock:
            w = self._workers.get(dest)
        return w.breaker if w is not None else None

    def would_allow(self, dest: str) -> bool:
        """Route-time peek: False only when the destination's breaker
        is open with the cooldown still running (spool instead of
        enqueue); True otherwise — including the probe slot, so
        exactly one routed wire rides through on recovery."""
        br = self.breaker(dest)
        return True if br is None else br.would_allow()

    def breaker_states(self) -> dict:
        with self._lock:
            workers = dict(self._workers)
        return {d: w.breaker.stats() for d, w in workers.items()
                if w.breaker is not None}

    def _drain_queue(self, w: _DestWorker) -> list:
        tasks = []
        while True:
            try:
                t = w.queue.get_nowait()
            except queue.Empty:
                return tasks
            if t is not None:
                tasks.append(t)

    @staticmethod
    def _signal_stop(w: _DestWorker) -> None:
        w._stop = True
        for _ in range(w.queue.maxsize + 1):
            try:
                w.queue.put_nowait(None)
                return
            except queue.Full:
                try:  # discard a queued batch to make room
                    w.queue.get_nowait()
                except queue.Empty:
                    pass

    def retire(self, keep) -> list[str]:
        """Stop + drop workers whose destination left the ring;
        returns the retired addresses.  Batches still queued for a
        retired destination are NOT silently discarded: each one's
        ``on_result`` fires with :class:`RetiredDestination` so the
        caller (and the ledger) can attribute the drop, counted in
        ``retired_dropped_batches`` / ``retired_dropped_items``."""
        keep = set(keep)
        with self._lock:
            gone = [d for d in self._workers if d not in keep]
            retired = {d: self._workers.pop(d) for d in gone}
        for d, w in retired.items():
            w._stop = True
            orphans = self._drain_queue(w)
            self._signal_stop(w)
            for fn, n_items, on_result, _bypass in orphans:
                self.retired_dropped_batches += 1
                self.retired_dropped_items += n_items
                cb = on_result or self._on_result
                if cb is not None:
                    try:
                        cb(d, n_items, RetiredDestination(d), 0)
                    except Exception:
                        pass
        for w in retired.values():
            w._thread.join(timeout=5.0)
        return gone

    def destinations(self) -> list[str]:
        with self._lock:
            return list(self._workers)

    def stats(self) -> dict:
        with self._lock:
            return {d: w.stats() for d, w in self._workers.items()}

    def totals(self) -> dict:
        out = {"sent_batches": 0, "sent_items": 0, "errors": 0,
               "error_items": 0, "retries": 0,
               "retry_budget_exhausted": 0,
               "short_circuit_batches": 0, "short_circuit_items": 0,
               "busy_drops": 0, "busy_dropped_items": 0}
        breaker_opens = 0
        for s in self.stats().values():
            for k in out:
                out[k] += s[k]
            breaker_opens += s.get("breaker", {}).get("opens", 0)
        out["breaker_opens"] = breaker_opens
        out["retired_dropped_batches"] = self.retired_dropped_batches
        out["retired_dropped_items"] = self.retired_dropped_items
        return out

    def stop(self) -> None:
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            self._signal_stop(w)
        for w in workers:
            w._thread.join(timeout=5.0)
