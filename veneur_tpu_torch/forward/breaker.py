"""Per-destination circuit breaker: closed -> open -> half-open.

Port of ``veneur_tpu/forward/breaker.py``.

The bounded-worker send paths (forward/destpool.py, sinks/fanout.py)
retry transient errors with jittered backoff, but against a DEAD peer
every batch still burns its full retry ladder before failing — the
worker spends the whole interval budget sleeping at a corpse while
its bounded queue backs up and busy-drops the batches behind it.  The
breaker is the standard fix (PAPERS.md's fault-tolerant aggregation
framing; the hinted-handoff stores it cites gate their handoff the
same way):

- ``closed``    — normal sends; ``threshold`` CONSECUTIVE failures
  (any success resets the streak) trip it open
- ``open``      — sends fail immediately (:class:`BreakerOpen`),
  consuming no retry budget and no queue time, until ``cooldown``
  seconds pass
- ``half_open`` — exactly ONE probe send is allowed through
  (single-probe exclusivity holds under concurrent ``allow`` calls);
  success closes the breaker, failure re-opens it for another
  cooldown

``would_allow`` is the non-consuming peek the forward path uses to
decide spool-vs-probe at route time: when it returns False the wire
goes straight to the spool without ever occupying a queue slot, and
when the cooldown has elapsed exactly one routed wire rides through
as the probe.

The clock is injectable so the state machine is property-testable
without real sleeps.
"""

from __future__ import annotations

import threading
import time

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# numeric codes for the veneur.forward.breaker.state gauge (and any
# dashboard that wants to max() over destinations): higher == sicker
STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class BreakerOpen(Exception):
    """A send was short-circuited because the destination's breaker is
    open — no attempt was made, no retry budget consumed."""


class CircuitBreaker:
    """Consecutive-failure breaker with a single half-open probe.

    Thread-safe; all transitions happen under one lock.  ``threshold
    <= 0`` disables the breaker entirely (``allow`` always True) so
    one code path serves both gated and ungated pools.
    """

    def __init__(self, threshold: int = 5, cooldown: float = 5.0,
                 clock=time.monotonic):
        self.threshold = int(threshold)
        self.cooldown = float(cooldown)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0          # consecutive, reset by success
        self._opened_at = 0.0
        self._probe_inflight = False
        self.opens = 0              # times the breaker tripped open
        self.short_circuits = 0     # sends rejected while open

    # -- queries -------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def state_code(self) -> int:
        return STATE_CODES[self.state]

    def would_allow(self) -> bool:
        """Non-consuming peek: True when a send issued now would be
        attempted (closed, or open with the cooldown elapsed so a
        probe slot is available).  Does NOT claim the probe."""
        if self.threshold <= 0:
            return True
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                return (self._clock() - self._opened_at
                        >= self.cooldown)
            # half-open: the single probe is already in flight
            return False

    # -- transitions ---------------------------------------------------

    def allow(self) -> bool:
        """Claim permission for one send attempt.  In ``open`` state
        past the cooldown this transitions to ``half_open`` and grants
        the ONE probe; concurrent callers lose the race and are
        rejected (counted as short-circuits)."""
        if self.threshold <= 0:
            return True
        with self._lock:
            if self._state == CLOSED:
                return True
            if (self._state == OPEN
                    and self._clock() - self._opened_at
                    >= self.cooldown):
                self._state = HALF_OPEN
                self._probe_inflight = True
                return True
            self.short_circuits += 1
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state in (HALF_OPEN, OPEN):
                self._state = CLOSED
            self._probe_inflight = False

    def record_failure(self) -> None:
        with self._lock:
            if self.threshold <= 0:
                return
            if self._state == HALF_OPEN:
                # the probe failed: straight back to open, fresh
                # cooldown
                self._state = OPEN
                self._opened_at = self._clock()
                self._probe_inflight = False
                self.opens += 1
                return
            self._failures += 1
            if self._state == CLOSED \
                    and self._failures >= self.threshold:
                self._state = OPEN
                self._opened_at = self._clock()
                self.opens += 1

    # -- introspection -------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "state_code": STATE_CODES[self._state],
                "consecutive_failures": self._failures,
                "opens": self.opens,
                "short_circuits": self.short_circuits,
            }
