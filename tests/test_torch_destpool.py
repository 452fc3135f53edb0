"""CPU parity of the port's circuit breaker and destination pool against
the JAX package.

``CircuitBreaker`` is driven by one injected clock and one script of
calls in both packages; ``DestinationPool`` by one failure script,
with its breakers' clocks injected and no backoff sleep, one batch at a
time.  After every step the states, stats and totals must be equal.

Tolerance: none — every compared value is a state, a count or a flag.
"""

from __future__ import annotations

import threading

import pytest

from veneur_tpu.forward import breaker as jbreaker
from veneur_tpu.forward import destpool as jdestpool
from veneur_tpu_torch.forward import breaker, destpool

_WAIT = 10.0  # seconds any one batch may take to resolve


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


# (op, argument): "allow", "peek", "ok", "fail", "tick" (advance clock)
BREAKER_SCRIPT = (
    ("allow", None), ("fail", None), ("peek", None), ("fail", None),
    ("allow", None), ("ok", None), ("fail", None), ("fail", None),
    ("fail", None), ("peek", None), ("allow", None), ("allow", None),
    ("tick", 4.0), ("peek", None), ("allow", None), ("tick", 2.0),
    ("peek", None), ("allow", None), ("allow", None), ("peek", None),
    ("fail", None), ("allow", None), ("tick", 5.0), ("allow", None),
    ("ok", None), ("allow", None), ("peek", None), ("fail", None),
)


def _run_breaker(mod, threshold):
    clock = _Clock()
    br = mod.CircuitBreaker(threshold=threshold, cooldown=5.0, clock=clock)
    trace = []
    for op, arg in BREAKER_SCRIPT:
        out = None
        if op == "allow":
            out = br.allow()
        elif op == "peek":
            out = br.would_allow()
        elif op == "ok":
            br.record_success()
        elif op == "fail":
            br.record_failure()
        else:
            clock.t += arg
        trace.append((op, out, br.state, br.state_code(), br.stats()))
    return trace


@pytest.mark.parametrize("threshold", [0, 1, 3])
def test_breaker_script_matches_jax(threshold):
    """The same script of allow / would_allow / success / failure /
    clock steps gives the same answers, states and stats; threshold 0
    disables the breaker in both."""
    assert _run_breaker(breaker, threshold) == \
        _run_breaker(jbreaker, threshold)


def test_full_jitter_bounds_match_jax():
    for attempt in range(8):
        for mod in (destpool, jdestpool):
            d = mod.full_jitter_delay(0.25, attempt)
            assert 0.0 <= d <= min(0.25 * 2 ** attempt,
                                   mod.MAX_RETRY_DELAY)
    assert destpool.MAX_RETRY_DELAY == jdestpool.MAX_RETRY_DELAY


def _strip(stats: dict) -> dict:
    """Per-destination stats without the wall-clock send duration."""
    return {d: {k: v for k, v in s.items() if k != "last_duration_s"}
            for d, s in stats.items()}


# per step: (destination, outcome of each attempt: "ok"/"fail", bypass)
POOL_SCRIPT = (
    ("a", ("ok",), False),
    ("b", ("fail", "ok"), False),          # one retry, then sent
    ("a", ("fail", "fail"), False),        # two failures: a opens
    ("a", (), False),                      # short-circuited, no attempt
    ("b", ("fail", "fail"), False),        # b opens too
    ("a", ("ok",), True),                  # a drain bypasses the breaker
    ("tick", 6.0, None),                   # cooldowns pass
    ("b", ("fail",), False),               # b's probe fails: open again
    ("a", ("ok",), False),                 # a's probe ok: closed
    ("b", (), False),                      # b short-circuits
    ("a", ("ok",), False),
)


def _run_pool(mod):
    clock = _Clock()
    results = []
    pool = mod.DestinationPool(queue_size=2, retries=1, backoff=0.0,
                               breaker_threshold=2, breaker_cooldown=5.0)
    trace = []
    workers = []
    try:
        for dest, outcomes, bypass in POOL_SCRIPT:
            if dest == "tick":
                clock.t += outcomes
                continue
            script = list(outcomes)
            done = threading.Event()

            def fn(script=script):
                if script.pop(0) == "fail":
                    raise OSError("refused")

            def on_result(d, n, err, tries, done=done):
                results.append((d, n, type(err).__name__ if err else None,
                                tries))
                done.set()

            assert pool.submit(dest, fn, n_items=3, on_result=on_result,
                               bypass_breaker=bypass)
            br = pool.breaker(dest)
            br._clock = clock  # the breakers tick on the script's clock
            assert done.wait(_WAIT)
            assert script == []  # every scripted attempt was made
            trace.append((dest, results[-1], pool.would_allow(dest),
                          _strip(pool.stats()), pool.breaker_states(),
                          pool.totals()))
        # busy-drop and retire: a worker held on one batch, one batch
        # queued behind it, one more refused; retiring the destination
        # credits the queued batch with RetiredDestination
        hold, started = threading.Event(), threading.Event()
        retired = []

        def held():
            started.set()
            hold.wait(_WAIT)

        pool.submit("c", held, n_items=1)
        assert started.wait(_WAIT)
        assert pool.submit("c", lambda: None, n_items=4,
                           on_result=lambda d, n, e, t: retired.append(
                               (d, n, type(e).__name__)))
        assert pool.submit("c", lambda: None, n_items=5)
        assert not pool.submit("c", lambda: None, n_items=6)
        busy = _strip(pool.stats())["c"]
        # retire drains the queue at once; the held batch ends after it
        threading.Timer(0.2, hold.set).start()
        workers = list(pool._workers.values())
        gone = pool.retire(["a", "b"])
        trace.append((busy, gone, pool.destinations(), pool.totals()))
    finally:
        pool.stop()
    assert not any(w._thread.is_alive() for w in workers)
    return trace, results, retired


def test_destination_pool_script_matches_jax():
    """One failure script through both pools: the same results handed
    to each callback (error type, retries), the same breaker peeks,
    per-destination stats, breaker states and totals after every step;
    then the same busy drop, and ``retire`` credits the same queued
    batches as retired-dropped.  Every worker thread stops."""
    got = _run_pool(destpool)
    want = _run_pool(jdestpool)
    assert got[1] == want[1]
    assert got[0] == want[0]
    assert got[2] == want[2] == [("c", 4, "RetiredDestination")]
