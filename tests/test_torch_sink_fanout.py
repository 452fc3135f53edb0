"""The port's per-sink flush fan-out (``sinks/fanout.py`` and the
server's wiring) against ``tests/test_sink_fanout.py``.

Each of the reference file's eight cases has its twin here.  The
fan-out runs on a hand-advanced clock, and its backoff sleeps advance
that clock instead of the wall's, so the retry ladder, the retry budget
and the breaker's cooldown are driven step by step: no case paces on
the wall clock (the reference's ``test_retry_with_backoff_then_success``
measures its gaps on it).  The only real waits are bounded ones on a
stalled worker, released at the end of each case.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

import pytest

from veneur_tpu.sinks.fanout import SinkFanout as JSinkFanout
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.sinks import fanout as fanout_mod
from veneur_tpu_torch.sinks.fanout import SinkFanout
from veneur_tpu_torch.sinks.simple import CaptureSink

_ROWS = {"tpu_counter_rows": 32, "tpu_gauge_rows": 32,
         "tpu_histo_rows": 32, "tpu_set_rows": 8}


class HandClock:
    """A clock that moves only when told; ``sleep`` records the delay
    and moves it."""

    def __init__(self):
        self.now = 1000.0
        self.sleeps: list[float] = []
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            return self.now

    def advance(self, dt: float) -> None:
        with self._lock:
            self.now += dt

    def sleep(self, dt: float) -> None:
        self.sleeps.append(dt)
        self.advance(dt)


def _fanout(names, clock, **kw):
    return SinkFanout(names, clock=clock, sleep=clock.sleep, **kw)


def test_stats_keys_match_jax():
    clock = HandClock()
    fo, jfo = _fanout(["s"], clock, retries=0), JSinkFanout(["s"], retries=0)
    try:
        assert fo.stats().keys() == jfo.stats().keys()
        assert fo.stats()["s"].keys() == jfo.stats()["s"].keys()
        assert fo.breaker_states() == jfo.breaker_states()
    finally:
        fo.stop()
        jfo.stop()


def test_stalled_sink_does_not_delay_or_drop_others():
    clock = HandClock()
    release = threading.Event()
    done = []
    fo = _fanout(["stalled", "fast1", "fast2"], clock, retries=0)
    try:
        tasks = [
            fo.dispatch("stalled", lambda: release.wait(timeout=30)),
            fo.dispatch("fast1", lambda: done.append("fast1")),
            fo.dispatch("fast2", lambda: done.append("fast2")),
        ]
        # the stalled task eats the deadline's 0.2 s; the fast ones
        # are already done
        late = fo.wait(tasks, deadline=clock() + 0.2)
        assert late == ["stalled"]
        assert sorted(done) == ["fast1", "fast2"]
        assert fo.stats()["stalled"]["timeouts"] == 1
        assert fo.stats()["fast1"]["flushes"] == 1
    finally:
        release.set()
        fo.stop()


def test_busy_worker_drops_not_queues():
    clock = HandClock()
    started = threading.Event()
    release = threading.Event()

    def stall():
        started.set()
        release.wait(timeout=30)

    fo = _fanout(["s"], clock, retries=0)
    try:
        t1 = fo.dispatch("s", stall)
        assert started.wait(timeout=10)  # the worker took t1
        t2 = fo.dispatch("s", lambda: None)  # queued behind the stall
        t3 = fo.dispatch("s", lambda: None)  # slot full: dropped
        assert t1 is not None and t2 is not None and t3 is None
        assert fo.stats()["s"]["busy_drops"] == 1
        release.set()
        for t in (t1, t2):
            assert t.done.wait(timeout=10)
    finally:
        release.set()
        fo.stop()


def test_retry_with_backoff_then_success(monkeypatch):
    # the full-jitter draw at its ceiling, so the ladder is exact
    monkeypatch.setattr(fanout_mod, "full_jitter_delay",
                        lambda base, attempt: base * 2 ** attempt)
    clock = HandClock()
    calls = []

    def flaky():
        calls.append(clock())
        if len(calls) < 3:
            raise RuntimeError("transient")

    fo = _fanout(["s"], clock, retries=3, backoff=0.02)
    try:
        task = fo.dispatch("s", flaky)
        assert task.done.wait(timeout=10)
        assert len(calls) == 3 and task.error is None
        st = fo.stats()["s"]
        assert st["retries"] == 2 and st["errors"] == 0
        # exponential backoff on the hand clock: 0.02 then 0.04
        assert clock.sleeps == [0.02, 0.04]
        assert calls[2] - calls[1] == pytest.approx(
            2 * (calls[1] - calls[0]))
        assert task.duration == pytest.approx(0.06)
    finally:
        fo.stop()


def test_retry_budget_fails_within_the_interval(monkeypatch):
    """A retry whose sleep would pass the retry budget fails the flush
    now, counted as budget exhausted."""
    monkeypatch.setattr(fanout_mod, "full_jitter_delay",
                        lambda base, attempt: base * 2 ** attempt)
    clock = HandClock()
    fo = _fanout(["s"], clock, retries=5, backoff=1.0, retry_budget=2.5)
    try:
        def boom():
            raise RuntimeError("down")
        task = fo.dispatch("s", boom)
        assert task.done.wait(timeout=10)
        st = fo.stats()["s"]
        # sleeps 1 and 2 would end at 3 > 2.5: only the first is taken
        assert clock.sleeps == [1.0]
        assert st["retry_budget_exhausted"] == 1 and st["errors"] == 1
    finally:
        fo.stop()


def test_breaker_opens_then_probes_after_cooldown():
    clock = HandClock()
    fo = _fanout(["s"], clock, retries=0, breaker_threshold=2,
                 breaker_cooldown=5.0)
    ok = [False]

    def flush():
        if not ok[0]:
            raise RuntimeError("down")

    try:
        for _ in range(2):
            assert fo.dispatch("s", flush).done.wait(timeout=10)
        assert fo.breaker_states()["s"]["state"] == "open"
        t = fo.dispatch("s", flush)
        assert t.done.wait(timeout=10)
        assert fo.stats()["s"]["short_circuits"] == 1
        ok[0] = True
        clock.advance(5.0)  # the cooldown passes: one probe goes
        t = fo.dispatch("s", flush)
        assert t.done.wait(timeout=10) and t.error is None
        assert fo.breaker_states()["s"]["state"] == "closed"
    finally:
        fo.stop()


def test_final_failure_counts_error_and_calls_on_error():
    clock = HandClock()
    seen = []
    fo = _fanout(["s"], clock, retries=1, backoff=0.01,
                 on_error=lambda name, exc: seen.append(name))
    try:
        task = fo.dispatch("s", lambda: (_ for _ in ()).throw(
            RuntimeError("boom")))
        assert task.done.wait(timeout=10)
        assert isinstance(task.error, RuntimeError)
        assert fo.stats()["s"]["errors"] == 1
        assert seen == ["s"]
        assert len(clock.sleeps) == 1 and 0.0 <= clock.sleeps[0] <= 0.01
    finally:
        fo.stop()


def test_ensure_adds_worker_for_late_sink():
    clock = HandClock()
    fo = _fanout([], clock, retries=0)
    try:
        task = fo.dispatch("late", lambda: None)
        assert not fo.wait([task], deadline=clock() + 10.0)
        assert fo.stats()["late"]["flushes"] == 1
    finally:
        fo.stop()


# ---------------------------------------------------------------------
# the server's wiring


@pytest.fixture
def fanout_server():
    servers = []

    def _make(**overrides):
        cap = CaptureSink()
        s = Server(read_config(data={
            "statsd_listen_addresses": [], "interval": "500ms",
            "hostname": "fanout-host", **_ROWS, **overrides}),
            device="cpu", extra_sinks=[cap])
        servers.append(s)
        return s, cap

    yield _make
    for s in servers:
        s.shutdown()


class _Stall:
    name = "stall"

    def __init__(self):
        self.release = threading.Event()

    def start(self):
        pass

    def flush(self, metrics):
        self.release.wait(timeout=30)

    def flush_other_samples(self, samples):
        pass


def _names(cap):
    return {m.name for m in cap.metrics}


def _wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def test_server_stalled_sink_isolated_from_capture(fanout_server):
    server, cap = fanout_server(tpu_sink_workers=1, interval="1s")
    assert server._fanout is not None
    stall = _Stall()
    server.metric_sinks.append(stall)
    try:
        server.handle_packet(b"iso.hits:1|c")
        t0 = time.monotonic()
        server.flush_once()
        # bounded by the budget (max(0.9 interval, 1 s)), not the stall
        assert time.monotonic() - t0 < 15.0
        assert _wait_for(lambda: "iso.hits" in _names(cap))
        assert server._fanout.stats()["stall"]["timeouts"] == 1
        assert server.stats["flush_slow_tasks"] >= 1
        # interval 2 queues behind the wedged worker, interval 3's is
        # a counted busy drop; the capture sink flows throughout
        server.handle_packet(b"iso.hits2:1|c")
        server.flush_once()
        assert _wait_for(lambda: "iso.hits2" in _names(cap))
        server.handle_packet(b"iso.hits3:1|c")
        server.flush_once()
        assert _wait_for(lambda: "iso.hits3" in _names(cap))
        st = server._fanout.stats()
        assert st["stall"]["busy_drops"] == 1
        assert st["capture"]["busy_drops"] == 0
        assert _wait_for(
            lambda: server._fanout.stats()["capture"]["flushes"] == 3)
        assert server.stats["flush_skipped_busy"] >= 1
        # the ledger names each interval's fan-out deltas
        assert server.ledger.last().fanout_busy_drops == 1
        row = server.signals.latest()
        assert row["sink.busy_drops"] == 1 and row["sink.timeouts"] >= 1
    finally:
        stall.release.set()


def test_server_shared_pool_mode_still_flushes(fanout_server):
    server, cap = fanout_server(tpu_sink_workers=0)
    assert server._fanout is None
    server.handle_packet(b"pool.hits:2|c")
    server.flush_once()
    assert any(m.name == "pool.hits" and m.value == 2.0
               for m in cap.metrics)


def test_debug_vars_surfaces_per_sink_counters():
    server = Server(read_config(data={
        "statsd_listen_addresses": [], **_ROWS,
        "http_address": "127.0.0.1:0", "interval": "10s",
        "tpu_sink_workers": 1}), device="cpu",
        extra_sinks=[CaptureSink()])
    server.start()
    try:
        server.flush_once()
        doc = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{server.http_port}/debug/vars",
            timeout=5).read())
        cap = doc["sinks"]["capture"]
        for key in ("flushes", "errors", "retries", "timeouts",
                    "busy_drops", "last_duration_s",
                    "total_duration_s"):
            assert key in cap
        assert cap["flushes"] >= 1 and cap["errors"] == 0
    finally:
        server.shutdown()
