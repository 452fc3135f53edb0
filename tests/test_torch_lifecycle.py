"""The server's lifecycle keys against the JAX server.

- the flush watchdog exits 2 once ``flush_watchdog_missed_flushes``
  intervals pass without a flush, in both packages (``os._exit``
  patched; the thread disarmed and joined before the patch is undone,
  as ``tests/test_failure.py`` does);
- ``synchronize_with_interval`` puts the first flush on a multiple of
  the interval;
- ``/quitquitquit`` answers only with ``http_quit`` and stops the
  server; ``/version`` and ``/builddate`` answer;
- ``tpu_warmup`` flushes one sample of each kind from a scratch table
  (the tally of a JAX table on the same samples), before ``start``,
  and leaves the live table and the launch registry as they were;
- ``compile_cache_dir`` moves the native build output;
- ``blackhole_sink`` and ``debug_flushed_metrics`` add the reference's
  sinks, in its order;
- ``count_unique_timeseries`` reports the unique timeseries as the JAX
  telemetry does;
- ``http_address: einhorn@0`` adopts einhorn's inherited listening
  socket (``EINHORN_FD_0``) and acks the master over
  ``EINHORN_SOCK_PATH``, as the JAX server does.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from veneur_tpu.core.config import read_config as jread_config
from veneur_tpu.core.flusher import Flusher as JFlusher
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.core.table import MetricTable as JTable
from veneur_tpu.core.table import TableConfig as JConfig
from veneur_tpu_torch import __version__, native, observe
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.ops import cluster_merge
from veneur_tpu_torch.protocol import dogstatsd as dsd

_ROWS = {"tpu_counter_rows": 32, "tpu_gauge_rows": 32,
         "tpu_histo_rows": 32, "tpu_set_rows": 8}


def _pair(**kw):
    data = {"interval": "10s", "hostname": "h", **_ROWS, **kw}
    return (Server(read_config(data=data), device="cpu"),
            JServer(jread_config(data=data)))


def _join_watchdog(server, timeout=15.0):
    """Disarm the watchdog and join its thread before the real
    ``os._exit`` comes back."""
    server._shutdown.set()
    server.last_flush = time.monotonic()
    for t in server._threads:
        if t.name == "watchdog":
            t.join(timeout)
            assert not t.is_alive(), "watchdog thread failed to stop"


def test_watchdog_exits_after_missed_flushes(monkeypatch):
    """A stale ``last_flush`` past the allowance makes each server's
    watchdog thread call ``os._exit(2)``."""
    exits = []

    def fake_exit(code):
        caller = sys._getframe(1).f_code.co_filename
        exits.append(("port" if "veneur_tpu_torch" in caller else "jax",
                      threading.current_thread().name, code))
    monkeypatch.setattr("os._exit", fake_exit)
    servers = _pair(interval="50ms", flush_watchdog_missed_flushes=2)
    try:
        for srv in servers:
            srv.start()
        deadline = time.monotonic() + 10.0
        while ({who for who, _, _ in exits} != {"port", "jax"}
               and time.monotonic() < deadline):
            # hold the flushes back: the loop's own flushes would
            # refresh the clock the watchdog reads
            for srv in servers:
                srv.last_flush = time.monotonic() - 10 * srv.interval
            time.sleep(0.02)
    finally:
        for srv in servers:
            _join_watchdog(srv)
            srv.shutdown()
    assert {who for who, _, _ in exits} == {"port", "jax"}
    assert {(name, code) for _, name, code in exits} == {("watchdog", 2)}


def test_watchdog_off_by_default():
    srv = Server(read_config(data={"interval": "10s", **_ROWS}),
                 device="cpu")
    srv.start()
    try:
        assert "watchdog" not in {t.name for t in srv._threads}
    finally:
        srv.shutdown()


@pytest.mark.parametrize("sync", [False, True])
def test_synchronize_with_interval_first_tick(sync):
    srv = Server(read_config(data={"interval": "10s", **_ROWS,
                                   "synchronize_with_interval": sync}),
                 device="cpu")
    # the reference's _flush_loop: one interval out, or the time to the
    # next multiple of the interval on the wall clock
    for wall, mono in ((1_700_000_003.25, 50.0), (1_700_000_010.0, 7.5),
                       (1_699_999_999.999, 0.0)):
        want = mono + (10.0 - wall % 10.0 if sync else 10.0)
        assert srv._first_tick(wall, mono) == pytest.approx(want)


def test_synchronized_first_flush_lands_on_the_interval():
    ticks = []
    srv = Server(read_config(data={"interval": "1s", **_ROWS,
                                   "synchronize_with_interval": True}),
                 device="cpu")
    orig = srv.flush_once

    def flush_once():
        ticks.append(time.time())
        return orig()
    srv.flush_once = flush_once
    srv.start()
    try:
        deadline = time.monotonic() + 10.0
        while not ticks and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        srv.shutdown()
    assert ticks, "no flush"
    # the tick is the start of a wall-clock second, give or take the
    # thread's wake-up
    assert ticks[0] % 1.0 < 0.45


def _get(port: int, path: str) -> tuple[int, bytes]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, b""


@pytest.mark.parametrize("http_quit", [False, True])
def test_http_lifecycle_endpoints(http_quit):
    got = []
    for srv in _pair(http_address="127.0.0.1:0", http_quit=http_quit):
        srv.start()
        try:
            port = srv.http_port
            ver, build = _get(port, "/version"), _get(port, "/builddate")
            quit_status = _get(port, "/quitquitquit")[0]
            if http_quit:
                deadline = time.monotonic() + 10.0
                while (not srv._shutdown.is_set()
                       and time.monotonic() < deadline):
                    time.sleep(0.01)
                assert srv._shutdown.is_set(), "quit did not stop it"
            got.append((ver[0], build, quit_status))
            if isinstance(srv, Server):
                assert ver[1] == __version__.encode()
                if http_quit:
                    assert srv.stopped.wait(10)
        finally:
            srv.shutdown()
    assert got[0] == got[1]
    assert got[0][0] == 200 and got[0][1] == (200, b"dev")
    assert got[0][2] == (200 if http_quit else 404)


def test_einhorn_socket_adoption(monkeypatch, tmp_path):
    """The port of ``tests/test_server.py::test_einhorn_socket_adoption``,
    for each package in turn: the server serves ``/healthcheck`` and
    ``/version`` on the socket the master bound, and its ack names its
    process."""
    import json
    import socket

    got = []
    for i, make in enumerate((
            lambda d: Server(read_config(data=d), device="cpu"),
            lambda d: JServer(jread_config(data=d)))):
        lsock = socket.socket()
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(8)
        port = lsock.getsockname()[1]
        ctrl = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        ctrl_path = str(tmp_path / f"einhorn{i}.sock")
        ctrl.bind(ctrl_path)
        ctrl.listen(1)
        ctrl.settimeout(10)  # a missing ack fails, never hangs
        monkeypatch.setenv("EINHORN_FD_0", str(lsock.fileno()))
        monkeypatch.setenv("EINHORN_SOCK_PATH", ctrl_path)
        srv = make({"interval": "10s", **_ROWS,
                    "http_address": "einhorn@0"})
        srv.start()
        try:
            conn, _ = ctrl.accept()
            with conn:
                ack = json.loads(conn.recv(4096).decode())
            assert srv.http_port == port
            got.append((ack, _get(port, "/healthcheck"),
                        _get(port, "/version")[0]))
        finally:
            srv.shutdown()
            ctrl.close()
            lsock.close()
    assert got[0] == got[1]
    assert got[0] == ({"command": "worker:ack", "pid": os.getpid()},
                      (200, b"ok"), 200)


_WARM = (dsd.Sample("veneur.warmup", dsd.COUNTER, 1.0),
         dsd.Sample("veneur.warmup", dsd.GAUGE, 1.0),
         dsd.Sample("veneur.warmup", dsd.HISTOGRAM, 1.0),
         dsd.Sample("veneur.warmup", dsd.TIMER, 1.0),
         dsd.Sample("veneur.warmup", dsd.SET, "w"))


def test_warmup_scratch_step_leaves_live_table_and_registry():
    before = observe.REGISTRY.snapshot()
    launches = cluster_merge.launch_count()
    srv = Server(read_config(data={"interval": "10s", **_ROWS,
                                   "tpu_warmup": True}), device="cpu")
    try:
        after = observe.REGISTRY.snapshot()
        w = srv.warmup
        jt = JTable(JConfig(counter_rows=32, gauge_rows=32, histo_rows=32,
                            set_rows=8))
        for s in _WARM:
            jt.ingest(s)
        want = JFlusher(is_local=False).flush(jt.swap())
        assert w["tally"] == want.tally
        assert w["metrics"] == len(want.metrics)
        assert w["seconds"] > 0 and w["merge_launches"] == 0
        assert cluster_merge.launch_count() == launches
        # nothing of the scratch steps in the live table or the registry
        assert srv.table.staged() == 0
        for idx in (srv.table.counter_idx, srv.table.gauge_idx,
                    srv.table.histo_idx, srv.table.set_idx):
            assert idx.occupancy() == 0
        calls = {k: v["calls"] for k, v in before["kernels"].items()}
        assert {k: v["calls"] for k, v in after["kernels"].items()
                if k in calls} == calls
        assert after["readback_bytes_total"] == \
            before["readback_bytes_total"]
        assert after["launches"] == before["launches"]
        assert srv.debug_vars()["warmup"] == w
        srv.handle_packet(b"live:1|c")
        vals = {m.name: m.value for m in srv.flush_once().metrics}
        assert vals["live"] == 1.0 and "veneur.warmup" not in vals
    finally:
        srv.shutdown()
    off = Server(read_config(data={"interval": "10s", **_ROWS}),
                 device="cpu")
    assert off.warmup is None
    off.shutdown()


def test_compile_cache_dir_moves_the_build_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    monkeypatch.setattr(cluster_merge, "BUILD_DIR", cluster_merge.BUILD_DIR)
    d = tmp_path / "build"
    srv = Server(read_config(data={"interval": "10s", **_ROWS,
                                   "compile_cache_dir": str(d)}),
                 device="cpu")
    srv.shutdown()
    assert native.BUILD_DIR == d.resolve()
    assert cluster_merge.BUILD_DIR == d.resolve()
    out = native.build()
    assert out.parent == d.resolve() and out.exists()
    assert os.listdir(d) == [out.name]


def test_blackhole_and_debug_sinks(caplog):
    t, j = _pair(blackhole_sink=True, debug_flushed_metrics=True,
                 tpu_overload=False)
    try:
        assert [s.name for s in t.metric_sinks] == \
            [s.name for s in j.metric_sinks] == ["blackhole", "debug"]
        with caplog.at_level(logging.INFO,
                             logger="veneur_tpu_torch.sinks"):
            t.handle_packet(b"dbg.hits:4|c\ndbg.lat:3|ms")
            t.flush_once()
        logged = [r.getMessage() for r in caplog.records
                  if r.name == "veneur_tpu_torch.sinks"]
        assert any(m.startswith("flushed metric dbg.hits=4.0 type=counter")
                   for m in logged), logged
        rec = t.ledger.records()[-1]
        assert rec.balanced
    finally:
        t.shutdown()
        j.shutdown()


def test_count_unique_timeseries_matches_jax_telemetry():
    t, j = _pair(count_unique_timeseries=True, tpu_overload=False)
    try:
        rows = []
        for srv in (t, j):
            srv.handle_packet(b"a:1|c\nb:2|c|#x:y\ng:3|g\nh:4|ms\ns:m|s")
            srv.flush_once()
            second = srv.flush_once()
            rows.append(sorted(
                (m.tags, m.value) for m in second.metrics
                if m.name == "veneur.flush.unique_timeseries_total"))
        assert rows[0] == rows[1] == [(("global_veneur:true",), 5.0)]
    finally:
        t.shutdown()
        j.shutdown()


def test_accelerator_probe_timeout_is_read_not_acted_on():
    """The reference probes its accelerator and falls back to the CPU;
    the port runs where it was asked: the key parses, a bad duration
    fails the server as the reference's does, and nothing falls back."""
    srv = Server(read_config(data={"interval": "10s", **_ROWS,
                                   "accelerator_probe_timeout": "1s"}),
                 device="cpu")
    assert srv.device.type == "cpu"
    srv.shutdown()
    cfg = read_config(data={"interval": "10s", **_ROWS})
    cfg.accelerator_probe_timeout = "soon"
    with pytest.raises(ValueError, match="bad duration"):
        Server(cfg, device="cpu")
