"""The port server's /debug/* surface and its cross-tier flush trace.

Ports ``tests/test_debughttp.py`` (pprof threads / heap / profile with
the concurrent-503 guard / the device capture, ``/debug/vars``, 404s),
the server halves of ``tests/test_signals.py`` and
``tests/test_flight.py`` (``/debug/signals``, ``/debug/cluster``,
``/debug/flight``), ``/debug/flushes``, ``/debug/ledger`` and
``tests/test_trace_propagation.py``: a local -> global chain over HTTP
and over gRPC stitches one trace, the global's ``import`` span parented
under the local's ``flush.forward`` span, and the port's chain renders
the same tree as a JAX chain on the same traffic; the wire context
also crosses between the packages.  ``/debug/vars`` asserts the port's
own launch names (the reference's ``test_debug_vars`` asserts a JAX
name).  On the CPU the device capture records CPU activity; the card
case lives in ``tests/test_torch_observe.py``.
"""

from __future__ import annotations

import json
import re
import socket
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from veneur_tpu.core.config import read_config as jread_config
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.observe import recorder as jrecorder
from veneur_tpu.sinks.simple import CaptureSink as JCaptureSink
from veneur_tpu_torch.core import debughttp
from veneur_tpu_torch.core import server as server_mod
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.observe import recorder
from veneur_tpu_torch.sinks.simple import CaptureSink
from tests.torch_fixtures import unsampled_span_uniqueness  # noqa: F401


_ROWS = {"tpu_counter_rows": 64, "tpu_gauge_rows": 64,
         "tpu_histo_rows": 64, "tpu_set_rows": 8}


@pytest.fixture
def make_server():
    servers = []

    def _make(**overrides):
        # an interval no test reaches: only the tests' own flushes swap
        data = {"statsd_listen_addresses": [], "interval": "300s",
                "hostname": "dbg", "http_address": "127.0.0.1:0",
                **_ROWS, **overrides}
        srv = Server(read_config(data=data), device="cpu",
                     extra_sinks=[CaptureSink()])
        srv.start()
        servers.append(srv)
        return srv

    yield _make
    for s in servers:
        s.shutdown()


@pytest.fixture
def server(make_server):
    return make_server()


def _get(server, path):
    return urllib.request.urlopen(
        f"http://127.0.0.1:{server.http_port}{path}", timeout=10)


def _json(server, path):
    return json.loads(_get(server, path).read())


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


# ---- pprof ------------------------------------------------------------------

def test_thread_dump(server):
    for path in ("/debug/pprof", "/debug/pprof/goroutine",
                 "/debug/pprof/threads"):
        body = _get(server, path).read().decode()
        assert "Thread" in body
    assert "flush-loop" in body


def test_heap_start_snapshot_stop(server):
    assert b"not tracing" in _get(server, "/debug/pprof/heap").read()
    assert _get(server, "/debug/pprof/heap?start=1").read() == \
        b"tracing started"
    try:
        assert ".py" in _get(server, "/debug/pprof/heap").read().decode()
    finally:
        assert _get(server, "/debug/pprof/heap?stop=1").read() == \
            b"tracing stopped"


def test_profile_seconds(server):
    body = _get(server, "/debug/pprof/profile?seconds=0.1").read()
    assert b"cumulative" in body


@pytest.mark.parametrize("part", ["profile", "device"])
def test_profilers_concurrent_503(server, part):
    """One profiler per process: while one capture holds the lock, a
    second request is refused, not queued."""
    assert server._pprof_lock.acquire(blocking=False)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(server, f"/debug/pprof/{part}?seconds=0.1")
        assert ei.value.code == 503
    finally:
        server._pprof_lock.release()


def test_device_profile_capture(server):
    """/debug/pprof/device runs torch.profiler in the live process and
    lists the Chrome trace it wrote."""
    out = _json(server, "/debug/pprof/device?seconds=0.1")
    assert out["dir"].startswith("/")
    assert [f["name"] for f in out["files"]] == ["trace.json"]
    assert json.loads((Path(out["dir"]) / "trace.json").read_text())


def test_unknown_debug_path_404(server):
    for path in ("/debug/nope", "/debug/pprof/nope", "/nope"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(server, path)
        assert ei.value.code == 404


def test_endpoint_inventory_matches_routing():
    """``SERVER_DEBUG_ENDPOINTS`` lists exactly the /debug/* paths the
    server's do_GET routes."""
    src = Path(server_mod.__file__).read_text()
    routed = set(re.findall(r'path\.startswith\("(/debug/[a-z]+)"\)', src))
    assert routed == set(debughttp.SERVER_DEBUG_ENDPOINTS)


# ---- /debug/vars, /debug/flushes, /debug/ledger ----------------------------

def test_debug_vars_port_launch_names(server):
    """The device-cost registry under the port's own step names, the
    readback bytes, the ledger summary and the plane accounting."""
    server.handle_packet(b"dv.c:1|c\ndv.t:2|ms\ndv.t:3|ms\ndv.s:x|s")
    server.flush_once()
    v = _json(server, "/debug/vars")
    dc = v["devicecost"]
    for name in ("table.superbatch_apply", "table.counter_dense",
                 "table.td_ingest_ranked_unit", "flusher.gather_rows",
                 "flusher.histo_readout_rows"):
        assert name in dc["kernels"], sorted(dc["kernels"])
    assert dc["kernels"]["table.superbatch_apply"]["calls"] >= 1
    # CPU tensors: no CUDA event pair, the device time stays null
    assert dc["kernels"]["table.superbatch_apply"][
        "device_duration_ns"] is None
    assert dc["readback_bytes_total"] > 0
    assert v["stats"]["metrics_processed"] == 4
    assert v["ledger"]["balanced"] == 1
    assert v["planes"]["total"] > 0
    assert v["trace_client"]["dropped"] == 0
    assert v["signals"]["rows"] == 1 and v["flight"]["retained"] == 0


def test_debug_flushes_and_ledger(server):
    server.handle_packet(b"fl.a:1|c\n_sc|fl.chk|1\ngarbage")
    server.flush_once()
    server.flush_once()
    flushes = _json(server, "/debug/flushes")
    assert [r["seq"] for r in flushes] == [1, 2]
    assert {"snapshot", "swap_apply", "dispatch", "device_wait",
            "host_emit", "sink_flush", "sink.capture"} <= \
        set(flushes[0]["stages_ns"])
    assert len(_json(server, "/debug/flushes?n=1")) == 1
    led = _json(server, "/debug/ledger")
    assert led["intervals"] == 2 and led["imbalanced"] == []
    rec = led["records"][0]
    assert rec["received"] == {"dogstatsd": 2}
    assert rec["status"] == 1 and rec["parse_errors"] == 1
    assert rec["balanced"] and rec["trace_id"] == flushes[0]["trace_id"]
    assert led["records"][1]["received"]["self-telemetry"] > 0
    assert _json(server, "/debug/ledger?n=1")["returned"] == 1


def test_flush_trace_tree(server):
    """The last flush's trace: a ``flush`` root with one child per
    stage, served at /debug/trace/<id> and listed at /debug/trace."""
    server.handle_packet(b"tr.a:1|c")
    server.flush_once()
    tid = server.flush_ring.records()[-1].trace_id
    assert str(tid) in _json(server, "/debug/trace")["trace_ids"]
    spans = _json(server, f"/debug/trace/{tid}")["spans"]
    root = [s for s in spans if s["name"] == "flush"]
    assert len(root) == 1
    kids = {s["name"] for s in spans
            if s["parent_id"] == root[0]["span_id"]}
    assert {"flush.snapshot", "flush.swap_apply", "flush.dispatch",
            "flush.device_wait", "flush.host_emit",
            "flush.sink_flush"} <= kids
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(server, "/debug/trace/notanumber")
    assert ei.value.code == 400


# ---- /debug/signals, /debug/cluster, /debug/flight -------------------------

def test_debug_signals(server):
    server.handle_packet(b"sig.a:1|c")
    server.flush_once()
    server.handle_packet(b"sig.a:3|c")
    server.flush_once()
    out = _json(server, "/debug/signals")
    assert out["rows"] == 2 and len(out["signals"]) >= 30
    for prefix in ("ingest.", "flush.", "pressure.", "ledger.",
                   "breaker.", "spool.", "table.", "sink.",
                   "forward.collective."):
        assert any(n.startswith(prefix) for n in out["signals"]), prefix
    proc = out["signals"]["ingest.metrics_processed"]
    assert proc["v"] == [1, 2] and proc["d"] == [0, 1]
    assert _json(server, "/debug/signals?window=0.000001")["rows"] == 0
    summ = _json(server, "/debug/signals?summary=1")
    assert summ["node"] == "dbg" and summ["signals"]["flush.count"] == 2


def test_signal_schema_is_the_reference_schema(server):
    """The fixed schema is the reference server's, name for name and in
    order: a subsystem the port lacks samples 0."""
    jsrv = JServer(jread_config(data={"interval": "10s", **_ROWS}))
    try:
        assert server.signals.schema == jsrv.signals.schema
    finally:
        jsrv.shutdown()
    row = server._signal_row()
    assert row["breaker.open"] == 0 and row["pressure.level"] == 0


def test_debug_cluster_self_and_peers(make_server):
    peer = make_server(hostname="peer")
    peer.handle_packet(b"p:1|c")
    peer.flush_once()
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead_addr = f"127.0.0.1:{dead.getsockname()[1]}"
    dead.close()
    srv = make_server(hostname="self",
                      tpu_cluster_peers=f"127.0.0.1:{peer.http_port},"
                                        f"{dead_addr}")
    srv.flush_once()
    out = _json(srv, "/debug/cluster")
    assert out["node"] == "self" and out["role"] == "global"
    assert out["self"]["signals"]["flush.count"] == 1
    p = out["peers"][f"127.0.0.1:{peer.http_port}"]
    assert p["node"] == "peer" and p["stale"] is False
    assert p["signals"]["flush.count"] == 1
    assert out["peers"][dead_addr]["stale"] is True
    assert "error" in out["peers"][dead_addr]


def test_debug_flight_end_to_end(make_server, tmp_path):
    """A strict-mode imbalance fires the ``ledger_imbalance`` trigger:
    the bundle is listed, served raw, readable by both packages'
    ``read_bundle`` and carries the sealed records and the trace."""
    srv = make_server(tpu_ledger_strict=True, tpu_flight_cooldown="0s",
                      tpu_flight_dir=str(tmp_path))
    srv.handle_packet(b"ok:1|c")
    srv.flush_once()
    from veneur_tpu_torch.protocol import dogstatsd as dsd
    with srv.lock:  # staged around the ledger: a drift
        srv.table.ingest(dsd.parse_metric(b"lost:1|c"))
    srv.flush_once()
    # the bundle is written on the recorder's own thread
    _wait(lambda: srv.flight.stats()["bundles_total"] == 1)
    listing = _json(srv, "/debug/flight")
    assert listing["stats"]["by_trigger"] == {"ledger_imbalance": 1}
    name = listing["bundles"][0]["name"]
    blob = _get(srv, f"/debug/flight/{name}").read()
    assert (tmp_path / name).read_bytes() == blob
    header, body = recorder.read_bundle(blob)
    assert jrecorder.read_bundle(blob) == (header, body)
    assert header["trigger"] == "ledger_imbalance"
    ctx = body["context"]
    assert ctx["ledger_records"][-1]["staged_drift"] == -1
    # the root span joins the index when the cycle ends, after the seal
    assert {s["name"] for s in ctx["trace"]} >= {"flush.snapshot",
                                                 "flush.sink_flush"}
    assert body["history"]["rows"] == 2
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(srv, "/debug/flight/flt-nope.bundle")
    assert ei.value.code == 404


def test_signal_history_disabled(make_server):
    srv = make_server(tpu_signal_history=0)
    assert srv.signals is None and srv.flight is None
    srv.handle_packet(b"a:1|c")
    srv.flush_once()
    for path in ("/debug/signals", "/debug/flight"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv, path)
        assert ei.value.code == 404


# ---- the cross-tier trace ---------------------------------------------------------

def _chain(kind, make_local, make_global):
    """A global and a local forwarding to it (``kind``: http or grpc);
    one interval of timers through the local; returns the local's
    forward span and the spans the global indexed under its trace."""
    if kind == "http":
        glob = make_global(http_address="127.0.0.1:0")
        local = make_local(forward_address=
                           f"http://127.0.0.1:{glob.http_port}")
    else:
        glob = make_global(grpc_listen_addresses=["tcp://127.0.0.1:0"])
        local = make_local(forward_address=
                           f"127.0.0.1:{glob.grpc_ports[0]}",
                           forward_use_grpc=True)
    local.handle_packet(b"\n".join(b"tp.lat:%d|ms" % v
                                   for v in range(50)))
    local.flush_once()
    tid = int(local.flush_ring.records()[-1].trace_id)
    fwd = [s for s in local.trace_index.get(tid)
           if s["name"] == "flush.forward"]
    assert len(fwd) == 1
    _wait(lambda: any(s["name"] == "import"
                      for s in glob.trace_index.get(tid)))
    return local, glob, tid, fwd[0], glob.trace_index.get(tid)


def _tree(local, glob, tid):
    """The stitched tree as (name, parent name) pairs over both tiers'
    fragments."""
    spans = local.trace_index.get(tid) + glob.trace_index.get(tid)
    by_id = {s["span_id"]: s["name"] for s in spans}
    return sorted((s["name"], by_id.get(s["parent_id"], ""))
                  for s in spans)


def _jax_maker(servers):
    def make(**overrides):
        srv = JServer(jread_config(data={
            "statsd_listen_addresses": [], "interval": "300s",
            "hostname": "j", **_ROWS, **overrides}),
            extra_sinks=[JCaptureSink()])
        srv.start()
        servers.append(srv)
        return srv
    return make


@pytest.mark.parametrize("kind", ["http", "grpc"])
def test_stitched_trace_matches_jax_chain(make_server, kind):
    """The port's local -> global chain: the global's import span shares
    the local's trace id and hangs under its forward span, served on
    either tier at /debug/trace/<id>; the whole tree is the one a JAX
    chain builds on the same traffic."""
    local, glob, tid, fwd, gspans = _chain(kind, make_server,
                                           make_server)
    imp = [s for s in gspans if s["name"] == "import"][0]
    assert imp["trace_id"] == str(tid)
    assert imp["parent_id"] == fwd["span_id"]
    assert imp["service"] == "veneur"
    assert imp["tags"]["protocol"] == kind
    assert int(imp["tags"]["accepted"]) == 1
    assert int(imp["tags"]["bytes"]) > 0
    d = _json(glob, f"/debug/trace/{tid}")
    assert d["trace_id"] == str(tid)
    assert {s["name"] for s in d["spans"]} == {"import"}
    if kind == "http":
        names = {s["name"] for s in _json(local, f"/debug/trace/{tid}")[
            "spans"]}
        assert "flush.forward" in names
    jservers = []
    try:
        mk = _jax_maker(jservers)
        jl, jg, jtid, _, _ = _chain(kind, mk, mk)
        _wait(lambda: len(_tree(jl, jg, jtid)) == len(_tree(local, glob,
                                                              tid)))
        assert _tree(local, glob, tid) == _tree(jl, jg, jtid)
    finally:
        for s in jservers:
            s.shutdown()


@pytest.mark.parametrize("kind", ["http", "grpc"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_trace_context_crosses_packages(make_server, kind, direction):
    """The wire context is one format: a port local's forward parents a
    JAX global's import span, and the other way round."""
    jservers = []
    try:
        mk = _jax_maker(jservers)
        if direction == "port_to_jax":
            _, _, tid, fwd, gspans = _chain(kind, make_server, mk)
        else:
            _, _, tid, fwd, gspans = _chain(kind, mk, make_server)
        imp = [s for s in gspans if s["name"] == "import"][0]
        assert imp["parent_id"] == fwd["span_id"]
        assert imp["trace_id"] == str(tid)
    finally:
        for s in jservers:
            s.shutdown()


@pytest.mark.parametrize("kind", ["http", "grpc"])
def test_trace_propagation_off(make_server, kind):
    """``tpu_trace_propagation: false`` on the local: the wire carries
    no context and the global starts no import span."""
    if kind == "http":
        glob = make_server(http_address="127.0.0.1:0")
        local = make_server(forward_address=
                            f"http://127.0.0.1:{glob.http_port}",
                            tpu_trace_propagation=False)
    else:
        glob = make_server(grpc_listen_addresses=["tcp://127.0.0.1:0"])
        local = make_server(forward_address=
                            f"127.0.0.1:{glob.grpc_ports[0]}",
                            forward_use_grpc=True,
                            tpu_trace_propagation=False)
    local.handle_packet(b"off.lat:1|ms")
    local.flush_once()
    assert glob.stats["imports_received"] == 1
    assert not any(s["name"] == "import"
                   for t in glob.trace_index.trace_ids()
                   for s in glob.trace_index.get(t))
