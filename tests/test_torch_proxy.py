"""CPU parity of the port's proxy tier against the JAX package.

A port ``ProxyServer`` and a JAX one, their sends stubbed, route the
same gRPC wires (the columnar route and the per-item oracle), the same
``/import`` bodies in both JSON schemas and the same ``/spans`` bodies:
the per-destination batches and the ``ProxyLedger`` summaries must be
equal.  Then a chain on the CPU — a port local, a port proxy and two
port globals over real gRPC — whose union flush must equal one port
global's and a JAX chain's on the same lines; the proxy's ``/debug/*``
surface; ``cli.proxy`` on the repo's ``example_proxy.yaml``; and
``ProxyConfig``'s validation and refused keys.

Tolerances (each comparison states its own): routed bodies, batches,
ledgers, counters, gauges, counts, min/max and set estimates exactly;
sums to rtol 1e-6; percentiles to rtol 2e-3 / atol 1e-3
(tests/test_pallas_merge.py), except where a comparison is stated bit
for bit.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from veneur_tpu.core import proxy as jproxy_mod
from veneur_tpu.core.config import ProxyConfig as JProxyConfig
from veneur_tpu.core.config import read_config as jread_config
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.forward import http_import as jhi
from veneur_tpu.sinks.simple import CaptureSink as JCaptureSink
from veneur_tpu_torch.cli import proxy as cli_proxy
from veneur_tpu_torch.core import debughttp
from veneur_tpu_torch.core import proxy as proxy_mod
from veneur_tpu_torch.core.config import ProxyConfig, read_config
from veneur_tpu_torch.core.flusher import Flusher
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.core.table import MetricTable, TableConfig
from veneur_tpu_torch.forward import grpc_forward as gf
from veneur_tpu_torch.forward import http_import as hi
from veneur_tpu_torch.forward.gen import forward_pb2
from veneur_tpu_torch.sinks.simple import CaptureSink
from tests.torch_fixtures import unsampled_span_uniqueness  # noqa: F401


ROOT = Path(__file__).resolve().parent.parent
DESTS = "10.0.0.1:8128,10.0.0.2:8128,10.0.0.3:8128"
TRACE_DESTS = "10.9.0.1:8127,10.9.0.2:8127"
_WAIT = 10.0
_SIZES = dict(counter_rows=64, gauge_rows=64, histo_rows=64, set_rows=8)
_SRV = {"interval": "60s", "tpu_counter_rows": 64, "tpu_gauge_rows": 64,
        "tpu_histo_rows": 64, "tpu_set_rows": 8,
        "percentiles": [0.5, 0.9, 0.99],
        "aggregates": ["min", "max", "count", "sum"]}


def _local_rows(seed: int):
    """A port local's forward rows: global-only counters, gauges and
    timers, tagged and untagged timers and sets."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(12):
        lines.append(b"c%d:%d|c|#veneurglobalonly" % (i, rng.integers(1, 9)))
        lines.append(b"g%d:%.3f|g|#veneurglobalonly" % (i, rng.normal()))
        tags = b"|#k:v" if i % 2 else b""
        lines += [b"t%d:%.3f|ms%s" % (i, v, tags)
                  for v in rng.gamma(2.0, 30.0, 40)]
    for i in range(4):
        lines += [b"s%d:m%d|s" % (i, j) for j in rng.integers(0, 300, 60)]
    t = MetricTable(TableConfig(**_SIZES), device="cpu")
    t.ingest_buffer(b"\n".join(lines))
    return Flusher(is_local=True, device="cpu").flush(t.swap(),
                                                      now=1).forward


def _proxy_pair(columnar: bool):
    """A port proxy and a JAX proxy with the same destinations and
    every send stubbed: each records (dest, payload) per batch."""
    out = []
    for mod, cfg_cls in ((proxy_mod, ProxyConfig),
                         (jproxy_mod, JProxyConfig)):
        cfg = cfg_cls(forward_address=DESTS, trace_address=TRACE_DESTS,
                      tpu_columnar_proxy=columnar, tpu_proxy_dest_queue=64)
        px = mod.ProxyServer(cfg)
        sent = []
        lock = threading.Lock()

        def record(kind, dest, payload, sent=sent, lock=lock):
            with lock:
                sent.append((kind, dest, payload))

        px._send_grpc_wire = (lambda dest, body, md=None, r=record:
                              r("grpc", dest, body))
        px._post_import = (lambda dest, batch, ctx=None, r=record:
                           r("json", dest, json.dumps(batch)))
        px._post_spans = (lambda dest, batch, r=record:
                          r("spans", dest, json.dumps(batch)))

        def send_grpc(dest, batch, ctx=None, r=record, px=px):
            r("grpc", dest, forward_pb2.MetricList(
                metrics=batch).SerializeToString())
            px.bump("forwards_sent")

        def send_http(dest, batch, ctx=None, r=record, px=px):
            r("json", dest, json.dumps(batch))
            px.bump("forwards_sent")

        def send_traces(dest, batch, r=record, px=px):
            r("spans", dest, json.dumps(batch))
            px.bump("traces_sent")

        px._send_grpc, px._send_http = send_grpc, send_http
        px._send_traces = send_traces
        out.append((px, sent))
    return out


def _settle(px):
    """Wait until every routed batch was handed to its (stubbed) send:
    the destination workers' items for the columnar route, the
    executor for the per-item path."""
    if px.columnar:
        want = px.ledger._cur.enqueued + px.stats.get("traces_routed", 0)
        _wait_for(lambda: px.destpool.totals()["sent_items"] == want,
                  "the destination workers")
    px._pool.shutdown(wait=True)


def _summary(px):
    """The ProxyLedger's sealed record (clock fields aside) and its
    summary."""
    rec = px.ledger.roll()
    return px.ledger.summary(), {k: v for k, v in rec.to_dict().items()
                                if k not in ("start_unix", "seq")}


def _spans_bodies():
    rng = np.random.default_rng(11)
    traces = []
    for t in range(20):
        tid = int(rng.integers(1, 2 ** 62))
        traces.append([{"trace_id": tid, "span_id": int(s), "name": "op",
                        "duration": int(rng.integers(1, 1000))}
                       for s in rng.integers(1, 2 ** 40, 3)])
    # flat spans, an untraced span (routed by its content) and junk
    traces += [{"trace_id": 77, "span_id": 1, "name": "flat"},
               {"span_id": 5, "name": "untraced"}, "junk"]
    return traces


@pytest.mark.parametrize("columnar", [True, False],
                         ids=["columnar", "oracle"])
def test_proxy_routes_like_jax(columnar):
    """Four gRPC wires, two /import bodies in each JSON schema and one
    /spans body through both proxies: the same batches for each
    destination (order of arrival aside), the same stats and the same
    ProxyLedger summary and sealed record."""
    wires = [gf.rows_to_metric_list(_local_rows(s)).SerializeToString()
             for s in range(4)]
    rows = _local_rows(9)
    bodies = [hi.encode_rows(rows), hi.encode_rows(_local_rows(10)),
              hi.encode_rows_reference(rows),
              hi.encode_rows_reference(_local_rows(10))]
    traces = _spans_bodies()
    results = []
    for (px, sent), dec in zip(_proxy_pair(columnar),
                               (hi.decode_body, jhi.decode_body)):
        try:
            for w in wires:
                px.route_pb_wire(w)
            for body, hdr in bodies:
                px.route_json_items(dec(body, hdr["Content-Encoding"]))
            px.route_traces(traces)
            _settle(px)
            results.append((sorted(sent), dict(px.stats), _summary(px)))
        finally:
            px.shutdown()
    assert results[0][0] == results[1][0]
    assert results[0][1] == results[1][1]
    assert results[0][2] == results[1][2]
    stats = results[0][1]
    assert stats["metrics_routed"] == sum(
        len(forward_pb2.MetricList.FromString(w).metrics)
        for w in wires) + 2 * len(rows) + 2 * len(_local_rows(10))
    assert stats.get("columnar_fallbacks", 0) == 0
    assert stats["traces_routed"] == 62 and stats["traces_dropped"] == 1
    assert stats["untraced_spans_total"] == 1
    led = results[0][2][0]
    assert led["balanced"] == 1 and led["owed_total"] == 0
    assert led["dropped_total"] == 0


def test_proxy_malformed_wire_falls_back_like_jax():
    """A wire the native walker refuses takes the per-item path
    (counted as a columnar fallback in stats and ledger) or, when
    protobuf refuses it too, counts an import error — in both."""
    good = gf.rows_to_metric_list(_local_rows(3)).SerializeToString()
    results = []
    for px, sent in _proxy_pair(True):
        try:
            px.route_pb_wire(b"\x0a\x05\x0a\x01")   # bad in both
            px.route_pb_wire(good + b"\x0f")         # bad wire type
            px.route_pb_wire(good)
            _settle(px)
            results.append((sorted(sent), dict(px.stats), _summary(px)))
        finally:
            px.shutdown()
    assert results[0] == results[1]
    assert results[0][1]["columnar_fallbacks"] == 2
    assert results[0][1]["import_errors"] == 2


# ---- the chain on the CPU ---------------------------------------------------

LINES = ([b"lat:%d|ms" % v for v in range(200)]
         + [b"lat%d:%d|ms|#veneurglobalonly" % (s, v)
            for s in range(30) for v in range(0, 300, 7)]
         + [b"hits%d:%d|c|#veneurglobalonly" % (s, s + 1) for s in range(40)]
         + [b"depth%d:%d|g|#veneurglobalonly" % (s, 3 * s) for s in range(40)]
         + [b"uniq%d:m%d|s" % (s % 5, s) for s in range(300)])
# datagrams under the server's 4,096-byte limit
PACKETS = [b"\n".join(LINES[i:i + 150]) for i in range(0, len(LINES), 150)]


def _wait_for(pred, what):
    deadline = time.monotonic() + _WAIT
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


def _chain(server_cls, cfg_read, proxy_cls, cfg_proxy, cap_cls, n_globals,
           through_proxy, **dev):
    """Run one chain: a local fed LINES in one datagram, forwarding
    over gRPC to a proxy in front of ``n_globals`` globals (or straight
    to the one global); returns every global's flushed metrics and the
    processes' stats."""
    caps, globals_ = [], []
    proxy = local = None
    try:
        for _ in range(n_globals):
            cap = cap_cls()
            g = server_cls(cfg_read(data=dict(
                _SRV, grpc_listen_addresses=["tcp://127.0.0.1:0"])),
                extra_sinks=[cap], **dev)
            g.start()
            caps.append(cap)
            globals_.append(g)
        dests = ",".join(f"127.0.0.1:{g.grpc_ports[0]}" for g in globals_)
        target = dests
        if through_proxy:
            proxy = proxy_cls(cfg_proxy(grpc_forward_address=dests,
                                        grpc_address="127.0.0.1:0"))
            proxy.start()
            target = f"127.0.0.1:{proxy.grpc_port}"
        local = server_cls(cfg_read(data=dict(
            _SRV, forward_address=target, forward_use_grpc=True,
            tpu_drain_on_shutdown=False)), **dev)
        for pkt in PACKETS:
            local.handle_packet(pkt)
        local.flush_once()
        n_fwd = local.stats["forward_post_metrics"]
        _wait_for(lambda: sum(g.stats.get("imports_received", 0)
                              for g in globals_) == n_fwd,
                  "every forwarded row at the globals")
        for g in globals_:
            g.flush_once()
        metrics = [m for cap in caps for m in cap.metrics
                   if not m.name.startswith("veneur.")]
        return metrics, [dict(g.stats) for g in globals_], (
            dict(proxy.stats) if proxy else None), n_fwd
    finally:
        if local is not None:
            local.shutdown()
        if proxy is not None:
            proxy.shutdown()
        for g in globals_:
            g.shutdown()


def _by_key(metrics):
    out = {(m.name, tuple(m.tags)): m.value for m in metrics}
    assert len(out) == len(metrics), "a series flushed on two globals"
    return out


def _assert_same(got, want, pct_bits=False):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if key[0].endswith("percentile") and not pct_bits:
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-3,
                                       err_msg=str(key))
        elif key[0].endswith(".sum"):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=str(key))
        else:
            assert g == w, (key, g, w)


def test_chain_two_globals_union_matches_one_global_and_jax():
    """Local -> port proxy -> two port globals on the CPU: every series
    flushes on exactly one global, both globals get a share, the proxy
    routes every row with no fallback and a balanced ledger, and the
    union equals one port global fed straight (bit for bit, percentiles
    too: each row's digest folds one wire either way) and a JAX chain
    of the same shape (percentiles to rtol 2e-3 / atol 1e-3)."""
    dev = {"device": "cpu"}
    two, gstats, pstats, n_fwd = _chain(
        Server, read_config, proxy_mod.ProxyServer, ProxyConfig,
        CaptureSink, 2, True, **dev)
    one, _, _, n_one = _chain(Server, read_config, None, None, CaptureSink,
                              1, False, **dev)
    jax_two, jstats, _, _ = _chain(
        JServer, jread_config, jproxy_mod.ProxyServer, JProxyConfig,
        JCaptureSink, 2, True)
    assert n_fwd == n_one > 0
    assert all(s["imports_received"] > 0 for s in gstats)
    assert sum(s["imports_received"] for s in gstats) == n_fwd
    assert pstats["metrics_routed"] == n_fwd
    assert pstats.get("columnar_fallbacks", 0) == 0
    got = _by_key(two)
    _assert_same(got, _by_key(one), pct_bits=True)
    _assert_same(got, _by_key(jax_two))
    # the split itself depends on the globals' (ephemeral) addresses
    assert sum(s["imports_received"] for s in jstats) == n_fwd
    assert repr(got[("lat.99percentile", ())]) == "197.00999450683594"


# ---- the proxy's own surface -----------------------------------------------

def test_proxy_debug_surface():
    """Every path of ``PROXY_DEBUG_ENDPOINTS`` answers on the proxy's
    listener, the inventory equals the do_GET routing, and /debug/vars
    and /debug/ledger carry the routing state after a refresh."""
    src = Path(proxy_mod.__file__).read_text()
    routed = set(re.findall(
        r'self\.path\.startswith\("(/debug/[a-z]+)"\)', src))
    assert routed == set(debughttp.PROXY_DEBUG_ENDPOINTS)
    px = proxy_mod.ProxyServer(ProxyConfig(
        forward_address=DESTS, http_address="127.0.0.1:0"))
    px._post_import = lambda dest, batch, ctx=None: None
    px.start()
    try:
        body = json.dumps([{"name": "a", "type": "counter", "tags": [],
                            "value": 1}] * 3).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{px.http_port}/import", data=body,
            method="POST")
        with urllib.request.urlopen(req, timeout=_WAIT) as r:
            assert json.loads(r.read()) == {"accepted": 3}
        _wait_for(lambda: px.destpool.totals()["sent_items"] == 3, "send")
        px._refresh_once()
        pages = {}
        for path in debughttp.PROXY_DEBUG_ENDPOINTS + ("/healthcheck",
                                                        "/version"):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{px.http_port}{path}",
                    timeout=_WAIT) as r:
                assert r.status == 200, path
                pages[path] = r.read()
        v = json.loads(pages["/debug/vars"])
        assert v["stats"]["metrics_routed"] == 3
        assert v["destinations"] == 3 and v["columnar"] is True
        assert v["discovery"]["forward"]["members"] == sorted(
            DESTS.split(","))
        assert sum(d["sent_items"] for d in v["destpool"].values()) == 3
        led = json.loads(pages["/debug/ledger"])
        assert led["records"][-1]["balanced"] and \
            led["records"][-1]["routed"] == 3
        sig = json.loads(pages["/debug/signals"])
        assert sig["rows"] == 1
        assert pages["/healthcheck"] == b"ok"
    finally:
        px.shutdown()


def test_cli_proxy_loads_example_config(capsys):
    assert cli_proxy.main(["-f", str(ROOT / "example_proxy.yaml"),
                           "--validate-config"]) == 0
    assert "config ok" in capsys.readouterr().out
    cfg = read_config(str(ROOT / "example_proxy.yaml"), cls=ProxyConfig)
    jcfg = jread_config(str(ROOT / "example_proxy.yaml"), cls=JProxyConfig)
    for f in ("grpc_address", "http_address", "consul_forward_service_name",
              "consul_refresh_interval", "consul_url", "forward_timeout",
              "stats_address"):
        assert getattr(cfg, f) == getattr(jcfg, f)


@pytest.mark.parametrize("key", ["forward_grpc_tls", "forward_grpc_tls_ca",
                                 "sentry_dsn"])
def test_proxy_config_refuses_unported_keys(key):
    with pytest.raises(ValueError, match=key):
        read_config(data={"forward_address": "a:1", key: "x"},
                    cls=ProxyConfig)
    jread_config(data={"forward_address": "a:1"}, cls=JProxyConfig)


def test_proxy_config_defaults_and_validation_match_jax():
    """Every key the port keeps has the reference's default; a proxy
    without a destination surface and a non-positive refresh interval
    are refused by both; an environment override applies to both."""
    port, ref = ProxyConfig(), JProxyConfig()
    for f in port.__dataclass_fields__:
        assert getattr(port, f) == getattr(ref, f), f
    for data, msg in (({}, "destination surface"),
                      ({"trace_address": "a:1",
                        "consul_refresh_interval": "0s"}, "positive")):
        with pytest.raises(ValueError, match=msg):
            read_config(data=data, cls=ProxyConfig)
        with pytest.raises(ValueError, match=msg):
            jread_config(data=data, cls=JProxyConfig)
    env = {"VENEUR_TPU_PROXY_DEST_QUEUE": "3",
           "VENEUR_FORWARD_TIMEOUT": "2.5"}
    cfg = read_config(data={"forward_address": "a:1"}, env=env,
                      cls=ProxyConfig)
    assert (cfg.tpu_proxy_dest_queue, cfg.forward_timeout) == (3, 2.5)
    assert os.environ.get("VENEUR_TPU_PROXY_DEST_QUEUE") is None


@pytest.mark.parametrize("mode", ["stack", "legacy"])
def test_split_fold_matches_jax(mode, monkeypatch):
    """Eight locals' wires split over two destinations and folded by a
    global each, as two globals behind a proxy fold them, against one
    global folding every wire: in both packages, under the stacked fold
    (one merge per wire, which a global holding under half the plane
    takes on the card) and the flat one.  The port's split union equals
    the JAX package's bit for bit, and so does its single global; the
    split's percentiles may differ from the single global's, in both
    packages alike."""
    from veneur_tpu.core.flusher import Flusher as JFlusher
    from veneur_tpu.core.table import MetricTable as JTable
    from veneur_tpu.core.table import TableConfig as JTableConfig
    from veneur_tpu.forward import grpc_forward as jgf
    from veneur_tpu_torch.forward import ring, route
    monkeypatch.setenv("VENEUR_TPU_FUSED_IMPORT", mode)
    wires = [gf.rows_to_metric_list(_local_rows(s)).SerializeToString()
             for s in range(8)]
    members = ["127.0.0.1:9001", "127.0.0.1:9002"]
    halves = [[], []]
    for w in wires:
        for d, body, _n in route.route_metric_list(
                w, ring.ConsistentRing(members)).batches:
            halves[d].append(body)

    def fold(bodies, jax):
        if jax:
            t = JTable(JTableConfig(**_SIZES))
            for b in bodies:
                jgf.apply_metric_list_bytes(t, b)
            res = JFlusher(is_local=False, percentiles=(0.5, 0.9, 0.99),
                           aggregates=("min", "max", "count")).flush(
                t.swap(), now=1)
        else:
            t = MetricTable(TableConfig(**_SIZES), device="cpu")
            for b in bodies:
                gf.apply_metric_list_bytes(t, b)
            res = Flusher(percentiles=(0.5, 0.9, 0.99),
                          aggregates=("min", "max", "count"),
                          device="cpu").flush(t.swap(), now=1)
        return {(m.name, tuple(m.tags)): m.value for m in res.metrics}

    out = []
    for jax in (False, True):
        split = {}
        for h in halves:
            part = fold(h, jax)
            assert not set(part) & set(split)
            split.update(part)
        out.append((split, fold(wires, jax)))
    (split, one), (jsplit, jone) = out
    assert split == jsplit and one == jone
    assert set(split) == set(one)
    for key, v in one.items():
        if not key[0].endswith("percentile"):
            assert split[key] == v, key


def test_proxy_ssf_self_telemetry_matches_jax():
    """``ssf_destination_address``: each proxy reports its stats as SSF
    gauges through its trace client, the same names and values from
    both packages after the same routing."""
    import socket

    from veneur_tpu.protocol.gen import ssf_pb2
    out = []
    for mod, cfg_cls in ((proxy_mod, ProxyConfig),
                         (jproxy_mod, JProxyConfig)):
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind(("127.0.0.1", 0))
        sock.settimeout(_WAIT)
        px = mod.ProxyServer(cfg_cls(
            forward_address=DESTS,
            ssf_destination_address=f"udp://127.0.0.1:"
                                    f"{sock.getsockname()[1]}",
            runtime_metrics_interval="50ms"))
        px._post_import = lambda dest, batch, ctx=None: None
        try:
            px.route_json_items([{"name": "a", "type": "counter",
                                  "tags": [], "value": 1}] * 4)
            _wait_for(lambda: px.destpool.totals()["sent_items"] == 4,
                      "the sends")
            px.start()
            while True:
                span = ssf_pb2.SSFSpan.FromString(sock.recvfrom(65536)[0])
                got = {m.name: m.value for m in span.metrics}
                if got.get("veneur_proxy.metrics_routed") == 4.0:
                    break
            out.append({k: v for k, v in got.items()
                        if k.startswith("veneur_proxy.")})
        finally:
            px.shutdown()
            sock.close()
    assert out[0] == out[1]
    assert out[0]["veneur_proxy.destinations"] == 3.0
