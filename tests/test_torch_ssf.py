"""The span plane against the JAX package: SSF conversion, ssfmetrics
extraction and the SSF listeners, and the trace client's metric
helpers, scoped client and opentracing shim.

- ``protocol/ssf_convert``: seeded spans, invalid samples (an unknown
  metric type, an empty name) and spans with bad trace ids included, go
  through both packages' ``parse_metric_ssf``, ``convert_metrics``,
  ``convert_indicator_metrics`` and ``convert_span_uniqueness_metrics``
  (the sampling roll fixed); the samples are equal field for field.
- A port server on the CPU and a JAX server take the same spans through
  ``handle_ssf``, a UDP socket (plus one unparsable datagram), a unix
  stream socket and gRPC ``SendSpan``, in the same order; each flushes
  once.  Their user metrics are equal: counters, gauges, counts,
  min/max and sets bit for bit, sums to rtol 1e-6, percentiles to
  rtol 2e-3 / atol 1e-3.  So are the span counters (received per
  protocol, processed, empty, invalid samples, parse errors) and the
  sealed ledger record's protocols.  The uniqueness sketch's 1% roll is
  fixed to "sampled" in both packages, so ``ssf.names_unique`` is
  compared too.
- ``trace.metrics``, ``trace.scoped`` and ``trace.opentracing`` build
  byte-identical ``SSFSpan`` protos with the clock and the id source
  fixed.
"""

from __future__ import annotations

import functools
import io
import os
import secrets
import socket
import tempfile
import time

import grpc
import numpy as np
import pytest

from veneur_tpu.core.config import read_config as jread_config
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.protocol import ssf_convert as jconv
from veneur_tpu.trace import metrics as jtm
from veneur_tpu.trace import opentracing as jot
from veneur_tpu.trace import scoped as jscoped
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.protocol import ssf_convert as conv
from veneur_tpu_torch.protocol import wire
from veneur_tpu_torch.protocol.gen import ssf_pb2
from veneur_tpu_torch.trace import metrics as tm
from veneur_tpu_torch.trace import opentracing as ot
from veneur_tpu_torch.trace import scoped

_ROWS = {"tpu_counter_rows": 128, "tpu_gauge_rows": 128,
         "tpu_histo_rows": 128, "tpu_set_rows": 16}
_WAIT = 20.0
_S = ssf_pb2.SSFSample


def _spans(seed: int, n: int = 48) -> list[bytes]:
    """Seeded spans: timers, counters, gauges, sets and a status on
    each, scope keys, indicator spans (some failed, some with an
    ``ssf_objective`` tag), invalid samples, bad trace ids, and one
    span with neither a valid trace nor samples."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sp = ssf_pb2.SSFSpan(
            id=i + 1, trace_id=i // 3 + 1, parent_id=i % 3,
            start_timestamp=1_000_000 + i,
            end_timestamp=1_000_000 + i + int(rng.integers(1, 10 ** 7)),
            service=f"svc{i % 4}", name=f"op{i % 5}",
            indicator=i % 3 == 0, error=i % 7 == 0)
        if i % 11 == 0:
            sp.trace_id = 0          # not a valid trace: samples only
        if i % 6 == 0:
            sp.tags["ssf_objective"] = f"obj{i % 2}"
        for v in rng.gamma(2.0, 30.0, 6 + i % 5):
            sp.metrics.add(metric=_S.HISTOGRAM, name=f"lat{i % 3}",
                           value=float(v), sample_rate=1.0, unit="ms")
        c = sp.metrics.add(metric=_S.COUNTER, name="hits",
                           value=float(i % 4 + 1), sample_rate=0.5)
        c.tags["route"] = f"r{i % 2}"
        g = sp.metrics.add(metric=_S.GAUGE, name=f"depth{i % 7}",
                           value=float(i))
        g.tags["veneurglobalonly"] = ""
        sp.metrics.add(metric=_S.SET, name="users", message=f"u{i % 9}")
        h = sp.metrics.add(metric=_S.HISTOGRAM, name="l.only",
                           value=float(i))
        h.tags["veneurlocalonly"] = "true"
        if i % 8 == 0:
            sp.metrics.add(metric=_S.STATUS, name="chk", status=i % 3,
                           message="m")
        if i % 5 == 0:
            sp.metrics.add(metric=7, name="bad.type", value=1.0)
            sp.metrics.add(metric=_S.COUNTER, name="", value=1.0)
        out.append(sp.SerializeToString())
    out.append(ssf_pb2.SSFSpan(service="svc", name="empty")
               .SerializeToString())
    return out


def _fields(s) -> tuple:
    return (s.name, s.type, s.value, s.tags, s.sample_rate, s.scope,
            s.message)


@pytest.mark.parametrize("seed", [1, 2])
def test_ssf_convert_matches_jax(seed):
    for raw in _spans(seed):
        span = wire.parse_ssf(raw)
        got, bad = conv.convert_metrics(span)
        want, jbad = jconv.convert_metrics(ssf_pb2.SSFSpan.FromString(raw))
        assert bad == jbad
        assert [_fields(s) for s in got] == [_fields(s) for s in want]
        for m in span.metrics:
            try:
                g = _fields(conv.parse_metric_ssf(m))
            except conv.InvalidSample as e:
                with pytest.raises(jconv.InvalidSample, match=str(e)):
                    jconv.parse_metric_ssf(m)
                continue
            assert g == _fields(jconv.parse_metric_ssf(m))
        for names in (("ind", "obj"), ("ind", ""), ("", "obj"), ("", "")):
            assert [_fields(s) for s in conv.convert_indicator_metrics(
                span, *names)] == [_fields(s) for s in
                                   jconv.convert_indicator_metrics(
                                       span, *names)]
        for roll in (0.0, 0.5):
            assert [_fields(s) for s in conv.convert_span_uniqueness_metrics(
                span, 0.01, _random=lambda r=roll: r)] == \
                [_fields(s) for s in jconv.convert_span_uniqueness_metrics(
                    span, 0.01, _random=lambda r=roll: r)]


# ---- servers on the same spans ---------------------------------------------

@pytest.fixture
def sampled(monkeypatch):
    """The uniqueness sketch's delivery roll, fixed to "sampled" in both
    packages."""
    for mod in (conv, jconv):
        monkeypatch.setattr(
            mod, "convert_span_uniqueness_metrics",
            functools.partial(mod.convert_span_uniqueness_metrics,
                              _random=lambda: 0.0))


def _wait(pred, what):
    deadline = time.monotonic() + _WAIT
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def _servers(tmp: str):
    data = {"interval": "60s", "hostname": "h", **_ROWS,
            "indicator_span_timer_name": "ssf.indicator_span",
            "objective_span_timer_name": "ssf.objective_span",
            "tags": ["env:t", "bare"],
            "grpc_listen_addresses": ["tcp://127.0.0.1:0"]}
    out = []
    for name, cls, read, kw in (("port", Server, read_config,
                                 {"device": "cpu"}),
                                ("jax", JServer, jread_config, {})):
        cfg = read(data=dict(data, ssf_listen_addresses=[
            "udp://127.0.0.1:0", f"unix://{tmp}/{name}.sock"]))
        srv = cls(cfg, **kw)
        srv.start()
        out.append((srv, f"{tmp}/{name}.sock"))
    return out


def _send(how: str, srv, path: str, spans: list[bytes]) -> None:
    if how == "handle_ssf":
        for raw in spans:
            srv.handle_ssf(wire.parse_ssf(raw))
    elif how == "udp":
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for raw in spans + [b"\xff\xff\xff\xff\x0f"]:
            s.sendto(raw, ("127.0.0.1", srv.ssf_ports[0]))
        s.close()
    elif how == "unix":
        buf = io.BytesIO()
        for raw in spans:
            wire.write_ssf(buf, ssf_pb2.SSFSpan.FromString(raw))
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(path)
        s.sendall(buf.getvalue())
        s.close()
    else:
        with grpc.insecure_channel(
                f"127.0.0.1:{srv.grpc_ports[0]}") as ch:
            send = ch.unary_unary("/ssf.SSFGRPC/SendSpan",
                                  request_serializer=lambda b: b,
                                  response_deserializer=lambda b: b)
            for raw in spans:
                send(raw, timeout=10)


_COUNTERS = ("received_ssf-udp", "received_ssf-unix", "received_ssf-grpc",
             "spans_processed", "empty_ssf", "ssf_invalid_samples",
             "ssf_errors", "metrics_processed", "metrics_dropped")


def _user(metrics) -> dict:
    out: dict = {}
    for m in metrics:
        if not m.name.startswith("veneur."):
            key = (m.name, m.tags)
            assert key not in out, key
            out[key] = (m.value, m.type)
    return out


@pytest.mark.parametrize("how", ["handle_ssf", "udp", "unix", "grpc"])
def test_servers_flush_the_same_spans_alike(how, sampled):
    spans = _spans(7)
    with tempfile.TemporaryDirectory() as tmp:
        pair = _servers(tmp)
        try:
            for srv, path in pair:
                _send(how, srv, path, spans)
            for srv, _ in pair:
                _wait(lambda: srv.stats.get("spans_processed", 0) +
                      srv.stats.get("empty_ssf", 0) == len(spans),
                      f"{how}: every span through the worker")
                if how == "udp":
                    _wait(lambda: srv.stats.get("ssf_errors", 0) == 1,
                          "the unparsable datagram")
            flushed = [srv.flush_once().metrics for srv, _ in pair]
            stats = [{k: srv.stats.get(k, 0) for k in _COUNTERS}
                     for srv, _ in pair]
            protos = [srv.ledger.records()[-1].received for srv, _ in pair]
            balanced = [srv.ledger.records()[-1].balanced
                        for srv, _ in pair]
        finally:
            for srv, _ in pair:
                srv.shutdown()
    assert stats[0] == stats[1]
    assert stats[0]["ssf_invalid_samples"] > 0
    assert protos[0] == protos[1] and balanced == [True, True]
    got, want = (_user(m) for m in flushed)
    assert got.keys() == want.keys(), (sorted(set(got) - set(want)),
                                       sorted(set(want) - set(got)))
    names = {k[0] for k in got}
    assert {"ssf.indicator_span.99percentile", "ssf.objective_span.count",
            "ssf.names_unique", "ssf.error_total", "chk"} <= names
    for key, (w, wtype) in want.items():
        g, gtype = got[key]
        assert gtype == wtype, key
        if key[0].endswith("percentile"):
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-3,
                                       err_msg=str(key))
        elif key[0].endswith(".sum"):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=str(key))
        else:
            assert g == w, key


# ---- the trace client's helpers --------------------------------------------

class _Record:
    def __init__(self):
        self.out: list[bytes] = []

    def record(self, span) -> bool:
        self.out.append(span.SerializeToString())
        return True


@pytest.fixture
def fixed_clock_and_ids(monkeypatch):
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_123_456_789)
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.5)

    def reset():
        counter = iter(range(1, 1 << 20))
        monkeypatch.setattr(secrets, "randbits",
                            lambda bits: next(counter) * 7919)
    return reset


def _metrics_scenario(mod):
    rec = _Record()
    mod.name_prefix = "pre."
    try:
        samples = [mod.count("c", 2.0, {"k": "v"}),
                   mod.gauge("g", 3.5, scope=_S.GLOBAL),
                   mod.histogram("h", 0.25, {"a": "b"}, unit="s"),
                   mod.set_sample("s", "member", {"t": "1"}),
                   mod.timing("t", 0.125, sample_rate=0.5),
                   mod.status("st", 2, "broken", {"x": "y"})]
        mod.report_batch(rec, samples)
        mod.report_one(rec, mod.count("one", 1.0))
    finally:
        mod.name_prefix = ""
    return rec.out


def _scoped_scenario(mod):
    rec = _Record()
    c = mod.ScopedClient(rec, tags={"svc": "a"}, count_scope=mod.LOCAL,
                         histogram_scope=mod.GLOBAL)
    c.count("c", 3.0, {"k": "v"})
    c.incr("i")
    c.gauge("g", 1.5)
    c.histogram("h", 2.5, {"svc": "override"})
    c.timing("t", 0.5)
    c.set("s", "m")
    return rec.out


def _opentracing_scenario(mod):
    rec = _Record()
    tracer = mod.Tracer()
    root = tracer.start_span("root", tags={"k": "v", "n": 3},
                             service="svc", start_time=100.0)
    child = tracer.start_span("child", child_of=root)
    child.set_baggage_item("b", "1")
    child.set_tag("error", True)
    hdrs: dict = {}
    tracer.inject_header(child, hdrs)
    req = tracer.extract_request_child("/res", hdrs, "handler")
    buf = io.BytesIO()
    tracer.inject(child.context(), mod.FORMAT_BINARY, buf)
    ctx = tracer.extract(mod.FORMAT_BINARY, io.BytesIO(buf.getvalue()))
    text: dict = {}
    tracer.inject(child.context(), mod.FORMAT_TEXT_MAP, text)
    for sp in (req, child, root):
        sp.finish(rec)
    return (rec.out, sorted(hdrs.items()), buf.getvalue(),
            (ctx.trace_id, ctx.span_id, ctx.resource), sorted(text.items()))


@pytest.mark.parametrize("scenario,port_mod,jax_mod", [
    (_metrics_scenario, tm, jtm),
    (_scoped_scenario, scoped, jscoped),
    (_opentracing_scenario, ot, jot),
], ids=["metrics", "scoped", "opentracing"])
def test_trace_helpers_build_the_same_protos(scenario, port_mod, jax_mod,
                                             fixed_clock_and_ids):
    fixed_clock_and_ids()
    got = scenario(port_mod)
    fixed_clock_and_ids()
    want = scenario(jax_mod)
    assert got == want
    assert got[0] if isinstance(got, tuple) else got
