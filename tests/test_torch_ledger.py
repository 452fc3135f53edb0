"""The port's sample-conservation ledger against the reference's.

Units: ``Ledger``, ``SpoolLedger``, ``ProxyLedger`` and
``ClassDropTally`` of ``veneur_tpu_torch.observe.ledger`` get the same
calls as ``veneur_tpu.observe.ledger`` and must give equal records,
JSON dumps and summaries (wall-clock fields left out).

Servers: a port server on the CPU and a JAX server take the same
datagrams (one reader, four reader shards, pipelined and serial steps,
a class overflow, a tiered table), the same ``/import`` bodies in both
schemas and the same gRPC MetricList wires; every sealed ledger record
must equal the JAX server's field by field, and balance, and each
flush's ``row_accounting`` must equal the JAX flush's.  The
reference's ``veneur.xla.*`` self-telemetry counts a process-global
registry (JIT compiles in the reference, library builds in the port):
both registries' compile counters read zero here, so the loopback
telemetry of both servers is the same sample set (both run their
ssfmetrics span sink and count its deliveries).  Also the
reference's ledger scenarios on the port alone: a shard's lock-free
``parse`` does no ledger work, concurrent reader shards balance to the
sample, strict mode names an injected loss.  Exact equality: the
ledger counts integers.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

import grpc
import numpy as np
import pytest

import veneur_tpu.observe as jobs
from veneur_tpu.core.config import read_config as jread_config
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.observe import ledger as jledger
from veneur_tpu.protocol import columnar as jcolumnar
from veneur_tpu.sinks.simple import CaptureSink as JCaptureSink
from veneur_tpu_torch import observe
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.forward import grpc_forward, http_import
from veneur_tpu_torch.observe import ledger
from veneur_tpu_torch.protocol import dogstatsd as dsd
from veneur_tpu_torch.protocol.gen import dogstatsd_grpc_pb2
from veneur_tpu_torch.sinks.simple import CaptureSink
from tests.torch_fixtures import unsampled_span_uniqueness  # noqa: F401


_MODS = {"jax": jledger, "torch": ledger}


def _no_clock(d):
    if isinstance(d, dict):
        return {k: _no_clock(v) for k, v in d.items()
                if k not in ("start_unix", "trace_id")}
    if isinstance(d, list):
        return [_no_clock(v) for v in d]
    return d


# ---- units ---------------------------------------------------------------------

def _ledger_script(mod, strict):
    hits = []
    led = mod.Ledger(capacity=3, strict=strict, node="n",
                     on_imbalance=hits.append)
    for i in range(5):
        led.ingest("dogstatsd", processed=100 + i, staged=90, overflow=6,
                   status=4, parse_errors=i, shed=i)
        led.credit_shed({("acme", "tenant_budget"): i})
        led.ingest("http-import", processed=10, staged=9, invalid=1)
        led.recover("incarnation:3", i)
        led.ingest("grpc-import-recovery", processed=i, staged=i)
        led.credit_reshard_received(2)
        led.note_coalesced()
        rec = led.close_interval(seq=i + 1, trace_id=7,
                                 table_staged=99 + 2 * i - (i == 3),
                                 table_overflow={"counter": 6},
                                 kernel_drops=i)
        led.credit_rows(rec, {"staged_rows": 40, "emitted_rows": 25,
                              "forwarded_rows": 20 + i,
                              "overlap_rows": 10, "retained_rows": 5})
        led.credit_forward_split(rec, "a:1", rows=12)
        led.credit_forward_split(rec, "b:2", rows=8, dropped=i)
        led.credit_forward_collective(rec, "c:3", 0)
        led.credit_forward_spooled(rec, 0)
        led.credit_spool_outcome(rec, spooled_async=1, replayed=i)
        led.credit_reshard(rec, i, ["x"], ["y"] if i else [], i)
        led.credit_sink(rec, "capture", 30)
        led.credit_forward_wire(rec, rows=20, nbytes=999, errors=i % 2)
        led.credit_forward_timeout(rec, "a:1", i)
        led.credit_fanout(rec, busy_drops=1, retries=i, timeouts=0)
        led.credit_tiers(rec, {"histo": {"promotions": i, "demotions": 1,
                                         "escalations": 0,
                                         "promote_refused": i % 2},
                               "set": {"promotions": 2}})
        led.seal(rec)
    return (_no_clock([r.to_dict() for r in led.records()]),
            _no_clock(json.loads(led.to_json())),
            _no_clock(json.loads(led.to_json(limit=1))), led.summary(),
            led.imbalanced_total, len(hits),
            _no_clock(led.open_to_dict()), led.last().seq)


@pytest.mark.parametrize("strict", [False, True])
def test_ledger_records_as_reference(strict):
    """Every credit method, a drift and a split imbalance, the bounded
    ring and the summary: the same calls give the same records."""
    out = {k: _ledger_script(m, strict) for k, m in _MODS.items()}
    assert out["torch"] == out["jax"]
    recs = out["torch"][0]
    assert [r["seq"] for r in recs] == [3, 4, 5]
    assert not any(r["balanced"] for r in recs)
    assert out["torch"][4] == 4  # seq 1 balanced, 2-5 drift


def test_unit_balance_and_owed_as_reference():
    """The reference's unit cases: a balanced interval, an injected
    loss carrying its owed count (strict escalates), rows owed from the
    routing."""
    def run(mod):
        led = mod.Ledger(node="test")
        led.ingest("dogstatsd", processed=100, staged=90, overflow=6,
                   status=4)
        rec = led.close_interval(seq=1, table_staged=90,
                                 table_overflow={"counter": 6})
        led.credit_rows(rec, {"staged_rows": 40, "emitted_rows": 25,
                              "forwarded_rows": 20, "overlap_rows": 10,
                              "retained_rows": 6})
        led.seal(rec)
        hits = []
        strict = mod.Ledger(strict=True, on_imbalance=hits.append)
        strict.ingest("dogstatsd", processed=50, staged=45)
        lost = strict.seal(strict.close_interval(seq=3))
        return (rec.balanced, rec.rows_owed, lost.owed, lost.balanced,
                len(hits), led.summary())
    out = {k: run(m) for k, m in _MODS.items()}
    assert out["torch"] == out["jax"]
    assert out["torch"][:5] == (False, -1, 5, False, 1)


def test_class_drop_tally_as_reference():
    for mod in _MODS.values():
        t = mod.ClassDropTally()
        t.add(3)
        t.add()
        assert t.count == 4 and t.take() == 4 and t.count == 0
    from veneur_tpu_torch.core.table import MetricTable, TableConfig
    table = MetricTable(TableConfig(counter_rows=2), device="cpu")
    assert isinstance(table.counter_idx.drops, ledger.ClassDropTally)


def test_spool_ledger_as_reference():
    def run(mod):
        hits = []
        sl = mod.SpoolLedger(capacity=4, node="l", strict=True,
                             on_imbalance=hits.append)
        for i in range(6):
            sl.seal_snapshot({"spooled_items": 10 * i,
                              "replayed_items": 4 * i,
                              "expired_items": i,
                              "queued_items": 5 * i - (i == 2),
                              "inflight_items": 0, "queued_bytes": 77,
                              "expired_by_reason": {"age": i}})
        return (_no_clock([r.to_dict() for r in sl.records()]),
                _no_clock(json.loads(sl.to_json())), sl.summary(),
                len(hits), sl.imbalanced_total)
    out = {k: run(m) for k, m in _MODS.items()}
    assert out["torch"] == out["jax"]
    assert out["torch"][3] == 1


def test_proxy_ledger_as_reference():
    def run(mod):
        pl = mod.ProxyLedger(capacity=3, node="p")
        for i in range(5):
            pl.credit_route(routed=10 + i, dropped=1, enqueued=8 + i,
                            busy_dropped=2 - (i == 1), fallbacks=i % 2,
                            per_dest={"g1": 6, "g2": 4 + i})
            pl.credit_send(sent_items=8, error_items=i, retries=1)
            pl.roll()
        return (_no_clock([r.to_dict() for r in pl.records()]),
                _no_clock(json.loads(pl.to_json(limit=2))), pl.summary(),
                pl.imbalanced_total)
    out = {k: run(m) for k, m in _MODS.items()}
    assert out["torch"] == out["jax"]


# ---- servers: the port against the JAX server ------------------------------------

_ROWS = {"tpu_counter_rows": 64, "tpu_gauge_rows": 64,
         "tpu_histo_rows": 64, "tpu_set_rows": 8}


@pytest.fixture
def zero_compile_counters(monkeypatch):
    """Both packages' process-global device-cost registries report no
    compiles or cache traffic: the reference counts JIT compiles, the
    port library builds, so ``veneur.xla.*`` would differ by design."""
    for reg in (jobs.REGISTRY, observe.REGISTRY):
        totals = reg.totals

        def zeroed(totals=totals):
            out = dict(totals())
            for k in ("compile_total", "compile_duration_ns",
                      "compile_cache_hits", "compile_cache_misses"):
                out[k] = 0
            return out
        monkeypatch.setattr(reg, "totals", zeroed)


def _pair(**cfg):
    # overload off on both servers: with the small classes here a
    # flush's pressure tick would engage it; its parity is held in
    # tests/test_torch_overload.py
    data = {"interval": "10s", "hostname": "h", **_ROWS,
            "tpu_overload": False, **cfg}
    jsrv = JServer(jread_config(data=data),
                   extra_sinks=[JCaptureSink()])
    tsrv = Server(read_config(data=data), device="cpu",
                  extra_sinks=[CaptureSink()])
    return jsrv, tsrv


def _datagrams(seed: int, n: int = 24) -> list[list[bytes]]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        lines = [b"c%d:%d|c" % (j % 7, j) for j in range(i % 4)]
        lines += [b"t%d:%.3f|ms" % (j % 5, v)
                  for j, v in enumerate(rng.gamma(2.0, 30.0, 6 + i % 9))]
        lines += [b"g%d:%d|g" % (i % 3, i), b"u:m%d|s" % i]
        if i % 5 == 0:
            lines += [b"_sc|chk%d|%d" % (i % 2, i % 3), b"not a line",
                      b"_e{1,1}:a|b"]
        if i % 7 == 0:
            lines += [b"tg:%d|ms|#veneurglobalonly" % i,
                      b"cg:1|c|#veneurglobalonly"]
        out.append([b"\n".join(lines[k::2]) for k in range(2)])
    return out


def _feed(jsrv, tsrv, batches, shards: int = 0):
    parser = jcolumnar.ColumnarParser()
    jshards = [jsrv.table.make_reader_shard() for _ in range(shards)]
    tshards = [tsrv.table.make_reader_shard() for _ in range(shards)]
    for i, pkts in enumerate(batches):
        if shards:
            jsrv.handle_packet_batch(pkts, parser,
                                     shard=jshards[i % shards])
            tsrv.handle_packet_batch(pkts, shard=tshards[i % shards])
        else:
            jsrv.handle_packet_batch(pkts, parser)
            tsrv.handle_packet_batch(pkts)


def _flush_both(jsrv, tsrv, n: int = 3):
    accts = []
    for _ in range(n):
        j, t = jsrv.flush_once(), tsrv.flush_once()
        accts.append((j.row_accounting, t.row_accounting))
    return accts


def _assert_same_records(jsrv, tsrv, accts):
    jr = [_no_clock(r.to_dict()) for r in jsrv.ledger.records()]
    tr = [_no_clock(r.to_dict()) for r in tsrv.ledger.records()]
    assert len(tr) == len(jr) == len(accts)
    for k, (j, t) in enumerate(zip(jr, tr)):
        assert t == j, (k, {f: (t[f], j[f]) for f in j if t[f] != j[f]})
        assert t["balanced"], t
    for j, t in accts:
        assert t == j
    assert tsrv.ledger.summary() == jsrv.ledger.summary()
    return tr


@pytest.mark.parametrize("variant", ["pipelined", "serial",
                                     "four_readers", "overflow",
                                     "tiered", "local"])
def test_packet_ledger_records_match_jax(variant, monkeypatch,
                                         zero_compile_counters):
    """Datagrams through ``handle_packet_batch`` (one reader, or four
    reader shards), then three flushes: the data interval and two of
    loopback self-telemetry.  Every sealed record equals the JAX
    server's and balances."""
    cfg, shards = {}, 0
    if variant == "serial":
        cfg["tpu_pipeline"] = False
    elif variant == "four_readers":
        cfg["num_readers"], shards = 4, 4
    elif variant == "overflow":
        cfg.update(tpu_counter_rows=4, tpu_histo_rows=4, tpu_set_rows=2)
    elif variant == "tiered":
        monkeypatch.setenv("VENEUR_TPU_PLANE_TIERS", "2")
        monkeypatch.setenv("VENEUR_TPU_PROMOTE_HISTO_SAMPLES", "16")
    elif variant == "local":
        cfg["forward_address"] = "http://127.0.0.1:9"  # nothing listens
    jsrv, tsrv = _pair(**cfg)
    try:
        if variant == "tiered":
            assert jsrv.table.tiers is not None
            assert tsrv.table.tiers is not None
        _feed(jsrv, tsrv, _datagrams(11), shards)
        accts = _flush_both(jsrv, tsrv)
        recs = _assert_same_records(jsrv, tsrv, accts)
    finally:
        jsrv.shutdown()
        tsrv.shutdown()
    assert recs[0]["received"]["dogstatsd"] > 0
    assert recs[1]["received"]["self-telemetry"] > 0
    if variant == "overflow":
        assert recs[0]["dropped"]["overflow"] > 0
    if variant == "local":
        assert recs[0]["rows"]["forwarded"] > 0
        assert recs[0]["forward_wire"]["errors"] == 1
    if variant == "tiered":
        assert sum(r["tiers"]["promotions"] for r in recs) > 0


def _local_rows(seed: int, **cfg):
    """A local port server's forward rows for one interval."""
    srv = Server(read_config(data={
        "interval": "10s", "hostname": "l", **_ROWS,
        "forward_address": "http://127.0.0.1:9", **cfg}), device="cpu")
    rng = np.random.default_rng(seed)
    lines = [b"lt%d:%.2f|ms" % (i % 9, v)
             for i, v in enumerate(rng.gamma(2.0, 30.0, 300))]
    lines += [b"lc%d:%d|c|#veneurglobalonly" % (i, i) for i in range(12)]
    lines += [b"lg%d:%d|g|#veneurglobalonly" % (i, i) for i in range(5)]
    lines += [b"ls:m%d|s" % i for i in range(40)]
    srv.handle_packet_batch([b"\n".join(lines[i:i + 20])
                             for i in range(0, len(lines), 20)])
    with srv.lock:
        snap = srv.table.swap()
    rows = srv.flusher.flush(snap).forward
    srv.shutdown()
    assert {r.kind for r in rows} == {"counter", "gauge", "histo", "set"}
    return rows


@pytest.mark.parametrize("wire", ["http_native", "http_reference",
                                  "grpc", "grpc_traced", "send_packet"])
def test_import_ledger_records_match_jax(wire, zero_compile_counters):
    """The same forward wires into a JAX global and a port global over
    ``/import`` (both schemas) or gRPC ``SendMetrics`` (with and
    without a trace context), and DogStatsD lines over gRPC
    ``SendPacket``: equal sealed records, received under the
    reference's protocol names (``SendPacket`` lines credit as
    ``dogstatsd``, as the reference's ``handle_packet`` credits them)."""
    rows = _local_rows(3)
    # started servers: an interval no run reaches, so only the test's
    # own flushes swap
    jsrv, tsrv = _pair(interval="300s", http_address="127.0.0.1:0",
                       grpc_listen_addresses=["tcp://127.0.0.1:0"],
                       tpu_counter_rows=8)
    try:
        jsrv.start()
        tsrv.start()
        for srv in (jsrv, tsrv):
            if wire.startswith("http"):
                enc = (http_import.encode_rows_reference
                       if wire == "http_reference"
                       else http_import.encode_rows)
                body, headers = enc(rows)
                headers = dict(headers)
                headers[http_import.TRACE_HEADER] = "77:88"
                req = urllib.request.Request(
                    f"http://127.0.0.1:{srv.http_port}/import",
                    data=body, headers=headers, method="POST")
                with urllib.request.urlopen(req, timeout=10) as r:
                    r.read()
            elif wire == "send_packet":
                with grpc.insecure_channel(
                        f"127.0.0.1:{srv.grpc_ports[0]}") as chan:
                    chan.unary_unary(
                        "/dogstatsd.DogstatsdGRPC/SendPacket",
                        request_serializer=dogstatsd_grpc_pb2
                        .DogstatsdPacket.SerializeToString,
                        response_deserializer=dogstatsd_grpc_pb2.Empty
                        .FromString)(dogstatsd_grpc_pb2.DogstatsdPacket(
                            packetBytes=b"sp.a:1|c\nsp.b:2|g\nsp.t:3|ms"
                                        b"\n_sc|sp.chk|1\nbad"),
                        timeout=10)
            else:
                client = grpc_forward.ForwardClient(
                    f"127.0.0.1:{srv.grpc_ports[0]}")
                try:
                    client.send(rows, trace_context=(
                        (77, 88) if wire == "grpc_traced" else None))
                finally:
                    client.close()
        if wire not in ("grpc", "send_packet"):
            # the import span reaches each span worker asynchronously;
            # it counts in spans_processed (it is no internal span)
            for srv in (jsrv, tsrv):
                _wait(lambda: srv.stats.get("spans_processed") == 1)
        accts = _flush_both(jsrv, tsrv)
        recs = _assert_same_records(jsrv, tsrv, accts)
        if wire == "send_packet":
            assert recs[0]["received"] == {"dogstatsd": 4}
            assert recs[0]["status"] == 1
            assert recs[0]["parse_errors"] == 1
            return
        proto = "http-import" if wire.startswith("http") else \
            "grpc-import"
        assert recs[0]["received"].get(proto) == len(rows), \
            [r["received"] for r in recs]
        assert recs[0]["dropped"]["overflow"] > 0  # 8 counter rows
        for srv in (jsrv, tsrv):
            imp = [s for s in srv.trace_index.get(77)
                   if s["name"] == "import"]
            if wire == "grpc":
                assert not imp
            else:
                assert len(imp) == 1 and imp[0]["parent_id"] == "88"
    finally:
        jsrv.shutdown()
        tsrv.shutdown()


def _wait(pred, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


# ---- the reference's scenarios on the port -------------------------------------

def _server(**cfg):
    return Server(read_config(data={"interval": "10s", "hostname": "h",
                                    **_ROWS, **cfg}), device="cpu")


def test_shard_parse_does_no_ledger_work():
    """A reader shard's lock-free parse leaves the open interval
    untouched; its credit lands at commit, under the ingest lock."""
    srv = _server(num_readers=2, tpu_counter_rows=1024)
    shard = srv._reader_shard()
    shard.parse(b"\n".join(b"np.%d:1|c" % i for i in range(500)))
    with srv.ledger._lock:
        assert srv.ledger._cur.received == {}
        assert srv.ledger._cur.staged == 0
    shard.reset()
    srv.handle_packet_batch([], drained=b"\n".join(
        b"np.%d:1|c" % i for i in range(500)), drained_pkts=1,
        shard=shard)
    srv.flush_once()
    rec = srv.ledger.last()
    srv.shutdown()
    assert rec.balanced and rec.received == {"dogstatsd": 500}


def test_concurrent_multireader_balances_exactly():
    """Four reader shards on real threads, with flushes racing them:
    every sealed interval balances, and the received total is every
    sample sent."""
    srv = _server(num_readers=4, tpu_counter_rows=1024)
    n_readers, per, chunk = 4, 6000, 250
    barrier = threading.Barrier(n_readers + 1)
    errs = []

    def reader(r):
        try:
            shard = srv._reader_shard()
            lines = [b"mrl.c.%d:2|c" % ((r * per + i) % 900)
                     for i in range(per)]
            barrier.wait()
            for j in range(0, per, chunk):
                srv.handle_packet_batch([b"\n".join(lines[j:j + chunk])],
                                        shard=shard)
        except Exception as e:  # reported below
            errs.append(e)

    threads = [threading.Thread(target=reader, args=(r,))
               for r in range(n_readers)]
    for t in threads:
        t.start()
    barrier.wait()
    for _ in range(3):
        srv.flush_once()
    for t in threads:
        t.join()
    srv.flush_once()
    recs = srv.ledger.records()
    srv.shutdown()
    assert not errs, errs
    assert all(r.balanced for r in recs), \
        [r.to_dict() for r in recs if not r.balanced]
    assert sum(r.received.get("dogstatsd", 0) for r in recs) == \
        n_readers * per


def test_strict_injected_drop_bumps_counter():
    """Strict mode: samples staged around the ledger are a staged drift
    the seal names, and the server counts the imbalance."""
    srv = _server(tpu_ledger_strict=True)
    assert srv.ledger.strict
    srv.handle_packet(b"good:1|c")
    with srv.lock:
        for i in range(3):
            srv.table.ingest(dsd.parse_metric(b"lost.%d:1|c" % i))
    srv.flush_once()
    rec = srv.ledger.last()
    srv.shutdown()
    assert not rec.balanced and rec.staged_drift == -3
    assert srv.stats["ledger_imbalance"] == 1
    assert srv.ledger.summary()["imbalanced"] == 1


def test_strict_key_from_env():
    cfg = read_config(data={}, env={"VENEUR_TPU_LEDGER_STRICT": "1"})
    assert cfg.tpu_ledger_strict is True
    jcfg = jread_config(data={}, env={"VENEUR_TPU_LEDGER_STRICT": "1"})
    assert jcfg.tpu_ledger_strict is True
