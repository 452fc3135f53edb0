"""CPU parity of the port's sharded global forward, outage spool and
drain handoff against the JAX package.

``ShardedForwarder`` routing (columnar and per-row) against the JAX
forwarder on the same rows; live reshard (``set_members`` epochs, a
burst merged against the oldest ring, a retired member's worker and
client closed, about 1/M of the rows moved on a scale-out);
``WireSpool`` driven by one script and one injected clock in both
packages, in memory and on disk; the drain wire through an open
breaker; then the whole ride on real gRPC — a sharded local and two
globals, one global stopped and restarted on its port, the spool
replayed, a drain on shutdown — run by port servers on the CPU and by
JAX servers on the same stream and the same ports, with the same
counters, ledger protocols and flushes; and a global that never drains.

Tolerances (each comparison states its own): bodies, splits, counters,
ledgers and spool accounts exactly; flushed counters, gauges, counts,
min/max and set estimates exactly; sums to rtol 1e-6; percentiles to
rtol 2e-3 / atol 1e-3 (tests/test_pallas_merge.py).
"""

from __future__ import annotations

import socket
import threading
import time

import grpc
import numpy as np
import pytest

from veneur_tpu.core.config import read_config as jread_config
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.forward import shard as jshard
from veneur_tpu.forward import spool as jspool
from veneur_tpu.sinks.simple import CaptureSink as JCaptureSink
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.flusher import Flusher
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.core.table import MetricTable, TableConfig
from veneur_tpu_torch.forward import grpc_forward as gf
from veneur_tpu_torch.forward import shard, spool
from veneur_tpu_torch.sinks.simple import CaptureSink
from tests.torch_fixtures import unsampled_span_uniqueness  # noqa: F401


_WAIT = 15.0
_SRV = {"interval": "60s", "tpu_counter_rows": 256, "tpu_gauge_rows": 256,
        "tpu_histo_rows": 256, "tpu_set_rows": 16,
        "percentiles": [0.5, 0.9, 0.99],
        "aggregates": ["min", "max", "count", "sum"]}


def _wait_for(pred, what, timeout=_WAIT):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


def _lines(seed: int, n: int = 60) -> list[bytes]:
    """One interval of a local's traffic: global-only counters, gauges
    and timers (tagged and not), local timers and sets."""
    rng = np.random.default_rng(seed)
    out = [b"gc%d:%d|c|#veneurglobalonly" % (i, rng.integers(1, 9))
           for i in range(n)]
    out += [b"gg%d:%.3f|g|#veneurglobalonly" % (i, rng.normal())
            for i in range(n // 2)]
    for i in range(n // 3):
        tags = b",k:v" if i % 2 else b""
        out += [b"gt%d:%.3f|ms|#veneurglobalonly%s" % (i, v, tags)
                for v in rng.gamma(2.0, 30.0, 12)]
        out += [b"t%d:%.3f|ms" % (i, v) for v in rng.gamma(2.0, 30.0, 12)]
    out += [b"s%d:m%d|s" % (i % 6, j) for i, j in
            enumerate(rng.integers(0, 500, 200))]
    return out


def _packets(lines):
    return [b"\n".join(lines[i:i + 120]) for i in range(0, len(lines), 120)]


def _rows(seed: int = 0):
    t = MetricTable(TableConfig(counter_rows=256, gauge_rows=256,
                                histo_rows=256, set_rows=16), device="cpu")
    t.ingest_buffer(b"\n".join(_lines(seed)))
    return Flusher(is_local=True, device="cpu").flush(t.swap(),
                                                      now=1).forward


MEMBERS = ("10.0.0.1:8128", "10.0.0.2:8128", "10.0.0.3:8128")


@pytest.mark.parametrize("m", [1, 2, 3])
def test_sharded_routing_matches_jax(m):
    """``serialize``, ``route`` and ``route_rows_scalar`` equal the JAX
    forwarder's on the same rows; the per-row path assigns every row to
    the owner the columnar path does; with one member the routed body is
    the whole wire."""
    rows = _rows()
    fwd, jfwd = (shard.ShardedForwarder(MEMBERS[:m]),
                 jshard.ShardedForwarder(MEMBERS[:m]))
    try:
        data = fwd.serialize(rows)
        assert data == jfwd.serialize(rows)
        got, want = fwd.route(data), jfwd.route(data)
        assert (got.members, got.batches, got.routed, got.dropped) == \
            (want.members, want.batches, want.routed, want.dropped)
        scalar = fwd.route_rows_scalar(rows)
        assert scalar == jfwd.route_rows_scalar(rows)
        assert {d: n for d, _b, n in scalar} == \
            {got.members[d]: n for d, _b, n in got.batches}
        assert [shard.row_route_key(r) for r in rows] == \
            [jshard.row_route_key(r) for r in rows]
        if m == 1:
            assert got.batches == [(0, data, len(rows))]
    finally:
        fwd.stop()
        jfwd.stop()


def test_live_reshard_matches_jax():
    """Seeding is no reshard; ``set_members`` swaps epochs; two swaps
    before a take merge against the oldest ring; a departed member's
    worker and client close; a scale-out 2 -> 3 moves only the new
    member's rows, about 1/3 of them — the same in both packages."""
    rows = _rows(1)
    out = []
    for mod in (shard, jshard):
        fwd = mod.ShardedForwarder(("a:1", "b:1"))
        try:
            trace = [fwd.take_reshard(), fwd.reshards]
            data = fwd.serialize(rows)
            fwd.client("b:1")
            assert fwd.send("b:1", b"", 0)
            assert fwd.set_members(["a:1", "b:1", "c:1"])
            assert not fwd.set_members(["c:1", "b:1", "a:1"])
            epoch, added, removed, prev = fwd.take_reshard()
            new, old = fwd.route(data), fwd.route(data, ring=prev)
            newc = {new.members[d]: n for d, _b, n in new.batches}
            oldc = {old.members[d]: n for d, _b, n in old.batches}
            moved = sum(max(0, newc.get(k, 0) - oldc.get(k, 0))
                        for k in set(newc) | set(oldc))
            trace += [epoch, added, removed, prev.members, moved, newc]
            fwd.set_members(["a:1", "c:1"])
            fwd.set_members(["c:1", "d:1"])
            epoch, added, removed, prev = fwd.take_reshard()
            trace += [epoch, added, removed, prev.members,
                      sorted(fwd._clients), sorted(fwd.pool.stats()),
                      fwd.discovery_stats()["reshards"]]
            out.append(trace)
        finally:
            fwd.stop()
    assert out[0] == out[1]
    moved, newc = out[0][6], out[0][7]
    assert moved == newc["c:1"]
    assert 0.15 < moved / len(rows) < 0.55
    assert out[0][8:12] == [4, ["d:1"], ["a:1", "b:1"], ("a:1", "b:1", "c:1")]
    assert out[0][12] == [] and out[0][13] == []


def _spool_script(mod, tmp):
    """One sequence of spool calls on an injected clock; the trace of
    answers, stats and balances."""
    t = [0.0]
    sp = mod.WireSpool(max_bytes=40, max_age=10.0, dir=tmp,
                       clock=lambda: t[0])
    trace = []

    def snap(tag, out=None):
        st = dict(sp.stats())
        st.pop("incarnation", None)
        trace.append((tag, out, st, sp.check_balance(), sp.queued(),
                      sp.queued("d:1"), sp.queued_items()))

    snap("put", sp.put("d:1", b"a" * 8, 3))
    t[0] = 1.0
    snap("put", sp.put("d:2", b"b" * 8, 4))
    snap("put", sp.put("d:1", b"c" * 8, 5))
    snap("reject", sp.put("d:1", b"x" * 41, 9))
    t[0] = 2.0
    snap("cap", sp.put("d:2", b"d" * 20, 6))       # evicts the oldest
    e = sp.take("d:1")
    snap("take", (e.read(), e.n_items))
    sp.requeue(e)
    snap("requeue")
    e = sp.take("d:1")
    sp.mark_replayed(e)
    snap("replayed", e.n_items)
    t[0] = 15.0
    snap("put_d3", sp.put("d:3", b"e" * 4, 2))     # ages out d:2's wires
    e = sp.take("d:3")
    sp.discard(e, "age")
    snap("discard")
    sp.put("d:4", b"f" * 4, 1)
    snap("drop", sp.drop_dest("d:4"))
    t[0] = 30.0
    snap("sweep", sp.sweep())
    snap("take_none", sp.take("d:1"))
    return trace


@pytest.mark.parametrize("disk", [False, True], ids=["memory", "disk"])
def test_wire_spool_script_matches_jax(disk, tmp_path):
    """Put, reject, cap eviction, take, requeue, replay, age expiry,
    discard, drop and sweep answer the same in both spools, with the
    same stats and ``check_balance`` 0 after every step; on disk the
    segments are written and unlinked as the reference's."""
    tp = str(tmp_path / "t") if disk else None
    tj = str(tmp_path / "j") if disk else None
    got = _spool_script(spool, tp)
    want = _spool_script(jspool, tj)
    assert got == want
    assert all(step[3] == 0 for step in got)
    reasons = got[-1][2]["expired_by_reason"]
    assert reasons["cap"] > 0 and reasons["age"] > 0
    assert reasons["retired"] == 1 and reasons["orphan_age"] == 0
    assert spool.EXPIRE_REASONS == jspool.EXPIRE_REASONS


def test_spool_adopts_orphans_as_jax(tmp_path):
    """A spool directory left by a dead process is adopted at startup:
    its segments re-enter as spooled and replay to their destination."""
    out = []
    for mod, name in ((spool, "t"), (jspool, "j")):
        d = str(tmp_path / name)
        first = mod.WireSpool(dir=d)
        first.put("10.0.0.1:8128", b"w1", 3)
        first.put("10.0.0.1:8128", b"w2", 4)
        second = mod.WireSpool(dir=d)
        e = second.take("10.0.0.1:8128")
        out.append((second.adopted_wires, second.adopted_items,
                    e.read(), e.n_items, second.check_balance()))
    assert out[0] == out[1] == (2, 7, b"w1", 3, 0)


def test_drain_wire_bypasses_open_breaker_as_jax():
    """A wire's failure opens a threshold-1 breaker and spools it; a
    normal wire while open spools with no send attempt; a drain wire
    rides through the open breaker flagged drain, never spools, and its
    success replays the spool flagged replay — in both packages."""
    out = []
    for mod, smod in ((shard, spool), (jshard, jspool)):
        class FakeClient:
            def __init__(self):
                self.fail, self.calls, self.sent = True, 0, []

            def send_wire(self, body, timeout=None, metadata=None):
                self.calls += 1
                if self.fail:
                    raise RuntimeError("peer down")
                self.sent.append((body, dict(metadata or ())))

            def close(self):
                pass

        sp = smod.WireSpool()
        fwd = mod.ShardedForwarder(("d:1",), retries=0, breaker_threshold=1,
                                   breaker_cooldown=60.0, spool=sp)
        fwd._clients["d:1"] = fake = FakeClient()
        results = []

        def send(body, drain=False):
            done = threading.Event()
            assert fwd.send("d:1", body, 1, drain=drain,
                            on_result=lambda d, n, err, t:
                            (results.append(type(err).__name__
                                            if err else None), done.set()))
            assert done.wait(_WAIT)

        try:
            send(b"w1")
            state = fwd.breaker_states()["d:1"]["state"]
            send(b"w2")
            calls = fake.calls
            fake.fail = False
            send(b"w3", drain=True)
            _wait_for(lambda: sp.queued("d:1") == 0, "the replay")
            out.append((results, state, calls, fake.sent,
                        sp.check_balance(), fwd.totals()))
        finally:
            fwd.stop()
    assert out[0] == out[1]
    results, state, calls, sent, owed, tot = out[0]
    assert results == ["Spooled", "Spooled", None] and state == "open"
    assert calls == 1 and owed == 0 and tot["replayed_wires"] == 2
    assert sent[0] == (b"w3", {gf.DRAIN_KEY: "1"})
    assert [m for _b, m in sent[1:]] == [{gf.REPLAY_KEY: "1"}] * 2


# ---- the ride on real gRPC --------------------------------------------------

COOLDOWN_S = 4


class _HandClock:
    """A breaker clock that moves only when the ride advances it: the
    breaker B trips at interval 2 stays open through interval 3 however
    long the host takes, and reaches its cooldown when the ride says."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _hold_port(port: int) -> socket.socket:
    """Keep ``port`` out of the kernel's ephemeral picks between the
    rides: a bound, non-listening SO_REUSEPORT socket.  The gRPC
    listeners bind with SO_REUSEPORT too, so they still take the port;
    a port-0 bind elsewhere skips it."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    s.bind(("127.0.0.1", port))
    return s

def _start_global(server_cls, cfg_read, port, cap, **dev):
    """A global on ``port`` (0: any); a port just released may take a
    few tries to bind again."""
    deadline = time.monotonic() + _WAIT
    while True:
        try:
            g = server_cls(cfg_read(data=dict(
                _SRV, grpc_listen_addresses=[f"tcp://127.0.0.1:{port}"])),
                extra_sinks=[cap], **dev)
            g.start()
            return g
        except RuntimeError:
            assert time.monotonic() < deadline, f"bind 127.0.0.1:{port}"
            time.sleep(0.1)


def _ride(server_cls, cfg_read, cap_cls, ports=(0, 0), holds=None,
          **dev):
    """Interval 1 with both globals up; global B stopped for intervals
    2 and 3 (the breaker opens at 2's failed send, 3's wire spools at
    route time); B restarted on its port and, past the cooldown,
    interval 4's probe replays the spool; interval 5's samples staged
    and the local shut down (the drain).  The local's breakers run on a
    hand-advanced clock, so the ride follows its own events, not the
    host's speed; ``holds`` collects sockets that keep the globals'
    ports for B's restart and the next ride.  Returns the globals' flushed
    metrics, their counters and ledger protocols, the local's counters,
    its spool ledger and every ledger's balance."""
    caps = [cap_cls(), cap_cls(), cap_cls()]
    ga = _start_global(server_cls, cfg_read, ports[0], caps[0], **dev)
    gb = _start_global(server_cls, cfg_read, ports[1], caps[1], **dev)
    ports = (ga.grpc_ports[0], gb.grpc_ports[0])
    if holds is not None:
        # the ride restarts B on its port, and the next ride rebinds both
        holds.extend(_hold_port(p) for p in ports)
    gb2 = local = None
    try:
        local = server_cls(cfg_read(data=dict(
            _SRV, forward_use_grpc=True, tpu_sharded_global=True,
            forward_address=",".join(f"127.0.0.1:{p}" for p in ports),
            tpu_breaker_threshold=1,
            tpu_breaker_cooldown=f"{COOLDOWN_S}s")), **dev)
        b_addr = f"127.0.0.1:{ports[1]}"

        def interval(seed):
            for p in _packets(_lines(seed)):
                local.handle_packet(p)
            local.flush_once()

        interval(1)
        # the breakers run on a clock the ride advances by hand
        clock = _HandClock()
        for addr in (f"127.0.0.1:{p}" for p in ports):
            local._sharded_fwd.pool.breaker(addr)._clock = clock
        # both globals flush interval 1 before B stops (a global never
        # drains: what it had not flushed would be lost)
        ga.flush_once()
        gb.flush_once()
        epoch1 = list(caps[0].metrics) + list(caps[1].metrics)
        n_a1 = len(caps[0].metrics)
        gb.shutdown()
        b_stats = dict(gb.stats)
        b_imports = [r.received for r in gb.ledger.records()]
        interval(2)
        interval(3)
        breaker = local._sharded_fwd.breaker_states()[b_addr]["state"]
        spooled = local._sharded_fwd.spool_stats()["queued_wires"]
        gb2 = _start_global(server_cls, cfg_read, ports[1], caps[2], **dev)
        # the cooldown passes, and the cached channel leaves its
        # reconnect backoff
        clock.t += COOLDOWN_S
        assert local._sharded_fwd.pool.breaker(b_addr).would_allow()
        grpc.channel_ready_future(
            local._sharded_fwd.client(b_addr)._channel).result(_WAIT)
        interval(4)
        _wait_for(lambda: local._sharded_fwd.spool_stats()[
            "queued_wires"] == 0, "the spool's replay")
        _wait_for(lambda: gb2.stats.get("replay_wires_received", 0) ==
                  spooled, "the replayed wires at B")
        for p in _packets(_lines(5)):
            local.handle_packet(p)
        local.shutdown()
        sent = local.stats["forward_post_metrics"]
        _wait_for(lambda: ga.stats.get("imports_received", 0) +
                  b_stats.get("imports_received", 0) +
                  gb2.stats.get("imports_received", 0) == sent,
                  "every forwarded row")
        for g in (ga, gb2):
            g.flush_once()
        lstats = dict(local.stats)
        keys = ("forward_shard_wires", "forward_spooled_wires",
                "forward_spooled_items", "forward_spooled_async_items",
                "replay_wires_sent", "replay_items_sent",
                "drain_wires_sent", "drain_items_sent", "drain_flushes",
                "forward_errors", "metrics_dropped", "forward_post_metrics")
        gkeys = ("imports_received", "drain_wires_received",
                 "drain_items_received", "replay_wires_received",
                 "replay_items_received")
        protos = []
        for recs in ([r.received for r in ga.ledger.records()], b_imports,
                     [r.received for r in gb2.ledger.records()]):
            agg = {}
            for rec in recs:
                for k, v in rec.items():
                    if k.startswith("grpc-import"):
                        agg[k] = agg.get(k, 0) + v
            protos.append(agg)
        led = [r.balanced for g in (local, ga, gb2)
               for r in g.ledger.records()]
        user = lambda ms: [m for m in ms  # noqa: E731
                           if not m.name.startswith("veneur.")]
        return {
            "metrics": (user(epoch1), user(caps[0].metrics[n_a1:]
                                           + caps[2].metrics)),
            "local": {k: lstats.get(k, 0) for k in keys},
            "globals": [{k: s.get(k, 0) for k in gkeys}
                        for s in (dict(ga.stats), b_stats,
                                  dict(gb2.stats))],
            "protocols": protos, "breaker": breaker, "spooled": spooled,
            "spool_ledger": local._spool_ledger.summary(),
            "balanced": led, "ports": ports}
    finally:
        if local is not None:
            local.shutdown()
        for g in (ga, gb, gb2):
            if g is not None:
                g.shutdown()


def _no_outage(**dev):
    """The same five intervals into one port global, nothing lost; the
    global flushes after interval 1 and at the end, as the ride's
    globals do."""
    cap = CaptureSink()
    g = _start_global(Server, read_config, 0, cap, **dev)
    local = None
    try:
        local = Server(read_config(data=dict(
            _SRV, forward_use_grpc=True,
            forward_address=f"127.0.0.1:{g.grpc_ports[0]}")), **dev)
        epochs = []
        for seed in (1, 2, 3, 4, 5):
            for p in _packets(_lines(seed)):
                local.handle_packet(p)
            if seed < 5:
                local.flush_once()
            if seed == 1:
                g.flush_once()
                epochs.append(len(cap.metrics))
        local.shutdown()
        sent = local.stats["forward_post_metrics"]
        _wait_for(lambda: g.stats.get("imports_received", 0) == sent,
                  "every forwarded row")
        g.flush_once()
        user = [m for m in cap.metrics if not m.name.startswith("veneur.")]
        n1 = sum(1 for m in cap.metrics[:epochs[0]]
                 if not m.name.startswith("veneur."))
        return user[:n1], user[n1:]
    finally:
        if local is not None:
            local.shutdown()
        g.shutdown()


def _union(metrics):
    out = {}
    for m in metrics:
        key = (m.name, tuple(m.tags))
        assert key not in out, f"{key} flushed twice"
        out[key] = m.value
    return out


def _assert_same(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if key[0].endswith("percentile"):
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-3,
                                       err_msg=str(key))
        elif key[0].endswith(".sum"):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=str(key))
        else:
            assert g == w, (key, g, w)


def test_outage_ride_and_drain_match_jax():
    """The ride through port servers on the CPU, then through JAX
    servers on the same stream and the same ports: the same local
    counters (wires sharded, spooled at route time and after a failed
    send, replayed, drained), the same counters and ledger protocols
    at each global (``grpc-import``, ``grpc-import-replay``,
    ``grpc-import-drain``), the spool ledger ending with nothing queued
    and replayed + expired = spooled, every ledger sealed balanced, and
    the globals' union flush of each epoch (interval 1; intervals 2 to
    5) equal to the same intervals forwarded to one global with no
    outage, and to the JAX ride's."""
    holds = []
    try:
        got = _ride(Server, read_config, CaptureSink, device="cpu",
                    holds=holds)
        want = _ride(JServer, jread_config, JCaptureSink,
                     ports=got["ports"])
    finally:
        for h in holds:
            h.close()
    assert got["ports"] == want["ports"]
    for key in ("local", "globals", "protocols", "breaker", "spooled"):
        assert got[key] == want[key], key
    assert got["breaker"] == "open" and got["spooled"] >= 1
    loc = got["local"]
    assert loc["forward_spooled_wires"] >= 1
    assert loc["forward_spooled_async_items"] > 0
    assert loc["replay_wires_sent"] == got["spooled"] == 2
    assert loc["drain_wires_sent"] == 2 and loc["drain_flushes"] == 1
    assert loc["metrics_dropped"] == 0
    a, b_before, b_after = got["globals"]
    assert b_after["replay_wires_received"] == loc["replay_wires_sent"]
    assert a["drain_wires_received"] == b_after["drain_wires_received"] == 1
    assert set(got["protocols"][2]) == {"grpc-import",
                                        "grpc-import-replay",
                                        "grpc-import-drain"}
    sl = got["spool_ledger"]
    assert sl["queued_items"] == 0 and sl["inflight_items"] == 0
    assert sl["replayed_items"] + sl["expired_items"] == sl["spooled_items"]
    assert sl["imbalanced"] == 0
    assert all(got["balanced"]) and all(want["balanced"])
    # each flush epoch (interval 1; intervals 2-5 with the replays and
    # the drain) holds every series once across the globals
    for g, one, j in zip(got["metrics"], _no_outage(device="cpu"),
                         want["metrics"]):
        union = _union(g)
        _assert_same(union, _union(one))
        _assert_same(union, _union(j))


def test_global_never_drains():
    """A global has nowhere to hand off to: its shutdown runs no drain
    flush, as the JAX server's does not."""
    for server_cls, cfg_read, dev in ((Server, read_config,
                                       {"device": "cpu"}),
                                      (JServer, jread_config, {})):
        g = server_cls(cfg_read(data=dict(
            _SRV, grpc_listen_addresses=["tcp://127.0.0.1:0"])), **dev)
        g.start()
        g.handle_packet(b"g.local:1|c")
        g.shutdown()
        assert g.stats.get("drain_flushes", 0) == 0
        assert g.stats.get("flushes", 0) == 0


def test_drain_off_exits_without_handoff():
    """``tpu_drain_on_shutdown: false`` shuts a local down with no final
    flush; on by default it drains once."""
    for drain in (False, True):
        local = Server(read_config(data=dict(
            _SRV, forward_address="127.0.0.1:1",
            tpu_drain_on_shutdown=drain)), device="cpu")
        local.handle_packet(b"x:1|c|#veneurglobalonly")
        local.shutdown()
        assert local.stats.get("drain_flushes", 0) == int(drain)
        assert local.stats.get("flushes", 0) == int(drain)
