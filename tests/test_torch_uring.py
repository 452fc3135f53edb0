"""The io_uring ring tier of the UDP readers against the JAX server.

A port server on the CPU and a JAX server, each with
``tpu_ingest_backend: uring``, take the same seeded datagrams over
loopback: the flushed user metrics (counters, gauges, counts, min/max
and sets bit for bit, sums to rtol 1e-6, percentiles to rtol 2e-3 /
atol 1e-3), the receive counters and the sealed ledger record are equal.
``ReaderShard.parse_ring`` stages what ``parse`` stages from the same
datagrams, and the ring's buffers stay held until the release after
the commit.  The tier resolution (``python``, ``recvmmsg``, ``auto``,
and a refusal made by patching the probe in both packages, as the
reference's own tests make it) lands on the same tier with the same
counters and telemetry names.  A four-buffer pool runs out: its ENOBUFS
count reaches the interval's ledger record and the pressure tick's
kernel-drop input, and every datagram is still read.  A two-buffer pool,
which validation accepts, is refused by the ring's set-up in both
packages (its completion queue would be smaller than its submission
queue) and lands on recvmmsg, counted as ``einval``.  A ring that dies
at runtime leaves its reader on the recvmmsg tier, counted by reason.

Tests that need the ring skip only where the kernel refuses the probe.
"""

from __future__ import annotations

import errno
import socket
import time

import numpy as np
import pytest

from veneur_tpu.core.config import read_config as jread_config
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.native import uring as juring
from veneur_tpu.sinks.simple import CaptureSink as JCaptureSink
from veneur_tpu_torch import native
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.core.table import MetricTable, TableConfig
from veneur_tpu_torch.native import uring
from veneur_tpu_torch.sinks.simple import CaptureSink
from tests.torch_fixtures import unsampled_span_uniqueness  # noqa: F401

_ERR = uring.probe(native.load())
requires_uring = pytest.mark.skipif(
    _ERR != 0, reason=f"io_uring refused by this kernel (errno {-_ERR})")

_ROWS = {"tpu_counter_rows": 128, "tpu_gauge_rows": 128,
         "tpu_histo_rows": 128, "tpu_set_rows": 16}
_WAIT = 20.0


def _datagrams(seed: int, n: int = 120) -> list[bytes]:
    """Counters, gauges, timers (gamma(2, 30)) and sets in 8-line
    datagrams, with a scope tag, a service check, an event and a
    malformed line among them."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n * 8):
        kind = i % 5
        if kind == 0:
            lines.append(b"hits.%d:%d|c" % (i % 7, i % 4 + 1))
        elif kind == 1:
            lines.append(b"depth.%d:%d|g|#az:%d" % (i % 5, i, i % 2))
        elif kind in (2, 3):
            lines.append(b"lat.%d:%.4f|ms" % (i % 6, rng.gamma(2.0, 30.0)))
        else:
            lines.append(b"users:u%d|s" % (i % 37))
    lines[9] = b"not a metric line"
    lines[20] = b"g.hits:3|c|#veneurglobalonly"
    lines[31] = b"_sc|ring.check|1|#a:b"
    lines[42] = b"_e{5,4}:title|text"
    return [b"\n".join(lines[k:k + 8]) for k in range(0, len(lines), 8)]


def _config(read, **kw):
    return read(data={"interval": "60s", "hostname": "h", **_ROWS,
                      "statsd_listen_addresses": ["udp://127.0.0.1:0"],
                      "percentiles": [0.5, 0.99], **kw}, env={})


def _wait(pred, what):
    deadline = time.monotonic() + _WAIT
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def _send(port: int, dgrams: list[bytes], srv, key="received_dogstatsd-udp"):
    """Send ``dgrams`` to ``port`` paced on the server's receive
    counter (every 32 datagrams), so no datagram waits on a full pool."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for i, d in enumerate(dgrams):
            s.sendto(d, ("127.0.0.1", port))
            if i % 32 == 31:
                _wait(lambda: srv.stats.get(key, 0) >= i + 1, "paced read")
    finally:
        s.close()
    _wait(lambda: srv.stats.get(key, 0) == len(dgrams), "every datagram")


def _user(metrics) -> dict:
    return {(m.name, m.tags): (m.value, m.type) for m in metrics
            if not m.name.startswith("veneur.")}


_COUNTERS = ("packets_received", "packet_errors", "metrics_processed",
             "metrics_dropped", "received_dogstatsd-udp")


@requires_uring
@pytest.mark.parametrize("num_readers", [1, 2])
def test_uring_server_matches_jax(num_readers):
    dgrams = _datagrams(21)
    pair = [Server(_config(read_config, tpu_ingest_backend="uring",
                           num_readers=num_readers), device="cpu"),
            JServer(_config(jread_config, tpu_ingest_backend="uring",
                            num_readers=num_readers))]
    try:
        for srv in pair:
            srv.start()
            assert srv.ingest_backend == "uring"
            _send(srv.statsd_ports[0], dgrams, srv)
            assert len(srv._urings) == num_readers
        flushed = [srv.flush_once().metrics for srv in pair]
        stats = [{k: srv.stats.get(k, 0) for k in _COUNTERS}
                 for srv in pair]
        recs = [srv.ledger.records()[-1].to_dict() for srv in pair]
    finally:
        for srv in pair:
            srv.shutdown()
    assert stats[0] == stats[1]
    assert stats[0]["packets_received"] == len(dgrams)
    assert stats[0]["packet_errors"] == 1
    for field in ("received", "balanced", "status", "dropped",
                  "parse_errors"):
        assert recs[0][field] == recs[1][field], field
    assert recs[0]["balanced"]
    got, want = (_user(m) for m in flushed)
    assert got.keys() == want.keys()
    assert ("ring.check", ("a:b",)) in got
    for key, (w, wtype) in want.items():
        g, gtype = got[key]
        assert gtype == wtype, key
        if key[0].endswith(("percentile", ".median")):
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-3,
                                       err_msg=str(key))
        elif key[0].endswith((".sum", ".avg", ".hmean")):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=str(key))
        else:
            assert g == w, key


def _staging(t: MetricTable) -> dict:
    h = t._histo_stage
    return dict(
        counter=t._counter_dense.copy(), gauge=t._gauge_dense.copy(),
        gauge_mask=t._gauge_mask.copy(),
        meta=[[(m.name, m.tags, m.scope) for m in i.meta]
              for i in (t.counter_idx, t.gauge_idx, t.histo_idx,
                        t.set_idx)],
        histo=[np.concatenate(x) for x in (h.rows, h.values, h.weights)],
        sets=[np.concatenate(x) for x in (t._set_pos_rows, t._set_pos)],
        staged=t.staged())


@requires_uring
def test_parse_ring_stages_as_parse():
    """The same datagrams through ``parse_ring`` (in place in the arena)
    and through ``parse`` of their newline-joined bytes: the same
    commit results and the same staging.  Every buffer a walk parsed
    stays out of the pool through the commit (the slow-path lines are
    sliced from the arena then) and is back after the release."""
    dgrams = _datagrams(5, 40)
    cfg = TableConfig(counter_rows=64, gauge_rows=64, histo_rows=64,
                      set_rows=8)
    ring_t, buf_t = (MetricTable(cfg, device="cpu") for _ in range(2))
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    ring = uring.UringReader(native.load(), rx.fileno(), 64, 4097)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    shard, other = ring_t.make_reader_shard(), buf_t.make_reader_shard()
    slow_ring, slow_buf = [], []
    try:
        for d in dgrams:
            tx.sendto(d, rx.getsockname())
        n = 0
        while n < len(dgrams):
            _nb, m, nov, neb = shard.parse_ring(ring, 16, 4096, 200, 1)
            assert (nov, neb) == (0, 0)
            if not m:
                continue
            assert ring.stats()["held_bufs"] == m
            got = shard.commit()
            assert ring.stats()["held_bufs"] == m, "held through commit"
            src = shard.last_slow_src
            slow_ring += [src[o:o + ln].tobytes() for o, ln, _k in got[2]]
            shard.reset()
            ring.release()
            assert ring.stats()["held_bufs"] == 0
            buf = b"\n".join(dgrams[n:n + m])
            other.parse(buf)
            want = other.commit()
            slow_buf += [buf[o:o + ln] for o, ln, _k in want[2]]
            other.reset()
            assert got[:2] == want[:2]
            assert [k for _o, _l, k in got[2]] == [k for _o, _l, k
                                                   in want[2]]
            n += m
    finally:
        ring.close()
        rx.close()
        tx.close()
    assert slow_ring == slow_buf and len(slow_ring) == 3
    a, b = _staging(ring_t), _staging(buf_t)
    for k in a:
        if isinstance(a[k], list) and a[k] and isinstance(a[k][0],
                                                          np.ndarray):
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y, err_msg=k)
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _tier_pair(monkeypatch, mode: str, refuse: int | None):
    if refuse is not None:
        monkeypatch.setattr(uring, "probe", lambda lib: refuse)
        monkeypatch.setattr(juring, "probe", lambda lib: refuse)
    caps = [CaptureSink(), JCaptureSink()]
    pair = [Server(_config(read_config, tpu_ingest_backend=mode,
                           num_readers=2), device="cpu",
                   extra_sinks=[caps[0]]),
            JServer(_config(jread_config, tpu_ingest_backend=mode,
                            num_readers=2), extra_sinks=[caps[1]])]
    return pair, caps


@pytest.mark.parametrize("mode,refuse", [
    ("python", None), ("recvmmsg", None), ("auto", None),
    ("uring", -errno.EPERM), ("auto", -errno.ENOSYS)])
def test_tier_resolution_matches_jax(monkeypatch, mode, refuse):
    """Each mode resolves to the JAX server's tier, with the same
    fallback counters (one a refusal, not one a reader) and the same
    ``veneur.socket.*`` telemetry; the readers still ingest."""
    if refuse is None and mode == "auto" and _ERR != 0:
        refuse = _ERR  # this kernel refuses: auto is a refusal here
    pair, caps = _tier_pair(monkeypatch, mode, refuse)
    try:
        for srv in pair:
            srv.start()
            _send(srv.statsd_ports[0], [b"alive:3|c", b"t:1|ms"], srv)
        resolved = [srv.ingest_backend for srv in pair]
        fb = [{k: v for k, v in srv.stats.items()
               if k.startswith("socket_backend_fallback")} for srv in pair]
        for srv in pair:
            srv.flush_once()
            srv.flush_once()  # telemetry of the first lands in the second
        names = [sorted({(m.name, m.tags, m.value) for m in cap.metrics
                         if m.name.startswith("veneur.socket.")})
                 for cap in caps]
        alive = [[m.value for m in cap.metrics if m.name == "alive"]
                 for cap in caps]
        dvars = pair[0].debug_vars()["sockets"]
    finally:
        for srv in pair:
            srv.shutdown()
    assert resolved[0] == resolved[1]
    want = {"python": "python", "recvmmsg": "recvmmsg",
            "auto": "uring" if refuse is None else "recvmmsg",
            "uring": "recvmmsg"}[mode]
    assert resolved[0] == want
    assert fb[0] == fb[1]
    if refuse is not None:
        reason = uring.probe_reason(refuse)
        assert fb[0] == {"socket_backend_fallback": 1,
                         f"socket_backend_fallback_{reason}": 1}
        assert ("veneur.socket.backend_fallback_total",
                (f"reason:{reason}",), 1.0) in names[0]
        assert dvars["uring_probe_errno"] == -refuse
    else:
        assert fb[0] == {}
    assert names[0] == names[1]
    assert dvars["backend"] == want
    assert (dvars["uring"] is not None) == (want == "uring")
    assert alive == [[3.0], [3.0]]


@requires_uring
def test_two_buffer_pool_refused_as_jax():
    pair = [Server(_config(read_config, tpu_ingest_backend="uring",
                           tpu_uring_buffers=2), device="cpu"),
            JServer(_config(jread_config, tpu_ingest_backend="uring",
                            tpu_uring_buffers=2))]
    try:
        for srv in pair:
            srv.start()
            _wait(lambda: srv.stats.get("socket_backend_fallback_einval",
                                        0) == 1, "the set-up refusal")
            _send(srv.statsd_ports[0], [b"tiny:1|c"], srv)
        fb = [{k: v for k, v in srv.stats.items()
               if k.startswith("socket_backend_fallback")} for srv in pair]
    finally:
        for srv in pair:
            srv.shutdown()
    assert fb[0] == fb[1] == {"socket_backend_fallback": 1,
                              "socket_backend_fallback_einval": 1}
    assert [srv.ingest_backend for srv in pair] == ["uring", "uring"]


@requires_uring
def test_enobufs_reaches_the_ledger_and_the_pressure_tick():
    """A four-buffer pool: with the reader held at its commit (the
    server's lock taken), the pool fills and the multishot receive ends
    with ENOBUFS.  The datagrams wait in the socket and are all read
    once the lock goes; the ENOBUFS count is the interval's kernel
    drops in the ledger and the pressure tick's drop input."""
    srv = Server(_config(read_config, tpu_ingest_backend="uring",
                         tpu_uring_buffers=4), device="cpu")
    ticks = []
    tick = srv.overload.tick

    def spy(**kw):
        ticks.append(kw["socket_drop_delta"])
        return tick(**kw)
    srv.overload.tick = spy
    srv.start()
    n = 40
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        with srv.lock:
            for i in range(n):
                s.sendto(b"eb.%d:1|c" % (i % 3), ("127.0.0.1",
                                                  srv.statsd_ports[0]))
            time.sleep(0.3)  # the reader reaches the commit and waits
        s.close()
        _wait(lambda: srv.stats.get("received_dogstatsd-udp", 0) == n,
              "every datagram read")
        eb = srv.stats.get("socket_uring_enobufs", 0)
        kd = srv.stats.get("socket_kernel_drops", 0)
        res = srv.flush_once()
        rec = srv.ledger.records()[-1]
        ring = next(iter(srv._urings.values())).stats()
        dvars = srv.debug_vars()["sockets"]
    finally:
        srv.shutdown()
    assert eb >= 1 and ring["enobufs"] == eb
    assert dvars["uring_enobufs_total"] == eb
    assert rec.kernel_drops == eb + kd
    assert ticks == [eb + kd]
    assert rec.balanced
    got = {m.name: m.value for m in res.metrics}
    assert sum(got[f"eb.{i}"] for i in range(3)) == n


@requires_uring
def test_ring_dead_at_runtime_falls_back_to_recvmmsg(monkeypatch):
    """A ring whose walk fails (here: EPERM on the first call, as a
    seccomp filter would) ends: the reader goes on with the recvmmsg
    sweep on the same socket, the fallback counted by reason, and the
    datagrams sent after it are all read."""
    from veneur_tpu_torch.core import table as tablemod

    def dead(self, ring, *a, **kw):
        raise uring.UringError(-errno.EPERM, "io_uring parse")
    monkeypatch.setattr(tablemod.ReaderShard, "parse_ring", dead)
    cap = CaptureSink()
    srv = Server(_config(read_config, tpu_ingest_backend="uring"),
                 device="cpu", extra_sinks=[cap])
    srv.start()
    try:
        assert srv.ingest_backend == "uring"
        _wait(lambda: srv.stats.get("socket_backend_fallback_eperm", 0)
              == 1, "the fallback")
        assert not srv._urings
        _send(srv.statsd_ports[0], _datagrams(3, 40), srv)
        srv.flush_once()
    finally:
        srv.shutdown()
    assert srv.stats["socket_backend_fallback"] == 1
    assert srv.ledger.records()[-1].balanced
    assert any(m.name == "users" for m in cap.metrics)
