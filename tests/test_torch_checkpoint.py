"""The port's crash riding against the reference's: listener fd
adoption, staged-plane checkpoints and recovery.

Port counterparts of every test in ``tests/test_checkpoint_smoke.py``
but its two arc-handoff tests (those are in
``tests/test_torch_handoff.py``) and of
``tests/test_adaptive_planes.py::test_checkpoint_roundtrip_mixed_tier``.
Where the reference's test runs one package, this one runs both on the
same inputs, or crosses them: fds sent by one package's
``send_sockets`` are received by the other's, segments written by one
are read and scanned by the other, both packages' incarnation counters
share one directory.  Beside them:
- ``serialize_capture`` of one staged stream gives a ``MetricList``
  body byte-identical to the JAX package's;
- a checkpoint directory a JAX server wrote, recovered by a port
  server, flushes what a JAX server recovering a copy of it flushes
  (every value equal: the recovered wire goes through each package's
  import fold, one merge per row, which both run on the same
  centroids);
- a JAX local's recovery wire sent twice over gRPC to a port global is
  merged once (the second counted ``recovery_wires_deduped``);
- a port server SIGKILLed in a subprocess (``--device cpu``) recovers
  once.
Servers run on the CPU at small table sizes.
"""

from __future__ import annotations

import os
import shutil
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from veneur_tpu.core.config import read_config as jread_config
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.core.table import MetricTable as JTable
from veneur_tpu.core.table import TableConfig as JTableConfig
from veneur_tpu.forward import grpc_forward as jgf
from veneur_tpu.ops import checkpoint as jckpt
from veneur_tpu.ops import fdpass as jfdpass
from veneur_tpu.protocol import columnar as jcolumnar
from veneur_tpu.sinks.simple import CaptureSink as JCaptureSink
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.core.table import MetricTable, TableConfig
from veneur_tpu_torch.forward import http_import
from veneur_tpu_torch.ops import checkpoint as ckpt
from veneur_tpu_torch.ops import fdpass
from veneur_tpu_torch.protocol import columnar
from veneur_tpu_torch.sinks.simple import CaptureSink
from tests.torch_fixtures import unsampled_span_uniqueness  # noqa: F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ROWS = {"tpu_counter_rows": 256, "tpu_gauge_rows": 256,
         "tpu_histo_rows": 256, "tpu_set_rows": 16}


def _data(ckdir=None, interval="30s", **extra):
    data = {"statsd_listen_addresses": [], "grpc_listen_addresses": [],
            "interval": interval, "hostname": "ck", **_ROWS}
    if ckdir is not None:
        data["tpu_checkpoint_dir"] = str(ckdir)
        data["tpu_checkpoint_interval"] = "30s"  # run_once by hand
    data.update(extra)
    return data


def _server(ckdir=None, cap=None, **extra):
    s = Server(read_config(data=_data(ckdir, **extra)), device="cpu",
               extra_sinks=[cap] if cap is not None else [])
    s.start()
    return s


def _jserver(ckdir=None, cap=None, **extra):
    s = JServer(jread_config(data=_data(ckdir, **extra)),
                extra_sinks=[cap] if cap is not None else [])
    s.start()
    return s


def _user(metrics) -> dict:
    return {(m.name, m.type): m.value for m in metrics
            if not m.name.startswith("veneur.")}


def _assert_flush_equal(got: dict, want: dict) -> None:
    """Order-free values bit for bit, percentiles within rtol 2e-3 /
    atol 1e-3."""
    assert set(got) == set(want)
    for key, v in want.items():
        if "percentile" in key[0]:
            assert got[key] == pytest.approx(v, rel=2e-3, abs=1e-3), key
        else:
            assert got[key] == v, key


# ----------------------------------------------------------------------
# fdpass mechanics


def test_cloak_roundtrip_and_fail_open():
    for mod in (fdpass, jfdpass):
        enc = mod.encode_cloak({"statsd.udp.0.0": 7, "http": 9})
        assert enc == jfdpass.encode_cloak({"statsd.udp.0.0": 7,
                                            "http": 9})
        assert mod.parse_cloak(enc) == {"statsd.udp.0.0": 7, "http": 9}
        assert mod.parse_cloak("junk,=3,x=,y=-1,ok=4") == {"ok": 4}
        assert mod.parse_cloak("") == {}
        for bad in ({"a=b": 1}, {"a": -1}):
            with pytest.raises(ValueError):
                mod.encode_cloak(bad)
    assert fdpass.ENV_VAR == jfdpass.ENV_VAR


@pytest.mark.parametrize("sender,receiver", [(fdpass, jfdpass),
                                             (jfdpass, fdpass)])
def test_scm_rights_moves_a_live_udp_socket(sender, receiver):
    """One package sends the fd, the other receives and adopts it; the
    datagram parked in the kernel queue before the handoff is read."""
    udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    udp.bind(("127.0.0.1", 0))
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    tx.sendto(b"parked:1|c", udp.getsockname())
    a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        sender.send_sockets(a, {"statsd.udp.0.0": udp.fileno()})
        got = receiver.recv_sockets(b)
        assert list(got) == ["statsd.udp.0.0"]
        adopted = fdpass.adopt_socket(got["statsd.udp.0.0"])
        udp.close()
        adopted.settimeout(5.0)
        assert adopted.recv(1024) == b"parked:1|c"
        adopted.close()
    finally:
        a.close()
        b.close()
        tx.close()


def test_server_adopts_cloaked_udp_listener(monkeypatch):
    udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    udp.bind(("127.0.0.1", 0))
    port = udp.getsockname()[1]
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    tx.sendto(b"adopt.live:7|c", ("127.0.0.1", port))
    monkeypatch.setenv(fdpass.ENV_VAR,
                       fdpass.socket_cloak({"statsd.udp.0.0": udp}))
    s = _server(statsd_listen_addresses=["udp://127.0.0.1:0"])
    try:
        assert s.restarts_adopted == 1
        assert s.statsd_ports == [port]
        assert "statsd.udp.0.0" in s._cloak_slots
        assert s.stats.get("listener_fds_adopted") == 1
        deadline = time.time() + 10
        while time.time() < deadline and \
                s.stats.get("packets_received", 0) < 1:
            time.sleep(0.02)
        assert s.stats.get("packets_received", 0) >= 1, \
            "parked datagram lost across adoption"
        assert s.debug_vars()["restarts_adopted"] == 1
    finally:
        udp.close()
        tx.close()
        s.shutdown()


# ----------------------------------------------------------------------
# segment file mechanics


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_segment_roundtrip_rejects_torn_and_corrupt(tmp_path, writer):
    d = str(tmp_path)
    w = ckpt if writer == "torch" else jckpt
    body = b"x" * 257
    path = w.write_segment(
        d, {"incarnation": 1, "seq": 3, "gen": 2, "wall": time.time(),
            "items": 9}, body)
    for mod in (ckpt, jckpt):
        seg = mod.read_segment(path)
        assert seg is not None and seg.body == body
        assert seg.recovery_id == "1:3"
    blob = open(path, "rb").read()
    torn = os.path.join(d, ckpt.segment_name(1, 4))
    with open(torn, "wb") as f:
        f.write(blob[:-10])
    rot = os.path.join(d, ckpt.segment_name(1, 5))
    with open(rot, "wb") as f:
        f.write(blob[:-1] + b"y")
    for mod in (ckpt, jckpt):
        assert mod.read_segment(torn) is None
        assert mod.read_segment(rot) is None
        segs = mod.scan_recoverable(d, self_incarnation=2, max_age=60)
        assert [s.recovery_id for s in segs] == ["1:3"]


def test_scan_newest_per_gen_consumed_and_age(tmp_path):
    d = str(tmp_path)
    now = time.time()
    for seq in (1, 2):
        ckpt.write_segment(d, {"incarnation": 1, "seq": seq, "gen": 1,
                               "wall": now, "items": seq}, b"b")
    jckpt.write_segment(d, {"incarnation": 1, "seq": 3, "gen": 2,
                            "wall": now, "items": 3}, b"b")
    ckpt.write_segment(d, {"incarnation": 5, "seq": 1, "gen": 1,
                           "wall": now, "items": 1}, b"b")
    jckpt.write_segment(d, {"incarnation": 2, "seq": 1, "gen": 1,
                            "wall": now - 999, "items": 1}, b"b")

    def ids():
        got = [[s.recovery_id for s in mod.scan_recoverable(
            d, self_incarnation=5, max_age=60, now=now)]
            for mod in (ckpt, jckpt)]
        assert got[0] == got[1]
        return got[0]
    assert ids() == ["1:2", "1:3"]
    ckpt.mark_consumed(d, "1:2")
    assert jckpt.load_consumed(d) == ckpt.load_consumed(d) == {"1:2"}
    assert ids() == ["1:3"]


def test_incarnations_are_monotonic(tmp_path):
    """Both packages' counters on one directory: one sequence."""
    d = str(tmp_path)
    got = [mod.next_incarnation(d)
           for mod in (ckpt, jckpt, ckpt, jckpt)]
    assert got == [1, 2, 3, 4]


# ----------------------------------------------------------------------
# the capture and its wire


def _staged_lines(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(400):
        k = int(rng.integers(0, 4))
        if k == 0:
            lines.append(b"cap.c.%d:%d|c" % (i % 13, int(rng.integers(1, 9))))
        elif k == 1:
            lines.append(b"cap.g.%d:%r|g" % (i % 7, float(rng.normal())))
        elif k == 2:
            lines.append(b"cap.h.%d:%r|ms|#t:%d"
                         % (i % 5, float(rng.gamma(2.0, 30.0)), i % 2))
        else:
            lines.append(b"cap.s.%d:m%d|s" % (i % 3,
                                              int(rng.integers(0, 500))))
    return b"\n".join(lines)


def test_serialize_capture_matches_jax():
    """One staged stream (every class, a histogram row past the
    condense cap) in a port table and a JAX table: the capture's
    ``MetricList`` body is byte-identical, and so is its row count."""
    kw = dict(counter_rows=64, gauge_rows=64, histo_rows=64, set_rows=8)
    table = MetricTable(TableConfig(**kw), device="cpu")
    jtable = JTable(JTableConfig(**kw))
    text = _staged_lines(3)
    deep = b"\n".join(b"cap.deep:%d|ms" % v for v in range(1500))
    for t, p in ((table, columnar.ColumnarParser()),
                 (jtable, jcolumnar.ColumnarParser())):
        t.ingest_columns(p.parse(text, copy=True))
        t.ingest_columns(p.parse(deep, copy=True))
    cap, jcap = table.checkpoint_capture(), jtable.checkpoint_capture()
    assert cap["ingested"] == jcap["ingested"] == 1900
    assert cap["device_staged"] == jcap["device_staged"] == 0
    body, n = ckpt.serialize_capture(cap, table.capacity, 100.0)
    jbody, jn = jckpt.serialize_capture(jcap, jtable.capacity, 100.0)
    assert n == jn > 0
    assert body == jbody
    # nothing staged: no capture
    assert MetricTable(TableConfig(**kw),
                       device="cpu").checkpoint_capture() is None


# ----------------------------------------------------------------------
# in-process crash, recover, dedup


def _ingest_known_mass(s):
    for i in range(100):
        s.handle_packet(f"ck.c.{i % 10}:{i}|c".encode())
    for i in range(50):
        s.handle_packet(f"ck.h.{i % 5}:{i}|h".encode())
    for i in range(30):
        s.handle_packet(f"ck.s:u{i}|s".encode())


def test_checkpoint_recovery_lands_once_and_balances(tmp_path):
    d = str(tmp_path)
    s1 = _server(d)
    try:
        _ingest_known_mass(s1)
        assert s1._checkpointer.run_once()
        assert s1._checkpointer.stats["written"] == 1
    finally:
        s1.shutdown()  # stands in for the crash (the segment survives)
    jd = str(tmp_path / "jax")
    shutil.copytree(d, jd)

    cap = CaptureSink()
    s2 = _server(d, cap)
    try:
        assert s2.incarnation == s1.incarnation + 1
        assert s2.stats.get("recovery_segments_replayed", 0) == 1
        assert s2.stats.get("recovery_items_replayed", 0) == 180
        s2.flush_once()
        rec = s2.ledger.last()
        assert rec.sealed and rec.balanced, rec.to_dict()
        assert rec.recovered_by.get(f"incarnation:{s1.incarnation}", 0) > 0
        assert rec.recovered_owed == 0
        got = _user(cap.metrics)
    finally:
        s2.shutdown()
    # a JAX server recovering the same segment flushes the same values
    jcap = JCaptureSink()
    j2 = _jserver(jd, jcap)
    try:
        assert j2.stats.get("recovery_items_replayed", 0) == 180
        j2.flush_once()
        want = _user(jcap.metrics)
    finally:
        j2.shutdown()
    _assert_flush_equal(got, want)
    assert sum(v for (k, t), v in got.items()
               if k.startswith("ck.c.") and t == "counter") == 4950
    assert abs(got[("ck.s", "gauge")] - 30) <= 2
    for k in range(5):
        assert abs(got[(f"ck.h.{k}.50percentile", "gauge")]
                   - (22.5 + k)) < 1.0

    s3 = _server(d)
    try:
        assert s3.stats.get("recovery_segments_replayed", 0) == 0
    finally:
        s3.shutdown()


def test_jax_checkpoint_dir_recovered_by_port(tmp_path):
    """A JAX server's checkpoint directory: a port server recovering it
    flushes what a JAX server recovering a copy of it flushes."""
    d = str(tmp_path / "ck")
    j1 = _jserver(d)
    try:
        _ingest_known_mass(j1)
        for line in _staged_lines(5).split(b"\n"):
            j1.handle_packet(line)
        assert j1._checkpointer.run_once()
    finally:
        j1.shutdown()
    jd = str(tmp_path / "ck-jax")
    shutil.copytree(d, jd)
    cap, jcap = CaptureSink(), JCaptureSink()
    s2 = _server(d, cap)
    j2 = _jserver(jd, jcap)
    try:
        assert s2.incarnation == j2.incarnation == 2
        assert s2.stats.get("recovery_items_replayed") == \
            j2.stats.get("recovery_items_replayed") == 580
        s2.flush_once()
        j2.flush_once()
        rec = s2.ledger.last()
        assert rec.balanced and rec.recovered == j2.ledger.last().recovered
        _assert_flush_equal(_user(cap.metrics), _user(jcap.metrics))
    finally:
        s2.shutdown()
        j2.shutdown()


def test_recovery_wire_dedup_is_pinned(tmp_path):
    d = str(tmp_path)
    s1 = _server(d)
    try:
        for i in range(10):
            s1.handle_packet(f"dd.{i}:1|c".encode())
        assert s1._checkpointer.run_once()
        segs = ckpt.scan_recoverable(d, self_incarnation=99, max_age=60)
        assert len(segs) == 1
        seg = segs[0]
    finally:
        s1.shutdown()
    s2 = _server()
    try:
        s2._recover_local(seg, seg.recovery_id)
        s2._recover_local(seg, seg.recovery_id)
        assert s2.stats.get("recovery_wires_deduped", 0) == 1
        s2.flush_once()
        rec = s2.ledger.last()
        assert rec.balanced and rec.recovered == 10
        assert rec.received.get("checkpoint-recovery") == 10
    finally:
        s2.shutdown()


def test_jax_recovery_wire_twice_to_port_global_merges_once(tmp_path):
    """A JAX local's checkpoint replayed over gRPC, flagged recovery,
    sent twice to a port global (a retransmit): merged once, the
    retransmit counted deduped, the ledger's recover arm credited."""
    d = str(tmp_path)
    j1 = _jserver(d)
    try:
        _ingest_known_mass(j1)
        assert j1._checkpointer.run_once()
        seg = jckpt.scan_recoverable(d, self_incarnation=99,
                                     max_age=60)[0]
    finally:
        j1.shutdown()
    cap = CaptureSink()
    g = _server(cap=cap, grpc_listen_addresses=["tcp://127.0.0.1:0"])
    cli = jgf.ForwardClient(f"127.0.0.1:{g.grpc_ports[0]}")
    try:
        for _ in range(2):
            cli.send_wire(seg.body,
                          metadata=[(jgf.RECOVERY_KEY, seg.recovery_id)])
        assert g.stats.get("recovery_wires_received") == 1
        assert g.stats.get("recovery_wires_deduped") == 1
        g.flush_once()
        rec = g.ledger.last()
        assert rec.balanced, rec.to_dict()
        assert rec.received.get("grpc-import-recovery") == rec.recovered
        assert rec.recovered_by == {"incarnation:1": rec.recovered}
        got = _user(cap.metrics)
        assert sum(v for (k, t), v in got.items()
                   if k.startswith("ck.c.") and t == "counter") == 4950
        # once over /import too: the same id is already applied
        assert g.handle_import(b"[]", "", {
            http_import.RECOVERY_HEADER: seg.recovery_id}) == 0
        assert g.stats.get("recovery_wires_deduped") == 2
    finally:
        cli.close()
        g.shutdown()


# ----------------------------------------------------------------------
# a real SIGKILL of a port server, recovery against the same directory

_CHILD = r"""
import sys, time
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.server import Server
s = Server(read_config(data={
    "statsd_listen_addresses": [], "grpc_listen_addresses": [],
    "interval": "60s", "hostname": "child",
    "tpu_counter_rows": 256, "tpu_gauge_rows": 256,
    "tpu_histo_rows": 256, "tpu_set_rows": 16,
    "tpu_checkpoint_dir": sys.argv[1],
    "tpu_checkpoint_interval": "150ms"}), device=sys.argv[2])
s.start()
for i in range(100):
    s.handle_packet(f"kill.{i % 10}:{i}|c".encode())
print("READY", flush=True)
while True:
    time.sleep(1)
"""


def test_sigkill_midinterval_recovers_once(tmp_path):
    d = str(tmp_path)
    env = dict(os.environ)
    env.pop(fdpass.ENV_VAR, None)
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, d, "cpu"],
                            stdout=subprocess.PIPE, env=env, cwd=REPO)
    try:
        assert proc.stdout.readline().strip() == b"READY"
        deadline = time.time() + 30
        items = 0
        while time.time() < deadline and items < 100:
            for seg in ckpt.scan_recoverable(d, self_incarnation=0,
                                             max_age=60):
                items = max(items, int(seg.header.get("items", 0)))
            time.sleep(0.05)
        assert items == 100, f"checkpointer never covered mass: {items}"
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(10)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()

    cap = CaptureSink()
    s2 = _server(d, cap)
    try:
        assert s2.stats.get("recovery_segments_replayed", 0) == 1
        assert s2.stats.get("recovery_items_replayed", 0) == 100
        s2.flush_once()
        rec = s2.ledger.last()
        assert rec.sealed and rec.balanced, rec.to_dict()
        assert rec.recovered and rec.recovered_owed == 0
        assert sum(m.value for m in cap.metrics
                   if m.name.startswith("kill.")
                   and m.type == "counter") == sum(range(100))
    finally:
        s2.shutdown()
    s3 = _server(d)
    try:
        assert s3.stats.get("recovery_segments_replayed", 0) == 0
    finally:
        s3.shutdown()


# ----------------------------------------------------------------------
# mixed-tier staged state

TIER_ENV = {
    "VENEUR_TPU_PLANE_TIERS": "2",
    "VENEUR_TPU_PROMOTE_HISTO_SAMPLES": "16",
    "VENEUR_TPU_PROMOTE_SET_ENTRIES": "16",
    "VENEUR_TPU_DEMOTE_IDLE_INTERVALS": "1",
}


def test_checkpoint_roundtrip_mixed_tier(monkeypatch, tmp_path):
    """A tiered table's mid-interval capture (a wide hot row, compact
    cold rows, set members) recovers once, balanced, in both packages,
    and the two recovered flushes are equal."""
    for k, v in TIER_ENV.items():
        monkeypatch.setenv(k, v)
    tier = {"percentiles": [0.5], "aggregates": ["min", "max", "count"],
            "tpu_histo_rows": 1024, "tpu_set_rows": 512,
            "interval": "10s"}
    out = {}
    for k, mk, capcls in (("torch", _server, CaptureSink),
                          ("jax", _jserver, JCaptureSink)):
        d = str(tmp_path / k)
        s1 = mk(d, **tier)
        try:
            for ln in [b"ck.hot:%d|ms" % i for i in range(20)]:
                s1.handle_packet(ln)
            s1.flush_once()
            occ = s1.table.plane_bytes()["tiers"]["occupancy"]
            assert occ["histo"]["wide"] == 1
            for ln in ([b"ck.hot:%d|ms" % i for i in range(20)]
                       + [b"ck.cold:%d|ms" % i for i in range(5)]
                       + [b"ck.s:m%d|s" % i for i in range(12)]):
                s1.handle_packet(ln)
            assert s1._checkpointer.run_once()
        finally:
            s1.shutdown()
        cap = capcls()
        s2 = mk(d, cap, **tier)
        try:
            assert s2.stats.get("recovery_segments_replayed", 0) == 1
            s2.flush_once()
            rec = s2.ledger.last()
            assert rec.sealed and rec.balanced, rec.to_dict()
            assert rec.recovered > 0 and rec.recovered_owed == 0
            out[k] = _user(cap.metrics)
        finally:
            s2.shutdown()
    _assert_flush_equal(out["torch"], out["jax"])
    vals = {name: v for (name, _t), v in out["torch"].items()}
    assert vals["ck.hot.50percentile"] == pytest.approx(9.5, abs=1.0)
    assert vals["ck.cold.50percentile"] == pytest.approx(2.0, abs=1.0)
    assert vals["ck.s"] == pytest.approx(12, abs=1)
