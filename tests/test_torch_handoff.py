"""The port's scale-out arc handoff against the reference's.

Port counterparts of the two handoff tests of
``tests/test_checkpoint_smoke.py`` (the row partition, a scale-out
that conserves the cluster's mass), each held to the JAX package: the
same rows split to the same members, and the flusher's handoff gate
forwards the same rows and emits the same metrics on both emits
(per row and columnar) as the JAX flusher.  Then scale-out across the
packages, both ways: a port global hands its departing arcs to a JAX
global, and a JAX global to a port global; in each, every series is
emitted exactly once cluster-wide and the union of the two flushes
equals one global's flush of the same datagrams (order-free values bit
for bit, percentiles within rtol 2e-3 / atol 1e-3: a handed-off digest
is merged once more on its new owner), but for the local-sample
aggregates of a handed-off histogram, which its new owner does not
emit (imported state; the reference's behaviour).  Servers run on the
CPU.
"""

from __future__ import annotations

import numpy as np
import pytest

from veneur_tpu.core.config import read_config as jread_config
from veneur_tpu.core.flusher import Flusher as JFlusher
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.core.table import MetricTable as JTable
from veneur_tpu.core.table import RowMeta as JRowMeta
from veneur_tpu.core.table import TableConfig as JTableConfig
from veneur_tpu.forward import handoff as jhandoff
from veneur_tpu.forward.ring import ConsistentRing as JRing
from veneur_tpu.protocol import columnar as jcolumnar
from veneur_tpu.sinks.simple import CaptureSink as JCaptureSink
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.flusher import Flusher
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.core.table import MetricTable, RowMeta, TableConfig
from veneur_tpu_torch.forward import handoff
from veneur_tpu_torch.forward.ring import ConsistentRing
from veneur_tpu_torch.protocol import columnar
from veneur_tpu_torch.protocol import dogstatsd as dsd
from veneur_tpu_torch.sinks.simple import CaptureSink

_ROWS = {"tpu_counter_rows": 512, "tpu_gauge_rows": 64,
         "tpu_histo_rows": 64, "tpu_set_rows": 16}
MEMBERS = ["a:1", "b:1", "c:1"]


class _Row:
    def __init__(self, meta):
        self.meta = meta


def _metas(cls, n: int) -> list:
    types = (dsd.COUNTER, dsd.GAUGE, dsd.TIMER, dsd.HISTOGRAM, dsd.SET)
    scopes = (dsd.SCOPE_DEFAULT, dsd.SCOPE_GLOBAL, dsd.SCOPE_LOCAL)
    return [cls(name=f"p.{i}", tags=(f"t:{i % 3}",) if i % 2 else (),
                scope=scopes[i % 3], type=types[i % 5])
            for i in range(n)]


def test_handoff_partition_conserves_rows():
    rows = [_Row(m) for m in _metas(RowMeta, 200)]
    jrows = [_Row(m) for m in _metas(JRowMeta, 200)]
    parts, kept = handoff.partition(rows, ConsistentRing(MEMBERS), "a:1")
    jparts, jkept = jhandoff.partition(jrows, JRing(MEMBERS), "a:1")
    assert kept == jkept
    assert {m: [r.meta.name for r in v] for m, v in parts.items()} == \
        {m: [r.meta.name for r in v] for m, v in jparts.items()}
    assert kept + sum(len(v) for v in parts.values()) == 200
    assert set(parts) <= {"b:1", "c:1"}
    ring = ConsistentRing(MEMBERS)
    for member, mrows in parts.items():
        for r in mrows:
            key = handoff.meta_route_key(r.meta)
            assert ring.get(key) == member
            assert key == jhandoff.meta_route_key(
                JRowMeta(name=r.meta.name, tags=r.meta.tags,
                         scope=r.meta.scope, type=r.meta.type))


def test_flusher_gate_matches_jax_gate():
    gate = handoff.make_flusher_gate(ConsistentRing(MEMBERS), "a:1")
    jgate = jhandoff.make_flusher_gate(JRing(MEMBERS), "a:1")
    for m, jm in zip(_metas(RowMeta, 120), _metas(JRowMeta, 120)):
        assert gate(m) == jgate(jm)
        if m.scope == dsd.SCOPE_LOCAL:
            assert not gate(m)


def _global_text(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    lines = [b"ho.c.%d:%d|c" % (i, i) for i in range(120)]
    lines += [b"ho.g.%d:%d|g" % (i, i) for i in range(30)]
    lines += [b"ho.h.%d:%r|h" % (i % 16, float(v))
              for i, v in enumerate(rng.gamma(2.0, 30.0, 640))]
    lines += [b"ho.s.%d:u%d|s" % (i % 8, i) for i in range(256)]
    lines += [b"ho.l.%d:1|c|#veneurlocalonly" % i for i in range(4)]
    return b"\n".join(lines)


@pytest.mark.parametrize("columnar_emit", [True, False],
                         ids=["columnar", "per_row"])
def test_flusher_handoff_emit_matches_jax(columnar_emit):
    """A global's flush with the handoff gate: the forwarded rows (and
    only them) leave, the rest emit, on both emits, as the JAX
    flusher's; a handed-off row is never emitted too."""
    kw = dict(counter_rows=512, gauge_rows=64, histo_rows=64, set_rows=16)
    table = MetricTable(TableConfig(**kw), device="cpu")
    jtable = JTable(JTableConfig(**kw))
    text = _global_text(4)
    table.ingest_columns(columnar.ColumnarParser().parse(text, copy=True))
    jtable.ingest_columns(jcolumnar.ColumnarParser().parse(text, copy=True))
    fl = Flusher(device="cpu", columnar=columnar_emit)
    jfl = JFlusher(is_local=False, columnar=columnar_emit)
    fl.handoff = handoff.make_flusher_gate(ConsistentRing(MEMBERS), "a:1")
    jfl.handoff = jhandoff.make_flusher_gate(JRing(MEMBERS), "a:1")
    res = fl.flush(table.swap(), now=1)
    jres = jfl.flush(jtable.swap(), now=1)
    fwd = sorted((r.meta.name, r.kind) for r in res.forward)
    assert fwd == sorted((r.meta.name, r.kind) for r in jres.forward)
    assert 0 < len(fwd) < 120 + 30 + 16 + 8
    got = {m.name: m.value for m in res.metrics}
    want = {m.name: m.value for m in jres.metrics}
    assert set(got) == set(want)
    for name, v in want.items():
        if "percentile" in name:
            assert got[name] == pytest.approx(v, rel=2e-3, abs=1e-3)
        else:
            assert got[name] == v, name
    handed = {n for n, _k in fwd}
    for name in got:
        assert name not in handed
        assert not any(name.startswith(h + ".") for h in handed)
    assert res.row_accounting == jres.row_accounting


# ----------------------------------------------------------------------
# scale-out through real servers


def _cfg():
    return {"grpc_listen_addresses": ["tcp://127.0.0.1:0"],
            "statsd_listen_addresses": [], "interval": "30s",
            "hostname": "g", **_ROWS}


def _port_global(cap):
    g = Server(read_config(data=_cfg()), device="cpu", extra_sinks=[cap])
    g.start()
    return g


def _jax_global(cap):
    g = JServer(jread_config(data=_cfg()), extra_sinks=[cap])
    g.span_sinks.clear()
    g.span_worker.sinks.clear()
    g.start()
    return g


def _feed(g, text: bytes) -> None:
    for line in text.split(b"\n"):
        g.handle_packet(line)


def _user(metrics) -> dict:
    return {m.name: m.value for m in metrics
            if m.name.startswith("ho.")}


def _scale_out(make0, make1, cap0, cap1):
    """g0 holds the keyspace, then the ring grows to {g0, g1}: g0 hands
    g1 its arcs and both flush.  Returns (union, handoff stats, g0's
    and g1's last records)."""
    g0, g1 = make0(cap0), make1(cap1)
    try:
        addrs = [f"127.0.0.1:{g.grpc_ports[0]}" for g in (g0, g1)]
        _feed(g0, _global_text(9))
        stats = g0.arc_handoff(addrs, addrs[0])
        assert g0.flusher.handoff is None and g0._handoff_pending is None
        g1.flush_once()
        union: dict = {}
        for cap in (cap0, cap1):
            for name, v in _user(cap.metrics).items():
                assert name not in union, f"{name} emitted twice"
                union[name] = v
        g1_stats = dict(g1.stats)
        return union, stats, g0.ledger.last(), g1.ledger.last(), g1_stats
    finally:
        g0.shutdown()
        g1.shutdown()


def _single(make, cap) -> dict:
    g = make(cap)
    try:
        _feed(g, _global_text(9))
        g.flush_once()
        return _user(cap.metrics)
    finally:
        g.shutdown()


@pytest.mark.parametrize("direction", ["torch_to_torch", "torch_to_jax",
                                       "jax_to_torch"])
def test_arc_handoff_scale_out_conserves_cluster_mass(direction):
    makers = {"torch": (_port_global, CaptureSink),
              "jax": (_jax_global, JCaptureSink)}
    src, dst = direction.split("_to_")
    (make0, cap0), (make1, cap1) = makers[src], makers[dst]
    union, stats, rec0, rec1, g1_stats = _scale_out(
        make0, make1, cap0(), cap1())
    assert stats["wires"] == 1 and stats["errors"] == 0
    assert stats["moved_rows"] == stats["items"] > 0
    assert stats["kept_rows"] == 0
    assert rec0.sealed and rec0.balanced, rec0.to_dict()
    assert rec1.balanced, rec1.to_dict()
    assert rec1.received.get("grpc-import-handoff", 0) == stats["items"]
    assert rec1.reshard_received_items == stats["items"]
    assert g1_stats.get("handoff_items_received") == stats["items"]
    # the union equals one global's flush of the same datagrams
    # (on the new owner a handed-off histogram is imported state: it
    # emits its percentiles, not the local-sample aggregates, as in
    # the reference)
    want = _single(_jax_global, JCaptureSink())
    assert set(union) <= set(want)
    missing = set(want) - set(union)
    assert missing and all(
        n.startswith("ho.h.") and "percentile" not in n for n in missing)
    for name, v in union.items():
        if "percentile" in name:
            assert v == pytest.approx(want[name], rel=2e-3, abs=1e-3)
        else:
            assert v == want[name], name
    assert sum(v for k, v in union.items()
               if k.startswith("ho.c.")) == sum(range(120))


def test_arc_handoff_disabled_is_a_noop():
    cfg = dict(_cfg(), tpu_arc_handoff=False)
    g = Server(read_config(data=cfg), device="cpu")
    try:
        assert g.arc_handoff(["a:1", "b:1"], "a:1") == {"enabled": False}
        assert g.flusher.handoff is None
    finally:
        g.shutdown()
