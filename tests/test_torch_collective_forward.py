"""The port's collective forward against the reference's.

Twins of ``tests/test_collective_forward.py``:

- **The byte format.** ``pack_block`` of the port and of the JAX
  package give the same bytes for the same rows; a JAX-packed block
  folded into a port table stages exactly what the JAX fold stages.
- **Bit parity.** A block packed by ``pack_block`` and folded by
  ``fold_block`` leaves the port table bit-identical to the port's
  gRPC-wire oracle (``apply_metric_list_bytes``) on the same rows.
- **Fail-open.** A deadline or an exchange failure raises
  ``CollectiveExchangeError``; a server re-routes the whole cycle's
  peer rows onto the wire, counted as ``collective_forward_fallbacks``,
  and a late landing is handed on, never dropped.
- **Conservation.** The interval seals on forwarded == wire split +
  collective split; a reshard credits moved arcs on both transports;
  the drain never takes the collective.

The exchange is a loopback hub or a failure injector here;
``test_torch_distributed.py`` runs the real ``all_to_all_single`` over
gloo between two processes.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from veneur_tpu.core.flusher import ForwardRow as JForwardRow
from veneur_tpu.core.table import MetricTable as JTable
from veneur_tpu.core.table import RowMeta as JRowMeta
from veneur_tpu.core.table import TableConfig as JTableConfig
from veneur_tpu.parallel import collective_forward as jplanes
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.flusher import ForwardRow
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.core.table import MetricTable, RowMeta, TableConfig
from veneur_tpu_torch.forward.collective import (CollectiveExchangeError,
                                                 CollectiveTransport,
                                                 parse_peers)
from veneur_tpu_torch.forward.grpc_forward import (apply_metric_list_bytes,
                                                   rows_to_metric_list)
from veneur_tpu_torch.ops import hll
from veneur_tpu_torch.parallel import collective_forward as cplanes
from veneur_tpu_torch.protocol import dogstatsd as dsd
from veneur_tpu_torch.sinks.simple import CaptureSink


def _meta(name, mtype, tags=(), scope=dsd.SCOPE_DEFAULT, cls=RowMeta):
    return cls(name=name, tags=tuple(tags), scope=scope, type=mtype)


def mixed_rows(n_counter=24, n_gauge=12, n_histo=8, n_set=4, seed=3,
               jax_rows=False):
    """Deterministic rows of all four classes (port ForwardRows, or the
    reference's with ``jax_rows``)."""
    row_cls = JForwardRow if jax_rows else ForwardRow
    meta_cls = JRowMeta if jax_rows else RowMeta
    rng = np.random.default_rng(seed)
    C = 616  # capacity_for(100.0)
    rows = []
    for i in range(n_counter):
        rows.append(row_cls(
            _meta(f"coll.ctr.{i}", dsd.COUNTER, (f"k:{i % 5}",),
                  cls=meta_cls), "counter", value=float(i * 3 + 1)))
    for i in range(n_gauge):
        rows.append(row_cls(
            _meta(f"coll.g.{i}", dsd.GAUGE, cls=meta_cls), "gauge",
            value=float(rng.normal() * 100)))
    for i in range(n_histo):
        k = int(rng.integers(1, 40))
        means = np.zeros(C, np.float32)
        weights = np.zeros(C, np.float32)
        means[:k] = rng.normal(size=k).astype(np.float32) * 50
        weights[:k] = rng.integers(1, 9, size=k).astype(np.float32)
        vals = means[:k].astype(np.float64)
        w = weights[:k].astype(np.float64)
        stats = np.array([w.sum(), vals.min(), vals.max(),
                          (vals * w).sum(),
                          (1.0 / np.abs(vals + 100.0)).sum()],
                         np.float32)
        rows.append(row_cls(
            _meta(f"coll.h.{i}", dsd.HISTOGRAM, ("t:h",),
                  cls=meta_cls), "histo",
            stats=stats, means=means, weights=weights))
    for i in range(n_set):
        regs = rng.integers(0, 20, size=hll.M).astype(np.uint8)
        rows.append(row_cls(_meta(f"coll.s.{i}", dsd.SET, cls=meta_cls),
                            "set", regs=regs))
    return rows


def _wire_oracle_apply(table, rows):
    data = rows_to_metric_list(rows, 100.0).SerializeToString()
    return apply_metric_list_bytes(table, data)


def _staged(t) -> dict:
    """A table's staged import state as numpy (either package)."""
    out = {"counter": np.asarray(t._counter_dense),
           "gauge": np.asarray(t._gauge_dense),
           "set": (None if t._set_import_plane is None
                   else np.asarray(t._set_import_plane)),
           "stats": [np.asarray(x[1]) for x in t._stats_import_parts],
           "digest": [[np.asarray(a) for a in x]
                      for x in t._wire_digest_parts]}
    return out


def _assert_staged_equal(a: dict, b: dict) -> None:
    assert np.array_equal(a["counter"], b["counter"])
    assert np.array_equal(a["gauge"], b["gauge"])
    assert (a["set"] is None and b["set"] is None) or np.array_equal(
        a["set"], b["set"])
    assert len(a["stats"]) == len(b["stats"])
    for x, y in zip(a["stats"], b["stats"]):
        assert np.array_equal(x, y)
    assert len(a["digest"]) == len(b["digest"])
    for x, y in zip(a["digest"], b["digest"]):
        for ax, ay in zip(x, y):
            assert np.array_equal(ax, ay)


def test_identity_roundtrip_matches_jax():
    schema = cplanes.PlaneSchema(max_rows=16, key_bytes=96)
    meta = _meta("a.metric", dsd.HISTOGRAM, ("env:prod", "zone:us"),
                 dsd.SCOPE_GLOBAL)
    buf = cplanes.encode_identity(meta, schema.key_bytes)
    assert buf == jplanes.encode_identity(
        _meta("a.metric", dsd.HISTOGRAM, ("env:prod", "zone:us"),
              dsd.SCOPE_GLOBAL, cls=JRowMeta), 96)
    assert cplanes.decode_identity(buf) == (
        "a.metric", dsd.HISTOGRAM, dsd.SCOPE_GLOBAL,
        ("env:prod", "zone:us"))
    # oversize identity -> None (rejected to the wire, not truncated)
    assert cplanes.encode_identity(_meta("x" * 200, dsd.COUNTER),
                                   96) is None
    with pytest.raises(cplanes.PlaneFormatError):
        cplanes.decode_identity(b"\x09\x00\x01\x00a\x00")


@pytest.mark.parametrize("max_rows,key_bytes", [(64, 128), (4, 96),
                                                (512, 192)])
def test_pack_block_bytes_equal_jax(max_rows, key_bytes):
    """The block is a byte format: the port packs the reference's
    bytes for the same rows, rejects the same rows, and the schemas
    agree on every offset."""
    schema = cplanes.PlaneSchema(compression=100.0, max_rows=max_rows,
                                 key_bytes=key_bytes)
    jschema = jplanes.PlaneSchema(compression=100.0, max_rows=max_rows,
                                  key_bytes=key_bytes)
    assert schema.block_size == jschema.block_size
    block, n, rej = cplanes.pack_block(mixed_rows(), schema)
    jblock, jn, jrej = jplanes.pack_block(mixed_rows(jax_rows=True),
                                          jschema)
    assert block.tobytes() == jblock.tobytes()
    assert n == jn and [r.meta.name for r in rej] == [
        r.meta.name for r in jrej]
    assert cplanes.block_counts(block) == jplanes.block_counts(jblock)


def test_jax_packed_block_folds_as_the_jax_fold():
    """A block the reference packed, folded by the port into a port
    table, stages exactly what the reference's fold stages into a JAX
    table."""
    jschema = jplanes.PlaneSchema(compression=100.0, max_rows=64,
                                  key_bytes=128)
    schema = cplanes.PlaneSchema(compression=100.0, max_rows=64,
                                 key_bytes=128)
    jblock, _, _ = jplanes.pack_block(mixed_rows(jax_rows=True), jschema)
    t = MetricTable(TableConfig(), device="cpu")
    jt = JTable(JTableConfig())
    assert cplanes.fold_block(t, jblock, schema) == jplanes.fold_block(
        jt, jblock, jschema) == (48, 0)
    _assert_staged_equal(_staged(t), _staged(jt))
    back = cplanes.unpack_block(jblock, schema)
    assert [r.meta.name for r in back] == [r.meta.name
                                           for r in mixed_rows()]


def test_pack_unpack_roundtrip_and_counts():
    schema = cplanes.PlaneSchema(compression=100.0, max_rows=64,
                                 key_bytes=128)
    block, n, rejected = cplanes.pack_block(mixed_rows(), schema)
    assert n == 48 and not rejected
    assert cplanes.block_counts(block) == (24, 12, 8, 4)
    assert cplanes.block_counts(np.zeros(schema.block_size,
                                         np.uint8)) == (0, 0, 0, 0)
    with pytest.raises(cplanes.PlaneFormatError):
        cplanes.block_counts(np.full(schema.block_size, 7, np.uint8))


def test_capacity_rejects_to_wire_never_truncates():
    schema = cplanes.PlaneSchema(max_rows=4, key_bytes=128)
    rows = mixed_rows(n_counter=7, n_gauge=0, n_histo=0, n_set=0)
    block, n, rejected = cplanes.pack_block(rows, schema)
    assert n == 4 and len(rejected) == 3
    assert cplanes.block_counts(block)[0] == 4
    assert all(r in rows for r in rejected)


def test_parse_peers():
    assert parse_peers("a:1=1,b:2=2") == {"a:1": 1, "b:2": 2}
    assert parse_peers("") == {}
    for bad in ("noindex", "a:1=1,a:1=2", "a:1=x", "=3"):
        with pytest.raises(ValueError):
            parse_peers(bad)


def test_fold_block_bit_parity_vs_wire_oracle():
    schema = cplanes.PlaneSchema(compression=100.0, max_rows=64,
                                 key_bytes=128)
    rows = mixed_rows()
    block, n, rejected = cplanes.pack_block(rows, schema)
    assert n == len(rows) and not rejected
    t1 = MetricTable(TableConfig(), device="cpu")
    t2 = MetricTable(TableConfig(), device="cpu")
    assert cplanes.fold_block(t1, block, schema) == \
        _wire_oracle_apply(t2, rows) == (len(rows), 0)
    _assert_staged_equal(_staged(t1), _staged(t2))


def test_plane_exchange_one_process_is_the_identity():
    ex = cplanes.PlaneExchange()
    assert ex.n_proc == 1
    blocks = np.arange(12, dtype=np.uint8).reshape(1, 12)
    assert np.array_equal(ex(blocks), blocks)
    with pytest.raises(ValueError, match="destination blocks"):
        ex(np.zeros((2, 12), np.uint8))


def _worker_alive(tr) -> bool:
    w = tr._worker
    return w is not None and w.is_alive()


def test_transport_deadline_falls_open_and_hands_late_planes():
    schema = cplanes.PlaneSchema(max_rows=8, key_bytes=96)
    release = threading.Event()
    late: list = []

    def slow_exchange(local):
        release.wait(10)
        return local

    tr = CollectiveTransport(schema, peers={"d:1": 1},
                             exchange=slow_exchange, deadline=0.2,
                             on_late=late.append)
    rows = mixed_rows(n_counter=3, n_gauge=0, n_histo=0, n_set=0)
    with pytest.raises(CollectiveExchangeError, match="deadline"):
        tr.send_cycle({"d:1": rows})
    assert tr.counters["fallback_cycles"] == 1
    # the next cycle finds the exchange still in flight: straight to
    # the wire, counted
    with pytest.raises(CollectiveExchangeError, match="in flight"):
        tr.send_cycle({"d:1": rows})
    assert tr.counters["fallback_cycles"] == 2
    release.set()
    deadline = time.monotonic() + 5
    while not late and time.monotonic() < deadline:
        time.sleep(0.01)
    assert late and late[0].shape == (2, schema.block_size)
    assert tr.counters["late_landed"] == 1
    tr.stop()
    assert not _worker_alive(tr)


def test_transport_error_raises_and_stop_joins_worker():
    schema = cplanes.PlaneSchema(max_rows=8, key_bytes=96)

    def bad_exchange(local):
        raise RuntimeError("mesh torn down")

    tr = CollectiveTransport(schema, peers={"d:1": 1},
                             exchange=bad_exchange, deadline=2.0)
    with pytest.raises(CollectiveExchangeError, match="torn down"):
        tr.send_cycle({"d:1": mixed_rows(2, 0, 0, 0)})
    assert tr.counters["fallback_cycles"] == 1
    worker = tr._worker
    tr.stop()
    assert not worker.is_alive()
    with pytest.raises(CollectiveExchangeError, match="stopped"):
        tr.send_cycle({"d:1": mixed_rows(2, 0, 0, 0)})


# ----------------------------------------------------------------------
# server level: a loopback hub exchange, the real ledger and spans


def _server(data, sinks=None):
    return Server(read_config(data=dict(data)), device="cpu",
                  extra_sinks=sinks or [])


def _hub_into(glob):
    def hub(local_blocks):
        landed = np.zeros_like(local_blocks)
        landed[0] = local_blocks[1]
        glob._collective_transport()
        glob.apply_collective_blocks(landed)
        return np.zeros_like(local_blocks)
    return hub


def _local(forward_address, peer):
    return _server({
        "statsd_listen_addresses": [], "forward_address":
            forward_address, "forward_use_grpc": True,
        "tpu_sharded_global": True, "tpu_collective_peers": f"{peer}=1",
        "interval": "10s", "hostname": "l"})


def test_server_collective_cycle_ledger_and_spans():
    """Every row rides the collective; the interval seals balanced on
    the collective split; one forward.collective span hangs under the
    forward stage; the global folds the planes, credits them under
    "collective-import" and flushes them; the signal row and
    /debug/vars name the cycle."""
    cap = CaptureSink()
    glob = _server({"interval": "10s", "hostname": "g",
                    "tpu_collective_forward": "on"}, [cap])
    dest = "127.0.0.1:9990"
    local = _local(dest, dest)
    local.collective_exchange = _hub_into(glob)
    try:
        n = 40
        for i in range(n):
            local.handle_packet(
                f"coll.e2e.{i}:{i}|c|#veneurglobalonly".encode())
        local.flush_once()

        assert local.stats["collective_forward_cycles"] == 1
        assert local.stats["collective_forward_rows"] == n
        assert local.stats.get("collective_forward_fallbacks", 0) == 0
        assert local.stats.get("forward_shard_wires", 0) == 0
        rec = local.ledger.last()
        assert rec.sealed and rec.balanced and rec.split_owed == 0
        assert rec.forward_collective == {dest: n}
        assert rec.forward_split == {}
        assert rec.forwarded_rows == n
        row = local._signal_row()
        assert row["forward.collective.cycles"] == 1
        assert row["forward.collective.rows"] == n
        coll = local.debug_vars()["forward.collective"]
        assert coll["cycles"] == 1 and coll["peers"] == {dest: 1}

        assert glob.stats["collective_items_received"] == n
        assert glob.stats["imports_received"] == n
        assert glob._signal_row()[
            "forward.collective.items_received"] == n
        glob.flush_once()
        got = {m.name: m.value for m in cap.metrics}
        assert len(got) == n
        for i in range(n):
            assert got[f"coll.e2e.{i}"] == float(i)
        assert any("collective-import" in r.received
                   for r in glob.ledger.records())

        tid = next(t for t in reversed(local.trace_index.trace_ids())
                   if any(s["name"] == "flush.forward"
                          for s in local.trace_index.get(t)))
        spans = local.trace_index.get(tid)
        fwd = next(s for s in spans if s["name"] == "flush.forward")
        colls = [s for s in spans
                 if s["name"] == "flush.forward.collective"]
        assert len(colls) == 1
        assert colls[0]["parent_id"] == fwd["span_id"]
        assert int(colls[0]["tags"]["rows"]) == n
    finally:
        local.shutdown()
        glob.shutdown()
    # shutdown stops the exchange worker
    assert not _worker_alive(local._collective_fwd)


def test_fail_open_to_wire_zero_unattributed_loss():
    """An exchange failure: the whole cycle's peer rows ride the wire,
    the fallback is counted, every row lands on the real global and
    the ledger balances."""
    cap = CaptureSink()
    glob = _server({"grpc_listen_addresses": ["tcp://127.0.0.1:0"],
                    "interval": "10s", "hostname": "g"}, [cap])
    glob.start()
    try:
        dest = f"127.0.0.1:{glob.grpc_ports[0]}"
        local = _local(dest, dest)

        def exploding(local_blocks):
            raise RuntimeError("injected exchange fault")

        local.collective_exchange = exploding
        try:
            n = 30
            for i in range(n):
                local.handle_packet(
                    f"coll.fo.{i}:{i}|c|#veneurglobalonly".encode())
            local.flush_once()
            assert local.stats["collective_forward_fallbacks"] == 1
            assert local.stats["collective_fallback_rows"] == n
            assert local.stats.get("collective_forward_cycles", 0) == 0
            assert local.stats["forward_shard_wires"] == 1
            rec = local.ledger.last()
            assert rec.sealed and rec.balanced
            assert rec.forward_collective == {}
            assert rec.forward_split == {dest: n}
            assert rec.forwarded_rows == n
            assert local._signal_row()[
                "forward.collective.fallback_cycles"] == 1
            glob.flush_once()
            got = {m.name: m.value for m in cap.metrics}
            assert len(got) == n
        finally:
            local.shutdown()
    finally:
        glob.shutdown()


def test_mixed_wire_and_collective_split_balances():
    """Two destinations, one a mesh peer: the flush splits across both
    transports and seals on forwarded == wire split + collective
    split; every key lands exactly once."""
    wire_cap, coll_cap = CaptureSink(), CaptureSink()
    wire_glob = _server({"grpc_listen_addresses": ["tcp://127.0.0.1:0"],
                         "interval": "10s", "hostname": "gw"},
                        [wire_cap])
    wire_glob.start()
    coll_glob = _server({"interval": "10s", "hostname": "gc",
                         "tpu_collective_forward": "on"}, [coll_cap])
    try:
        wire_dest = f"127.0.0.1:{wire_glob.grpc_ports[0]}"
        coll_dest = "127.0.0.1:9991"
        local = _local(f"{wire_dest},{coll_dest}", coll_dest)
        local.collective_exchange = _hub_into(coll_glob)
        try:
            n = 200
            for i in range(n):
                local.handle_packet(
                    f"coll.mix.{i}:{i}|c|#veneurglobalonly".encode())
            local.flush_once()
            rec = local.ledger.last()
            assert rec.sealed and rec.balanced
            n_coll = sum(rec.forward_collective.values())
            n_wire = sum(rec.forward_split.values())
            assert n_coll > 0 and n_wire > 0
            assert set(rec.forward_collective) == {coll_dest}
            assert set(rec.forward_split) == {wire_dest}
            assert n_coll + n_wire == rec.forwarded_rows == n
            assert local.stats["collective_forward_rows"] == n_coll
            summ = local.ledger.summary()
            assert summ["forward_collective_total"] == n_coll
            assert summ["forward_split_total"] == n_wire
            wire_glob.flush_once()
            coll_glob.flush_once()
            merged = {}
            for capt in (wire_cap, coll_cap):
                for m in capt.metrics:
                    assert m.name not in merged, "key owned twice"
                    merged[m.name] = m.value
            assert merged == {f"coll.mix.{i}": float(i)
                              for i in range(n)}
        finally:
            local.shutdown()
    finally:
        wire_glob.shutdown()
        coll_glob.shutdown()


def test_reshard_crossing_credits_moved_on_both_transports():
    """A mesh peer joining the ring moves arcs from the wire member
    onto the collective: the crossing flush credits the moved rows
    against the pre-swap ring and still balances."""
    wire_glob = _server({"grpc_listen_addresses": ["tcp://127.0.0.1:0"],
                         "interval": "10s", "hostname": "gw"},
                        [CaptureSink()])
    wire_glob.start()
    coll_glob = _server({"interval": "10s", "hostname": "gc",
                         "tpu_collective_forward": "on"},
                        [CaptureSink()])
    try:
        wire_dest = f"127.0.0.1:{wire_glob.grpc_ports[0]}"
        coll_dest = "127.0.0.1:9992"
        local = _local(wire_dest, coll_dest)
        local.collective_exchange = _hub_into(coll_glob)
        try:
            n = 120
            mk = [f"coll.rs.{i}:{i}|c|#veneurglobalonly".encode()
                  for i in range(n)]
            for p in mk:
                local.handle_packet(p)
            local.flush_once()
            rec1 = local.ledger.last()
            assert rec1.balanced
            assert sum(rec1.forward_split.values()) == n
            assert rec1.forward_collective == {}
            assert local._sharded_fwd.set_members([wire_dest, coll_dest])
            for p in mk:
                local.handle_packet(p)
            local.flush_once()
            rec2 = local.ledger.last()
            assert rec2.sealed and rec2.balanced
            n_coll = sum(rec2.forward_collective.values())
            n_wire = sum(rec2.forward_split.values())
            assert n_coll > 0 and n_wire > 0
            assert n_coll + n_wire == rec2.forwarded_rows == n
            assert rec2.reshard_epoch > 0
            assert coll_dest in rec2.reshard_added
            assert rec2.reshard_moved_rows == n_coll
            assert local.stats["forward_reshards"] == 1
        finally:
            local.shutdown()
    finally:
        wire_glob.shutdown()
        coll_glob.shutdown()


def test_drain_flush_never_takes_the_collective():
    """The shutdown drain rides the wire only."""
    glob = _server({"grpc_listen_addresses": ["tcp://127.0.0.1:0"],
                    "interval": "10s", "hostname": "g"}, [CaptureSink()])
    glob.start()
    try:
        dest = f"127.0.0.1:{glob.grpc_ports[0]}"
        local = _local(dest, dest)
        calls = []

        def hub(local_blocks):
            calls.append(1)
            return np.zeros_like(local_blocks)

        local.collective_exchange = hub
        try:
            for i in range(10):
                local.handle_packet(
                    f"coll.drain.{i}:{i}|c|#veneurglobalonly".encode())
        finally:
            local.shutdown()
        assert not calls
        assert local.stats.get("drain_items_sent", 0) == 10
        assert glob.stats.get("drain_items_received", 0) == 10
    finally:
        glob.shutdown()


def test_receive_cycle_needs_the_gate():
    srv = _server({"interval": "10s"})
    try:
        with pytest.raises(RuntimeError, match="collective forward is off"):
            srv.collective_receive_cycle(timeout=0.1)
    finally:
        srv.shutdown()
    glob = _server({"interval": "10s", "tpu_collective_forward": "on"})
    try:
        # one process: the exchange is the identity, nothing lands
        assert glob.collective_receive_cycle(timeout=5.0) == (0, 0)
    finally:
        glob.shutdown()
