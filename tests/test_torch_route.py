"""CPU parity of the port's routing primitives against the JAX package.

The two native routing entries (``vtpu_metriclist_spans``,
``vtpu_proxy_keyhash``) against the reference's library on well-formed
and malformed wires; ``hash_keys`` / ``ConsistentRing.get`` /
``assign`` against the JAX ring, before and after ``set_members``;
``proxy_key_hashes``, ``record_spans`` and ``route_metric_list``
against the JAX functions on seeded MetricLists of every metric type,
the frozen Go-side wire fixture, a port local's own forward wire, and
one destination (the routed body is the input).

Tolerance: none — every output here is integer or bytes and must be
identical.
"""

from __future__ import annotations

import base64
import ctypes
import os

import numpy as np
import pytest

from veneur_tpu import native as jnative
from veneur_tpu.forward import grpc_forward as jgf
from veneur_tpu.forward import ring as jring
from veneur_tpu.forward import route as jroute
from veneur_tpu_torch import native
from veneur_tpu_torch.core.flusher import Flusher
from veneur_tpu_torch.core.table import MetricTable, TableConfig
from veneur_tpu_torch.forward import grpc_forward as gf
from veneur_tpu_torch.forward import ring, route
from veneur_tpu_torch.forward.gen import forward_pb2, metric_pb2

FIXTURE = os.path.join(os.path.dirname(__file__), "testdata",
                       "forward_fixture.b64")
MEMBERS = [f"10.0.0.{i}:8128" for i in range(1, 6)]


def _metric_list(seed: int, n: int = 60) -> bytes:
    """A seeded MetricList holding every metric type (and a type enum
    outside 0..4, which the key hasher spells as its number), tagged
    and untagged, every scope."""
    rng = np.random.default_rng(seed)
    ms = []
    for i in range(n):
        kind = int(rng.integers(0, 6))
        tags = [f"k{j}:v{int(rng.integers(0, 9))}"
                for j in range(int(rng.integers(0, 4)))]
        m = metric_pb2.Metric(name=f"m{seed}.{i}", tags=tags,
                              scope=int(rng.integers(0, 3)))
        if kind == 0:
            m.type = metric_pb2.Counter
            m.counter.value = int(rng.integers(-5, 1000))
        elif kind == 1:
            m.type = metric_pb2.Gauge
            m.gauge.value = float(rng.normal())
        elif kind in (2, 4):
            m.type = metric_pb2.Histogram if kind == 2 else metric_pb2.Timer
            d = m.histogram.t_digest
            d.compression = 100.0
            for v in np.sort(rng.gamma(2.0, 30.0, int(rng.integers(1, 9)))):
                c = d.main_centroids.add()
                c.mean, c.weight = float(v), float(rng.integers(1, 4))
            d.min, d.max = 0.0, 500.0
        elif kind == 3:
            m.type = metric_pb2.Set
            m.set.hyper_log_log = rng.bytes(int(rng.integers(4, 40)))
        else:
            m.type = 9  # no name: the oracle's key spells str(m.type)
            m.gauge.value = 1.0
        ms.append(m)
    return forward_pb2.MetricList(metrics=ms).SerializeToString()


def _port_local_wire() -> bytes:
    """A port local's own forward wire (counters, gauges, timers, sets)
    through the real encoder."""
    rng = np.random.default_rng(5)
    lines = [b"req:3|c|#veneurglobalonly", b"depth:4|g|#veneurglobalonly"]
    for i in range(8):
        lines += [b"t%d:%.3f|ms|#k:v" % (i, v) for v in rng.gamma(2, 30, 40)]
    lines += [b"users:u%d|s" % j for j in range(50)]
    t = MetricTable(TableConfig(counter_rows=32, gauge_rows=32,
                                histo_rows=32, set_rows=4), device="cpu")
    t.ingest_buffer(b"\n".join(lines))
    rows = Flusher(is_local=True, device="cpu").flush(t.swap(),
                                                      now=1).forward
    return gf.rows_to_metric_list(rows).SerializeToString()


def _fixture() -> bytes:
    with open(FIXTURE) as f:
        return base64.b64decode(f.read())


GOOD = {"seeded0": lambda: _metric_list(0), "seeded1": lambda: _metric_list(1),
        "fixture": _fixture, "port_local": _port_local_wire,
        "empty": lambda: b""}
_ONE = _metric_list(2, n=3)
BAD = {
    # a record whose length varint runs off the end
    "truncated_varint": _ONE + b"\x0a\xff",
    # a record claiming more bytes than the wire holds
    "oversize_length": _ONE + b"\x0a\x7f\x0a\x01",
    # wire type 7 does not exist
    "wrong_wire_type": b"\x0f" + _ONE,
    # a record cut short
    "truncated_record": _ONE[:-3],
}


def _spans_call(lib, data: bytes, cap: int):
    buf = np.frombuffer(data or b"\0", np.uint8)
    off = np.full(max(cap, 1), -7, np.int64)
    ln = np.full(max(cap, 1), -7, np.int64)
    need = np.zeros(1, np.int64)
    p = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))  # noqa: E731
    rc = lib.vtpu_metriclist_spans(
        p(buf, ctypes.c_uint8), len(data), cap, p(off, ctypes.c_int64),
        p(ln, ctypes.c_int64), p(need, ctypes.c_int64))
    return rc, off, ln, need


@pytest.mark.parametrize("which", sorted(GOOD) + sorted(BAD))
@pytest.mark.parametrize("cap", [2, 4096])
def test_metriclist_spans_matches_reference_library(which, cap):
    """The port's ``vtpu_metriclist_spans`` against the reference's
    library: return code (count, -1 malformed, -2 over capacity), the
    spans written and the count needed, on every wire."""
    data = GOOD[which]() if which in GOOD else BAD[which]
    got = _spans_call(native.load(), data, cap)
    want = _spans_call(jnative.load(), data, cap)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    if which in BAD:
        assert got[0] == -1
        assert route.record_spans(data) is None
        assert jroute.record_spans(data) is None
        with pytest.raises((ValueError, IndexError)):
            route.record_spans_py(data)


@pytest.mark.parametrize("which", sorted(GOOD))
def test_proxy_keyhash_and_spans_match_jax(which):
    """``record_spans`` (native) equals ``record_spans_py`` and the JAX
    function; ``proxy_key_hashes`` equals the JAX function and the
    scalar oracle ``ring._h(name|type|tags)`` item by item, including
    the unnamed type enum."""
    data = GOOD[which]()
    spans = route.record_spans(data)
    jspans = jroute.record_spans(data)
    for g, w in zip(spans, jspans):
        np.testing.assert_array_equal(g, w)
    assert list(zip(*(a.tolist() for a in spans))) == \
        route.record_spans_py(data)
    cols = gf.decode_metric_list(data)
    hashes = route.proxy_key_hashes(data, cols)
    jhashes = jroute.proxy_key_hashes(data, jgf.decode_metric_list(data))
    np.testing.assert_array_equal(hashes, jhashes)
    ml = forward_pb2.MetricList.FromString(data)
    names = {0: "counter", 1: "gauge", 2: "histogram", 3: "set",
             4: "timer"}
    oracle = [ring._h(f"{m.name}|{names.get(int(m.type), str(m.type))}|"
                      f"{','.join(m.tags)}") for m in ml.metrics]
    assert hashes.tolist() == oracle


def test_hash_keys_and_ring_match_jax():
    """``hash_keys`` (the native fnv1a64+fmix64, keys up to 600 bytes)
    and the ring's ``get``/``assign`` equal the JAX ring's, before and
    after ``set_members``; ``assign`` equals ``get`` per key; an empty
    ring raises LookupError in both."""
    rng = np.random.default_rng(3)
    keys = [bytes(rng.integers(33, 127, int(n)).astype(np.uint8))
            for n in rng.integers(0, 600, 400)]
    h = ring.hash_keys(keys)
    np.testing.assert_array_equal(h, jring.hash_keys(keys))
    assert h.tolist() == [ring._h(k.decode()) for k in keys]
    r, jr = ring.ConsistentRing(MEMBERS), jring.ConsistentRing(MEMBERS)
    for members in (MEMBERS, MEMBERS[:3] + ["10.0.0.9:8128"],
                    ["solo:1"]):
        r.set_members(members)
        jr.set_members(members)
        assert r.members == jr.members
        got = [r.get(k.decode()) for k in keys]
        assert got == [jr.get(k.decode()) for k in keys]
        idx = r.assign(h)
        np.testing.assert_array_equal(idx, jr.assign(h))
        assert [r.members[i] for i in idx] == got
    for rr in (ring.ConsistentRing(), jring.ConsistentRing()):
        with pytest.raises(LookupError):
            rr.get("k")
        with pytest.raises(LookupError):
            rr.assign(h)


@pytest.mark.parametrize("n_members", [1, 2, 5])
@pytest.mark.parametrize("which", sorted(GOOD))
def test_route_metric_list_byte_identical_to_jax(which, n_members):
    """Per-destination bodies, item counts and member order equal the
    JAX function's byte for byte; every body decodes to exactly the
    records the oracle assigns that destination, in wire order; with
    one destination the body is the input."""
    data = GOOD[which]()
    members = MEMBERS[:n_members]
    got = route.route_metric_list(data, ring.ConsistentRing(members))
    want = jroute.route_metric_list(data, jring.ConsistentRing(members))
    assert (got.members, got.batches, got.routed, got.dropped, got.n) == \
        (want.members, want.batches, want.routed, want.dropped, want.n)
    ml = forward_pb2.MetricList.FromString(data)
    oracle = {}
    r = ring.ConsistentRing(members)
    names = {0: "counter", 1: "gauge", 2: "histogram", 3: "set",
             4: "timer"}
    for m in ml.metrics:
        key = f"{m.name}|{names.get(int(m.type), str(m.type))}|" \
              f"{','.join(m.tags)}"
        oracle.setdefault(r.get(key), []).append(m)
    assert {got.members[d]: n for d, _, n in got.batches} == \
        {d: len(v) for d, v in oracle.items()}
    for d, body, _n in got.batches:
        assert list(forward_pb2.MetricList.FromString(body).metrics) == \
            oracle[got.members[d]]
    if n_members == 1 and data:
        assert got.batches == [(0, data, len(ml.metrics))]


@pytest.mark.parametrize("which", sorted(BAD))
def test_route_metric_list_refuses_malformed_as_jax(which):
    """A malformed wire routes to None in both packages (the caller's
    per-item fallback), and an empty ring drops the whole batch."""
    r = ring.ConsistentRing(MEMBERS)
    assert route.route_metric_list(BAD[which], r) is None
    assert jroute.route_metric_list(
        BAD[which], jring.ConsistentRing(MEMBERS)) is None
    data = _metric_list(4, n=7)
    got = route.route_metric_list(data, ring.ConsistentRing())
    want = jroute.route_metric_list(data, jring.ConsistentRing())
    assert (got.batches, got.routed, got.dropped, got.n) == \
        (want.batches, want.routed, want.dropped, want.n) == ([], 0, 7, 7)


def test_group_indices_matches_jax():
    rng = np.random.default_rng(9)
    assign = rng.integers(0, 4, 300).astype(np.int32)
    got = route.group_indices(assign, 6)
    want = jroute.group_indices(assign, 6)
    assert [d for d, _ in got] == [d for d, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
