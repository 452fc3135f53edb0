"""The port's native library against the JAX package's, entry by entry.

The port builds its own copy of the reference's C++ parser
(``veneur_tpu_torch/native/dsd_parse.cpp``) with g++; every bound entry
is called here on the same seeded inputs as the reference library
(``veneur_tpu.native``, which only the tests may load) and must agree
bit for bit, and the per-array entries must equal their numpy plain
versions.  The table's fused ingest must stage exactly what the JAX
table with its native library stages.
"""

from __future__ import annotations

import ctypes
import socket

import numpy as np
import pytest

from veneur_tpu import native as jnative
from veneur_tpu.core.table import MetricTable as JTable
from veneur_tpu.core.table import TableConfig as JConfig
from veneur_tpu.protocol import columnar as jcol
from veneur_tpu.utils import intern as jintern
from veneur_tpu_torch import native
from veneur_tpu_torch.core.table import MetricTable, TableConfig
from veneur_tpu_torch.ops import hll
from veneur_tpu_torch.protocol import columnar
from veneur_tpu_torch.utils import hashing, intern


@pytest.fixture(scope="module")
def libs():
    jlib = jnative.load()
    assert jlib is not None, "the reference's native library must build"
    return native.load(), jlib


def _p(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _text(rng, n=3000) -> list[bytes]:
    """Every line kind the grammar knows: each metric type, sample
    rates, tags, both scope tags, long lines (the general parse path),
    events, service checks and malformed lines."""
    kinds = ["c", "g", "ms", "h", "d", "s"]
    out = []
    for i in range(n):
        k = kinds[i % len(kinds)]
        name = f"m{rng.integers(0, 40)}.{k}"
        if k == "s":
            val = f"user{rng.integers(0, 500)}"
        else:
            val = f"{rng.normal(50, 30):.{rng.integers(0, 6)}f}"
        line = f"{name}:{val}|{k}"
        r = rng.random()
        if r < 0.2 and k not in ("g",):
            line += f"|@{rng.choice([0.5, 0.25, 0.1])}"
        if rng.random() < 0.6:
            tags = [f"t{j}:{rng.integers(0, 5)}"
                    for j in range(rng.integers(1, 4))]
            if rng.random() < 0.1:
                tags.append("veneurlocalonly")
            elif rng.random() < 0.1:
                tags.append("veneurglobalonly")
            if rng.random() < 0.05:
                tags.append("long:" + "x" * 80)
            line += "|#" + ",".join(tags)
        out.append(line.encode())
    out += [b"_e{5,4}:title|text|#a:b", b"_sc|svc.check|1|#x:y",
            b"no_colon|c", b"v:|c", b"v:1|q", b"v:1|c|@2", b"v:abc|c",
            b"v:1|g|@0.5", b"|c", b":1|c", b"a|b:1|c"]
    order = rng.permutation(len(out))
    return [out[i] for i in order]


# ---- the batch parser -------------------------------------------------

def test_parse_batch_bit_equal(libs):
    lines = _text(np.random.default_rng(1))
    buf = b"\n".join(lines) + b"\n\n"
    # small scratch: both parsers take the -(needed) retry
    tb = columnar.ColumnarParser(max_lines=8).parse(buf)
    jb = jcol.ColumnarParser(max_lines=8).parse(buf)
    assert tb.n == jb.n == len(lines)
    for col in ("type_code", "line_off", "line_len"):
        np.testing.assert_array_equal(getattr(tb, col), getattr(jb, col))
    codes = set(tb.type_code.tolist())
    assert {0, 1, 2, 3, 4, 250, 251, 255} <= codes
    metric = tb.type_code <= columnar.CODE_SET
    for col in ("key_hash", "weight", "scope"):
        np.testing.assert_array_equal(getattr(tb, col)[metric],
                                      getattr(jb, col)[metric])
    sets = tb.type_code == columnar.CODE_SET
    vals = metric & ~sets
    np.testing.assert_array_equal(tb.value[vals], jb.value[vals])
    np.testing.assert_array_equal(tb.member_hash[sets],
                                  jb.member_hash[sets])
    assert set(tb.scope[metric].tolist()) == {0, 1, 2}
    # the identity hash is utils/hashing.key_hash64's
    i = int(np.nonzero(tb.type_code == columnar.CODE_COUNTER)[0][0])
    from veneur_tpu_torch.protocol import dogstatsd as dsd
    s = dsd.parse_metric(tb.line(i))
    assert int(tb.key_hash[i]) == hashing.key_hash64(
        s.name, 0, s.tags, columnar.SCOPE_CODES.index(s.scope))


def test_parse_batch_views_are_scratch():
    parser = columnar.ColumnarParser(max_lines=16)
    a = parser.parse(b"a:1|c\nb:2|c", copy=False)
    assert np.shares_memory(a.value, parser._val)
    b = parser.parse(b"a:1|c\nb:2|c")
    assert not np.shares_memory(b.value, parser._val)


def test_hash_members_bit_equal(libs):
    rng = np.random.default_rng(2)
    members = [bytes(rng.integers(0, 256, rng.integers(0, 40),
                                  dtype=np.uint8)) for _ in range(300)]
    buf = np.frombuffer(b"".join(members) or b"\0", np.uint8)
    lens = np.array([len(m) for m in members], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    outs = []
    for lib in libs:
        out = np.empty(len(members), np.uint64)
        lib.vtpu_hash_members(_p(buf, ctypes.c_uint8),
                              _p(offs, ctypes.c_int64),
                              _p(lens, ctypes.c_int64), len(members),
                              _p(out, ctypes.c_uint64))
        outs.append(out)
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], hashing.hash64(members))


def test_recv_drain_bit_equal(libs):
    """The same datagrams, drained once by each library: the same
    newline-joined bytes, the same counts, the oversize one rejected."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    dgrams = [b"a:1|c", b"b:2|g\nc:3|ms", b"x" * 300, b"", b"d:4|s"]
    results = []
    try:
        for lib in libs:
            for d in dgrams:
                tx.sendto(d, rx.getsockname())
            out = np.zeros(16 * 257, np.uint8)
            n_msgs, n_over = ctypes.c_int32(0), ctypes.c_int32(0)
            for _ in range(200):  # loopback delivery is asynchronous
                nbytes = lib.vtpu_recv_drain(
                    rx.fileno(), _p(out, ctypes.c_uint8), out.nbytes, 16,
                    256, ctypes.byref(n_msgs), ctypes.byref(n_over))
                if nbytes:
                    break
            results.append((out[:nbytes].tobytes(), n_msgs.value,
                            n_over.value))
    finally:
        rx.close()
        tx.close()
    assert results[0] == results[1]
    data, kept, over = results[0]
    assert over == 1 and kept == 3
    assert data == b"a:1|c\nb:2|g\nc:3|ms\nd:4|s\n"


# ---- rank, dense plane, HLL planes, gather -------------------------------

def _rows(rng, n, num_rows):
    # includes out-of-range rows (skipped / rank 0 by contract)
    return rng.integers(-2, num_rows + 2, n).astype(np.int32)


def test_rank_bit_equal(libs):
    rng = np.random.default_rng(3)
    rows = _rows(rng, 5000, 50)
    outs = []
    for lib in libs:
        counts = np.zeros(50, np.int32)
        rank = np.empty(len(rows), np.int32)
        lib.vtpu_rank(_p(rows, ctypes.c_int32), len(rows), 50,
                      _p(counts, ctypes.c_int32), _p(rank, ctypes.c_int32))
        outs.append((rank, counts))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    rank, mx = native.rank(rows, 50)
    prank, pmx = native.rank_plain(rows, 50)
    np.testing.assert_array_equal(rank, outs[0][0])
    np.testing.assert_array_equal(rank, prank)
    assert mx == pmx == int(outs[0][1].max())


@pytest.mark.parametrize("unit", [True, False])
def test_dense_plane_bit_equal(libs, unit):
    rng = np.random.default_rng(4 + unit)
    R, width, n = 40, 32, 3000
    rows = _rows(rng, n, R)
    vals = rng.gamma(2.0, 30.0, n).astype(np.float32)
    vals[::13] = 0.0
    wts = None if unit else rng.choice([1.0, 2.0, 10.0], n).astype(
        np.float32)
    outs = []
    for lib in libs:
        pv = np.zeros((R, width), np.float32)
        pw = None if unit else np.zeros((R, width), np.float32)
        counts = np.zeros(R, np.int32)
        ovr = np.empty(n, np.int32)
        ovv = np.empty(n, np.float32)
        ovw = None if unit else np.empty(n, np.float32)
        st = native._empty_stats(R)
        f32 = ctypes.c_float
        spill = lib.vtpu_dense_plane(
            _p(rows, ctypes.c_int32), _p(vals, f32),
            None if unit else _p(wts, f32), n, R, width, _p(pv, f32),
            None if unit else _p(pw, f32), _p(counts, ctypes.c_int32),
            _p(ovr, ctypes.c_int32), _p(ovv, f32),
            None if unit else _p(ovw, f32), _p(st, ctypes.c_double))
        outs.append((pv, pw, counts, ovr[:spill], ovv[:spill],
                     None if unit else ovw[:spill], st))
    for a, b in zip(*outs):
        if a is not None:
            np.testing.assert_array_equal(a, b)
    tv, tw, tc, (tor, tov, tow), ts = native.dense_plane(rows, vals, wts,
                                                         R, width)
    pv, pw, pc, (por, pov, pow_), ps = native.dense_plane_plain(
        rows, vals, wts, R, width)
    assert len(outs[0][3]) > 0  # some rows spilled
    for got, ref, plain in ((tv, outs[0][0], pv), (tc, outs[0][2], pc),
                            (tor, outs[0][3], por), (tov, outs[0][4], pov),
                            (ts, outs[0][6], ps)):
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, plain)
    if not unit:
        np.testing.assert_array_equal(tw, outs[0][1])
        np.testing.assert_array_equal(tw, pw)
        np.testing.assert_array_equal(tow, pow_)


def _packed(rng, n):
    return hll.pack_positions(rng.integers(0, hll.M, n),
                              rng.integers(1, 40, n))


def test_hll_plane_bit_equal(libs):
    rng = np.random.default_rng(6)
    R, n = 6, 20000
    rows = _rows(rng, n, R)
    pk = _packed(rng, n)
    planes = []
    for lib in libs:
        plane = np.zeros((R, hll.M), np.uint8)
        lib.vtpu_hll_plane(_p(rows, ctypes.c_int32),
                           _p(pk, ctypes.c_int32), n, R, hll.M,
                           _p(plane, ctypes.c_uint8))
        planes.append(plane)
    np.testing.assert_array_equal(planes[0], planes[1])
    mine = np.zeros((R, hll.M), np.uint8)
    native.hll_plane(rows, pk, mine)
    plain = np.zeros((R, hll.M), np.uint8)
    native.hll_plane_plain(rows, pk, plain)
    np.testing.assert_array_equal(mine, planes[0])
    np.testing.assert_array_equal(mine, plain)


def test_hll_plane_stats_bit_equal(libs):
    R, n = 5, 30000
    out = []
    for lib in libs:
        r2 = np.random.default_rng(8)
        plane = np.zeros((R, hll.M), np.uint8)
        ez = np.full(R, hll.M, np.int32)
        inv = np.full(R, float(hll.M), np.float64)
        for _ in range(3):  # incremental folds
            rows = _rows(r2, n // 3, R)
            pk = _packed(r2, n // 3)
            lib.vtpu_hll_plane_stats(
                _p(rows, ctypes.c_int32), _p(pk, ctypes.c_int32), len(rows),
                R, hll.M, _p(plane, ctypes.c_uint8),
                _p(inv, ctypes.c_double), _p(ez, ctypes.c_int32))
        out.append((plane, ez, inv))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    plane, ez, inv = out[0]
    np.testing.assert_array_equal(ez, (plane == 0).sum(axis=1))
    plain_inv = np.exp2(-plane.astype(np.float64)).sum(axis=1)
    np.testing.assert_allclose(inv, plain_inv, rtol=1e-12)
    np.testing.assert_allclose(hll.estimate_from_stats(ez, inv),
                               hll.estimate_np(plane), rtol=1e-6)
    # the wrapper folds the same plane
    mine = np.zeros((R, hll.M), np.uint8)
    mez = np.full(R, hll.M, np.int32)
    minv = np.full(R, float(hll.M), np.float64)
    r2 = np.random.default_rng(8)
    for _ in range(3):
        native.hll_plane_stats(_rows(r2, n // 3, R), _packed(r2, n // 3),
                               mine, minv, mez)
    np.testing.assert_array_equal(mine, plane)
    np.testing.assert_array_equal(mez, ez)
    np.testing.assert_array_equal(minv, inv)


@pytest.mark.parametrize("cap", [100, 37])  # padded, and cut short
def test_sb_gather_bit_equal(libs, cap):
    rng = np.random.default_rng(9)
    parts = [rng.integers(-5, 1000, k).astype(np.int32)
             for k in (0, 17, 3, 40)]
    outs = []
    for lib in libs:
        dst = np.empty(cap, np.int32)
        k = len(parts)
        i32p = ctypes.POINTER(ctypes.c_int32)
        ptrs = (i32p * k)(*(_p(p, ctypes.c_int32) for p in parts))
        lens = (ctypes.c_int64 * k)(*(len(p) for p in parts))
        lib.vtpu_sb_gather_i32(ptrs, lens, k, _p(dst, ctypes.c_int32),
                               cap, -7)
        outs.append(dst)
    np.testing.assert_array_equal(outs[0], outs[1])
    mine = np.empty(cap, np.int32)
    native.sb_gather_i32(parts, mine, -7)
    plain = np.full(cap, -7, np.int32)
    cat = np.concatenate(parts)[:cap]
    plain[:len(cat)] = cat
    np.testing.assert_array_equal(mine, outs[0])
    np.testing.assert_array_equal(mine, plain)


# ---- the reference-schema /import value decode ---------------------------

def _gob_items(rng):
    """(payloads, kinds): digests (debug-free, empty, cut before its
    trailing float messages), LE counters and gauges, and malformed
    items — truncated, garbage, wrong length, unknown kinds."""
    from veneur_tpu_torch.forward import gob_codec
    out = []
    for n in (30, 0, 200, 7):
        m = np.sort(rng.gamma(2.0, 30.0, n)).astype(np.float32)
        w = rng.integers(1, 4, n).astype(np.float32)
        out.append((gob_codec.encode_digest(
            m, w, 100.0, float(m.min(initial=0)), float(m.max(initial=0)),
            0.5), 3))
    full = out[0][0]
    out += [(full[:-12], 3), (full[:9], 3), (b"\xff\xfe\xfd", 3), (b"", 3),
            (gob_codec.encode_counter(-42.0), 1),
            (gob_codec.encode_gauge(2.5), 2), (b"\x01\x02", 1),
            (b"\x00" * 8, 0), (b"\x00" * 8, 4), (full, 1)]
    order = rng.permutation(len(out))
    return [out[i][0] for i in order], np.array(
        [out[i][1] for i in order], np.uint8)


def _gob_decode(lib, payloads, kinds, cap):
    n = len(payloads)
    lens = np.array([len(p) for p in payloads], np.int64)
    off = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    buf = np.frombuffer(b"".join(payloads), np.uint8).copy()
    out = dict(scalar=np.zeros(n), dstats=np.zeros((n, 4)),
               start=np.zeros(n, np.int64), cnt=np.zeros(n, np.int32),
               means=np.full(cap, -1, np.float32),
               weights=np.full(cap, -1, np.float32),
               err=np.zeros(n, np.uint8), needed=np.zeros(1, np.int64))
    c = ctypes
    out["rc"] = lib.vtpu_gob_decode(
        _p(buf, c.c_uint8), len(buf), n, _p(off, c.c_int64),
        _p(lens, c.c_int64), _p(kinds, c.c_uint8), cap,
        _p(out["scalar"], c.c_double), _p(out["dstats"], c.c_double),
        _p(out["start"], c.c_int64), _p(out["cnt"], c.c_int32),
        _p(out["means"], c.c_float), _p(out["weights"], c.c_float),
        _p(out["err"], c.c_uint8), _p(out["needed"], c.c_int64))
    return out


@pytest.mark.parametrize("cap", [4096, 40])  # fits; forces -2
def test_gob_decode_bit_equal(libs, cap):
    """vtpu_gob_decode in both libraries on the same items, malformed
    and truncated ones included: every output column bit-equal; a too
    small centroid buffer returns -2 with the exact need, and one retry
    at that need decodes everything."""
    payloads, kinds = _gob_items(np.random.default_rng(12))
    mine, ref = (_gob_decode(lib, payloads, kinds, cap) for lib in libs)
    for k in mine:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
    from veneur_tpu.forward import gob_codec as jgob
    from veneur_tpu_torch.forward import gob_codec

    def per_item(p, k):  # the per-item codec: malformed iff it raises
        fn = {1: gob_codec.decode_counter, 2: gob_codec.decode_gauge,
              3: gob_codec.decode_digest}.get(int(k))
        try:
            return 0 if fn is not None and fn(p) is not None else 1
        except ValueError:
            return 1
    expect_err = [per_item(p, k) for p, k in zip(payloads, kinds)]
    np.testing.assert_array_equal(mine["err"], expect_err)
    assert sum(expect_err) == 8
    need = int(mine["needed"][0])
    assert need == 30 + 200 + 7  # the well-formed digests' centroids
    assert mine["rc"] == (need if cap >= need else -2)
    retry = _gob_decode(libs[0], payloads, kinds, need)
    assert retry["rc"] == need
    if cap >= need:
        np.testing.assert_array_equal(retry["means"], mine["means"][:need])
    t = gob_codec.decode_batch(payloads, kinds)
    j = jgob.decode_batch(payloads, kinds)
    for k in t:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


# ---- the gRPC MetricList walker ----------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _field(num: int, payload: bytes) -> bytes:
    """One length-delimited field."""
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _fleet_metrics(rng, n=12):
    """Metric messages of every kind, type and scope, with 0-2 tags."""
    from veneur_tpu_torch.forward.gen import metric_pb2
    out = []
    for i in range(n):
        m = metric_pb2.Metric(
            name=f"fleet.{i}", tags=["host:h%d" % (i % 3), "dc:x"][:i % 3],
            type=(metric_pb2.Counter, metric_pb2.Gauge,
                  (metric_pb2.Histogram, metric_pb2.Timer)[i // 4 % 2],
                  metric_pb2.Set)[i % 4], scope=i % 3)
        if i % 4 == 0:
            m.counter.value = int(rng.integers(-5, 10 ** 9))
        elif i % 4 == 1:
            m.gauge.value = float(rng.normal(0, 1e3))
        elif i % 4 == 2:
            d = m.histogram.t_digest
            d.compression, d.min, d.max, d.reciprocalSum = 100, 1, 90, 0.3
            for v in np.sort(rng.gamma(2.0, 30.0, int(rng.integers(0, 40)))):
                c = d.main_centroids.add()
                c.mean, c.weight = float(v), float(rng.integers(1, 4))
        else:
            m.set.hyper_log_log = bytes(rng.integers(0, 255, 40, np.uint8))
        out.append(m)
    return out


def _ml_wires(rng) -> dict[str, bytes]:
    """Serialized MetricLists: a fleet wire; the same with unknown fields
    at every level (list, metric, value and digest messages); a
    histogram whose oneof a later counter field overwrites (proto3
    last-one-wins leaves its centroids orphaned in the columns); an
    empty list; truncations of the fleet wire; garbage."""
    from veneur_tpu_torch.forward.gen import forward_pb2
    ms = _fleet_metrics(rng)
    fleet = forward_pb2.MetricList(metrics=ms).SerializeToString()
    unknown = []
    for m in ms:
        b = m.SerializeToString()
        b += b"\x78\x05" + b"\x81\x01" + bytes(8) + b"\x8d\x01" + bytes(4)
        b += _field(18, b"abc")
        if m.WhichOneof("value") == "counter":
            b += _field(5, b"\x08\x07\x10\x01")  # value 7, field 2 unknown
        elif m.WhichOneof("value") == "histogram":
            # a second histogram field merges in one more centroid
            cent = b"\x09" + np.float64(5.5).tobytes() + b"\x11" + \
                np.float64(2).tobytes() + b"\x19" + bytes(8)
            b += _field(7, _field(1, b"\x48\x03" + _field(1, cent)))
        unknown.append(b"\x10\x05" + _field(1, b))
    hist = next(m for m in ms if m.WhichOneof("value") == "histogram"
                and len(m.histogram.t_digest.main_centroids))
    orphan = _field(1, hist.SerializeToString() + _field(5, b"\x08\x03"))
    return {"fleet": fleet,
            "unknown_fields": b"".join(unknown),
            "orphaned": (_field(1, ms[2].SerializeToString()) + orphan +
                         _field(1, ms[6].SerializeToString())),
            "empty": b"",
            "garbage": b"\xff\xff\xff\x01garbage",
            **{f"cut{k}": fleet[:len(fleet) * k // 7] for k in range(1, 7)}}


def _ml_decode(lib, data: bytes, caps=(64, 4096, 256)):
    from veneur_tpu_torch.forward import grpc_forward as gf
    cols = {k: np.zeros_like(v) for k, v in gf._alloc_cols(*caps).items()}
    needed = np.zeros(3, np.int64)
    rc = gf._decode_call(lib, np.frombuffer(data, np.uint8), cols, needed)
    return rc, needed, cols


def _ml_keyhash(lib, data: bytes, cols, n: int) -> np.ndarray:
    out = np.zeros(n, np.uint64)
    c = ctypes
    lib.vtpu_metriclist_keyhash(
        _p(np.frombuffer(data, np.uint8), c.c_uint8), n,
        _p(cols["name_off"], c.c_int64), _p(cols["name_len"], c.c_int32),
        _p(cols["kind"], c.c_uint8), _p(cols["mtype"], c.c_int32),
        _p(cols["scope"], c.c_int32), _p(cols["tag_start"], c.c_int64),
        _p(cols["tag_cnt"], c.c_int32), _p(cols["tag_off"], c.c_int64),
        _p(cols["tag_len"], c.c_int32), _p(out, c.c_uint64))
    return out


@pytest.mark.parametrize("wire", ["fleet", "unknown_fields", "orphaned",
                                  "empty", "garbage", "cut1", "cut2",
                                  "cut3", "cut4", "cut5", "cut6"])
def test_metriclist_decode_bit_equal(libs, wire):
    """vtpu_metriclist_decode and vtpu_metriclist_keyhash in both
    libraries on the same wire: the return code, the need triple, every
    column and every identity hash bit-equal; a wire is malformed (-1)
    exactly when protobuf refuses it."""
    from google.protobuf.message import DecodeError

    from veneur_tpu_torch.forward.gen import forward_pb2
    data = _ml_wires(np.random.default_rng(31))[wire]
    (rc, need, mine), (jrc, jneed, ref) = (_ml_decode(lib, data)
                                           for lib in libs)
    assert rc == jrc
    np.testing.assert_array_equal(need, jneed)
    for k in mine:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
    try:
        n_pb = len(forward_pb2.MetricList.FromString(data).metrics)
    except DecodeError:
        n_pb = -1
    assert rc == n_pb
    if rc > 0:
        np.testing.assert_array_equal(_ml_keyhash(libs[0], data, mine, rc),
                                      _ml_keyhash(libs[1], data, ref, rc))
    if wire == "unknown_fields":
        # the unknown fields change no column of the known ones
        _, _, clean = _ml_decode(libs[0], _ml_wires(
            np.random.default_rng(31))["fleet"])
        for k in ("name_len", "mtype", "scope", "tag_cnt", "hll_len"):
            np.testing.assert_array_equal(mine[k], clean[k], err_msg=k)
        kinds = mine["kind"][:rc]
        scalar, clean_scalar = mine["scalar"][:rc], clean["scalar"][:rc]
        np.testing.assert_array_equal(scalar[kinds == 1], 7.0)
        np.testing.assert_array_equal(scalar[kinds == 2],
                                      clean_scalar[kinds == 2])
        # each digest gained the one centroid appended to it
        np.testing.assert_array_equal(
            mine["cent_cnt"][:rc], clean["cent_cnt"][:rc] + (kinds == 3))
    if wire == "orphaned":
        assert list(mine["kind"][:3]) == [3, 1, 3]
        assert mine["cent_cnt"][1] > 0 and mine["scalar"][1] == 3.0


def test_metriclist_decode_grow_and_retry(libs):
    """Buffers too small for the wire: both libraries return -2 with the
    same exact need, and one retry at that need decodes what large
    buffers decode."""
    data = _ml_wires(np.random.default_rng(31))["fleet"]
    rc, need, _ = _ml_decode(libs[0], data, caps=(3, 5, 2))
    jrc, jneed, _ = _ml_decode(libs[1], data, caps=(3, 5, 2))
    assert rc == jrc == -2
    np.testing.assert_array_equal(need, jneed)
    assert need[0] == 12
    rc, _, exact = _ml_decode(libs[0], data, caps=tuple(int(x) for x in need))
    rc2, _, big = _ml_decode(libs[0], data)
    assert rc == rc2 == 12
    for k in exact:
        n = len(exact[k])
        np.testing.assert_array_equal(exact[k], big[k][:n], err_msg=k)


# ---- the identity index ------------------------------------------------

def test_native_index_matches_hash_index(libs):
    rng = np.random.default_rng(10)
    keys = rng.integers(1, 2 ** 63, 5000, dtype=np.uint64)
    keys[7] = 0  # the zero key, aliased in both
    vals = rng.integers(0, 1000, len(keys)).astype(np.int32)
    vals[::11] = intern.DROPPED
    nat = intern.NativeHashIndex(libs[0], capacity=1024)  # grows
    ref = intern.HashIndex(capacity=1024)
    jnat = jintern.NativeHashIndex(libs[1], capacity=1024)
    for k, v in zip(keys, vals):
        nat.insert(int(k), int(v))
        ref.insert(int(k), int(v))
        jnat.insert(int(k), int(v))
    probe = np.concatenate([keys, rng.integers(1, 2 ** 63, 3000,
                                               dtype=np.uint64),
                            np.array([0, 2 ** 64 - 1], np.uint64)])
    got = nat.lookup(probe)
    np.testing.assert_array_equal(got, ref.lookup(probe))
    np.testing.assert_array_equal(got, jnat.lookup(probe))
    assert (got[len(keys):-2] == intern.MISSING).all()
    assert got[7] == vals[7]
    assert (got[:len(keys)][::11] == intern.DROPPED).all()
    assert nat.count == ref.count == len(np.unique(keys))
    nat.insert(0, 5)  # overwrite
    assert nat.lookup(np.array([0], np.uint64))[0] == 5
    nat.clear()
    assert nat.count == 0
    assert (nat.lookup(keys) == intern.MISSING).all()


# ---- the table's fused ingest ------------------------------------------

_SIZES = dict(counter_rows=48, gauge_rows=48, histo_rows=64, set_rows=8)


def _tables(**extra):
    jt = JTable(JConfig(**_SIZES, **extra))
    assert jt._lib is not None
    return jt, MetricTable(TableConfig(**_SIZES, **extra), device="cpu")


def _staging(t):
    h = t._histo_stage
    return dict(
        counter=t._counter_dense.copy(), gauge=t._gauge_dense.copy(),
        gauge_mask=t._gauge_mask.copy(),
        touched=[i.touched.copy() for i in (t.counter_idx, t.gauge_idx,
                                            t.histo_idx, t.set_idx)],
        drops=[i.overflow for i in (t.counter_idx, t.gauge_idx,
                                    t.histo_idx, t.set_idx)],
        meta=[[(m.name, m.tags, m.scope, m.key_hash) for m in i.meta]
              for i in (t.counter_idx, t.gauge_idx, t.histo_idx,
                        t.set_idx)],
        histo=[np.concatenate(x) if x else None
               for x in (h.rows, h.values, h.weights)],
        sets=[np.concatenate(x) if x else None
              for x in (t._set_pos_rows, t._set_pos)],
        staged=t.staged())


def _assert_same_staging(tt, jt):
    a, b = _staging(tt), _staging(jt)
    for k in a:
        if k in ("touched", "histo", "sets"):
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y, err_msg=k)
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("how", ["buffer", "columns"])
def test_ingest_matches_jax_table(how):
    """Two buffers (new series, then mostly known ones) through the
    port's fused ingest and the JAX table's: the same (processed,
    dropped, others) and the same staging, byte for byte — including
    drops once the small tables fill."""
    rng = np.random.default_rng(11)
    jt, tt = _tables()
    for _ in range(2):
        buf = b"\n".join(_text(rng, 2000))
        if how == "buffer":
            got, want = tt.ingest_buffer(buf), jt.ingest_buffer(buf)
            assert got == want
            assert got[2], "event/service-check/error lines reported"
        else:
            tb = columnar.ColumnarParser().parse(buf)
            jb = jcol.ColumnarParser().parse(buf)
            assert tt.ingest_columns(tb) == jt.ingest_columns(jb)
        _assert_same_staging(tt, jt)
    assert any(i.overflow for i in (tt.counter_idx, tt.histo_idx)), \
        "the small tables overflowed"


def test_compaction_then_ingest_buffer_hits_renumbered_rows():
    """Idle series compact away at the swap and the native key index is
    rebuilt: the survivors' lines then hit their NEW rows (no miss, no
    new row), in both tables alike."""
    jt, tt = _tables()
    for t in (jt, tt):
        t.ingest_buffer(b"\n".join(f"old{i}:1|c".encode()
                                   for i in range(40)))
        t.ingest_buffer(b"keep:1|c\nkeep2:1|c")
        t.swap()
        t.ingest_buffer(b"keep:2|c\nkeep2:3|c")
        t.swap()  # old* idle for an interval: compacted here
    names = [m.name for m in tt.counter_idx.meta]
    assert sorted(names) == ["keep", "keep2"]
    assert names == [m.name for m in jt.counter_idx.meta]
    for t in (jt, tt):
        before = t.key_index.count
        assert t.ingest_buffer(b"keep2:5|c\nkeep:4|c")[:2] == (2, 0)
        assert t.key_index.count == before  # no miss resolved
        assert len(t.counter_idx.meta) == 2
    want = {"keep": 4.0, "keep2": 5.0}
    np.testing.assert_array_equal(tt._counter_dense[:2],
                                  [want[n] for n in names])
    _assert_same_staging(tt, jt)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a source that does not compile raises, naming the
    compiler's error, and the table cannot be built without it."""
    bad = tmp_path / "dsd_parse.cpp"
    bad.write_text("this is not C++ at all;\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="native library build failed"):
        native.load()
    with pytest.raises(RuntimeError, match="error"):
        MetricTable(TableConfig(**_SIZES), device="cpu")
    with pytest.raises(RuntimeError):
        columnar.ColumnarParser()


# ---- the io_uring ring ----------------------------------------------------

def _uring_blocks(path) -> list[str]:
    """The ``#ifdef VTPU_HAVE_URING`` blocks of a dsd_parse.cpp, with
    comments and blank lines stripped."""
    import re
    text = open(path).read()
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    text = re.sub(r"//[^\n]*", "", text)
    lines = [ln.rstrip() for ln in text.split("\n") if ln.strip()]
    blocks, cur = [], None
    for ln in lines:
        if ln == "#ifdef VTPU_HAVE_URING":
            cur = []
        if cur is not None:
            cur.append(ln)
            if ln == "#endif":
                blocks.append("\n".join(cur))
                cur = None
    return blocks


def test_uring_source_is_the_reference_text():
    """The ring and its exports are the reference's code, comments
    aside (two blocks: the ring, and the exports with their stubs)."""
    import pathlib
    ref = pathlib.Path(jnative.__file__).parent / "dsd_parse.cpp"
    got, want = _uring_blocks(native.SOURCE), _uring_blocks(ref)
    assert len(want) == 2 and got == want


def _uring_refused(lib) -> bool:
    return int(lib.vtpu_uring_probe()) != 0


def test_uring_probe_and_bad_arguments_as_reference(libs):
    """The probe answers alike, and both refuse the same bad pools
    (not a power of two, buffers under 64 bytes) with EINVAL."""
    import errno
    from veneur_tpu.native import uring as juring
    from veneur_tpu_torch.native import uring
    tlib, jlib = libs
    assert int(tlib.vtpu_uring_probe()) == int(jlib.vtpu_uring_probe())
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for mod, lib in ((uring, tlib), (juring, jlib)):
            for count, length in ((3, 128), (8, 16)):
                err = ctypes.c_int64(0)
                arena = np.zeros(max(count * length, 1), np.uint8)
                h = lib.vtpu_uring_new(sock.fileno(), count, length,
                                       _p(arena, ctypes.c_uint8),
                                       ctypes.byref(err))
                assert not h and err.value == errno.EINVAL
            with pytest.raises(ValueError):
                mod.UringReader(lib, sock.fileno(), 6, 128)
    finally:
        sock.close()


def _ring_round(mod, lib, dgrams, fn, buf_len=257):
    """A ring of the given module (16 buffers of ``buf_len``) over a
    fresh socket, ``dgrams`` sent to it, then ``fn(ring)``; the ring and
    socket closed."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    ring = mod.UringReader(lib, rx.fileno(), 16, buf_len)
    try:
        for d in dgrams:
            tx.sendto(d, rx.getsockname())
        return fn(ring)
    finally:
        ring.close()
        rx.close()
        tx.close()


def test_uring_drain_bit_equal(libs):
    """The copy-out drain: the same datagrams through each library's
    ring give the same newline-joined bytes and counts, the oversize
    datagram rejected whole, the empty one recycled uncounted, and the
    same pool counters after."""
    from veneur_tpu.native import uring as juring
    from veneur_tpu_torch.native import uring
    tlib, jlib = libs
    if _uring_refused(tlib):
        pytest.skip("io_uring refused by this kernel")
    dgrams = [b"a:1|c", b"b:2|g\nc:3|ms", b"x" * 300, b"", b"d:4|s"]

    def drain(ring):
        out = np.zeros(16 * 258, np.uint8)
        got, n, nov, neb = b"", 0, 0, 0
        for _ in range(50):  # until every datagram completed
            w, m, o, e = ring.drain(out, 16, 256, 100, 1)
            got += out[:w].tobytes()
            n, nov, neb = n + m, nov + o, neb + e
            if n + nov >= len(dgrams) - 1:
                break
        st = ring.stats()
        return got, n, nov, neb, {k: st[k] for k in (
            "buf_count", "buf_len", "completions", "oversize", "enobufs",
            "held_bufs", "armed", "dead_errno")}

    got = _ring_round(uring, tlib, dgrams, drain)
    want = _ring_round(juring, jlib, dgrams, drain)
    assert got == want
    assert got[2] == 1 and got[1] == 3
    assert got[0] == b"a:1|c\nb:2|g\nc:3|ms\nd:4|s\n"


def test_uring_parse_ingest_matches_jax_table():
    """The in-place fused pass: the same datagrams (every line kind,
    malformed ones included) through a port reader shard's
    ``parse_ring`` and a JAX shard's give the same (processed, dropped,
    others), the same staging and the same held datagrams; the buffers
    stay held through the commit and return to the pool on release."""
    from veneur_tpu.native import uring as juring
    from veneur_tpu_torch.native import uring
    if _uring_refused(native.load()):
        pytest.skip("io_uring refused by this kernel")
    rng = np.random.default_rng(12)
    lines = _text(rng, 240)
    dgrams = [b"\n".join(lines[i:i + 12]) for i in range(0, 240, 12)]
    dgrams.append(b"y" * 1100)  # oversize: rejected whole

    def run(mod, table):
        shard = table.make_reader_shard()

        def fn(ring):
            n = nov = 0
            outs = []
            while n + nov < len(dgrams):
                _w, m, o, _e = shard.parse_ring(ring, 8, 1024, 200, 1)
                n, nov = n + m, nov + o
                if not m:
                    continue
                held = ring.stats()["held_bufs"]
                pending = ring.pending_copy()
                outs.append((m, shard.commit(), held, pending,
                             ring.stats()["held_bufs"]))
                shard.reset()
                ring.release()
            return outs, n, nov, ring.stats()["held_bufs"]
        return _ring_round(mod, table._lib, dgrams, fn, buf_len=1025)

    jt, tt = _tables()
    got, want = run(uring, tt), run(juring, jt)
    assert got == want
    outs, n, nov, held_after = got
    assert (n, nov, held_after) == (len(dgrams) - 1, 1, 0)
    assert all(m == held == held_commit for m, _c, held, _p, held_commit
               in outs), "every parsed buffer held through the commit"
    assert b"".join(p for _m, _c, _h, p, _hc in outs) == b"".join(
        d + b"\n" for d in dgrams[:-1])
    assert any(c[2] for _m, c, _h, _p, _hc in outs), "slow-path lines"
    _assert_same_staging(tt, jt)
