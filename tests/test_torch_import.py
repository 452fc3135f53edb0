"""CPU parity of the port's global tier over HTTP against the JAX package.

The wire codecs (gob, HLL, both /import schemas), the import surface of
the table (``apply_import``, the stacked, per-wire and flat wire folds,
``merge_wire_stack_rows``), the local-role flush, and a local -> global
chain of two port servers over real UDP and HTTP.  Every case feeds
the same seeded inputs through ``veneur_tpu`` and ``veneur_tpu_torch``.

Tolerances (each comparison states its own): encoded bytes, counters,
gauges, counts, min/max, HLL registers and set estimates match exactly;
float sums to rtol 1e-6; percentiles to rtol 2e-3 / atol 1e-3, the
reference's merge tolerance (tests/test_pallas_merge.py); the port's
stack and per-wire folds are bit-identical.
"""

from __future__ import annotations

import base64
import json
import socket
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.core.flusher import Flusher as JFlusher
from veneur_tpu.core.table import MetricTable as JTable
from veneur_tpu.core.table import TableConfig as JConfig
from veneur_tpu.forward import gob_codec as jgob
from veneur_tpu.forward import hll_codec as jhllc
from veneur_tpu.forward import http_import as jhttp
from veneur_tpu.ops import tdigest as jtd
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.flusher import Flusher, ForwardRow
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.core.table import MetricTable, TableConfig
from veneur_tpu_torch.forward import gob_codec, hll_codec, http_import
from veneur_tpu_torch.ops import hll, tdigest
from veneur_tpu_torch.protocol import dogstatsd as dsd
from veneur_tpu_torch.sinks.simple import CaptureSink
from veneur_tpu_torch.utils import hashing

PCTS = (0.5, 0.9, 0.99)
AGGS = ("min", "max", "count", "sum", "avg", "median", "hmean")
QS = np.array([0.1, 0.5, 0.9, 0.99], np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _by_name(metrics):
    out = {(m.name, m.tags): m for m in metrics}
    assert len(out) == len(metrics), "duplicate metric keys"
    return out


def _assert_same_flush(tm, jm):
    t, j = _by_name(tm), _by_name(jm)
    assert set(t) == set(j)
    for key, jv in j.items():
        tv = t[key]
        assert tv.type == jv.type, key
        if key[0].endswith(("percentile", ".median")):
            np.testing.assert_allclose(tv.value, jv.value, rtol=2e-3,
                                       atol=1e-3, err_msg=str(key))
        elif key[0].endswith((".sum", ".avg", ".hmean")):
            np.testing.assert_allclose(tv.value, jv.value, rtol=1e-6,
                                       err_msg=str(key))
        else:  # counters, gauges, count/min/max, set estimates
            assert tv.value == jv.value, (key, tv.value, jv.value)


def _quantiles_close(tm, tw, jm, jw):
    qt = _np(tdigest.quantile(torch.as_tensor(np.asarray(tm)),
                              torch.as_tensor(np.asarray(tw)),
                              torch.from_numpy(QS)))
    qj = np.asarray(jtd.quantile(jnp.asarray(np.asarray(jm)),
                                 jnp.asarray(np.asarray(jw)),
                                 jnp.asarray(QS)))
    np.testing.assert_allclose(qt, qj, rtol=2e-3, atol=1e-3,
                               equal_nan=True)


def _local_lines(rng, n_timer=20, per=60, prefix="t") -> list[bytes]:
    """One local's interval: global-only counters and gauges, mixed-
    and local-scope timers, a global-only histogram, sets."""
    out = [b"req:3|c|#veneurglobalonly", b"req:2|c|#veneurglobalonly",
           b"req:1|c|#veneurglobalonly,env:b", b"plain:5|c",
           b"depth:4|g|#veneurglobalonly", b"depth:9|g|#veneurglobalonly",
           b"temp:7|g", b"loc:1|ms|#veneurlocalonly",
           b"loc:3|ms|#veneurlocalonly", b"gh:2.5|h|#veneurglobalonly"]
    for i in range(n_timer):
        out += [f"{prefix}{i}:{v:.3f}|ms".encode()
                for v in rng.gamma(2.0, 30.0, per)]
    out += [f"deep:{v:.3f}|ms|#k:v".encode()
            for v in rng.gamma(2.0, 30.0, 700)]
    for i in range(3):
        out += [f"users{i}:u{j}|s".encode()
                for j in rng.integers(0, 400, 150)]
    out += [f"gset:m{j}|s|#veneurglobalonly".encode() for j in range(20)]
    return [out[i] for i in rng.permutation(len(out))]


_LOCAL = dict(counter_rows=64, gauge_rows=64, histo_rows=64, set_rows=8)


def _local_flush(lines, sizes=_LOCAL):
    """The same text through a JAX local and a port local: (port
    FlushResult, JAX FlushResult)."""
    jt = JTable(JConfig(**sizes))
    tt = MetricTable(TableConfig(**sizes), device="cpu")
    buf = b"\n".join(lines)
    assert tt.ingest_buffer(buf) == jt.ingest_buffer(buf)
    kw = dict(percentiles=PCTS, aggregates=AGGS, hostname="h")
    jr = JFlusher(is_local=True, **kw).flush(jt.swap(), now=1)
    tr = Flusher(is_local=True, **kw, device="cpu").flush(tt.swap(), now=1)
    return tr, jr


def _fwd_key(r):
    return (r.kind, r.meta.name, r.meta.tags, r.meta.scope)


# ---- the local role ---------------------------------------------------

def test_local_flush_matches_jax():
    """A local emits what the JAX local emits (no percentiles, local
    aggregates of mixed-scope timers, local-only rows in full) and
    forwards the same rows: global-scope counters and gauges by value,
    digests with their stat rows, set registers bit for bit."""
    tr, jr = _local_flush(_local_lines(np.random.default_rng(5)))
    _assert_same_flush(tr.metrics, jr.metrics)
    names = {m.name for m in tr.metrics}
    assert "loc.99percentile" in names and "t0.count" in names
    assert not any(n.startswith(("t0.", "deep.")) and
                   n.endswith("percentile") for n in names)
    assert not any(n.startswith(("req", "depth", "gh", "gset"))
                   for n in names)
    tf = {_fwd_key(r): r for r in tr.forward}
    jf = {_fwd_key(r): r for r in jr.forward}
    assert set(tf) == set(jf)
    kinds = sorted(k[0] for k in tf)
    assert kinds.count("counter") == 2 and kinds.count("gauge") == 1
    assert kinds.count("set") == 4 and kinds.count("histo") == 22
    for key, j in jf.items():
        t = tf[key]
        if key[0] in ("counter", "gauge"):
            assert t.value == j.value, key
        elif key[0] == "set":
            np.testing.assert_array_equal(t.regs, np.asarray(j.regs))
        else:
            js = np.asarray(j.stats)
            np.testing.assert_array_equal(t.stats[[0, 1, 2]], js[[0, 1, 2]])
            np.testing.assert_allclose(t.stats, js, rtol=1e-6)
            np.testing.assert_allclose(t.weights.sum(), j.weights.sum(),
                                       rtol=1e-6)
            _quantiles_close(t.means[None], t.weights[None],
                             np.asarray(j.means)[None],
                             np.asarray(j.weights)[None])


# ---- codecs -------------------------------------------------------------

@pytest.mark.parametrize("what", ["digest", "digest_empty", "counter",
                                  "gauge"])
def test_gob_codec_matches_jax(what):
    """Encoders give the same bytes, decoders the same values."""
    rng = np.random.default_rng(len(what))
    if what.startswith("digest"):
        n = 0 if what == "digest_empty" else 80
        means = np.sort(rng.gamma(2.0, 30.0, n)).astype(np.float32)
        wts = rng.integers(0, 5, n).astype(np.float32)  # zeros skipped
        args = (means, wts, 100.0, float(means.min(initial=1.0)),
                float(means.max(initial=1.0)), 0.37)
        enc = gob_codec.encode_digest(*args)
        assert enc == jgob.encode_digest(*args)
        t, j = gob_codec.decode_digest(enc), jgob.decode_digest(enc)
        for k in ("means", "weights"):
            np.testing.assert_array_equal(t[k], j[k])
        for k in ("compression", "min", "max", "rsum"):
            assert t[k] == j[k]
        np.testing.assert_array_equal(t["means"], means[wts > 0])
    else:
        v = float(rng.normal(1e6, 1e5))
        enc = getattr(gob_codec, f"encode_{what}")(v)
        assert enc == getattr(jgob, f"encode_{what}")(v)
        assert (getattr(gob_codec, f"decode_{what}")(enc) ==
                getattr(jgob, f"decode_{what}")(enc))
        with pytest.raises(ValueError):
            getattr(gob_codec, f"decode_{what}")(enc[:7])


def _sparse_sketch(members) -> bytes:
    """An axiomhq sparse sketch: half the encoded hashes in the tmpSet,
    half in the varint-delta list (sparse.go:15 encodeHash)."""
    keys = []
    for h in hashing.hash64(members):
        h = int(h)
        idx = (h >> (64 - 25)) & ((1 << 25) - 1)
        if (h >> (64 - 25)) & ((1 << 11) - 1) == 0:
            w = ((h << 25) & ((1 << 64) - 1)) | (1 << 24)
            keys.append((idx << 7) | ((64 - w.bit_length() + 1) << 1) | 1)
        else:
            keys.append(idx << 1)
    keys = sorted(set(keys))
    tmpset, listed = keys[::2], keys[1::2]
    body = bytearray([1, 14, 0, 1]) + len(tmpset).to_bytes(4, "big")
    for k in tmpset:
        body += k.to_bytes(4, "big")
    var = bytearray()
    last = 0
    for k in listed:
        x, last = k - last, k
        while x & ~0x7F:
            var.append((x & 0x7F) | 0x80)
            x >>= 7
        var.append(x)
    body += len(listed).to_bytes(4, "big") + last.to_bytes(4, "big")
    body += len(var).to_bytes(4, "big") + var
    return bytes(body)


@pytest.mark.parametrize("form", ["dense", "sparse", "garbage"])
def test_hll_codec_matches_jax(form):
    rng = np.random.default_rng(3)
    if form == "dense":
        regs = rng.integers(0, 30, hll.M).astype(np.uint8)
        enc = hll_codec.encode_dense(regs)
        assert enc == jhllc.encode_dense(regs)
        out = hll_codec.decode(enc)
        np.testing.assert_array_equal(out, np.minimum(regs, 15))
    elif form == "sparse":
        enc = _sparse_sketch([f"m{i}".encode() for i in range(90)])
        out = hll_codec.decode(enc)
        assert out.any()
    else:
        for bad in (b"\x01", bytes([1, 10, 0, 0]) + bytes(16),
                    bytes([1, 14, 0, 0]) + (8192).to_bytes(4, "big")):
            with pytest.raises(ValueError):
                hll_codec.decode(bad)
            with pytest.raises(ValueError):
                jhllc.decode(bad)
        return
    np.testing.assert_array_equal(out, jhllc.decode(enc))


@pytest.mark.parametrize("schema", ["native", "reference"])
def test_encode_rows_byte_identical(schema):
    """The same ForwardRows encode to the same body in both packages."""
    tr, _ = _local_flush(_local_lines(np.random.default_rng(9)))
    if schema == "native":
        t = http_import.encode_rows(tr.forward)
        j = jhttp.encode_rows(tr.forward)
    else:
        t = http_import.encode_rows_reference(tr.forward,
                                              compression=100.0)
        j = jhttp.encode_rows_reference(tr.forward, compression=100.0)
    assert t == j
    assert (http_import.decode_body(t[0], "deflate") ==
            jhttp.decode_body(j[0], "deflate"))


def test_import_headers_decode_fail_open():
    hdr = {http_import.TRACE_HEADER: "12:34",
           http_import.DRAIN_HEADER: "1",
           http_import.RECOVERY_HEADER: "bad",
           http_import.HANDOFF_HEADER: "0"}
    got = http_import.decode_headers(hdr)
    assert got == {"trace": (12, 34), "drain": True, "replay": False,
                   "recovery": "", "handoff": False}
    assert got["trace"] == jhttp.decode_trace_header("12:34")
    assert http_import.decode_trace_header("x:y") == (0, 0)
    assert http_import.decode_headers({})["trace"] == (0, 0)


# ---- apply_import ---------------------------------------------------------

def _riders() -> list[dict]:
    """Malformed items: bad base64, truncated gob, unknown type, a NaN
    gauge, non-finite digest stats, a native item of unknown kind and
    a native histo with mismatched centroid shapes."""
    good = gob_codec.encode_digest([1.0, 2.0], [1.0, 1.0], 100.0, 1.0,
                                   2.0, 1.5)
    b64 = lambda b: base64.b64encode(b).decode()  # noqa: E731
    return [
        {"name": "bad.b64", "type": "counter", "tags": [],
         "value": "!!!not-b64!!!"},
        {"name": "bad.gob", "type": "histogram", "tags": [],
         "value": b64(good[:7])},
        {"name": "bad.type", "type": "mystery", "tags": [],
         "value": b64(b"x")},
        {"name": "bad.nan", "type": "gauge", "tags": [],
         "value": b64(gob_codec.encode_gauge(float("nan")))},
        {"name": "bad.inf", "type": "histogram", "tags": [],
         "value": b64(gob_codec.encode_digest(
             [1.0], [1.0], 100.0, float("inf"), 1.0, 0.0))},
        {"name": "bad.kind", "kind": "mystery", "type": "x", "tags": []},
        {"name": "bad.shape", "kind": "histo", "type": "histogram",
         "tags": [], "stats": [1, 1, 1, 1, 1],
         "means": base64.b64encode(np.ones(3, np.float32)).decode(),
         "weights": base64.b64encode(np.ones(2, np.float32)).decode()},
    ]


def _bodies(schema: str, n_wires: int = 3, seed: int = 0):
    """Decoded /import items of ``n_wires`` locals' flushes."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(n_wires):
        tr, _ = _local_flush(_local_lines(rng))
        rows = tr.forward
        if schema == "native":
            body, hdr = http_import.encode_rows(rows)
        elif schema == "reference":
            body, hdr = http_import.encode_rows_reference(rows)
        else:  # mixed: half the rows in each schema, in one body
            a, _ = http_import.encode_rows(rows[::2], deflate=False)
            b, _ = http_import.encode_rows_reference(rows[1::2],
                                                     deflate=False)
            body = json.dumps(json.loads(a) + json.loads(b)).encode()
            hdr = {}
        out.append(http_import.decode_body(
            body, hdr.get("Content-Encoding", "")))
    return out


_GLOBAL = dict(counter_rows=64, gauge_rows=64, histo_rows=64, set_rows=8)


def _global_flush(table, is_jax):
    kw = dict(percentiles=PCTS, aggregates=AGGS, hostname="h")
    if is_jax:
        return JFlusher(is_local=False, **kw).flush(table.swap(), now=1)
    return Flusher(**kw, device="cpu").flush(table.swap(), now=1)


@pytest.mark.parametrize("schema", ["native", "reference", "mixed"])
def test_apply_import_matches_jax(schema):
    """Three wires (plus malformed riders on the last) into a JAX global
    and a port global: the same accepted and dropped counts, then the
    same flush; the reference-schema batch decode also equals its
    per-item oracle."""
    wires = _bodies(schema)
    wires[-1] = wires[-1] + _riders()
    jt, tt = JTable(JConfig(**_GLOBAL)), MetricTable(
        TableConfig(**_GLOBAL), device="cpu")
    for items in wires:
        got = http_import.apply_import(tt, items)
        assert got == jhttp.apply_import(jt, items)
    assert got[1] == len(_riders())
    jr, tr = _global_flush(jt, True), _global_flush(tt, False)
    assert len(tr.metrics) > 80
    _assert_same_flush(tr.metrics, jr.metrics)
    names = {m.name for m in tr.metrics}
    assert "t0.99percentile" in names and "req" in names
    if schema != "native":
        ref = [it for it in wires[-1]
               if "kind" not in it and isinstance(it.get("value"), str)]
        a = MetricTable(TableConfig(**_GLOBAL), device="cpu")
        b = MetricTable(TableConfig(**_GLOBAL), device="cpu")
        wa, wb = http_import._WireBatch(a), http_import._WireBatch(b)
        got_a = http_import._apply_reference_batch(a, ref, wa)
        got_b = http_import._apply_reference_fallback(b, ref, wb)
        wa.stage()
        wb.stage()
        assert got_a == got_b
        assert a._wire_digest_n == b._wire_digest_n > 0
        for pa, pb in zip(a._wire_digest_parts, b._wire_digest_parts):
            for x, y in zip(pa, pb):
                np.testing.assert_array_equal(x, y)


def test_gauge_import_last_write_in_wire_order():
    """Native items apply in body order, reference items after them, so
    a gauge's last write is the reference item's."""
    nat = {"name": "g", "kind": "gauge", "type": "gauge", "tags": [],
           "scope": "", "value": 1.0}
    ref = {"name": "g", "type": "gauge", "tags": [],
           "value": base64.b64encode(gob_codec.encode_gauge(3.0)).decode()}
    items = [dict(nat, value=1.0), ref, dict(nat, value=2.0)]
    jt, tt = JTable(JConfig(**_GLOBAL)), MetricTable(
        TableConfig(**_GLOBAL), device="cpu")
    assert http_import.apply_import(tt, items) == jhttp.apply_import(
        jt, items)
    tv = {m.name: m.value for m in _global_flush(tt, False).metrics}
    jv = {m.name: m.value for m in _global_flush(jt, True).metrics}
    assert tv == jv == {"g": 3.0}


# ---- the wire folds ----------------------------------------------------------

def test_merge_wire_stack_rows_matches_jax():
    """The stacked fold against the JAX function: live wires merge in
    wire order, a dead wire is skipped even when it holds data."""
    rng = np.random.default_rng(17)
    R, U, K, W = 24, 10, 16, 8
    cap = tdigest.DEFAULT_CAPACITY
    occ = rng.integers(0, 40, R)
    live_slot = np.arange(cap)[None, :] < occ[:, None]
    means = np.where(live_slot, np.sort(rng.gamma(2.0, 30.0, (R, cap)),
                                        axis=1), 0).astype(np.float32)
    weights = np.where(live_slot, rng.integers(1, 9, (R, cap)),
                       0).astype(np.float32)
    idx = np.full(16, R, np.int32)
    idx[:U] = np.sort(rng.choice(R, U, replace=False))
    sw = (rng.random((W, 16, K)) < 0.7).astype(np.float32)
    sw *= rng.integers(1, 4, sw.shape)
    sm = np.where(sw > 0, rng.gamma(2.0, 30.0, sw.shape),
                  0).astype(np.float32)
    live = np.array([1, 0, 1, 1, 0, 1, 0, 0], bool)
    tm, tw = tdigest.merge_wire_stack_rows(
        torch.from_numpy(means), torch.from_numpy(weights),
        torch.from_numpy(idx), torch.from_numpy(sm), torch.from_numpy(sw),
        live)
    jm, jw = jtd.merge_wire_stack_rows(
        jnp.asarray(means), jnp.asarray(weights), jnp.asarray(idx),
        jnp.asarray(sm), jnp.asarray(sw), jnp.asarray(live),
        compression=100.0)
    np.testing.assert_allclose(_np(tw).sum(1), np.asarray(jw).sum(1),
                               rtol=1e-6)
    _quantiles_close(_np(tm), _np(tw), jm, jw)
    # the live wires only, merged one by one: the same bits
    m, w = torch.from_numpy(means), torch.from_numpy(weights)
    for i in np.flatnonzero(live):
        m, w = tdigest.merge_wire_stack_rows(
            m, w, torch.from_numpy(idx), torch.from_numpy(sm[i:i + 1]),
            torch.from_numpy(sw[i:i + 1]), np.ones(1, bool))
    assert torch.equal(m, tm) and torch.equal(w, tw)
    untouched = np.setdiff1d(np.arange(R), idx[:U])
    np.testing.assert_array_equal(_np(tm)[untouched], means[untouched])


def _fold_tables(monkeypatch, mode, histo_rows, sizes=None):
    monkeypatch.setenv("VENEUR_TPU_FUSED_IMPORT", mode)
    # the serial wire scan is the JAX package's oracle for the fold
    monkeypatch.setenv("VENEUR_TPU_COLLECTIVE_IMPORT", "off")
    cfg = dict(counter_rows=64, gauge_rows=64, histo_rows=histo_rows,
               set_rows=8, histo_slots=64)
    return (JTable(JConfig(**cfg)),
            MetricTable(TableConfig(**cfg), device="cpu"))


@pytest.mark.parametrize("mode,histo_rows,route", [
    ("stack", 512, "wire_stack"), ("perwire", 512, "wire_perwire"),
    ("legacy", 512, None), ("stack", 256, "wire_flat")])
def test_wire_digest_step_matches_jax(monkeypatch, mode, histo_rows,
                                      route):
    """Four wires through ``_wire_digest_step`` in each mode, the JAX
    table forced to the same mode: the same flush.  A row deeper than
    the stack width (64 here) spills to the ranked path; a union-row
    bucket past half the plane (256 of 256 rows) falls back to the
    flat merge; ``legacy`` stages every wire into the one flat digest
    batch at import time."""
    jt, tt = _fold_tables(monkeypatch, mode, histo_rows)
    assert tt.import_mode() == mode and tt._wire_stack_kmax == 64
    assert jt._wire_stack_kmax == tt._wire_stack_kmax
    for items in _bodies("native", n_wires=4, seed=2):
        assert http_import.apply_import(tt, items) == \
            jhttp.apply_import(jt, items)
    parts = 0 if mode == "legacy" else 4
    assert len(tt._wire_digest_parts) == len(jt._wire_digest_parts) == \
        parts
    assert len(tt._digest_stage.rows) == len(jt._digest_stage.rows) == \
        4 - parts
    jr, tr = _global_flush(jt, True), _global_flush(tt, False)
    wire_routes = {k: v for k, v in tt.routes.items()
                   if k.startswith("wire_")}
    assert wire_routes == ({route: 1} if route else {}), tt.routes
    if route in ("wire_stack", "wire_perwire"):  # the deep row spilled
        assert tt.routes.get("deep_scan") or tt.routes.get("ranked")
    _assert_same_flush(tr.metrics, jr.metrics)
    assert any(m.name == "deep.99percentile" for m in tr.metrics)


def test_stack_and_perwire_bit_identical(monkeypatch):
    """The stacked fold and one call per wire give the same planes bit
    for bit (the port's counterpart of tests/test_pipeline.py's
    stack-vs-perwire pin)."""
    snaps = []
    for mode in ("stack", "perwire"):
        _, tt = _fold_tables(monkeypatch, mode, 512)
        for items in _bodies("reference", n_wires=5, seed=4):
            http_import.apply_import(tt, items)
        snaps.append(tt.swap())
    a, b = snaps
    for k in ("histo_means", "histo_weights", "histo_import_stats",
              "counters", "gauges", "hll_regs"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_auto_mode_resolves_per_device(monkeypatch):
    monkeypatch.delenv("VENEUR_TPU_FUSED_IMPORT", raising=False)
    tt = MetricTable(TableConfig(histo_rows=8), device="cpu")
    assert tt.fused_import_mode == "auto"
    assert tt.import_mode() == "legacy"
    tt.device = torch.device("cuda")  # resolution only: nothing runs
    assert tt.import_mode() == "stack"


# ---- two port servers: local -> global over UDP and HTTP -----------------

def _post(port: int, body: bytes, headers=None) -> int:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/import",
                                 data=body, headers=headers or {},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _wait(pred, what: str, timeout: float = 20.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.02)


@pytest.mark.parametrize("schema", ["native", "reference"])
def test_local_global_chain(schema):
    """A port local (UDP in, ``forward_address`` set) forwards to a port
    global (``http_address`` set): the global flushes the percentile
    the JAX chain flushes for ``lat:{0..199}|ms``; a garbage /import
    body gets a 400, is counted, and later imports still flush."""
    sizes = {"tpu_counter_rows": 64, "tpu_gauge_rows": 64,
             "tpu_histo_rows": 64, "tpu_set_rows": 8,
             "interval": "60s", "hostname": "h",
             "percentiles": [0.5, 0.99]}
    gcap = CaptureSink()
    glob = Server(read_config(data=dict(
        sizes, http_address="127.0.0.1:0")), device="cpu",
        extra_sinks=[gcap])
    glob.start()
    local = None
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{glob.http_port}/healthcheck",
                timeout=10) as r:
            assert r.read() == b"ok"
        lcap = CaptureSink()
        local = Server(read_config(data=dict(
            sizes, statsd_listen_addresses=["udp://127.0.0.1:0"],
            forward_address=f"http://127.0.0.1:{glob.http_port}",
            forward_json_schema=schema)), device="cpu",
            extra_sinks=[lcap])
        assert local.is_local and not glob.is_local
        local.start()
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        msgs = [f"lat:{v}|ms".encode() for v in range(200)]
        msgs += [b"hits:2|c|#veneurglobalonly", b"uniq:a|s", b"uniq:b|s"]
        for m in msgs:
            s.sendto(m, ("127.0.0.1", local.bound_ports()[0]))
        s.close()
        _wait(lambda: local.stats["metrics_processed"] == len(msgs),
              "the local's ingest")
        assert _post(glob.http_port, b"\x00garbage") == 400
        # well-formed JSON of malformed items: each dropped and counted
        assert _post(glob.http_port, b'[1, [2], {"kind": "x"}]') == 200
        vars_ = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{glob.http_port}/debug/vars",
            timeout=10).read())["stats"]
        assert vars_["import_errors"] == 1
        assert vars_["metrics_dropped"] == 3
        local.flush_once()
        assert local.stats["forwarded_rows"] == 3
        assert local.stats["forward_errors"] == 0
        lv = {m.name: m.value for m in lcap.metrics}
        assert lv["lat.count"] == 200.0 and "lat.99percentile" not in lv
        glob.flush_once()
    finally:
        if local is not None:
            local.shutdown()
        glob.shutdown()
    gv = {m.name: m.value for m in gcap.metrics}
    assert repr(gv["lat.99percentile"]) == "197.00999450683594"
    assert gv["hits"] == 2.0 and gv["uniq"] == 2.0
    assert glob.stats["import_errors"] == 1
    assert glob.stats["imports_received"] == 3


def test_forward_failure_is_counted():
    cfg = read_config(data={"tpu_histo_rows": 8, "interval": "60s",
                            "forward_address": "http://127.0.0.1:9"})
    srv = Server(cfg, device="cpu")
    srv.table.ingest_buffer(b"lat:1|ms\nlat:2|ms")
    srv.flush_once()
    assert srv.stats["forward_errors"] == 1
    assert srv.stats["metrics_dropped"] == 1


@pytest.mark.parametrize("key,default,bad", [
    ("http_address", "", "nohost"),
    ("forward_address", "", "a:1,b:2"),
    ("forward_json_schema", "native", "protobuf"),
    ("tpu_compression", 100.0, 0)])
def test_config_forward_keys(key, default, bad):
    """The tier keys keep the reference's names and defaults."""
    assert getattr(read_config(data={}), key) == default
    with pytest.raises(ValueError, match=key):
        read_config(data={key: bad})


def test_forward_row_fields_match_jax():
    from veneur_tpu.core.flusher import ForwardRow as JRow
    assert ([f for f in ForwardRow.__dataclass_fields__] ==
            [f for f in JRow.__dataclass_fields__])


def _subnormal_rows() -> list:
    """Forward rows a sender that keeps f32 subnormals could put on a
    wire: a global counter and gauge of 1e-40, a global-scope digest of
    two 1e-40 samples, one mixing 1e-40 with 5, and a default-scope one
    with a subnormal centroid weight."""
    from veneur_tpu_torch.core.table import RowMeta
    tiny = float(np.float32(1e-40))
    cap = tdigest.DEFAULT_CAPACITY
    rows = [ForwardRow(RowMeta("ic", (), dsd.SCOPE_GLOBAL, dsd.COUNTER),
                       "counter", value=tiny),
            ForwardRow(RowMeta("ig", (), dsd.SCOPE_GLOBAL, dsd.GAUGE),
                       "gauge", value=tiny)]
    for name, scope, stats, means, weights in (
            ("h1", dsd.SCOPE_GLOBAL, [2, tiny, tiny, 2 * tiny, 0],
             [tiny], [2]),
            ("h2", dsd.SCOPE_GLOBAL, [2, tiny, 5, 5, 0.2], [tiny, 5],
             [1, 1]),
            ("h3", dsd.SCOPE_DEFAULT, [2, 3, 5, 8, 0.5], [3, 5],
             [tiny, 1])):
        m = np.zeros(cap, np.float32)
        w = np.zeros(cap, np.float32)
        m[:len(means)], w[:len(weights)] = means, weights
        rows.append(ForwardRow(RowMeta(name, (), scope, dsd.TIMER),
                               "histo", stats=np.asarray(stats, np.float32),
                               means=m, weights=w))
    return rows


@pytest.mark.parametrize("path", ["native", "reference", "grpc"])
def test_import_subnormals_flush_as_jax(path):
    """F1 on the import paths, one case per finding: before the flush
    of subnormals the port kept them in imported counters (every
    schema), in ``merge_histo_stats``'s min/max/sum rows (native and
    gRPC) and in forwarded digests' percentiles (every schema).  Now
    the same wire flushes bit-equal to a JAX global, percentiles
    included; the gauge keeps its subnormal in both."""
    from veneur_tpu.forward import grpc_forward as jgf
    from veneur_tpu_torch.forward import grpc_forward as gf
    rows = _subnormal_rows()
    jt = JTable(JConfig(**_GLOBAL))
    tt = MetricTable(TableConfig(**_GLOBAL), device="cpu")
    if path == "grpc":
        wire = gf.rows_to_metric_list(rows).SerializeToString()
        assert (gf.apply_metric_list_bytes(tt, wire) ==
                jgf.apply_metric_list_bytes(jt, wire) == (5, 0))
    else:
        body, hdr = (http_import.encode_rows(rows) if path == "native"
                     else http_import.encode_rows_reference(rows))
        enc = hdr.get("Content-Encoding", "")
        assert (http_import.apply_import(
            tt, http_import.decode_body(body, enc)) ==
            jhttp.apply_import(jt, jhttp.decode_body(body, enc)) == (5, 0))
    jm = _by_name(_global_flush(jt, True).metrics)
    tm = _by_name(_global_flush(tt, False).metrics)
    assert tm.keys() == jm.keys()
    for key, jv in jm.items():
        assert (np.float64(tm[key].value).tobytes() ==
                np.float64(jv.value).tobytes()), (key, tm[key].value,
                                                  jv.value)
    assert tm[("ic", ())].value == 0.0
    assert tm[("ig", ())].value == float(np.float32(1e-40))
    assert tm[("h1.99percentile", ())].value == 0.0
