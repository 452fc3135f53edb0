"""gRPC forward tier: the ``forwardrpc.Forward`` client and import server.

Port of ``veneur_tpu/forward/grpc_forward.py``.  A local forwards its
mergeable state as protobuf ``MetricList`` batches (the reference's
flusher.go:499 ``forwardGRPC``) to a global's ``/forwardrpc.Forward/
SendMetrics`` (importsrv/server.go:102), which merges them into the
table: counters +=, gauges last-write, histogram centroids through the
wire-digest fold, HLL register unions.  The package, method path and
field numbers are the reference's (``forward/gen``, byte-identical
protoc output), so Go locals and proxies interoperate.

The import path is columnar: ``decode_metric_list`` walks the raw wire
in the native library (``vtpu_metriclist_decode``) and hashes each
item's identity (``vtpu_metriclist_keyhash``) without touching the
table, so a handler runs it outside the server's lock;
``apply_decoded`` then resolves rows through the table's row and
wire-plan caches and stages every value with vectorized batch appliers.
The import's ``decode_import`` also classifies the set items' HLL
sketches (and decodes the sparse ones) outside the lock, and
``apply_decoded`` folds them into the import plane in one native pass
under it; only sketches the codec must judge go item by item.
The per-item protobuf path (``apply_metric_list``) runs only for a
wire the native walker calls malformed, for its per-item isolation,
and serves the tests as the columnar path's oracle.
"""

from __future__ import annotations

import ctypes
import logging
import threading
import time
from concurrent import futures

import grpc
import numpy as np
from google.protobuf import empty_pb2
from google.protobuf.message import DecodeError

from veneur_tpu_torch import native
from veneur_tpu_torch.core.flusher import ForwardRow
from veneur_tpu_torch.core.table import MetricTable
from veneur_tpu_torch.forward import hll_codec
from veneur_tpu_torch.forward.gen import forward_pb2, metric_pb2
from veneur_tpu_torch.ops import segment
from veneur_tpu_torch.protocol import dogstatsd as dsd
from veneur_tpu_torch.protocol import wire
from veneur_tpu_torch.protocol.gen import (dogstatsd_grpc_pb2, health_pb2,
                                           ssf_pb2)

log = logging.getLogger("veneur_tpu_torch.grpc")

_METHOD = "/forwardrpc.Forward/SendMetrics"

# Invocation metadata the reference's tiers exchange beside the wire
# (keys are lowercase ASCII).  As on the HTTP path, the trace context
# parents the import span and the flags name the ledger protocol; a
# flagged wire is also counted (``drain_*``, ``replay_*``,
# ``recovery_*``, ``handoff_*_received``), a recovery wire is applied
# once per ``incarnation:seq`` id and credits the ledger's recover arm,
# a handoff wire its reshard arrival.  Every decoder fails open: a bad
# or missing key never rejects an import.
TRACE_ID_KEY = "veneur-trace-id"
SPAN_ID_KEY = "veneur-span-id"
DRAIN_KEY = "veneur-drain"
REPLAY_KEY = "veneur-replay"
RECOVERY_KEY = "veneur-recovery"
HANDOFF_KEY = "veneur-handoff"


def _md(metadata) -> dict:
    return {k: v for k, v in (metadata or ())}


def decode_drain_metadata(metadata) -> bool:
    """True when the wire is a shutdown drain handoff."""
    try:
        return _md(metadata).get(DRAIN_KEY, "") == "1"
    except (TypeError, ValueError):
        return False


def decode_replay_metadata(metadata) -> bool:
    """True when the wire is a spool replay after an outage."""
    try:
        return _md(metadata).get(REPLAY_KEY, "") == "1"
    except (TypeError, ValueError):
        return False


def decode_recovery_metadata(metadata) -> str:
    """The wire's recovery id (``incarnation:seq``) or ""."""
    try:
        rid = _md(metadata).get(RECOVERY_KEY, "")
        return rid if ":" in rid else ""
    except (TypeError, ValueError):
        return ""


def decode_handoff_metadata(metadata) -> bool:
    """True when the wire is a scale-out arc handoff."""
    try:
        return _md(metadata).get(HANDOFF_KEY, "") == "1"
    except (TypeError, ValueError):
        return False


def decode_trace_metadata(metadata) -> tuple[int, int]:
    """(trace_id, span_id); (0, 0) when absent or malformed."""
    try:
        md = _md(metadata)
        tid = int(md.get(TRACE_ID_KEY, 0))
        sid = int(md.get(SPAN_ID_KEY, 0))
    except (TypeError, ValueError):
        return 0, 0
    if tid <= 0 or sid <= 0:
        return 0, 0
    return tid, sid


def decode_metadata(metadata) -> dict:
    """Every import key of a call's metadata, decoded (the shape of
    ``http_import.decode_headers``)."""
    return {"trace": decode_trace_metadata(metadata),
            "drain": decode_drain_metadata(metadata),
            "replay": decode_replay_metadata(metadata),
            "recovery": decode_recovery_metadata(metadata),
            "handoff": decode_handoff_metadata(metadata)}


_TYPE_TO_PB = {dsd.COUNTER: metric_pb2.Counter,
               dsd.GAUGE: metric_pb2.Gauge,
               dsd.HISTOGRAM: metric_pb2.Histogram,
               dsd.TIMER: metric_pb2.Timer,
               dsd.SET: metric_pb2.Set}
_PB_TO_TYPE = {v: k for k, v in _TYPE_TO_PB.items()}
_SCOPE_TO_PB = {dsd.SCOPE_DEFAULT: metric_pb2.Mixed,
                dsd.SCOPE_LOCAL: metric_pb2.Local,
                dsd.SCOPE_GLOBAL: metric_pb2.Global}
_PB_TO_SCOPE = {v: k for k, v in _SCOPE_TO_PB.items()}


# ----------------------------------------------------------------------
# ForwardRow <-> metricpb.Metric

def row_to_metric(r: ForwardRow,
                  compression: float = 100.0) -> metric_pb2.Metric:
    """Encode one forwardable row (worker.go:181 ForwardableMetrics ->
    metricpb).  ``compression`` is the table's digest compression (a Go
    global sizes its MergingDigest from this field)."""
    m = metric_pb2.Metric(name=r.meta.name, tags=list(r.meta.tags),
                          type=_TYPE_TO_PB[r.meta.type],
                          scope=_SCOPE_TO_PB[r.meta.scope])
    if r.kind == "counter":
        # the reference wire type is int64 (metric.proto CounterValue)
        m.counter.value = int(round(r.value))
    elif r.kind == "gauge":
        m.gauge.value = float(r.value)
    elif r.kind == "histo":
        d = m.histogram.t_digest
        d.compression = float(compression)
        st = r.stats
        d.min = float(st[segment.STAT_MIN])
        d.max = float(st[segment.STAT_MAX])
        d.reciprocalSum = float(st[segment.STAT_RSUM])
        live = np.asarray(r.weights) > 0
        means = np.asarray(r.means)[live]
        weights = np.asarray(r.weights)[live]
        for mean, w in zip(means, weights):
            c = d.main_centroids.add()
            c.mean = float(mean)
            c.weight = float(w)
    elif r.kind == "set":
        m.set.hyper_log_log = hll_codec.encode_dense(r.regs)
    else:
        raise ValueError(f"unknown forward kind {r.kind}")
    return m


def rows_to_metric_list(rows: list[ForwardRow],
                        compression: float = 100.0
                        ) -> forward_pb2.MetricList:
    return forward_pb2.MetricList(
        metrics=[row_to_metric(r, compression) for r in rows])


def apply_metric(table: MetricTable, m: metric_pb2.Metric) -> bool:
    """Merge one received metricpb.Metric into the table (worker.go:438
    ImportMetricGRPC semantics)."""
    mtype = _PB_TO_TYPE.get(m.type)
    tags = tuple(m.tags)
    scope = _PB_TO_SCOPE.get(m.scope, dsd.SCOPE_DEFAULT)
    which = m.WhichOneof("value")
    if which == "counter":
        return table.import_counter(m.name, tags, float(m.counter.value))
    if which == "gauge":
        v = float(m.gauge.value)
        if not np.isfinite(v):
            raise ValueError("non-finite gauge value in gRPC import")
        return table.import_gauge(m.name, tags, v)
    if which == "histogram":
        d = m.histogram.t_digest
        means = np.asarray([c.mean for c in d.main_centroids], np.float32)
        weights = np.asarray([c.weight for c in d.main_centroids],
                             np.float32)
        # the DogStatsD parse's finiteness gate: one NaN poisons a whole
        # row's aggregates
        if not (np.isfinite(means).all() and np.isfinite(weights).all()
                and (weights >= 0).all()):
            raise ValueError("non-finite centroids in gRPC import")
        total_w = float(weights.sum())
        if total_w and not (np.isfinite(d.min) and np.isfinite(d.max)
                            and np.isfinite(d.reciprocalSum)):
            raise ValueError("non-finite digest stats in gRPC import")
        # the Go digest's Sum() is sum(mean * weight)
        # (merging_digest.go:349); min/max/reciprocalSum ride in the proto
        total_sum = float((means * weights).sum())
        stats = np.asarray(
            [total_w,
             d.min if total_w else segment.STAT_MIN_EMPTY,
             d.max if total_w else segment.STAT_MAX_EMPTY,
             total_sum, d.reciprocalSum if total_w else 0.0],
            np.float32)
        if mtype not in (dsd.HISTOGRAM, dsd.TIMER):
            mtype = dsd.HISTOGRAM
        return table.import_histo(m.name, mtype, tags, stats, means,
                                  weights, scope=scope)
    if which == "set":
        regs = hll_codec.decode(bytes(m.set.hyper_log_log))
        return table.import_set(m.name, tags, regs, scope=scope)
    log.warning("import metric %s with empty value oneof", m.name)
    return False


def apply_metric_list(table: MetricTable,
                      ml: forward_pb2.MetricList) -> tuple[int, int]:
    """Per-item protobuf apply.  Returns (accepted, dropped); a bad
    item is dropped and counted without aborting the rest."""
    accepted = dropped = 0
    for m in ml.metrics:
        try:
            ok = apply_metric(table, m)
        except (ValueError, KeyError, hll_codec.HLLCodecError) as e:
            log.warning("dropping bad gRPC import item %s: %s", m.name, e)
            dropped += 1
            continue
        accepted += int(ok)
        dropped += int(not ok)
    return accepted, dropped


# ----------------------------------------------------------------------
# columnar wire decode (native vtpu_metriclist_decode)

# Per-thread decode scratch: a steady-state global decodes same-sized
# wires from each peer every interval, so the ~17 column arrays are
# kept between calls; thread-local because gRPC handler threads decode
# concurrently (columns are only read within the call: everything
# staged is a copy).  Scratch above _SCRATCH_MAX_BYTES is not kept (one
# near-max 64 MB wire must not pin ~230 MB of columns per thread), and
# retained high-water scratch is released after _SCRATCH_SHRINK_AFTER
# consecutive decodes needing under a quarter of it.
_decode_scratch = threading.local()
_SCRATCH_MAX_BYTES = 32 << 20
_SCRATCH_SHRINK_AFTER = 8

_scratch_lock = threading.Lock()
_scratch_bytes: dict[int, int] = {}  # thread ident -> retained bytes


def decode_scratch_bytes() -> int:
    """Decode scratch retained across handler threads (the
    ``forward.decode_scratch_bytes`` entry of /debug/vars)."""
    with _scratch_lock:
        return sum(_scratch_bytes.values())


def _cols_nbytes(cols: dict) -> int:
    return sum(a.nbytes for a in cols.values()
               if isinstance(a, np.ndarray))


def _keep_scratch(cols: dict) -> None:
    nb = _cols_nbytes(cols)
    if nb <= _SCRATCH_MAX_BYTES:
        _decode_scratch.cols = cols
    else:
        _decode_scratch.cols = None
        nb = 0
    tid = threading.get_ident()
    with _scratch_lock:
        if nb:
            _scratch_bytes[tid] = nb
        else:
            _scratch_bytes.pop(tid, None)
        if len(_scratch_bytes) > 32:
            # entries outlive their (dead) handler threads
            live = {t.ident for t in threading.enumerate()}
            for t in [t for t in _scratch_bytes if t not in live]:
                del _scratch_bytes[t]


def _alloc_cols(cap_m: int, cap_c: int, cap_t: int) -> dict:
    return {
        "name_off": np.empty(cap_m, np.int64),
        "name_len": np.empty(cap_m, np.int32),
        "kind": np.empty(cap_m, np.uint8),
        "mtype": np.empty(cap_m, np.int32),
        "scope": np.empty(cap_m, np.int32),
        "scalar": np.empty(cap_m, np.float64),
        "dstats": np.empty((cap_m, 4), np.float64),
        "cent_start": np.empty(cap_m, np.int64),
        "cent_cnt": np.empty(cap_m, np.int32),
        "means": np.empty(cap_c, np.float32),
        "weights": np.empty(cap_c, np.float32),
        "tag_start": np.empty(cap_m, np.int64),
        "tag_cnt": np.empty(cap_m, np.int32),
        "tag_off": np.empty(cap_t, np.int64),
        "tag_len": np.empty(cap_t, np.int32),
        "hll_off": np.empty(cap_m, np.int64),
        "hll_len": np.empty(cap_m, np.int32),
    }


def _decode_call(lib, buf: np.ndarray, cols: dict,
                 needed: np.ndarray) -> int:
    p = native.ptr
    c = ctypes
    return lib.vtpu_metriclist_decode(
        p(buf, c.c_uint8), len(buf), len(cols["name_off"]),
        len(cols["means"]), len(cols["tag_off"]),
        p(cols["name_off"], c.c_int64), p(cols["name_len"], c.c_int32),
        p(cols["kind"], c.c_uint8), p(cols["mtype"], c.c_int32),
        p(cols["scope"], c.c_int32), p(cols["scalar"], c.c_double),
        p(cols["dstats"], c.c_double),
        p(cols["cent_start"], c.c_int64), p(cols["cent_cnt"], c.c_int32),
        p(cols["means"], c.c_float), p(cols["weights"], c.c_float),
        p(cols["tag_start"], c.c_int64), p(cols["tag_cnt"], c.c_int32),
        p(cols["tag_off"], c.c_int64), p(cols["tag_len"], c.c_int32),
        p(cols["hll_off"], c.c_int64), p(cols["hll_len"], c.c_int32),
        p(needed, c.c_int64))


def _decode_native(lib, data: bytes) -> dict | None:
    """Run the wire walker on this thread's scratch, growing it once if
    the size guess was short (rc -2 reports the exact need).  Returns
    the columns with their count ``n``, or None when the wire is
    malformed (rc -1)."""
    n = len(data)
    buf = np.frombuffer(data, np.uint8)
    cap_m = max(256, n // 48)
    cap_c = max(1024, n // 18)
    cap_t = cap_m * 4
    needed = np.zeros(3, np.int64)
    cols = getattr(_decode_scratch, "cols", None)
    if cols is not None:
        oversized = (len(cols["name_off"]) > 4 * cap_m or
                     len(cols["means"]) > 4 * cap_c or
                     len(cols["tag_off"]) > 4 * cap_t)
        if oversized:
            streak = getattr(_decode_scratch, "oversized_streak", 0) + 1
            _decode_scratch.oversized_streak = streak
            if streak >= _SCRATCH_SHRINK_AFTER:
                cols = None
                _decode_scratch.oversized_streak = 0
        else:
            _decode_scratch.oversized_streak = 0
    if (cols is None or len(cols["name_off"]) < cap_m or
            len(cols["means"]) < cap_c or len(cols["tag_off"]) < cap_t):
        cols = _alloc_cols(cap_m, cap_c, cap_t)
        _keep_scratch(cols)
    for _ in range(2):
        rc = _decode_call(lib, buf, cols, needed)
        if rc == -1:
            return None
        if rc >= 0:
            out = dict(cols)
            out["n"] = int(rc)
            return out
        # rc == -2: grow to the elementwise max of the exact need and
        # the size guess (exact-only buffers for a centroid-dense wire
        # would sit below the next call's guess and be replaced, walking
        # every wire twice)
        cols = _alloc_cols(max(int(needed[0]), cap_m, 1),
                           max(int(needed[1]), cap_c, 1),
                           max(int(needed[2]), cap_t, 1))
        _keep_scratch(cols)
    return None  # still short after the exact-size retry


def decode_metric_list(data: bytes) -> dict | None:
    """The lock-free half of ``apply_metric_list_bytes``: the native
    columnar decode plus one import-identity hash per item (``khash``),
    touching no table state.  Returns the column dict, or None when the
    native walker finds the wire malformed (the caller then takes the
    per-item protobuf path).  Raises if the native library cannot be
    built."""
    lib = native.load()
    cols = _decode_native(lib, data)
    if cols is None:
        return None
    nm = cols["n"]
    khash = np.empty(nm, np.uint64)
    if nm:
        p = native.ptr
        c = ctypes
        lib.vtpu_metriclist_keyhash(
            p(np.frombuffer(data, np.uint8), c.c_uint8), nm,
            p(cols["name_off"], c.c_int64), p(cols["name_len"], c.c_int32),
            p(cols["kind"], c.c_uint8), p(cols["mtype"], c.c_int32),
            p(cols["scope"], c.c_int32),
            p(cols["tag_start"], c.c_int64), p(cols["tag_cnt"], c.c_int32),
            p(cols["tag_off"], c.c_int64), p(cols["tag_len"], c.c_int32),
            p(khash, c.c_uint64))
    cols["khash"] = khash
    return cols


def _classify_sets(data: bytes, cols: dict) -> native.Sketches:
    nm = cols["n"]
    return native.hll_classify(
        np.frombuffer(data, np.uint8), cols["kind"][:nm],
        cols["hll_off"][:nm], cols["hll_len"][:nm])


def decode_import(data: bytes) -> dict | None:
    """The import's lock-free half: ``decode_metric_list`` plus, where
    the wire has set items, their HLL sketches classified and the
    sparse ones decoded (``cols["hll"]``, a ``native.Sketches``) for
    ``apply_decoded``'s fold.  The proxy router decodes with
    ``decode_metric_list`` alone."""
    cols = decode_metric_list(data)
    if cols is not None and (cols["kind"][:cols["n"]] == 4).any():
        cols["hll"] = _classify_sets(data, cols)
    return cols


_WIRE_PLAN_CACHE_MAX = 256


def _resolve_rows(table: MetricTable, data: bytes,
                  cols: dict) -> np.ndarray:
    """Map every item to its table row, -1 (class overflow) or -2
    (malformed identity or empty value oneof).

    A whole wire's hash vector keys a row plan on the table, so a peer
    re-forwarding the same series set every interval resolves every row
    with one dict get.  Plans carry the compaction epoch; a plan's
    overflow drops keep counting per sample on every replay, as the
    uncached path counts them."""
    nm = cols["n"]
    kind = cols["kind"][:nm]
    khash = cols["khash"]
    class_idx = {1: table.counter_idx, 2: table.gauge_idx,
                 3: table.histo_idx, 4: table.set_idx}
    epoch = table._reindex_epoch
    plan_cache = table._wire_plan_cache
    pkey = khash.tobytes()
    hit = plan_cache.get(pkey)
    if hit is not None and hit[0] == epoch:
        table.wire_plan_hits += 1
        rows, over_counts = hit[1], hit[2]
        for k, c in over_counts.items():
            class_idx[k].drops.add(c)
        return rows
    table.wire_plan_misses += 1
    cache = table.import_row_cache
    rows = np.full(nm, -1, np.int64)

    def _ident(i: int) -> tuple[str, tuple[str, ...]]:
        no, nl = int(cols["name_off"][i]), int(cols["name_len"][i])
        name = data[no:no + nl].decode()
        ts, tc = int(cols["tag_start"][i]), int(cols["tag_cnt"][i])
        tags = tuple(
            data[int(cols["tag_off"][ts + j]):
                 int(cols["tag_off"][ts + j]) +
                 int(cols["tag_len"][ts + j])].decode()
            for j in range(tc))
        return name, tags

    if len(cache) >= table.import_row_cache_limit:
        cache.clear()  # churning identities: rebound, self-rebuilds
    name_len = cols["name_len"]
    for i, h in enumerate(khash.tolist()):
        ent = cache.get(h)
        had_pos = ent is not None and ent >= 0
        if ent is not None:
            if had_pos:
                # collision guard on the 64-bit hash: the entry carries
                # the resolved name length, and a hit whose wire name
                # length disagrees is a distinct series that collided —
                # it takes the slow path instead of merging into this row
                if (ent >> 32) == int(name_len[i]):
                    rows[i] = ent & 0xFFFFFFFF
                    continue
            else:
                rows[i] = ent
                if ent == -1:
                    # the slow path counted the overflow when it cached
                    # the drop; every hit counts its sample again, as
                    # the uncached path would
                    idx = class_idx.get(int(kind[i]))
                    if idx is not None:
                        idx.drops.add(1)
                continue
        k = int(kind[i])
        row = None
        resolved = False
        try:
            name, tags = _ident(i)
            if k == 1:
                resolved = True
                row = table.import_counter_row(name, tags)
            elif k == 2:
                resolved = True
                row = table.import_gauge_row(name, tags)
            elif k == 3:
                mtype = _PB_TO_TYPE.get(int(cols["mtype"][i]))
                if mtype not in (dsd.HISTOGRAM, dsd.TIMER):
                    mtype = dsd.HISTOGRAM
                scope = _PB_TO_SCOPE.get(int(cols["scope"][i]),
                                         dsd.SCOPE_DEFAULT)
                resolved = True
                row = table.import_histo_row(name, mtype, tags, scope)
            elif k == 4:
                scope = _PB_TO_SCOPE.get(int(cols["scope"][i]),
                                         dsd.SCOPE_DEFAULT)
                resolved = True
                row = table.import_set_row(name, tags, scope)
            else:
                log.warning("import metric %s with empty value oneof",
                            name)
        except UnicodeDecodeError as e:
            log.warning("dropping bad gRPC import item: %s", e)
        # row None: malformed identity, empty oneof or class overflow,
        # each stable until the next compaction clears the cache.
        # Overflow (-1: the lookup ran and failed) keeps counting per
        # sample on hits; malformed (-2) never counted as overflow.
        if row is None:
            rows[i] = -1 if resolved else -2
            # a collision-guard fall-through that then overflows keeps
            # the colliding series' live entry
            if not had_pos:
                cache[h] = int(rows[i])
        else:
            cache[h] = (int(name_len[i]) << 32) | int(row)
            rows[i] = int(row)

    # overflow (-1) rows were counted while building; a replay of the
    # plan repeats those per-class counts
    over_counts: dict[int, int] = {}
    for k in (1, 2, 3, 4):
        c = int(((rows == -1) & (kind == k)).sum())
        if c:
            over_counts[k] = c
    if len(plan_cache) >= _WIRE_PLAN_CACHE_MAX:
        plan_cache.clear()
    plan_cache[pkey] = (epoch, rows, over_counts)
    return rows


def apply_decoded(table: MetricTable, data: bytes, cols: dict,
                  span_ns: dict | None = None,
                  counts: dict | None = None) -> tuple[int, int]:
    """The locked half: resolve rows through the caches and stage every
    value with vectorized batch appliers.  Value-level validity
    (finiteness, the HLL codec) is checked on every wire; only series
    identity is cached.  ``cols`` comes from ``decode_import`` (from
    ``decode_metric_list`` alone, the sketches are classified here).
    ``span_ns`` (span name -> ns) gets the set fold's time as
    ``import.hll``, and ``counts`` the sketches folded natively and
    handed to the codec as ``import.hll_native`` / ``import.hll_codec``.
    Returns (accepted, dropped)."""
    nm = cols["n"]
    if nm == 0:
        return 0, 0
    kind = cols["kind"][:nm]
    rows = _resolve_rows(table, data, cols)
    valid = rows >= 0
    dropped = int((~valid).sum())
    accepted = 0

    # counters: += (no finiteness gate, as import_counter and the
    # reference's Counter.Merge)
    selc = np.nonzero(valid & (kind == 1))[0]
    if len(selc):
        table.import_counter_batch(rows[selc], cols["scalar"][selc])
        accepted += len(selc)

    # gauges: last write wins in wire order; a non-finite value drops
    # for this wire only
    selg = np.nonzero(valid & (kind == 2))[0]
    if len(selg):
        vals = cols["scalar"][selg]
        fin = np.isfinite(vals)
        bad = int((~fin).sum())
        if bad:
            log.warning("dropping %d non-finite gauge imports", bad)
            dropped += bad
        if fin.any():
            table.import_gauge_batch(rows[selg][fin], vals[fin])
            accepted += int(fin.sum())

    # histograms: per-item centroid sums in one reduceat pass, then one
    # staging append for the wire
    means, weights = cols["means"], cols["weights"]
    dstats = cols["dstats"]
    cs = cols["cent_start"][:nm]
    cc = cols["cent_cnt"][:nm]
    selh = np.nonzero(valid & (kind == 3))[0]
    if len(selh):
        w_tot = np.zeros(len(selh), np.float64)
        s_tot = np.zeros(len(selh), np.float64)
        with_c = cc[selh] > 0
        if with_c.any():
            # paired (start, end) segments: a Metric whose oneof was
            # overwritten after its histogram (proto3 last-one-wins)
            # leaves orphaned centroids between the selected segments,
            # which start-only reduceat would sweep into the preceding
            # histogram's sums.  The zero pad keeps the last end index
            # inside reduceat's range.
            starts = cs[selh][with_c]
            ends = starts + cc[selh][with_c]
            end_max = int(ends[-1])
            w64 = np.zeros(end_max + 1, np.float64)
            w64[:end_max] = weights[:end_max]
            wm64 = w64.copy()
            wm64[:end_max] *= means[:end_max]
            pairs = np.empty(2 * len(starts), np.int64)
            pairs[0::2] = starts
            pairs[1::2] = ends
            w_tot[with_c] = np.add.reduceat(w64, pairs)[0::2]
            s_tot[with_c] = np.add.reduceat(wm64, pairs)[0::2]
        dmin = dstats[selh, 0]
        dmax = dstats[selh, 1]
        drsum = dstats[selh, 2]
        has_w = w_tot != 0
        ok_h = (np.isfinite(w_tot) & np.isfinite(s_tot) &
                (~has_w | (np.isfinite(dmin) & np.isfinite(dmax) &
                           np.isfinite(drsum))))
        bad = int((~ok_h).sum())
        if bad:
            log.warning("dropping %d non-finite digest imports", bad)
            dropped += bad
        if ok_h.any():
            wt = w_tot[ok_h]
            hw = has_w[ok_h]
            stats_mat = np.empty((int(ok_h.sum()),
                                  segment.HISTO_STAT_COLS), np.float32)
            stats_mat[:, 0] = wt
            stats_mat[:, 1] = np.where(hw, dmin[ok_h],
                                       segment.STAT_MIN_EMPTY)
            stats_mat[:, 2] = np.where(hw, dmax[ok_h],
                                       segment.STAT_MAX_EMPTY)
            stats_mat[:, 3] = s_tot[ok_h]
            stats_mat[:, 4] = np.where(hw, drsum[ok_h], 0.0)
            sel_ok = selh[ok_h]
            cnts = cc[sel_ok]
            rep_rows = np.repeat(rows[sel_ok], cnts).astype(np.int32)
            total_c = int(cnts.sum())
            # ragged gather without a per-item arange: position within
            # the item plus the item's repeated segment start
            within = (np.arange(total_c, dtype=np.int64) -
                      np.repeat(np.cumsum(cnts) - cnts, cnts))
            take = np.repeat(cs[sel_ok].astype(np.int64), cnts) + within
            cm = means[take]
            cw = weights[take]
            live = (cw > 0) & np.isfinite(cm) & np.isfinite(cw)
            table.import_histo_batch(
                rows[sel_ok].astype(np.int32), stats_mat,
                rep_rows[live], cm[live], cw[live])
            accepted += int(ok_h.sum())

    # sets: every sketch the lock-free classifier accepted folds in one
    # native pass; the rest go through the codec one by one, which
    # drops them (or folds one it accepts after all)
    sels = np.nonzero(valid & (kind == 4))[0]
    if not len(sels):
        return accepted, dropped
    t0 = time.monotonic_ns()
    sk = cols.get("hll") or _classify_sets(data, cols)
    fast = sk.status[sels] != native.HLL_CODEC
    n_native = 0
    if fast.any():
        n_native = table.import_set_sketches(
            np.frombuffer(data, np.uint8), sk, sels[fast],
            rows[sels[fast]])
        accepted += n_native
    slow = sels[~fast]
    for i in slow:
        ho, hl = int(cols["hll_off"][i]), int(cols["hll_len"][i])
        try:
            regs = hll_codec.decode(data[ho:ho + hl])
            table.import_set_at(int(rows[i]), regs)
            accepted += 1
        except (ValueError, hll_codec.HLLCodecError) as e:
            log.warning("dropping bad gRPC import item: %s", e)
            dropped += 1
    if span_ns is not None:
        span_ns["import.hll"] = time.monotonic_ns() - t0
    if counts is not None:
        counts["import.hll_native"] = n_native
        counts["import.hll_codec"] = len(slow)
    return accepted, dropped


def apply_metric_list_bytes(table: MetricTable,
                            data: bytes) -> tuple[int, int]:
    """Merge one raw MetricList wire: ``decode_metric_list`` then
    ``apply_decoded`` back to back (the import server splits the two
    around its lock).  A wire the native walker calls malformed takes
    the per-item protobuf path, which isolates bad items or raises
    ``DecodeError``."""
    cols = decode_import(data)
    if cols is None:
        return apply_metric_list(table,
                                 forward_pb2.MetricList.FromString(data))
    return apply_decoded(table, data, cols)


# ----------------------------------------------------------------------
# server (importsrv)

class ImportServer:
    """One gRPC listener serving forward import, SSF spans, DogStatsD
    packets and grpc health (the reference's networking.go:295-358
    startGRPCTCP), merging into the port server's table under its
    lock."""

    def __init__(self, server, address: str = "127.0.0.1:0",
                 credentials=None):
        """``server`` is the port's core Server (its ``table``,
        ``lock``, ``stats``, ``handle_packet`` and device step);
        ``address`` is host:port, port 0 for an ephemeral one;
        ``credentials``, gRPC server credentials, serve it over TLS."""
        self._core = server
        self._grpc = grpc.server(
            futures.ThreadPoolExecutor(max_workers=8),
            options=[("grpc.max_receive_message_length",
                      64 * 1024 * 1024)])
        handlers = (
            grpc.method_handlers_generic_handler(
                "forwardrpc.Forward",
                {"SendMetrics": grpc.unary_unary_rpc_method_handler(
                    self._send_metrics,
                    # raw bytes: the native decoder walks the wire itself
                    request_deserializer=lambda b: b,
                    response_serializer=(
                        empty_pb2.Empty.SerializeToString))}),
            grpc.method_handlers_generic_handler(
                "ssf.SSFGRPC",
                {"SendSpan": grpc.unary_unary_rpc_method_handler(
                    self._send_span,
                    request_deserializer=ssf_pb2.SSFSpan.FromString,
                    # ssf.Empty: no fields, an empty encoding
                    response_serializer=lambda _: b"")}),
            grpc.method_handlers_generic_handler(
                "dogstatsd.DogstatsdGRPC",
                {"SendPacket": grpc.unary_unary_rpc_method_handler(
                    self._send_packet,
                    request_deserializer=(
                        dogstatsd_grpc_pb2.DogstatsdPacket.FromString),
                    response_serializer=lambda _: b"")}),
            grpc.method_handlers_generic_handler(
                "grpc.health.v1.Health",
                {"Check": grpc.unary_unary_rpc_method_handler(
                    self._health_check,
                    request_deserializer=(
                        health_pb2.HealthCheckRequest.FromString),
                    response_serializer=(
                        health_pb2.HealthCheckResponse
                        .SerializeToString))}),
        )
        self._grpc.add_generic_rpc_handlers(handlers)
        if credentials is not None:
            self.port = self._grpc.add_secure_port(address, credentials)
        else:
            self.port = self._grpc.add_insecure_port(address)

    def _send_metrics(self, request: bytes, context):
        """Decode outside the server's lock (another handler's apply
        may hold it), apply under it and, past the staging bound, detach
        the staged work there and apply it to the device after the lock
        is released.  A wire that neither the native
        walker nor protobuf can read is counted in ``import_errors`` and
        answered INVALID_ARGUMENT.  The apply and its ledger credit run
        through the server's ``apply_import_locked`` (``grpc-import``
        suffixed by the wire's flag; a recovery id seen before is
        counted deduped and never merged), and a wire carrying a trace
        context records the ``import`` span under the sender's forward
        span.

        The wire's host spans go to the interval whose ledger record
        credits it (the one open when it took ``core.lock``), and so to
        the ``span_ns`` of the flush record that closes it
        (``/debug/flushes``): ``import.decode`` (outside the lock),
        ``import.lock_wait`` (asking for the lock to holding it),
        ``import.apply`` (held) and ``import.hll`` (the apply's set
        fold), each summed over the interval's wires, and the record's
        ``counts``: ``import.hll_native`` and ``import.hll_codec``."""
        core = self._core
        flags = decode_metadata(context.invocation_metadata())
        flagged = any(flags[k] for k in ("drain", "replay", "recovery",
                                         "handoff"))
        t0 = time.monotonic_ns()
        cols = decode_import(request)
        span_ns = {"import.decode": time.monotonic_ns() - t0}
        counts = {}
        interval = None

        def apply():
            if cols is None:
                return apply_metric_list(
                    core.table, forward_pb2.MetricList.FromString(request))
            return apply_decoded(core.table, request, cols, span_ns,
                                 counts)
        try:
            t0 = time.monotonic_ns()
            with core.lock:
                t1 = time.monotonic_ns()
                interval = core.flush_tracer.interval
                acc, dropped, deduped = core.apply_import_locked(
                    "grpc-import", flags, apply)
                span_ns["import.lock_wait"] = t1 - t0
                span_ns["import.apply"] = time.monotonic_ns() - t1
                work = (None if deduped
                        else core._maybe_device_step_locked())
            if deduped:
                core.note_flagged_import(flags, 0, deduped=True)
                return empty_pb2.Empty()
            core._apply_staged(work)
            core.bump("imports_received", acc)
            core.bump("received_grpc", acc + dropped)
            core.bump("metrics_dropped", dropped)
            core.bump("import_flagged_wires", int(flagged))
            core.note_flagged_import(flags, acc)
            core.note_import_span("grpc", acc, dropped, *flags["trace"],
                                  nbytes=len(request))
        except DecodeError as e:
            core.bump("import_errors")
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          f"malformed MetricList: {e}")
        finally:
            (interval or core.flush_tracer.interval).add(span_ns, counts)
        return empty_pb2.Empty()

    def _send_span(self, request, context):
        """ssf.SSFGRPC/SendSpan (networking.go:321 SendSpan ->
        handleSSF)."""
        self._core.bump("received_ssf-grpc")
        self._core.handle_ssf(wire.normalize_span(request))
        return None  # ssf.Empty

    def _send_packet(self, request, context):
        """dogstatsd.DogstatsdGRPC/SendPacket (networking.go:314): the
        body may hold many newline-separated lines."""
        self._core.bump("received_dogstatsd-grpc")
        self._core.handle_packet(request.packetBytes)
        return None  # dogstatsd.Empty

    def _health_check(self, request, context):
        """grpc.health.v1.Health/Check: "" and "veneur" are SERVING
        (networking.go:340)."""
        pb = health_pb2.HealthCheckResponse
        if request.service in ("", "veneur"):
            return pb(status=pb.SERVING)
        return pb(status=pb.SERVICE_UNKNOWN)

    def start(self) -> None:
        self._grpc.start()

    def stop(self, grace: float = 0.5) -> None:
        self._grpc.stop(grace).wait()


# ----------------------------------------------------------------------
# client (forwardGRPC)

class ForwardClient:
    """Dial-once client of the Forward service (flusher.go:499
    forwardGRPC: a failed send is dropped and counted by the caller,
    never retried); insecure, or over TLS with ``credentials`` (gRPC
    channel credentials)."""

    def __init__(self, target: str, timeout: float = 10.0,
                 credentials=None, compression: float = 100.0):
        target = target.removeprefix("http://")
        if credentials is not None:
            self._channel = grpc.secure_channel(target, credentials)
        else:
            self._channel = grpc.insecure_channel(target)
        self._timeout = timeout
        self._compression = compression
        self._call = self._channel.unary_unary(
            _METHOD,
            request_serializer=forward_pb2.MetricList.SerializeToString,
            response_deserializer=empty_pb2.Empty.FromString)
        self._call_raw = self._channel.unary_unary(
            _METHOD, request_serializer=lambda b: b,
            response_deserializer=empty_pb2.Empty.FromString)

    def send_wire(self, body: bytes, timeout: float | None = None,
                  metadata=None) -> None:
        """Send an already-serialized MetricList.  Raises
        grpc.RpcError on failure."""
        self._call_raw(body, timeout=timeout or self._timeout,
                       metadata=metadata)

    def send(self, rows: list[ForwardRow],
             trace_context: tuple[int, int] | None = None,
             drain: bool = False) -> None:
        """Encode and send a flush's rows; ``trace_context`` = (trace_id,
        span_id) of the sending flush cycle, stamped as invocation
        metadata when set; ``drain`` flags the wire as a shutdown
        handoff.  Raises grpc.RpcError on failure."""
        metadata = []
        if trace_context and trace_context[0] and trace_context[1]:
            metadata = [(TRACE_ID_KEY, str(trace_context[0])),
                        (SPAN_ID_KEY, str(trace_context[1]))]
        if drain:
            metadata.append((DRAIN_KEY, "1"))
        self._call(rows_to_metric_list(rows, self._compression),
                   timeout=self._timeout, metadata=metadata or None)

    def close(self) -> None:
        self._channel.close()
