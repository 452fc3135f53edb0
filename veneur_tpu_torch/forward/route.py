"""Columnar routing of a MetricList wire: batched decode -> vectorized
consistent hash -> per-destination re-encode, with no per-item Python on
the hot path.

Port of ``veneur_tpu/forward/route.py``.  The per-item oracle
(``ProxyServer.route_pb_metrics``) decodes a MetricList into protobuf
objects, builds a ``name|type|tags`` key string per metric and walks the
ring with ``ConsistentRing.get`` one item at a time.  Here the same
batch is routed in a handful of vectorized passes over the wire's
columns:

1. **Decode** — the native columnar walker (``decode_metric_list``)
   yields name/tag/type offset columns straight off the wire; a second
   native walk (``vtpu_metriclist_spans``) records each top-level
   record's byte span *including* its tag+length header, so any subset
   of records concatenates back into a valid MetricList.
2. **Hash** — ``vtpu_proxy_keyhash`` streams fnv1a64+fmix64 over the
   exact bytes the oracle's key string would contain (name, ``|``, type
   name, ``|``, comma-joined tags) — bit-identical to
   ``ring._h(ProxyServer._pb_key(m))`` without materializing a key.
   Metrics with out-of-range type enums (the oracle spells those
   ``str(m.type)``) take a scalar hash over the assembled key bytes.
3. **Assign** — ``ConsistentRing.assign`` searchsorts the hash column
   against the precomputed vnode array, one destination index per row.
4. **Group + re-encode** — one stable argsort orders rows by
   destination; a single ragged byte-gather copies every record into
   destination-major order, and per-destination bodies are plain
   slices of that blob.

``route_metric_list`` returns ``None`` when the wire is malformed — the
caller falls back to the per-item loop, which stays the bit-parity
oracle.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from veneur_tpu_torch import native
from veneur_tpu_torch.forward.grpc_forward import decode_metric_list
from veneur_tpu_torch.forward.ring import ConsistentRing
from veneur_tpu_torch.utils.hashing import _fmix64, fnv1a_64_int

_TYPE_NAMES = {0: b"counter", 1: b"gauge", 2: b"histogram",
               3: b"set", 4: b"timer"}


def _p(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


@dataclass
class RoutedWire:
    """One gRPC MetricList routed by destination.

    ``batches`` holds ``(member_index, body, n_items)`` triples —
    ``body`` is a ready-to-send serialized MetricList containing
    exactly that destination's records, in wire order.  ``members`` is
    the ring membership the indices refer to (pinned at assignment
    time, so a concurrent refresh can't skew the mapping).
    """

    members: tuple[str, ...]
    batches: list[tuple[int, bytes, int]]
    routed: int
    dropped: int
    n: int


def record_spans(data: bytes):
    """(rec_off, rec_len) int64 arrays for each top-level MetricList
    record, spans covering tag+length+payload; None when the wire is
    malformed."""
    lib = native.load()
    n = len(data)
    buf = np.frombuffer(data or b"\0", np.uint8)
    cap = max(16, n // 24)
    needed = np.zeros(1, np.int64)
    for _ in range(2):
        rec_off = np.empty(cap, np.int64)
        rec_len = np.empty(cap, np.int64)
        rc = lib.vtpu_metriclist_spans(
            _p(buf, ctypes.c_uint8), n, cap,
            _p(rec_off, ctypes.c_int64), _p(rec_len, ctypes.c_int64),
            _p(needed, ctypes.c_int64))
        if rc == -1:
            return None
        if rc >= 0:
            return rec_off[:rc], rec_len[:rc]
        cap = max(int(needed[0]), 1)
    return None


def record_spans_py(data: bytes):
    """Pure-Python oracle for :func:`record_spans` (tests): a list of
    (offset, length); raises ValueError (or IndexError past the end)
    on a malformed wire."""
    spans = []
    pos, n = 0, len(data)
    while pos < n:
        start = pos
        tag, pos = _read_varint(data, pos)
        wt = tag & 7
        if (tag >> 3) != 1 or wt != 2:
            if wt == 0:
                _, pos = _read_varint(data, pos)
            elif wt == 1:
                pos += 8
            elif wt == 2:
                ln, pos = _read_varint(data, pos)
                pos += ln
            elif wt == 5:
                pos += 4
            else:
                raise ValueError("bad wire type")
            continue
        ln, pos = _read_varint(data, pos)
        pos += ln
        if pos > n:
            raise ValueError("truncated record")
        spans.append((start, pos - start))
    return spans


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint overflow")


def proxy_key_hashes(data: bytes, cols: dict) -> np.ndarray:
    """uint64 route-key hash per decoded metric — bit-identical to
    ``ring._h(ProxyServer._pb_key(m))`` per item."""
    lib = native.load()
    nm = cols["n"]
    out = np.empty(nm, np.uint64)
    if nm == 0:
        return out
    buf = np.frombuffer(data, np.uint8)
    need_py = np.empty(nm, np.uint8)
    lib.vtpu_proxy_keyhash(
        _p(buf, ctypes.c_uint8), nm,
        _p(cols["name_off"], ctypes.c_int64),
        _p(cols["name_len"], ctypes.c_int32),
        _p(cols["mtype"], ctypes.c_int32),
        _p(cols["tag_start"], ctypes.c_int64),
        _p(cols["tag_cnt"], ctypes.c_int32),
        _p(cols["tag_off"], ctypes.c_int64),
        _p(cols["tag_len"], ctypes.c_int32),
        _p(out, ctypes.c_uint64), _p(need_py, ctypes.c_uint8))
    for i in np.nonzero(need_py)[0]:
        # unknown type enum: the oracle's key spells it str(m.type)
        key = b"|".join((
            data[cols["name_off"][i]:
                 cols["name_off"][i] + cols["name_len"][i]],
            str(int(cols["mtype"][i])).encode(),
            b",".join(
                data[cols["tag_off"][t]:
                     cols["tag_off"][t] + cols["tag_len"][t]]
                for t in range(
                    int(cols["tag_start"][i]),
                    int(cols["tag_start"][i]) +
                    int(cols["tag_cnt"][i])))))
        out[i] = _fmix64(fnv1a_64_int(key)) & 0xFFFFFFFFFFFFFFFF
    return out


def group_indices(assign: np.ndarray, nmembers: int
                  ) -> list[tuple[int, np.ndarray]]:
    """``(member_index, row_indices)`` per non-empty destination, row
    indices in original batch order (stable sort)."""
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=nmembers)
    bounds = np.zeros(nmembers + 1, np.int64)
    np.cumsum(counts, out=bounds[1:])
    return [(d, order[bounds[d]:bounds[d + 1]])
            for d in range(nmembers) if counts[d]]


def route_metric_list(data: bytes, ring: ConsistentRing
                      ) -> RoutedWire | None:
    """Route a serialized MetricList across ``ring`` columnar-ly.

    Returns None when the wire is malformed (the caller falls back to
    the per-item loop).  An empty ring drops the whole batch, matching
    the per-item LookupError accounting.
    """
    cols = decode_metric_list(data)
    if cols is None:
        return None
    n = cols["n"]
    if n == 0:
        return RoutedWire(ring.members, [], 0, 0, 0)
    if len(ring) == 0:
        return RoutedWire((), [], 0, n, n)
    spans = record_spans(data)
    if spans is None:
        return None
    rec_off, rec_len = spans
    if len(rec_off) != n:
        return None  # decode/span walk disagree: malformed, fall back
    hashes = proxy_key_hashes(data, cols)
    assign = ring.assign(hashes)
    order = np.argsort(assign, kind="stable")
    starts = rec_off[order]
    lens = rec_len[order]
    total = int(lens.sum())
    # one ragged gather: every record's bytes, destination-major
    out_end = np.cumsum(lens)
    out_start = out_end - lens
    pos = (np.arange(total, dtype=np.int64)
           - np.repeat(out_start, lens) + np.repeat(starts, lens))
    blob = np.frombuffer(data, np.uint8)[pos].tobytes()
    counts = np.bincount(assign, minlength=len(ring.members))
    bounds = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=bounds[1:])
    byte_bounds = np.zeros(n + 1, np.int64)
    byte_bounds[1:] = out_end
    batches = []
    for d in range(len(counts)):
        i0, i1 = int(bounds[d]), int(bounds[d + 1])
        if i0 == i1:
            continue
        body = blob[int(byte_bounds[i0]):int(byte_bounds[i1])]
        batches.append((d, body, i1 - i0))
    return RoutedWire(ring.members, batches, n, 0, n)
