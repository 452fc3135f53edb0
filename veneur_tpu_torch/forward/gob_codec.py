"""Go ``encoding/gob`` codec for the reference's HTTP-import values.

Port of ``veneur_tpu/forward/gob_codec.py``; ``decode_batch`` runs the
port's own native library (``vtpu_gob_decode``).

The reference's HTTP ``/import`` carries ``JSONMetric`` items whose
``value`` field is opaque bytes per type (samplers/samplers.go:106):
LE int64 for counters (:162 ``Counter.Export``), LE float64 for
gauges, the axiomhq HLL binary for sets (handled by
``forward.hll_codec``), and a **gob** stream for histograms —
``MergingDigest.GobEncode`` (tdigest/merging_digest.go:393): the
centroid slice, then compression, min, max and reciprocalSum, each as
its own gob message.

This module speaks exactly that stream — not general gob.  The wire
format (https://pkg.go.dev/encoding/gob):

- unsigned ints: one byte if < 128, else a byte holding 256-n
  followed by n big-endian bytes;
- signed ints: bit 0 is the sign, value in the upper bits;
- float64: the IEEE754 bits BYTE-REVERSED, sent as an unsigned int
  (so low-entropy trailing bytes drop);
- each message: uvarint byte length, then a signed type id —
  negative introduces a type definition, positive a value of that
  type (non-struct top-level values carry one 0x00 delta byte);
- struct values: uvarint field deltas (0 terminates), zero-valued
  fields omitted.

The type-definition prologue for ``[]Centroid`` is a deterministic
function of the reference's type names, so it is carried as the
constant the reference itself emits (verified byte-for-byte against
the reference's checked-in ``testdata/import.uncompressed``).
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from veneur_tpu_torch import native


class GobCodecError(ValueError):
    pass


# Type-definition messages Go emits for []tdigest.Centroid
# (slice id 68 -> struct "Centroid" id 66 {Mean, Weight, Samples} ->
# "[]float64" id 67), as produced by gob for these type names.
_DIGEST_TYPEDEFS = bytes.fromhex(
    "0dff87020102ff880001ff84000037ff830301010843656e74726f696401"
    "ff8400010301044d65616e0108000106576569676874010800010753616d"
    "706c657301ff8600000017ff85020101095b5d666c6f6174363401ff8600"
    "01080000")
_SLICE_TYPE_ID = 68
_FLOAT_TYPE_ID = 4  # gob builtin id for float64


def _read_uint(data: bytes, pos: int) -> tuple[int, int]:
    if pos >= len(data):
        raise GobCodecError("truncated gob stream")
    b = data[pos]
    if b < 0x80:
        return b, pos + 1
    n = 256 - b
    if n > 8 or pos + 1 + n > len(data):
        raise GobCodecError("bad gob uint")
    return int.from_bytes(data[pos + 1:pos + 1 + n], "big"), pos + 1 + n


def _write_uint(out: bytearray, v: int) -> None:
    if v < 0x80:
        out.append(v)
        return
    raw = v.to_bytes((v.bit_length() + 7) // 8, "big")
    out.append(256 - len(raw))
    out += raw


def _to_signed(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def _from_signed(s: int) -> int:
    return (s << 1) ^ (s >> 63) if s >= 0 else ((-s) << 1) - 1


def _read_float(data: bytes, pos: int) -> tuple[float, int]:
    u, pos = _read_uint(data, pos)
    return struct.unpack("<d", u.to_bytes(8, "big"))[0], pos


def _write_float(out: bytearray, v: float) -> None:
    bits = int.from_bytes(struct.pack("<d", float(v)), "big")
    _write_uint(out, bits)


def decode_digest(data: bytes) -> dict:
    """Parse a MergingDigest gob stream -> dict with ``means``,
    ``weights`` (np.float32 arrays), ``compression``, ``min``,
    ``max``, ``rsum``.  Per-centroid sample lists (debug mode) are
    skipped; a missing reciprocalSum message fails open like the
    reference decoder (merging_digest.go:434)."""
    pos = 0
    means: list[float] = []
    weights: list[float] = []
    floats: list[float] = []
    got_slice = False
    while pos < len(data):
        msg_len, pos = _read_uint(data, pos)
        end = pos + msg_len
        if end > len(data):
            raise GobCodecError("truncated gob message")
        tid_u, p = _read_uint(data, pos)
        tid = _to_signed(tid_u)
        if tid < 0:
            pos = end  # type definition: skip (prologue is fixed)
            continue
        if p >= end or data[p] != 0:
            raise GobCodecError("missing top-level delta byte")
        p += 1
        if not got_slice:
            if tid < 64:
                raise GobCodecError(
                    f"expected centroid slice, got type {tid}")
            count, p = _read_uint(data, p)
            if count > 1 << 20:
                raise GobCodecError("unreasonable centroid count")
            for _ in range(count):
                mean = weight = 0.0
                field = -1
                while True:
                    delta, p = _read_uint(data, p)
                    if delta == 0:
                        break
                    field += delta
                    if field == 0:
                        mean, p = _read_float(data, p)
                    elif field == 1:
                        weight, p = _read_float(data, p)
                    elif field == 2:  # Samples []float64 (debug mode)
                        n, p = _read_uint(data, p)
                        for _ in range(n):
                            _, p = _read_float(data, p)
                    else:
                        raise GobCodecError(
                            f"unknown centroid field {field}")
                means.append(mean)
                weights.append(weight)
            got_slice = True
        else:
            v, p = _read_float(data, p)
            floats.append(v)
        pos = end
    if not got_slice:
        raise GobCodecError("no centroid slice in stream")
    # Encode order: centroids, compression, min, max, reciprocalSum;
    # older streams may omit reciprocalSum (fail open).
    comp = floats[0] if len(floats) > 0 else 100.0
    vmin = floats[1] if len(floats) > 1 else float("inf")
    vmax = floats[2] if len(floats) > 2 else float("-inf")
    rsum = floats[3] if len(floats) > 3 else 0.0
    return {"means": np.asarray(means, np.float32),
            "weights": np.asarray(weights, np.float32),
            "compression": comp, "min": vmin, "max": vmax,
            "rsum": rsum}


def encode_digest(means, weights, compression: float, vmin: float,
                  vmax: float, rsum: float) -> bytes:
    """Produce the MergingDigest gob stream a Go global decodes
    (tdigest/merging_digest.go:417 GobDecode)."""
    out = bytearray(_DIGEST_TYPEDEFS)
    body = bytearray()
    _write_uint(body, _from_signed(_SLICE_TYPE_ID))
    body.append(0)  # top-level non-struct delta byte
    live = [(float(m), float(w)) for m, w in zip(means, weights)
            if w > 0]
    _write_uint(body, len(live))
    for mean, weight in live:
        if mean != 0.0:
            _write_uint(body, 1)  # field 0 (Mean)
            _write_float(body, mean)
            if weight != 0.0:
                _write_uint(body, 1)  # field 1 (Weight)
                _write_float(body, weight)
        elif weight != 0.0:
            _write_uint(body, 2)  # skip Mean, field 1
            _write_float(body, weight)
        body.append(0)  # end struct
    _write_uint(out, len(body))
    out += body
    for v in (compression, vmin, vmax, rsum):
        fb = bytearray()
        _write_uint(fb, _from_signed(_FLOAT_TYPE_ID))
        fb.append(0)
        _write_float(fb, v)
        _write_uint(out, len(fb))
        out += fb
    return bytes(out)


KIND_COUNTER, KIND_GAUGE, KIND_DIGEST = 1, 2, 3


def decode_batch(payloads, kinds, lib=None):
    """Batch-decode a whole import cycle's opaque wire values into
    flat columns with one ``vtpu_gob_decode`` call.

    ``payloads`` is a list of bytes, ``kinds`` a parallel sequence of
    KIND_* codes; ``lib`` defaults to the port's native library (whose
    load raises if it cannot be built).  Returns a dict of columns:

    - ``scalar``      float64[n]  counter/gauge value
    - ``dstats``      float64[n,4]  digest min, max, rsum, compression
    - ``cent_start``  int64[n], ``cent_cnt`` int32[n]  slices into
    - ``means``/``weights``  float32[total_centroids]
    - ``err``         uint8[n]  1 where the item was malformed (the
      caller drops-and-counts it, like the per-item codec's exception
      path; well-formed siblings in the same batch still decode)
    """
    if lib is None:
        lib = native.load()
    n = len(payloads)
    lens = np.fromiter((len(p) for p in payloads), np.int64, n)
    off = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=off[1:])
    buf = np.frombuffer(b"".join(payloads), np.uint8)
    if buf.size == 0:
        buf = np.zeros(1, np.uint8)
    kind = np.ascontiguousarray(kinds, np.uint8)
    scalar = np.zeros(n, np.float64)
    dstats = np.zeros((n, 4), np.float64)
    cent_start = np.zeros(n, np.int64)
    cent_cnt = np.zeros(n, np.int32)
    err = np.zeros(n, np.uint8)
    needed = np.zeros(1, np.int64)
    cap = max(1024, 4 * n)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    for _ in range(2):  # -2 reports the exact need: one retry fits
        means = np.empty(cap, np.float32)
        weights = np.empty(cap, np.float32)
        rc = lib.vtpu_gob_decode(
            buf.ctypes.data_as(u8p), buf.size, n,
            off.ctypes.data_as(i64p), lens.ctypes.data_as(i64p),
            kind.ctypes.data_as(u8p), cap,
            scalar.ctypes.data_as(f64p), dstats.ctypes.data_as(f64p),
            cent_start.ctypes.data_as(i64p),
            cent_cnt.ctypes.data_as(i32p),
            means.ctypes.data_as(f32p), weights.ctypes.data_as(f32p),
            err.ctypes.data_as(u8p), needed.ctypes.data_as(i64p))
        if rc != -2:
            break
        cap = int(needed[0])
    total = int(rc) if rc >= 0 else 0
    return {"scalar": scalar, "dstats": dstats,
            "cent_start": cent_start, "cent_cnt": cent_cnt,
            "means": means[:total], "weights": weights[:total],
            "err": err}


def decode_counter(data: bytes) -> float:
    """Counter.Export wire value: little-endian int64
    (samplers/samplers.go:162)."""
    if len(data) != 8:
        raise GobCodecError("counter value must be 8 bytes")
    return float(struct.unpack("<q", data)[0])


def encode_counter(v: float) -> bytes:
    return struct.pack("<q", round(v))


def decode_gauge(data: bytes) -> float:
    """Gauge.Export wire value: little-endian float64."""
    if len(data) != 8:
        raise GobCodecError("gauge value must be 8 bytes")
    return float(struct.unpack("<d", data)[0])


def encode_gauge(v: float) -> bytes:
    return struct.pack("<d", float(v))
