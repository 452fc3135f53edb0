"""Forward wires (``forwardrpc.MetricList``) for a fleet of locals, built
by the benchmark itself.

Each local's interval (``plan.fleet_local``) becomes what a Veneur local
forwards: a t-digest per timer series, a summed counter and a last-write
gauge per global-only series, and a HyperLogLog sketch per set series.
The digests come from a plain merging t-digest (``plain_digest``), the
sketches from a 64-bit mix of each member (``splitmix64``) into 2**14
registers in the axiomhq dense encoding.  The protobuf bytes are written
directly (field numbers and wire types of ``wire_pb``'s schema), so
nothing of the program makes an input.
"""

from __future__ import annotations

import math

import numpy as np

from pbench import plan as planmod

HLL_P = 14
HLL_M = 1 << HLL_P

# metricpb.Type and metricpb.Scope
PB_TYPE = {"counter": 0, "gauge": 1, "histogram": 2, "set": 3, "timer": 4}
PB_SCOPE = {"mixed": 0, "local": 1, "global": 2}


# ----------------------------------------------------------------------
# plain t-digest


def plain_digest(values: np.ndarray, compression: float
                 ) -> tuple[np.ndarray, np.ndarray]:
    """A merging t-digest of unit samples: sorted, then adjacent samples
    join a centroid while its span of the scale
    ``k(q) = compression * (asin(2q - 1) / pi + 1/2)`` stays within one
    unit.  Returns (means, weights)."""
    v = np.sort(np.asarray(values, np.float64))
    n = len(v)
    means: list[float] = []
    weights: list[float] = []
    lo = 0
    while lo < n:
        hi = lo + 1
        k_lo = _k(lo / n, compression)
        while hi < n and _k((hi + 1) / n, compression) - k_lo <= 1.0:
            hi += 1
        means.append(float(v[lo:hi].mean()))
        weights.append(float(hi - lo))
        lo = hi
    return np.asarray(means), np.asarray(weights)


def _k(q: float, compression: float) -> float:
    return compression * (math.asin(min(1.0, max(-1.0, 2 * q - 1)))
                          / math.pi + 0.5)


def singleton_bound(compression: float) -> int:
    """Below this many samples no two samples can share a centroid (two
    samples span at least ``2 / n`` of q, and the scale's slope is at
    least ``2 * compression / pi``), so the digest is the sorted
    samples."""
    return int(math.floor(4.0 * compression / math.pi))


# ----------------------------------------------------------------------
# HyperLogLog


def splitmix64(x: np.ndarray) -> np.ndarray:
    z = np.asarray(x, np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _bit_length(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.uint64).copy()
    n = np.zeros(x.shape, np.int64)
    for s in (32, 16, 8, 4, 2, 1):
        big = x >= (np.uint64(1) << np.uint64(s))
        n += np.where(big, s, 0)
        x = np.where(big, x >> np.uint64(s), x)
    return n + (x > 0)


def hll_positions(members: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Register index and rank of each member: the hash's top 14 bits
    pick the register, the leading zeros of the rest (plus one) are the
    rank."""
    with np.errstate(over="ignore"):
        h = splitmix64(members)
    idx = (h >> np.uint64(64 - HLL_P)).astype(np.int64)
    rest = (h << np.uint64(HLL_P)) | np.uint64(1 << (HLL_P - 1))
    rank = 65 - _bit_length(rest)
    return idx, rank.astype(np.uint8)


# ----------------------------------------------------------------------
# protobuf


def varint(n: int) -> bytes:
    if n < len(_VARINT):
        return _VARINT[n]
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


_VARINT: list[bytes] = []
_VARINT = [varint(n) for n in range(1 << 14)]


def _ld(field: int, payload: bytes) -> bytes:
    """A length-delimited field."""
    return varint(field << 3 | 2) + varint(len(payload)) + payload


def _f64(field: int, x: float) -> bytes:
    return varint(field << 3 | 1) + np.float64(x).tobytes()


def metric_head(name: str, tags: tuple[str, ...], mtype: str) -> bytes:
    out = _ld(1, name.encode())
    for t in tags:
        out += _ld(2, t.encode())
    if PB_TYPE[mtype]:
        out += varint(3 << 3) + varint(PB_TYPE[mtype])
    return out


def metric_tail(scope: str) -> bytes:
    return (varint(9 << 3) + varint(PB_SCOPE[scope])) if PB_SCOPE[scope] \
        else b""


def counter_item(name: str, tags: tuple[str, ...], value: int,
                 scope: str) -> bytes:
    body = varint(1 << 3) + varint(int(value) & ((1 << 64) - 1)) \
        if value else b""
    return _ld(1, metric_head(name, tags, "counter") + _ld(5, body)
               + metric_tail(scope))


def centroid_blob(means: np.ndarray, weights: np.ndarray) -> bytes:
    """Repeated ``main_centroids`` (field 1 of MergingDigestData), each
    ``{mean: 1, weight: 2}`` as two doubles."""
    n = len(means)
    mat = np.empty((n, 20), np.uint8)
    mat[:, 0] = 0x0A
    mat[:, 1] = 18
    mat[:, 2] = 0x09
    mat[:, 3:11] = np.asarray(means, "<f8").view(np.uint8).reshape(n, 8)
    mat[:, 11] = 0x11
    mat[:, 12:20] = np.asarray(weights, "<f8").view(np.uint8).reshape(n, 8)
    return mat.tobytes()


# ----------------------------------------------------------------------
# a local's wire


class FleetEncoder:
    """Builds each local's wire.  Every local of a fleet forwards the
    same series with the same sample counts (``plan.balanced_series``),
    so the bytes of each digest and sketch item that do not depend on
    values (identity, framing, lengths) are laid out once in a template,
    and each local's values are scattered into a copy of it."""

    def __init__(self, compression: float):
        self.compression = float(compression)
        self._heads: dict = {}
        self._layouts: dict = {}

    def _head(self, c: planmod.FleetClass, j: int) -> bytes:
        key = (c.names.prefix, c.type, j)
        h = self._heads.get(key)
        if h is None:
            h = self._heads[key] = metric_head(c.names.name(j),
                                               c.names.tags(j), c.type)
        return h

    def _layout(self, c: planmod.FleetClass, var_lens: np.ndarray,
                field_framing, n_kinds: int = 1
                ) -> tuple[np.ndarray, list[np.ndarray]]:
        """(template, one byte mask per kind of value) for a class whose
        item ``j`` is ``entry(head + framing(j) + values_j + tail)``;
        ``var_lens`` is (items, kinds): item ``j``'s value bytes of each
        kind, in kind order."""
        key = (c.names.prefix, c.type, c.names.n_series,
               var_lens.tobytes())
        got = self._layouts.get(key)
        if got is not None:
            return got
        var_lens = var_lens.reshape(-1, n_kinds)
        tail = metric_tail(c.scope)
        chunks = []
        kinds = []
        for j, lens in enumerate(var_lens.tolist()):
            n_var = sum(lens)
            inner = self._head(c, j) + field_framing(n_var)
            entry = (varint(1 << 3 | 2)
                     + varint(len(inner) + n_var + len(tail)) + inner)
            chunks += [entry, bytes(n_var), tail]
            kinds.append(np.zeros(len(entry), np.uint8))
            for k, n in enumerate(lens):
                kinds.append(np.full(n, k + 1, np.uint8))
            kinds.append(np.zeros(len(tail), np.uint8))
        kind = np.concatenate(kinds)
        got = (np.frombuffer(b"".join(chunks), np.uint8),
               [kind == k + 1 for k in range(n_kinds)])
        self._layouts[key] = got
        return got

    def wire(self, classes: list[planmod.FleetClass]
             ) -> tuple[bytes, int, int]:
        """One local's forward wire.  Returns (bytes, items,
        centroids)."""
        parts: list[bytes] = []
        n_items = n_cent = 0
        for c in classes:
            S = c.names.n_series
            tail = metric_tail(c.scope)
            n_items += S
            if c.type in ("timer", "histogram"):
                n_cent += len(c.series)
                parts.append(self._digests(c))
            elif c.type == "counter":
                sums = np.bincount(c.series, weights=c.values.text,
                                   minlength=S).astype(np.int64)
                for j in range(S):
                    v = int(sums[j])
                    body = (varint(1 << 3) + varint(v & ((1 << 64) - 1))
                            if v else b"")
                    parts.append(_ld(1, self._head(c, j) + _ld(5, body)
                                     + tail))
            elif c.type == "gauge":
                vals = c.values.value[planmod.last_per_series(c.series, S)]
                for j in range(S):
                    v = float(vals[j])
                    body = _f64(1, v) if v else b""
                    parts.append(_ld(1, self._head(c, j) + _ld(6, body)
                                     + tail))
            elif c.type == "set":
                parts.append(self._sketches(c))
            else:
                raise ValueError(f"unknown class type {c.type!r}")
        return b"".join(parts), n_items, n_cent

    def _sketches(self, c: planmod.FleetClass) -> bytes:
        """One entry per set series: its members' registers as a dense
        sketch (``SetValue.hyper_log_log``)."""
        S = c.names.n_series
        idx, rank = hll_positions(c.values.text)
        # each register's largest rank, then two registers a byte (even
        # register high), each capped at 15
        cell = c.series * HLL_M + idx
        order = np.lexsort((rank, cell))
        last = np.r_[cell[order][1:] != cell[order][:-1], True]
        cell, reg = cell[order][last], np.minimum(rank[order][last], 15)
        packed = np.zeros(S * HLL_M // 2, np.uint8)
        np.bitwise_or.at(packed, cell >> 1,
                         np.where(cell & 1, reg, reg << 4).astype(np.uint8))
        head = bytes([1, HLL_P, 0, 0]) + (HLL_M // 2).to_bytes(4, "big")

        def framing(n: int) -> bytes:
            n += len(head)
            inner = varint(1 << 3 | 2) + varint(n)
            return varint(8 << 3 | 2) + varint(len(inner) + n) + inner + head
        tmpl, (mask,) = self._layout(c, np.full(S, HLL_M // 2, np.int64),
                                     framing)
        out = tmpl.copy()
        out[mask] = packed
        return out.tobytes()

    def _digests(self, c: planmod.FleetClass) -> bytes:
        """One entry per timer series: its samples' digest with min, max
        and reciprocal sum, as a local's flush forwards it."""
        S = c.names.n_series
        vals = c.values.value.astype(np.float32).astype(np.float64)
        order = np.lexsort((vals, c.series))
        sv = vals[order]
        counts = np.bincount(c.series, minlength=S)
        ends = np.cumsum(counts)
        starts = ends - counts
        nz = counts > 0
        trailer = np.zeros((S, 4), np.float64)
        trailer[:, 0] = self.compression
        trailer[nz, 1] = np.minimum.reduceat(sv, starts[nz])
        trailer[nz, 2] = np.maximum.reduceat(sv, starts[nz])
        trailer[nz, 3] = np.add.reduceat(1.0 / sv, starts[nz])
        tmat = np.empty((S, 36), np.uint8)
        for k, tag in enumerate((0x11, 0x19, 0x21, 0x29)):
            tmat[:, 9 * k] = tag
            tmat[:, 9 * k + 1:9 * k + 9] = trailer[:, k:k + 1].astype(
                "<f8").view(np.uint8)
        if (counts >= singleton_bound(self.compression)).any():
            cents = [np.frombuffer(centroid_blob(*plain_digest(
                sv[starts[j]:ends[j]], self.compression)), np.uint8)
                for j in range(S)]
        else:
            # every digest is its sorted samples, in one blob
            blob = np.frombuffer(centroid_blob(sv, np.ones(len(sv))),
                                 np.uint8)
            cents = None
        lens = (np.asarray([len(x) for x in cents], np.int64) if cents
                else 20 * counts.astype(np.int64))

        def framing(n: int) -> bytes:
            hv = varint(1 << 3 | 2) + varint(n)
            return varint(7 << 3 | 2) + varint(len(hv) + n) + hv
        tmpl, (cmask, tmask) = self._layout(
            c, np.stack([lens, np.full(S, 36, np.int64)], 1).ravel(),
            framing, n_kinds=2)
        out = tmpl.copy()
        out[cmask] = np.concatenate(cents) if cents else blob
        out[tmask] = tmat.ravel()
        return out.tobytes()
