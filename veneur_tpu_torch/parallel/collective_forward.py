"""Collective forward plane exchange: the forward hop as tensors.

Port of ``veneur_tpu/parallel/collective_forward.py``.  Where locals
and globals are processes of one ``torch.distributed`` job
(:func:`veneur_tpu_torch.parallel.sharded.init_process_mesh`), a
local's sealed planes need not serialize into a MetricList wire, ride
a socket and decode on the far side: t-digest centroid planes, HLL
register planes and counter/gauge segments are mergeable state, so the
owning global folds the raw planes directly.

- :class:`PlaneSchema` — the fixed per-destination block layout: a
  header (per-class row counts) plus four class segments (counter,
  gauge, histo, set), each padded to ``max_rows`` rows of fixed
  stride, so every participant contributes identically shaped tensors
  and a cycle is ONE collective.  Row identity (name, metric type,
  scope, tags) rides in a ``key_bytes``-wide length-prefixed field per
  row; rows that do not fit fall open to the gRPC wire, never
  truncated.  The byte format is the reference's, byte for byte.
- :func:`pack_block` / :func:`unpack_block` — ForwardRow lists in and
  out of a block, values pre-conditioned for bit parity with the gRPC
  wire (counters round through int64 as the proto CounterValue does;
  histo planes carry exactly the wire's live centroids; set rows the
  dense registers, tail-cut at 15 as the wire's encoding is).
- :func:`fold_block` — the receiving global's intake through the same
  row lookups and batch appliers the gRPC import uses, operation for
  operation, so the folded table state is bit-identical to the wire's.
- :class:`PlaneExchange` — the one collective: ``all_to_all_single``
  over the job's process group.  Each process contributes
  ``[n_proc, block]`` (row d = block destined to process d) and
  receives ``[n_proc, block]`` (row s = block process s addressed to
  it).  One process short-circuits to the identity (self-addressed
  blocks land locally), the loopback oracle.

The gRPC wire stays the fallback, the parity oracle and the only
recovery path: nothing here retries, spools or breaks; a failed
exchange surfaces to the caller, which re-routes the cycle onto the
wire (``forward/collective.py`` owns that contract).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

import torch

from veneur_tpu_torch.core.flusher import ForwardRow
from veneur_tpu_torch.core.table import RowMeta
from veneur_tpu_torch.ops import hll, segment, tdigest
from veneur_tpu_torch.protocol import dogstatsd as dsd

# header: magic + 4 per-class row counts, little-endian int32
_MAGIC = 0x56504C4E  # "VPLN"
_HDR_WORDS = 8
HEADER_BYTES = _HDR_WORDS * 4

# class codes, matching the native wire decoder's kind column
KLASS_COUNTER = 1
KLASS_GAUGE = 2
KLASS_HISTO = 3
KLASS_SET = 4

# identity field codes: fixed tuples shared by every participant (the
# schema is config-derived, never negotiated)
_MTYPE_CODES = (dsd.COUNTER, dsd.GAUGE, dsd.HISTOGRAM, dsd.TIMER,
                dsd.SET)
_MTYPE_TO_CODE = {t: i for i, t in enumerate(_MTYPE_CODES)}
_SCOPE_CODES = (dsd.SCOPE_DEFAULT, dsd.SCOPE_LOCAL, dsd.SCOPE_GLOBAL)
_SCOPE_TO_CODE = {s: i for i, s in enumerate(_SCOPE_CODES)}

_KIND_TO_KLASS = {"counter": KLASS_COUNTER, "gauge": KLASS_GAUGE,
                  "histo": KLASS_HISTO, "set": KLASS_SET}


class PlaneFormatError(ValueError):
    """A landed block fails structural validation (bad magic, counts
    out of range, identity decode failure)."""


@dataclass(frozen=True)
class PlaneSchema:
    """Fixed per-destination block layout.  All mesh participants must
    construct this from the same config (compression sizes the
    centroid plane width; max_rows/key_bytes are the operator knobs
    ``tpu_collective_max_rows`` / ``tpu_collective_key_bytes``) — the
    exchange is a collective, so shapes cannot be negotiated per
    cycle."""

    compression: float = tdigest.DEFAULT_COMPRESSION
    max_rows: int = 512
    key_bytes: int = 192
    centroids: int = field(init=False)
    counter_stride: int = field(init=False)
    gauge_stride: int = field(init=False)
    histo_stride: int = field(init=False)
    set_stride: int = field(init=False)
    block_size: int = field(init=False)

    def __post_init__(self):
        c = tdigest.capacity_for(float(self.compression))
        object.__setattr__(self, "centroids", c)
        object.__setattr__(self, "counter_stride", self.key_bytes + 8)
        object.__setattr__(self, "gauge_stride", self.key_bytes + 8)
        object.__setattr__(
            self, "histo_stride",
            self.key_bytes + 4 * segment.HISTO_STAT_COLS + 8 * c)
        object.__setattr__(self, "set_stride",
                           self.key_bytes + hll.M)
        object.__setattr__(
            self, "block_size",
            HEADER_BYTES + self.max_rows * (
                self.counter_stride + self.gauge_stride
                + self.histo_stride + self.set_stride))

    def seg_offset(self, klass: int) -> int:
        off = HEADER_BYTES
        if klass == KLASS_COUNTER:
            return off
        off += self.max_rows * self.counter_stride
        if klass == KLASS_GAUGE:
            return off
        off += self.max_rows * self.gauge_stride
        if klass == KLASS_HISTO:
            return off
        off += self.max_rows * self.histo_stride
        return off

    def stride(self, klass: int) -> int:
        return (self.counter_stride, self.gauge_stride,
                self.histo_stride, self.set_stride)[klass - 1]


def encode_identity(meta: RowMeta, key_bytes: int) -> bytes | None:
    """Length-prefixed identity field: u8 mtype code, u8 scope code,
    u16 name length + name bytes, u8 tag count, then per tag u16
    length + bytes.  Returns None when it will not fit in
    ``key_bytes`` — the caller routes that row to the wire instead
    (never truncated, never lost)."""
    mt = _MTYPE_TO_CODE.get(meta.type)
    sc = _SCOPE_TO_CODE.get(meta.scope)
    if mt is None or sc is None:
        return None
    try:
        nb = meta.name.encode()
        tags = [t.encode() for t in meta.tags]
    except UnicodeEncodeError:
        return None
    if len(nb) > 0xFFFF or len(tags) > 0xFF or any(
            len(t) > 0xFFFF for t in tags):
        return None
    parts = [struct.pack("<BBH", mt, sc, len(nb)), nb,
             struct.pack("<B", len(tags))]
    for t in tags:
        parts.append(struct.pack("<H", len(t)))
        parts.append(t)
    out = b"".join(parts)
    if len(out) > key_bytes:
        return None
    return out


def decode_identity(buf: bytes) -> tuple[str, str, str,
                                         tuple[str, ...]]:
    """Inverse of :func:`encode_identity`; returns
    (name, mtype, scope, tags).  Raises :class:`PlaneFormatError` on
    structural damage."""
    try:
        mt, sc, nlen = struct.unpack_from("<BBH", buf, 0)
        pos = 4
        name = buf[pos:pos + nlen].decode()
        pos += nlen
        ntags = buf[pos]
        pos += 1
        tags = []
        for _ in range(ntags):
            (tl,) = struct.unpack_from("<H", buf, pos)
            pos += 2
            tags.append(buf[pos:pos + tl].decode())
            pos += tl
        if mt >= len(_MTYPE_CODES) or sc >= len(_SCOPE_CODES):
            raise ValueError("identity code out of range")
    except (struct.error, IndexError, UnicodeDecodeError,
            ValueError) as e:
        raise PlaneFormatError(f"bad identity field: {e}") from e
    return name, _MTYPE_CODES[mt], _SCOPE_CODES[sc], tuple(tags)


def pack_block(rows: list[ForwardRow], schema: PlaneSchema
               ) -> tuple[np.ndarray, int, list[ForwardRow]]:
    """Pack one destination's forward rows into a block.  Returns
    (block u8[block_size], packed_count, rejected) — ``rejected``
    holds rows that exceed the per-class capacity, whose identity
    overflows ``key_bytes`` or whose live centroids overflow the
    plane width; the caller ships those on the gRPC wire (the
    fixed-schema exchange pads, it never truncates)."""
    block = np.zeros(schema.block_size, np.uint8)
    counts = [0, 0, 0, 0]
    rejected: list[ForwardRow] = []
    kb = schema.key_bytes
    for r in rows:
        klass = _KIND_TO_KLASS.get(r.kind)
        if klass is None:
            rejected.append(r)
            continue
        n = counts[klass - 1]
        if n >= schema.max_rows:
            rejected.append(r)
            continue
        ident = encode_identity(r.meta, kb)
        if ident is None:
            rejected.append(r)
            continue
        off = schema.seg_offset(klass) + n * schema.stride(klass)
        block[off:off + len(ident)] = np.frombuffer(ident, np.uint8)
        body = off + kb
        if klass == KLASS_COUNTER:
            # int64 round-trip up front: the proto wire carries
            # CounterValue int64, so the folded += must see the SAME
            # rounded value the wire oracle applies
            block[body:body + 8] = np.frombuffer(
                struct.pack("<d", float(int(round(r.value)))),
                np.uint8)
        elif klass == KLASS_GAUGE:
            block[body:body + 8] = np.frombuffer(
                struct.pack("<d", float(r.value)), np.uint8)
        elif klass == KLASS_HISTO:
            stats = np.asarray(r.stats, np.float32)
            means = np.asarray(r.means, np.float32)
            weights = np.asarray(r.weights, np.float32)
            live = weights > 0
            n_live = int(live.sum())
            if n_live > schema.centroids:
                counts[klass - 1] = n  # row not taken
                rejected.append(r)
                continue
            block[body:body + 20] = stats.view(np.uint8)
            cm = np.zeros(schema.centroids, np.float32)
            cw = np.zeros(schema.centroids, np.float32)
            # exactly the wire's centroid list: live entries in
            # original order (row_to_metric's weights > 0 filter)
            cm[:n_live] = means[live]
            cw[:n_live] = weights[live]
            mo = body + 20
            block[mo:mo + 4 * schema.centroids] = cm.view(np.uint8)
            wo = mo + 4 * schema.centroids
            block[wo:wo + 4 * schema.centroids] = cw.view(np.uint8)
        else:  # KLASS_SET
            regs = np.asarray(r.regs, np.uint8)
            if regs.shape != (hll.M,):
                rejected.append(r)
                continue
            # the wire's dense axiomhq encoding tailcut-saturates at
            # 15 (hll_codec.encode_dense); mirror it so the folded
            # registers are bit-identical to decode(encode(regs))
            block[body:body + hll.M] = np.minimum(regs, 15)
        counts[klass - 1] = n + 1
    hdr = np.asarray([_MAGIC] + counts + [0, 0, 0], np.int32)
    block[:HEADER_BYTES] = hdr.view(np.uint8)
    return block, sum(counts), rejected


def block_counts(block: np.ndarray) -> tuple[int, int, int, int]:
    """Per-class row counts of a block; (0,0,0,0) for an all-zero
    (empty / padding) block.  Raises :class:`PlaneFormatError` on a
    non-empty block with a bad magic or out-of-range counts."""
    hdr = np.ascontiguousarray(block[:HEADER_BYTES]).view(np.int32)
    if int(hdr[0]) != _MAGIC:
        if not block.any():
            return (0, 0, 0, 0)
        raise PlaneFormatError(f"bad plane magic {int(hdr[0]):#x}")
    counts = tuple(int(c) for c in hdr[1:5])
    if any(c < 0 for c in counts):
        raise PlaneFormatError(f"negative plane counts {counts}")
    return counts  # max_rows bound is checked against a schema later


def unpack_block(block: np.ndarray, schema: PlaneSchema
                 ) -> list[ForwardRow]:
    """Reconstruct ForwardRows from a block — the debugging/test
    inverse of :func:`pack_block` (the production intake is
    :func:`fold_block`, which never materializes row objects)."""
    rows: list[ForwardRow] = []
    counts = block_counts(block)
    if any(c > schema.max_rows for c in counts):
        raise PlaneFormatError(
            f"plane counts {counts} exceed max_rows={schema.max_rows}")
    kb = schema.key_bytes
    kinds = ("counter", "gauge", "histo", "set")
    for klass in (KLASS_COUNTER, KLASS_GAUGE, KLASS_HISTO, KLASS_SET):
        stride = schema.stride(klass)
        base = schema.seg_offset(klass)
        for i in range(counts[klass - 1]):
            off = base + i * stride
            name, mtype, scope, tags = decode_identity(
                bytes(block[off:off + kb]))
            meta = RowMeta(name=name, tags=tags, scope=scope,
                           type=mtype)
            body = off + kb
            if klass in (KLASS_COUNTER, KLASS_GAUGE):
                (v,) = struct.unpack(
                    "<d", bytes(block[body:body + 8]))
                rows.append(ForwardRow(meta, kinds[klass - 1],
                                       value=v))
            elif klass == KLASS_HISTO:
                stats = np.ascontiguousarray(
                    block[body:body + 20]).view(np.float32).copy()
                mo = body + 20
                cw_off = mo + 4 * schema.centroids
                means = np.ascontiguousarray(
                    block[mo:mo + 4 * schema.centroids]).view(
                    np.float32).copy()
                weights = np.ascontiguousarray(
                    block[cw_off:cw_off + 4 * schema.centroids]).view(
                    np.float32).copy()
                rows.append(ForwardRow(meta, "histo", stats=stats,
                                       means=means, weights=weights))
            else:
                regs = np.ascontiguousarray(
                    block[body:body + hll.M]).copy()
                rows.append(ForwardRow(meta, "set", regs=regs))
    return rows


def fold_block(table, block: np.ndarray, schema: PlaneSchema
               ) -> tuple[int, int]:
    """Fold one landed block into ``table`` — the collective twin of
    ``forward.grpc_forward.apply_decoded``, and deliberately a mirror
    of it: row resolution through the same import row lookups, then
    the same vectorized batch appliers with the same f64 reduceat
    centroid totals, finiteness gates and empty-stat fallbacks, so
    the staged table state is bit-identical to what the wire oracle
    produces for the same rows.  Returns (accepted, dropped).  Caller
    holds the server ingest lock (same contract as apply_decoded)."""
    counts = block_counts(block)
    if all(c == 0 for c in counts):
        return 0, 0
    if any(c > schema.max_rows for c in counts):
        raise PlaneFormatError(
            f"plane counts {counts} exceed max_rows={schema.max_rows}")
    kb = schema.key_bytes
    accepted = dropped = 0

    def _rows_of(klass):
        stride = schema.stride(klass)
        base = schema.seg_offset(klass)
        return [base + i * stride for i in range(counts[klass - 1])]

    # counters: += accumulate, no finiteness gate (matching
    # import_counter / apply_decoded's counter branch)
    offs = _rows_of(KLASS_COUNTER)
    if offs:
        rows = np.empty(len(offs), np.int64)
        vals = np.empty(len(offs), np.float64)
        keep = np.ones(len(offs), bool)
        for j, off in enumerate(offs):
            try:
                name, _mt, _sc, tags = decode_identity(
                    bytes(block[off:off + kb]))
            except PlaneFormatError:
                keep[j] = False
                continue
            row = table.import_counter_row(name, tags)
            if row is None:
                keep[j] = False
                continue
            rows[j] = row
            (vals[j],) = struct.unpack(
                "<d", bytes(block[off + kb:off + kb + 8]))
        dropped += int((~keep).sum())
        if keep.any():
            table.import_counter_batch(rows[keep], vals[keep])
            accepted += int(keep.sum())

    # gauges: last-write-wins in plane order; non-finite drop per
    # cycle (value-level, same as the wire's gauge gate)
    offs = _rows_of(KLASS_GAUGE)
    if offs:
        rows = np.empty(len(offs), np.int64)
        vals = np.empty(len(offs), np.float64)
        keep = np.ones(len(offs), bool)
        for j, off in enumerate(offs):
            try:
                name, _mt, _sc, tags = decode_identity(
                    bytes(block[off:off + kb]))
            except PlaneFormatError:
                keep[j] = False
                continue
            row = table.import_gauge_row(name, tags)
            if row is None:
                keep[j] = False
                continue
            rows[j] = row
            (vals[j],) = struct.unpack(
                "<d", bytes(block[off + kb:off + kb + 8]))
        dropped += int((~keep).sum())
        fin = np.isfinite(vals) & keep
        bad = int((keep & ~fin).sum())
        if bad:
            dropped += bad
        if fin.any():
            table.import_gauge_batch(rows[fin], vals[fin])
            accepted += int(fin.sum())

    # histograms: one reduceat pass over the concatenated live
    # centroid segments — operation-for-operation the apply_decoded
    # histo branch, so the f64 partial-sum order (and therefore the
    # staged f32 stat planes) matches the wire exactly
    offs = _rows_of(KLASS_HISTO)
    if offs:
        nh = len(offs)
        rows = np.empty(nh, np.int64)
        keep = np.ones(nh, bool)
        dstats = np.empty((nh, 3), np.float32)
        cc = np.empty(nh, np.int64)
        C = schema.centroids
        all_means = np.empty((nh, C), np.float32)
        all_weights = np.empty((nh, C), np.float32)
        for j, off in enumerate(offs):
            try:
                name, mtype, scope, tags = decode_identity(
                    bytes(block[off:off + kb]))
            except PlaneFormatError:
                keep[j] = False
                cc[j] = 0
                continue
            if mtype not in (dsd.HISTOGRAM, dsd.TIMER):
                mtype = dsd.HISTOGRAM
            row = table.import_histo_row(name, mtype, tags, scope)
            if row is None:
                keep[j] = False
                cc[j] = 0
                continue
            rows[j] = row
            body = off + kb
            st = np.ascontiguousarray(
                block[body:body + 20]).view(np.float32)
            dstats[j, 0] = st[segment.STAT_MIN]
            dstats[j, 1] = st[segment.STAT_MAX]
            dstats[j, 2] = st[segment.STAT_RSUM]
            mo = body + 20
            wo = mo + 4 * C
            all_means[j] = np.ascontiguousarray(
                block[mo:mo + 4 * C]).view(np.float32)
            all_weights[j] = np.ascontiguousarray(
                block[wo:wo + 4 * C]).view(np.float32)
            # packed centroids are the wire's live list, left-aligned
            cc[j] = int((all_weights[j] > 0).sum())
        dropped += int((~keep).sum())
        selh = np.nonzero(keep)[0]
        if len(selh):
            # flatten like the wire decoder's (means, weights,
            # cent_start, cent_cnt) columns
            cnts = cc[selh]
            cs = np.concatenate(([0], np.cumsum(cnts)[:-1]))
            total = int(cnts.sum())
            means = np.empty(total, np.float32)
            weights = np.empty(total, np.float32)
            for k, j in enumerate(selh):
                s, c = int(cs[k]), int(cnts[k])
                means[s:s + c] = all_means[j][:c]
                weights[s:s + c] = all_weights[j][:c]
            w_tot = np.zeros(len(selh), np.float64)
            s_tot = np.zeros(len(selh), np.float64)
            with_c = cnts > 0
            if with_c.any():
                starts = cs[with_c]
                ends = starts + cnts[with_c]
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
                    (~has_w | (np.isfinite(dmin) & np.isfinite(dmax)
                               & np.isfinite(drsum))))
            dropped += int((~ok_h).sum())
            if ok_h.any():
                wt = w_tot[ok_h]
                hw = has_w[ok_h]
                stats_mat = np.empty(
                    (int(ok_h.sum()), segment.HISTO_STAT_COLS),
                    np.float32)
                stats_mat[:, 0] = wt
                stats_mat[:, 1] = np.where(hw, dmin[ok_h],
                                           segment.STAT_MIN_EMPTY)
                stats_mat[:, 2] = np.where(hw, dmax[ok_h],
                                           segment.STAT_MAX_EMPTY)
                stats_mat[:, 3] = s_tot[ok_h]
                stats_mat[:, 4] = np.where(hw, drsum[ok_h], 0.0)
                sel_ok = selh[ok_h]
                okc = cc[sel_ok]
                rep_rows = np.repeat(rows[sel_ok],
                                     okc).astype(np.int32)
                total_c = int(okc.sum())
                if total_c:
                    within = (np.arange(total_c, dtype=np.int64) -
                              np.repeat(np.cumsum(okc) - okc, okc))
                    ok_pos = np.nonzero(ok_h)[0]
                    take = np.repeat(cs[ok_pos].astype(np.int64),
                                     okc) + within
                else:
                    take = np.empty(0, np.int64)
                cm = means[take]
                cw = weights[take]
                live = (cw > 0) & np.isfinite(cm) & np.isfinite(cw)
                table.import_histo_batch(
                    rows[sel_ok].astype(np.int32), stats_mat,
                    rep_rows[live], cm[live], cw[live])
                accepted += int(ok_h.sum())

    # sets: register planes are already dense — the union is one
    # np.maximum per row, same staging half the codec path uses
    offs = _rows_of(KLASS_SET)
    for off in offs:
        try:
            name, _mt, scope, tags = decode_identity(
                bytes(block[off:off + kb]))
            row = table.import_set_row(name, tags, scope)
            if row is None:
                dropped += 1
                continue
            regs = np.ascontiguousarray(
                block[off + kb:off + kb + hll.M])
            table.import_set_at(int(row), regs)
            accepted += 1
        except (PlaneFormatError, ValueError):
            dropped += 1
    return accepted, dropped


def make_forward_mesh(device=None, group=None):
    """The rendezvous surface of the plane exchange: one place per
    process of the job's group (default: the initialized world group,
    the process's own device), in process order."""
    from veneur_tpu_torch.parallel import sharded
    if device is None:
        device = sharded.process_device() or torch.device("cpu")
    group = group if group is not None else sharded._world_group()
    return sharded.Mesh([device], 1, 1, group)


class PlaneExchange:
    """The one collective of a forward cycle: ``all_to_all_single`` of
    the per-destination blocks over the forward mesh's group.

    Every process of the mesh MUST call :meth:`__call__` once a cycle
    (collectives rendezvous); a global with nothing to send contributes
    zero blocks.  A one-process mesh short-circuits to the identity —
    the self-addressed block lands locally with no collective, which
    doubles as the loopback oracle."""

    def __init__(self, mesh=None):
        if mesh is None:
            mesh = make_forward_mesh()
        self.mesh = mesh
        self.n_proc = int(mesh.n_proc)

    def __call__(self, local_blocks: np.ndarray) -> np.ndarray:
        """``local_blocks`` u8[n_proc, block]: row d = block destined
        to process d.  Returns u8[n_proc, block]: row s = the block
        process s addressed to THIS process."""
        local_blocks = np.ascontiguousarray(local_blocks, np.uint8)
        if local_blocks.shape[0] != self.n_proc:
            raise ValueError(
                f"expected {self.n_proc} destination blocks, got "
                f"{local_blocks.shape[0]}")
        if self.n_proc == 1:
            return local_blocks
        import torch.distributed as dist
        send = torch.from_numpy(local_blocks).to(self.mesh.home)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.mesh.group)
        return recv.cpu().numpy()
