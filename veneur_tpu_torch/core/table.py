"""Device-resident metric tables: every series of a class in one plane.

Port of ``veneur_tpu/core/table.py``, single-reader and single-tier.
All series of a metric class live in one fixed-capacity plane on the
device, addressed by a dense row id that the host allocates per key:

  class     state                                   update
  counter   f32[R]                                  dense add
  gauge     f32[R]                                  last-write select
  histo     f32[R,5] stats + f32[R,C] digest planes t-digest merge
  set       u8[R,16384] HLL registers               scatter-max

Ingest appends to host-side staging buffers; ``device_step`` ships the
staging to the device, and ``swap()`` at the interval boundary hands
the planes to the flusher and starts fresh ones.  Each apply cycle
packs everything it can into one superbatch buffer (ops/superbatch):
one host-to-device copy and one fused step.  Batches whose rows carry
more samples than one merge width take the deep path (host stats fold
+ one merge per chunk).

The port carries no native library: ingest is the pure-Python parse
and the numpy columnar path, ranks come from a numpy pass, raw set
members fold into a host register plane (or, past
``host_set_plane_max_bytes``, scatter on the device) — the reference
table's ``self._lib is None`` branches.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from veneur_tpu_torch import resolve_device
from veneur_tpu_torch.ops import cluster_merge, hll, segment, superbatch
from veneur_tpu_torch.ops import tdigest
from veneur_tpu_torch.protocol import columnar, dogstatsd as dsd
from veneur_tpu_torch.utils import hashing, intern

_MIN_BUCKET = 256
_MIN_BUCKET_WIDE = 8  # for batches whose rows are whole planes


def _bucket_len(n: int, wide: bool = False) -> int:
    """Pad-to bucket: powers of two plus 1.5x half-steps."""
    b = _MIN_BUCKET_WIDE if wide else _MIN_BUCKET
    while True:
        if n <= b:
            return b
        if n <= b + b // 2:
            return b + b // 2
        b *= 2


def _pad_np(arr: np.ndarray, length: int, fill) -> np.ndarray:
    out = np.full(length, fill, arr.dtype)
    out[:len(arr)] = arr
    return out


@dataclass
class TableConfig:
    counter_rows: int = 4096
    gauge_rows: int = 4096
    histo_rows: int = 4096
    set_rows: int = 512
    compression: float = 100.0
    histo_slots: int = 512  # max samples per row per merge call
    compact_threshold: float = 0.75
    # histo and set samples accumulate across device steps and ship in
    # ONE pass at the swap (or when this many are staged)
    histo_merge_samples: int = 4 << 20
    # raw set samples fold into a HOST register plane when the plane
    # fits this bound; past it they scatter on the device
    host_set_plane_max_bytes: int = 64 << 20


@dataclass
class RowMeta:
    name: str
    tags: tuple[str, ...]
    scope: str
    type: str
    key_hash: int = 0


class _DropTally:
    """Per-class overflow-drop count for one interval (samples)."""

    def __init__(self):
        self.count = 0

    def add(self, n: int) -> None:
        self.count += int(n)

    def take(self) -> int:
        n, self.count = self.count, 0
        return n


class _ClassIndex:
    """Host-side MetricKey -> row allocation for one metric class."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.rows: dict[tuple, int] = {}
        self.meta: list[RowMeta] = []
        self.touched = np.zeros(capacity, dtype=bool)
        self.last_gen = np.zeros(capacity, dtype=np.int64)
        self.drops = _DropTally()

    @property
    def overflow(self) -> int:
        return self.drops.count

    def lookup(self, sample_key: tuple, name: str,
               tags: tuple[str, ...], scope: str, mtype: str,
               gen: int, key_hash: int = 0,
               count_overflow: bool = True) -> int | None:
        row = self.rows.get(sample_key)
        if row is None:
            if len(self.meta) >= self.capacity:
                if count_overflow:
                    self.drops.add(1)
                return None
            row = len(self.meta)
            self.rows[sample_key] = row
            self.meta.append(RowMeta(name, tags, scope, mtype, key_hash))
        elif key_hash and not self.meta[row].key_hash:
            self.meta[row].key_hash = key_hash
        self.last_gen[row] = gen
        self.touched[row] = True
        return row

    def touch_rows(self, rows: np.ndarray, gen: int) -> None:
        self.touched[rows] = True
        self.last_gen[rows] = gen

    def occupancy(self) -> int:
        return len(self.meta)

    def compact(self, keep_gen: int) -> np.ndarray:
        """Drop keys untouched since ``keep_gen``; renumber survivors.
        Only legal at a swap boundary.  Returns old-row -> new-row
        (-1 for dropped rows)."""
        new_rows: dict[tuple, int] = {}
        new_meta: list[RowMeta] = []
        new_gen = np.zeros(self.capacity, dtype=np.int64)
        mapping = np.full(self.capacity, -1, np.int32)
        for key, row in self.rows.items():
            if self.last_gen[row] >= keep_gen:
                new_row = len(new_meta)
                new_rows[key] = new_row
                new_gen[new_row] = self.last_gen[row]
                new_meta.append(self.meta[row])
                mapping[row] = new_row
        self.rows = new_rows
        self.meta = new_meta
        self.last_gen = new_gen
        self.touched = np.zeros(self.capacity, dtype=bool)
        return mapping

    def reset_interval(self) -> None:
        self.touched = np.zeros(self.capacity, dtype=bool)


class _Staging:
    """Columnar append buffers for one class."""

    def __init__(self):
        self.rows: list[np.ndarray] = []
        self.values: list[np.ndarray] = []
        self.weights: list[np.ndarray] = []

    def append(self, rows, values, weights=None):
        self.rows.append(np.asarray(rows, np.int32))
        self.values.append(np.asarray(values, np.float32))
        if weights is not None:
            self.weights.append(np.asarray(weights, np.float32))

    def take(self):
        if not self.rows:
            return None
        rows = np.concatenate(self.rows)
        vals = np.concatenate(self.values)
        wts = np.concatenate(self.weights) if self.weights else None
        self.rows, self.values, self.weights = [], [], []
        return rows, vals, wts

    def __len__(self):
        return sum(len(r) for r in self.rows)


class _IntervalState:
    """One interval's device-resident accumulation state."""

    __slots__ = ("gen", "fresh", "counters", "gauges", "histo_stats",
                 "histo_import_stats", "histo_means", "histo_weights",
                 "hll_regs", "hll_host_plane", "hll_device_touched")

    def __init__(self, gen: int):
        self.gen = gen
        self.fresh: set = set()
        self.hll_host_plane: np.ndarray | None = None
        self.hll_device_touched = False


class _StagedWork:
    """Staging buffers detached for one apply."""

    __slots__ = ("state", "counter", "gauge", "histo", "set_parts",
                 "empty")


class _PendingSwap:
    """begin_swap's output: the final detached staging plus the row
    metadata captured at the interval boundary."""

    __slots__ = ("work", "state", "counter_meta", "counter_touched",
                 "gauge_meta", "gauge_touched", "histo_meta",
                 "histo_touched", "set_meta", "set_touched",
                 "overflow", "ingested")


@dataclass
class Snapshot:
    """Everything the flusher needs from one interval: device planes
    plus row metadata."""
    gen: int
    counters: Any
    counter_meta: list[RowMeta]
    counter_touched: np.ndarray
    gauges: Any
    gauge_meta: list[RowMeta]
    gauge_touched: np.ndarray
    histo_stats: Any  # raw-sample ("local") stats plane
    histo_import_stats: Any  # forwarded-stat-row merges only
    histo_means: Any
    histo_weights: Any
    histo_meta: list[RowMeta]
    histo_touched: np.ndarray
    hll_regs: Any
    set_meta: list[RowMeta]
    set_touched: np.ndarray
    # host-folded raw-set registers for the interval (None when the
    # plane exceeded host_set_plane_max_bytes) and whether anything
    # touched the DEVICE registers
    hll_host_plane: np.ndarray | None = None
    hll_device_touched: bool = False
    overflow: dict[str, int] = field(default_factory=dict)
    ingested: int = 0

    @property
    def host_only_sets(self) -> bool:
        return (self.hll_host_plane is not None and
                not self.hll_device_touched)

    def host_set_estimates(self) -> np.ndarray:
        return hll.estimate_np(self.hll_host_plane)


class MetricTable:
    """The port's metric table.  ``device`` defaults to ``"cuda"``
    and raises without CUDA unless the caller passes ``"cpu"``."""

    _KINDS = ("counter", "gauge", "histo", "hll")

    def __init__(self, config: TableConfig | None = None,
                 device: "str | torch.device" = "cuda"):
        self.device = resolve_device(device)
        self.config = config or TableConfig()
        c = self.config
        self.gen = 0
        self.capacity = tdigest.capacity_for(c.compression)

        self.counter_idx = _ClassIndex(c.counter_rows)
        self.gauge_idx = _ClassIndex(c.gauge_rows)
        self.histo_idx = _ClassIndex(c.histo_rows)
        self.set_idx = _ClassIndex(c.set_rows)

        # counters and gauges stage as DENSE per-row host buffers (f64
        # counter accumulator: one f32 round-off at ship time)
        self._counter_dense = np.zeros(c.counter_rows, np.float64)
        self._gauge_dense = np.zeros(c.gauge_rows, np.float32)
        self._gauge_mask = np.zeros(c.gauge_rows, np.uint8)
        self._counter_dirty = False
        self._gauge_dirty = False
        self._histo_stage = _Staging()
        self._set_rows: list[int] = []
        self._set_members: list[bytes] = []
        # columnar set staging: packed (idx << 6) | rank per member
        self._set_pos_rows: list[np.ndarray] = []
        self._set_pos: list[np.ndarray] = []
        self.key_index = intern.HashIndex()
        self.status: dict[tuple, tuple[float, str, tuple[str, ...]]] = {}

        # merge chunk width, capped so state + chunk stays inside the
        # cluster merge kernel's width bound
        self._eff_histo_slots = c.histo_slots
        mb = cluster_merge.max_batch_slots(self.capacity)
        if mb >= _MIN_BUCKET:
            self._eff_histo_slots = min(c.histo_slots, mb)
        self._staged_n = 0
        self._interval_ingested = 0

        self._sb_bufs = superbatch.DoubleBuffer(
            pin=self.device.type == "cuda")
        # fused superbatch applies (one host-to-device copy each)
        self.superbatch_applies = 0
        self._device_lock = threading.Lock()
        self._init_state()

    def _init_state(self):
        st = _IntervalState(self.gen)
        for kind in self._KINDS:
            self._alloc_state(st, kind)
        self._state = st

    def _alloc_state(self, st: _IntervalState, kind: str) -> None:
        c = self.config
        dev = self.device
        if kind == "counter":
            st.counters = segment.empty_counter_state(c.counter_rows, dev)
        elif kind == "gauge":
            st.gauges = segment.empty_gauge_state(c.gauge_rows, dev)
        elif kind == "histo":
            st.histo_stats = segment.empty_histo_stats(c.histo_rows, dev)
            st.histo_import_stats = segment.empty_histo_stats(
                c.histo_rows, dev)
            st.histo_means, st.histo_weights = tdigest.empty_state(
                c.histo_rows, self.capacity, dev)
        elif kind == "hll":
            st.hll_regs = hll.empty_state(c.set_rows, dev)

    def _ensure_fresh(self, st: _IntervalState, kind: str) -> None:
        """Lazy per-kind reinit: after a swap the old planes belong to
        the snapshot; a kind gets new zeroed planes on first touch."""
        if kind in st.fresh:
            self._alloc_state(st, kind)
            st.fresh.discard(kind)

    # ------------------------------------------------------------------
    # ingest

    def ingest(self, s: dsd.Sample) -> bool:
        """Single-sample ingest.  Returns False on row-table overflow
        (sample dropped and counted)."""
        key = (s.name, s.type, s.tags, s.scope)
        weight = 1.0 / s.sample_rate
        if s.type == dsd.COUNTER:
            row = self.counter_idx.lookup(key, s.name, s.tags, s.scope,
                                          s.type, self.gen)
            if row is None:
                return False
            self._counter_dense[row] += s.value * weight
            self._counter_dirty = True
        elif s.type == dsd.GAUGE:
            row = self.gauge_idx.lookup(key, s.name, s.tags, s.scope,
                                        s.type, self.gen)
            if row is None:
                return False
            self._gauge_dense[row] = s.value
            self._gauge_mask[row] = 1
            self._gauge_dirty = True
        elif s.type in (dsd.TIMER, dsd.HISTOGRAM):
            row = self.histo_idx.lookup(key, s.name, s.tags, s.scope,
                                        s.type, self.gen)
            if row is None:
                return False
            self._histo_stage.append([row], [s.value], [weight])
        elif s.type == dsd.SET:
            row = self.set_idx.lookup(key, s.name, s.tags, s.scope,
                                      s.type, self.gen)
            if row is None:
                return False
            self._set_rows.append(row)
            member = s.value if isinstance(s.value, bytes) else str(
                s.value).encode()
            self._set_members.append(member)
        elif s.type == dsd.STATUS:
            self.status[key] = (float(s.value), s.message, s.tags)
            return True
        else:
            raise ValueError(f"unknown metric type {s.type}")
        self._note_staged(1)
        return True

    def ingest_many(self, samples) -> int:
        dropped = 0
        for s in samples:
            if not self.ingest(s):
                dropped += 1
        return dropped

    def _class_for_code(self, code: int) -> _ClassIndex:
        if code == columnar.CODE_COUNTER:
            return self.counter_idx
        if code == columnar.CODE_GAUGE:
            return self.gauge_idx
        if code in (columnar.CODE_TIMER, columnar.CODE_HISTOGRAM):
            return self.histo_idx
        return self.set_idx

    def _resolve_misses(self, pb: columnar.ParsedBatch,
                        miss_lines: np.ndarray,
                        miss_keys: np.ndarray) -> None:
        """Allocate rows for never-seen series: slow-parse ONE
        representative line per unique identity hash and remember the
        mapping (or DROPPED on class overflow) in the key index."""
        _, first = np.unique(miss_keys, return_index=True)
        for fp in first:
            i = int(miss_lines[fp])
            k = int(miss_keys[fp])
            try:
                s = dsd.parse_metric(pb.line(i))
            except dsd.ParseError:
                self.key_index.insert(k, intern.DROPPED)
                continue
            cls = self._class_for_code(int(pb.type_code[i]))
            row = cls.lookup((s.name, s.type, s.tags, s.scope), s.name,
                             s.tags, s.scope, s.type, self.gen,
                             key_hash=k, count_overflow=False)
            self.key_index.insert(
                k, row if row is not None else intern.DROPPED)

    def ingest_columns(self, pb: columnar.ParsedBatch
                       ) -> tuple[int, int]:
        """Batch ingest of a parsed buffer's metric lines (type codes
        0-4) in a handful of vectorized numpy passes.  Returns
        (processed, dropped)."""
        tc = pb.type_code
        sel = np.nonzero(tc <= columnar.CODE_SET)[0]
        if len(sel) == 0:
            return 0, 0
        keys = pb.key_hash[sel]
        rows = self.key_index.lookup(keys)
        miss = rows == intern.MISSING
        if miss.any():
            self._resolve_misses(pb, sel[miss], keys[miss])
            rows = self.key_index.lookup(keys)
        live = rows >= 0
        dropped = int((~live).sum())
        if dropped:
            for code in np.unique(tc[sel][~live]):
                self._class_for_code(int(code)).drops.add(int(
                    ((tc[sel] == code) & ~live).sum()))

        codes = tc[sel]
        vals = pb.value[sel]
        wts = pb.weight[sel]

        cmask = (codes == columnar.CODE_COUNTER) & live
        if cmask.any():
            r = rows[cmask]
            self._counter_dense += np.bincount(
                r, weights=vals[cmask] * wts[cmask],
                minlength=self.config.counter_rows)
            self._counter_dirty = True
            self.counter_idx.touch_rows(r, self.gen)

        gmask = (codes == columnar.CODE_GAUGE) & live
        if gmask.any():
            r = rows[gmask]
            # fancy assignment applies in index order: last write wins
            self._gauge_dense[r] = vals[gmask]
            self._gauge_mask[r] = 1
            self._gauge_dirty = True
            self.gauge_idx.touch_rows(r, self.gen)

        hmask = ((codes == columnar.CODE_TIMER) |
                 (codes == columnar.CODE_HISTOGRAM)) & live
        if hmask.any():
            r = rows[hmask]
            self._histo_stage.append(r, vals[hmask], wts[hmask])
            self.histo_idx.touch_rows(r, self.gen)

        smask = (codes == columnar.CODE_SET) & live
        if smask.any():
            r = rows[smask]
            idx, rank = hashing.hll_position(pb.member_hash[sel][smask])
            self._set_pos_rows.append(np.asarray(r, np.int32))
            self._set_pos.append(hll.pack_positions(idx, rank))
            self.set_idx.touch_rows(r, self.gen)

        processed = len(sel)
        self._note_staged(processed - dropped)
        return processed, dropped

    def staged(self) -> int:
        return self._staged_n

    def _note_staged(self, n: int) -> None:
        self._staged_n += n
        self._interval_ingested += n

    # ------------------------------------------------------------------
    # device step

    def device_step(self, final: bool = False) -> None:
        """Push staged samples to the device.  Counters and gauges ship
        only at the swap (they are dense interval accumulators); histo
        and set staging ship at the swap or past
        ``histo_merge_samples``."""
        w = self._detach_staged(final)
        if w.empty:
            return
        with self._device_lock:
            self._apply_work(w)

    def _detach_staged(self, final: bool) -> _StagedWork:
        c = self.config
        w = _StagedWork()
        w.state = self._state
        w.counter = w.gauge = w.histo = w.set_parts = None
        self._staged_n = 0
        if self._counter_dirty and final:
            w.counter = self._counter_dense
            self._counter_dense = np.zeros(c.counter_rows, np.float64)
            self._counter_dirty = False
        if self._gauge_dirty and final:
            w.gauge = (self._gauge_dense, self._gauge_mask)
            self._gauge_dense = np.zeros(c.gauge_rows, np.float32)
            self._gauge_mask = np.zeros(c.gauge_rows, np.uint8)
            self._gauge_dirty = False
        if self._histo_stage.rows and (
                final or
                len(self._histo_stage) >= c.histo_merge_samples):
            w.histo = self._histo_stage
            self._histo_stage = _Staging()
        staged_sets = (len(self._set_rows) +
                       sum(len(r) for r in self._set_pos_rows))
        if (staged_sets and
                (final or staged_sets >= c.histo_merge_samples)):
            w.set_parts = (self._set_rows, self._set_members,
                           self._set_pos_rows, self._set_pos)
            self._set_rows, self._set_members = [], []
            self._set_pos_rows, self._set_pos = [], []
        w.empty = (w.counter is None and w.gauge is None and
                   w.histo is None and w.set_parts is None)
        return w

    def _apply_work(self, w: _StagedWork) -> None:
        """Apply detached staging to its interval state: the superbatch
        takes every family its schema carries; deep histo batches and
        the host set fold run on their own.  Caller holds
        _device_lock."""
        st = w.state
        self._superbatch_apply(w)
        if w.set_parts is not None:
            # the superbatch left the sets: the plane fits the host
            # bound, so they fold into the host register plane
            set_rows, set_members, pos_rows, pos = w.set_parts
            srows, spos = self._set_positions(set_rows, set_members,
                                              pos_rows, pos)
            if len(srows):
                self._hll_host_fold(st, srows, spos)

    @staticmethod
    def _set_positions(set_rows, set_members, pos_rows, pos):
        parts_rows, parts_pos = [], []
        if set_rows:
            idx, rank = hashing.hash_members(set_members)
            parts_rows.append(np.asarray(set_rows, np.int32))
            parts_pos.append(hll.pack_positions(idx, rank))
        parts_rows.extend(np.ascontiguousarray(p, np.int32)
                          for p in pos_rows)
        parts_pos.extend(np.ascontiguousarray(p, np.int32) for p in pos)
        if not parts_rows:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        return np.concatenate(parts_rows), np.concatenate(parts_pos)

    # ------------------------------------------------------------------
    # superbatch apply: one packed host buffer, one copy, one fused step

    def _superbatch_apply(self, w: _StagedWork) -> None:
        """Consume every staged family the one-buffer schema carries
        this cycle and apply them with one fused step.  Consumed
        families are nulled on ``w``."""
        st = w.state
        c = self.config
        counter = None
        if w.counter is not None:
            counter = np.ascontiguousarray(w.counter, np.float32)
            w.counter = None
        gauge = None
        if w.gauge is not None:
            dense, mask = w.gauge
            gauge = (np.ascontiguousarray(dense, np.float32),
                     np.ascontiguousarray(mask, np.int32))
            w.gauge = None
        histo = None
        if w.histo is not None:
            batch = w.histo.take()
            w.histo = None
            if batch is not None:
                histo = self._sb_histo_pack(st, *batch)
        sets = None
        if (w.set_parts is not None and
                c.set_rows * hll.M > c.host_set_plane_max_bytes):
            # the host-fold route (small pools) never touches the
            # device, so it keeps w.set_parts
            srows, spos = self._set_positions(*w.set_parts)
            w.set_parts = None
            if len(srows):
                sets = (srows, spos)
        if (counter is None and gauge is None and histo is None
                and sets is None):
            return
        kw: dict = {}
        if counter is not None:
            kw["counter_rows"] = c.counter_rows
        if gauge is not None:
            kw["gauge_rows"] = c.gauge_rows
        if histo is not None:
            kw.update(histo[0])
        if sets is not None:
            kw["pos_n"] = _bucket_len(len(sets[0]))
        spec = superbatch.SBSpec(**kw)
        off = superbatch.layout(spec)
        tbuf = self._sb_bufs.take_tensor(off["total"])
        buf = tbuf.numpy()
        superbatch.fill_header(buf, spec, off)
        if counter is not None:
            o = off["counter"]
            buf[o:o + c.counter_rows].view(np.float32)[:] = counter
        if gauge is not None:
            o = off["gauge_dense"]
            buf[o:o + c.gauge_rows].view(np.float32)[:] = gauge[0]
            o = off["gauge_mask"]
            buf[o:o + c.gauge_rows] = gauge[1]
        if histo is not None:
            self._sb_fill_histo(buf, off, spec, histo)
        if sets is not None:
            o = off["pos_rows"]
            buf[o:o + spec.pos_n] = _pad_np(sets[0], spec.pos_n,
                                            c.set_rows)
            o = off["pos_pk"]
            buf[o:o + spec.pos_n] = _pad_np(sets[1], spec.pos_n, 0)
        if spec.counter_rows:
            self._ensure_fresh(st, "counter")
        if spec.gauge_rows:
            self._ensure_fresh(st, "gauge")
        if spec.histo_n:
            self._ensure_fresh(st, "histo")
        if spec.pos_n:
            self._ensure_fresh(st, "hll")
            st.hll_device_touched = True
        dbuf = superbatch.to_device(tbuf, self.device, self._sb_bufs)
        out = superbatch.step(spec, st.counters, st.gauges,
                              st.histo_means, st.histo_weights,
                              st.histo_stats, st.hll_regs, dbuf)
        self.superbatch_applies += 1
        if spec.counter_rows:
            st.counters = out[0]
        if spec.gauge_rows:
            st.gauges = out[1]
        if spec.histo_n:
            st.histo_means, st.histo_weights, st.histo_stats = out[2:5]
        if spec.pos_n:
            st.hll_regs = out[5]

    def _sb_histo_pack(self, st, rows, vals, wts):
        """Route one histo batch: ride the superbatch when the shallow
        ranked merge fits one merge width, else take the deep path.
        Returns the packed operands, or None when handled here."""
        c = self.config
        n = len(rows)
        if not n:
            return None
        unit = bool(np.all(wts == 1.0))
        rows = np.ascontiguousarray(rows, np.int32)
        vals = np.ascontiguousarray(vals, np.float32)
        rank, max_count = self._rank(rows)
        if max_count > self._eff_histo_slots:
            self._histo_device_step(st, rows, vals, wts, with_stats=True)
            return None
        b = _bucket_len(n)
        slots = min(self._eff_histo_slots, _bucket_len(max_count))
        uniq = np.unique(rows)
        mb = _bucket_len(len(uniq))
        sub = mb * 2 <= c.histo_rows
        if sub:
            local = np.searchsorted(uniq, rows).astype(np.int32)
            rows_seg = _pad_np(local, b, mb)
            idx_seg = _pad_np(uniq.astype(np.int32), mb, c.histo_rows)
        else:
            rows_seg = _pad_np(rows, b, c.histo_rows)
            idx_seg = None
        wts_seg = (None if unit else
                   _pad_np(np.ascontiguousarray(wts, np.float32), b, 0.0))
        spec_kw = dict(histo_n=b, histo_slots=slots,
                       histo_sub=mb if sub else 0, histo_unit=unit,
                       histo_stats=True, compression=c.compression)
        return (spec_kw, rows_seg, _pad_np(rank, b, 0),
                _pad_np(vals, b, 0.0), wts_seg, idx_seg)

    def _sb_fill_histo(self, buf, off, spec, histo) -> None:
        _kw, rows_seg, rank_seg, vals_seg, wts_seg, idx_seg = histo
        b = spec.histo_n
        buf[off["histo_rows"]:off["histo_rows"] + b] = rows_seg
        buf[off["histo_rank"]:off["histo_rank"] + b] = rank_seg
        o = off["histo_vals"]
        buf[o:o + b].view(np.float32)[:] = vals_seg
        if wts_seg is not None:
            o = off["histo_wts"]
            buf[o:o + b].view(np.float32)[:] = wts_seg
        if idx_seg is not None:
            o = off["histo_idx"]
            buf[o:o + spec.histo_sub] = idx_seg

    # ------------------------------------------------------------------
    # histogram steps outside the superbatch

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _histo_device_step(self, st: _IntervalState, rows: np.ndarray,
                           vals: np.ndarray, wts: np.ndarray,
                           with_stats: bool = True) -> None:
        """Histo ingest: a batch that fits one merge width merges in one
        ranked pass; a deep batch folds its local aggregates on the
        host (exact) and merges digest-only, one chunk width at a time
        (or, past 64 chunk widths in one row, pre-clusters on the host
        first)."""
        unit = bool(np.all(wts == 1.0))
        rank, max_count = self._rank(rows)
        eff = self._eff_histo_slots
        if max_count <= eff:
            self._digest_merge(st, rows, vals, wts, rank, unit,
                               with_stats)
            return
        if with_stats:
            self._host_stats_fold(st, rows, vals, wts)
            with_stats = False
        n_chunks = -(-max_count // eff)
        if n_chunks > 64:
            rows, vals, wts = self._host_precluster(rows, vals, wts)
            rank, max_count = self._rank(rows)
            if max_count <= eff:
                self._digest_merge(st, rows, vals, wts, rank, False,
                                   False)
                return
            n_chunks = -(-max_count // eff)
        self._digest_merge_scan(st, rows, vals, wts, rank, n_chunks)

    def _host_stats_fold(self, st, rows, vals, wts) -> None:
        """Fold a batch's per-row local aggregates into the stats plane
        from host-computed exact values."""
        c = self.config
        rows = np.ascontiguousarray(rows, np.int64)
        R = c.histo_rows
        batch = np.zeros((R, segment.HISTO_STAT_COLS), np.float32)
        batch[:, segment.STAT_MIN] = segment.STAT_MIN_EMPTY
        batch[:, segment.STAT_MAX] = segment.STAT_MAX_EMPTY
        batch[:, segment.STAT_WEIGHT] = np.bincount(
            rows, weights=wts, minlength=R)[:R]
        batch[:, segment.STAT_SUM] = np.bincount(
            rows, weights=vals * wts, minlength=R)[:R]
        nz = vals != 0
        batch[:, segment.STAT_RSUM] = np.bincount(
            rows[nz], weights=wts[nz] / vals[nz], minlength=R)[:R]
        np.minimum.at(batch[:, segment.STAT_MIN], rows, vals)
        np.maximum.at(batch[:, segment.STAT_MAX], rows, vals)
        self._ensure_fresh(st, "histo")
        st.histo_stats = tdigest._combine_row_stats(st.histo_stats,
                                                    self._dev(batch))

    def _host_precluster(self, rows, vals, wts
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Collapse a sample batch into <= capacity weighted centroids
        per row on the same k-scale as the device merge."""
        c = self.config
        cap = self.capacity
        rows = np.ascontiguousarray(rows, np.int64)
        order = np.lexsort((vals, rows))
        r = rows[order]
        v = np.ascontiguousarray(vals, np.float64)[order]
        w = np.ascontiguousarray(wts, np.float64)[order]
        cw = np.cumsum(w)
        first = np.ones(len(r), bool)
        first[1:] = r[1:] != r[:-1]
        base = np.maximum.accumulate(np.where(first, cw - w, 0.0))
        totals = np.bincount(r, weights=w)[r]
        q_left = (cw - w - base) / np.maximum(totals, 1e-30)
        k = (tdigest.k_scale_np(q_left, c.compression) -
             tdigest.k_scale_np(0.0, c.compression))
        cl = np.clip(np.floor(k).astype(np.int64), 0, cap - 1)
        key = r * cap + cl
        uniq, inv = np.unique(key, return_inverse=True)
        cw_sum = np.bincount(inv, weights=w)
        cwv = np.bincount(inv, weights=w * v)
        return ((uniq // cap).astype(np.int32),
                (cwv / np.maximum(cw_sum, 1e-30)).astype(np.float32),
                cw_sum.astype(np.float32))

    def _ensure_host_plane(self, st: _IntervalState) -> None:
        if st.hll_host_plane is None:
            st.hll_host_plane = np.zeros((self.config.set_rows, hll.M),
                                         np.uint8)

    def _hll_host_fold(self, st: _IntervalState, rows: np.ndarray,
                       pos: np.ndarray) -> None:
        """Fold packed member positions into the interval's host
        register plane — no device work at all."""
        self._ensure_host_plane(st)
        pool = self.config.set_rows
        rows = np.ascontiguousarray(rows, np.int32)
        pos = np.ascontiguousarray(pos, np.int32)
        idx = pos >> 6
        rank = (pos & 0x3F).astype(np.uint8)
        live = (rows >= 0) & (rows < pool)
        np.maximum.at(st.hll_host_plane,
                      (rows[live], idx[live]), rank[live])

    def _rank(self, rows: np.ndarray,
              num_rows: int | None = None) -> tuple[np.ndarray, int]:
        """Within-row occurrence rank + max per-row count."""
        n = len(rows)
        rows = np.ascontiguousarray(rows, np.int32)
        order = np.argsort(rows, kind="stable")
        sorted_rows = rows[order]
        first = np.ones(n, dtype=bool)
        first[1:] = sorted_rows[1:] != sorted_rows[:-1]
        start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
        rank = np.empty(n, np.int32)
        rank[order] = np.arange(n) - start
        return rank, int(rank.max(initial=-1)) + 1

    def _digest_merge(self, st, rows, vals, wts, rank, unit,
                      with_stats) -> None:
        c = self.config
        self._ensure_fresh(st, "histo")
        b = _bucket_len(len(rows))
        vals_dev = self._dev(_pad_np(vals, b, 0.0))
        rank_dev = self._dev(_pad_np(rank, b, 0))
        slots = min(self._eff_histo_slots,
                    _bucket_len(int(rank.max(initial=-1)) + 1))
        uniq = np.unique(rows)
        mb = _bucket_len(len(uniq))
        sub = mb * 2 <= c.histo_rows
        if sub:
            local = np.searchsorted(uniq, rows).astype(np.int32)
            rows_dev = self._dev(_pad_np(local, b, mb))
            pre = (self._dev(_pad_np(uniq.astype(np.int32), mb,
                                     c.histo_rows)),)
        else:
            rows_dev = self._dev(_pad_np(rows, b, c.histo_rows))
            pre = ()
        kw = dict(slots=slots, compression=c.compression)
        wts_dev = () if unit else (self._dev(_pad_np(wts, b, 0.0)),)
        if with_stats:
            fn = {(True, True): tdigest.ingest_ranked_unit_rows,
                  (True, False): tdigest.ingest_ranked_unit,
                  (False, True): tdigest.ingest_ranked_rows,
                  (False, False): tdigest.ingest_ranked}[(unit, sub)]
            (st.histo_means, st.histo_weights, st.histo_stats) = fn(
                st.histo_means, st.histo_weights, st.histo_stats, *pre,
                rows_dev, rank_dev, vals_dev, *wts_dev, **kw)
        else:
            fn = {(True, True): tdigest.add_samples_ranked_unit_rows,
                  (True, False): tdigest.add_samples_ranked_unit,
                  (False, True): tdigest.add_samples_ranked_rows,
                  (False, False): tdigest.add_samples_ranked}[(unit, sub)]
            st.histo_means, st.histo_weights = fn(
                st.histo_means, st.histo_weights, *pre, rows_dev,
                rank_dev, vals_dev, *wts_dev, **kw)

    def _digest_merge_scan(self, st, rows, vals, wts, rank,
                           n_chunks: int) -> None:
        """Digest-only merge of a deep batch, one chunk width per merge.
        The chunk count is rounded up to a power of two (chunks past the
        real depth merge empty slices, as in the reference).  The batch
        ships host-densified when the plane is not much bigger than the
        flat triplets, else as flat triplets scattered per chunk."""
        c = self.config
        self._ensure_fresh(st, "histo")
        eff = self._eff_histo_slots
        nc = 1 << max(0, (n_chunks - 1).bit_length())
        uniq = np.unique(rows)
        mb = _bucket_len(len(uniq))
        sub = mb * 2 <= c.histo_rows
        n_plane_rows = mb if sub else c.histo_rows
        if sub:
            local = np.searchsorted(uniq, rows).astype(np.int32)
            pre = (self._dev(_pad_np(uniq.astype(np.int32), mb,
                                     c.histo_rows)),)
        else:
            local = np.ascontiguousarray(rows, np.int32)
            pre = ()
        width = nc * eff
        b = _bucket_len(len(rows))
        kw = dict(slots=eff, n_chunks=nc, compression=c.compression)
        if n_plane_rows * width * 8 <= 32 * b:
            plane_v = np.zeros((n_plane_rows, width), np.float32)
            plane_w = np.zeros((n_plane_rows, width), np.float32)
            plane_v[local, rank] = vals
            plane_w[local, rank] = wts
            fn = (tdigest.merge_dense_scan_rows if sub
                  else tdigest.merge_dense_scan)
            st.histo_means, st.histo_weights = fn(
                st.histo_means, st.histo_weights, *pre,
                self._dev(plane_v), self._dev(plane_w), **kw)
            return
        # padding rank nc*eff is past every chunk's live window
        vals_dev = self._dev(_pad_np(vals, b, 0.0))
        rank_dev = self._dev(_pad_np(rank, b, nc * eff))
        wts_dev = self._dev(_pad_np(wts, b, 0.0))
        if sub:
            rows_dev = self._dev(_pad_np(local, b, mb))
            fn = tdigest.add_samples_ranked_scan_rows
        else:
            rows_dev = self._dev(_pad_np(rows, b, c.histo_rows))
            fn = tdigest.add_samples_ranked_scan
        st.histo_means, st.histo_weights = fn(
            st.histo_means, st.histo_weights, *pre, rows_dev, rank_dev,
            vals_dev, wts_dev, **kw)

    # ------------------------------------------------------------------
    # flush boundary

    def swap(self) -> Snapshot:
        """End the interval: push remaining staging, hand the device
        planes to the caller, start fresh state, maybe compact."""
        return self.complete_swap(self.begin_swap())

    def begin_swap(self) -> _PendingSwap:
        """Swap half 1, under the caller's ingest lock: detach the
        final staging, capture the row metadata, install a fresh
        interval state, bump the generation, compact."""
        st = self._state
        work = self._detach_staged(final=True)
        pend = _PendingSwap()
        pend.work = work
        pend.state = st
        pend.counter_meta = list(self.counter_idx.meta)
        pend.counter_touched = self.counter_idx.touched.copy()
        pend.gauge_meta = list(self.gauge_idx.meta)
        pend.gauge_touched = self.gauge_idx.touched.copy()
        pend.histo_meta = list(self.histo_idx.meta)
        pend.histo_touched = self.histo_idx.touched.copy()
        pend.set_meta = list(self.set_idx.meta)
        pend.set_touched = self.set_idx.touched.copy()
        pend.overflow = {
            "counter": self.counter_idx.overflow,
            "gauge": self.gauge_idx.overflow,
            "histo": self.histo_idx.overflow,
            "set": self.set_idx.overflow,
        }
        pend.ingested = self._interval_ingested
        self._interval_ingested = 0
        # the new interval adopts the plane references with every kind
        # marked fresh: new planes are allocated on first touch
        ns = _IntervalState(self.gen + 1)
        ns.counters = st.counters
        ns.gauges = st.gauges
        ns.histo_stats = st.histo_stats
        ns.histo_import_stats = st.histo_import_stats
        ns.histo_means = st.histo_means
        ns.histo_weights = st.histo_weights
        ns.hll_regs = st.hll_regs
        ns.fresh = set(self._KINDS)
        self._state = ns
        self.gen += 1
        compacted = False
        for idx in (self.counter_idx, self.gauge_idx, self.histo_idx,
                    self.set_idx):
            idx.drops.take()
            occ = idx.occupancy()
            if occ > idx.capacity * self.config.compact_threshold:
                freed = occ - int(
                    (idx.last_gen[:occ] >= self.gen - 1).sum())
                if (freed >= max(1, idx.capacity // 8) or
                        (occ >= idx.capacity and freed > 0)):
                    idx.compact(keep_gen=self.gen - 1)
                    compacted = True
                else:
                    idx.reset_interval()
            else:
                idx.reset_interval()
        if compacted:
            # rows renumbered: rebuild the columnar key index from the
            # surviving metas
            self.key_index.clear()
            for idx in (self.counter_idx, self.gauge_idx,
                        self.histo_idx, self.set_idx):
                for row, m in enumerate(idx.meta):
                    if m.key_hash:
                        self.key_index.insert(m.key_hash, row)
        return pend

    def complete_swap(self, pend: _PendingSwap) -> Snapshot:
        """Swap half 2 (no ingest lock needed): apply the final staging
        to the outgoing state and assemble the snapshot."""
        if not pend.work.empty:
            with self._device_lock:
                self._apply_work(pend.work)
        st = pend.state
        return Snapshot(
            gen=st.gen,
            counters=st.counters,
            counter_meta=pend.counter_meta,
            counter_touched=pend.counter_touched,
            gauges=st.gauges,
            gauge_meta=pend.gauge_meta,
            gauge_touched=pend.gauge_touched,
            histo_stats=st.histo_stats,
            histo_import_stats=st.histo_import_stats,
            histo_means=st.histo_means,
            histo_weights=st.histo_weights,
            histo_meta=pend.histo_meta,
            histo_touched=pend.histo_touched,
            hll_regs=st.hll_regs,
            set_meta=pend.set_meta,
            set_touched=pend.set_touched,
            hll_host_plane=st.hll_host_plane,
            hll_device_touched=st.hll_device_touched,
            overflow=pend.overflow,
            ingested=pend.ingested,
        )

    def take_status(self):
        out = self.status
        self.status = {}
        return out
