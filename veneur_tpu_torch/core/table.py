"""Device-resident metric tables: every series of a class in one plane.

Port of ``veneur_tpu/core/table.py``.  Several reader threads can share
one table: each parses into a ``ReaderShard`` of its own without the
lock and merges under it.
All series of a metric class live in one fixed-capacity plane on the
device, addressed by a dense row id that the host allocates per key:

  class     state                                   update
  counter   f32[R]                                  dense add
  gauge     f32[R]                                  last-write select
  histo     f32[R,5] stats + f32[R,C] digest planes t-digest merge
  set       u8[R,16384] HLL registers               scatter-max

Ingest runs in the port's native library (``veneur_tpu_torch/native``):
``ingest_buffer`` parses raw DogStatsD text, probes the C++ key index
and combines into host staging in one pass (dense counter/gauge
accumulators, histo and set append columns); ``ingest_columns`` does
the same for an already-parsed batch.  Only never-seen series take a
per-line Python parse, once each.

A global node also takes forwarded state through the ``import_*``
entry points (``forward/http_import``): counters and gauges join the
dense accumulators, forwarded stat rows merge into their own plane
(``histo_import_stats``), register rows max into a host import plane,
and each wire's centroids stage as one part that the apply folds into
the digests through the cluster merge (``_wire_digest_step``; with
``tpu_collective_import`` the wire stack splits over the import mesh's
places and the partials union in one merge, ``parallel/sharded``).

``device_step`` ships the staging to the device, and ``swap()`` at the
interval boundary hands the planes to the flusher and starts fresh
ones.  Each apply cycle packs what it can into one superbatch buffer
(ops/superbatch): one host-to-device copy and one fused step.
Histogram batches dense enough for it take the host-densified plane
(``vtpu_dense_plane``: exact f64 per-row stats on the host, the value
plane shipped as f16 when its range allows, ``ingest_plane_pre*`` on
the device); rows past the plane width spill to the ranked merge.
Sparse batches whose rows carry more samples than one merge width
take the deep path (host stats fold + one merge per chunk).  Raw set
members fold into a host register plane with running estimate
statistics (or, past ``host_set_plane_max_bytes``, ride the
superbatch as a compact plane, a full plane or packed positions).

Adaptive sketch tiers (``core/tiers.py``): when the dense histogram and
set planes would pass ``VENEUR_TPU_TIER_AUTO_BYTES`` (256 MiB), or
``VENEUR_TPU_PLANE_TIERS`` forces it, the centroid planes and the set
register plane are pooled at an eighth of the rows, and per-row tier
bits route each series to a pool slot (WIDE) or to an exact host store
(COMPACT: raw samples, sparse registers).  A tiered table skips the
superbatch and applies class by class; series cross tiers mid-interval
(escalation, drained through the cluster merge) and at the interval
boundary (``_tier_boundary``).  The stat planes stay row-indexed in
both modes.
"""

from __future__ import annotations

import ctypes
import os
import threading
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from veneur_tpu_torch import native, observe, resolve_device
from veneur_tpu_torch.core import tiers as tiersmod
from veneur_tpu_torch.observe.ledger import ClassDropTally
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


def _ladder_floor(n: int) -> int:
    """Largest wide-ladder bucket <= n (inverse of _bucket_len): the
    per-wire spill threshold of the stacked merge is itself a ladder
    value, so bucketing the observed depth never rounds the stack width
    past it."""
    b = best = _MIN_BUCKET_WIDE
    while b <= n:
        best = b
        if b + b // 2 <= n:
            best = b + b // 2
        b *= 2
    return best


def _fused_import_mode() -> str:
    """VENEUR_TPU_FUSED_IMPORT, read as the reference reads it:
    unset/"auto" resolves per device at apply time (``stack`` on the
    card, where every wire's merge is one launch of the hand kernel;
    ``legacy`` on the CPU, as the reference resolves there); "1"/
    "stack" forces one stacked fold per cycle; "0"/"perwire" folds one
    wire per call (bit-identical to the stack); "legacy" interleaves
    every wire's centroids into one flat ranked merge."""
    raw = os.environ.get("VENEUR_TPU_FUSED_IMPORT", "auto").lower()
    if raw in ("0", "false", "off", "perwire", "per-wire"):
        return "perwire"
    if raw == "legacy":
        return "legacy"
    if raw in ("", "auto"):
        return "auto"
    return "stack"


def _collective_import_mode(cfg_default: str = "auto") -> str:
    """VENEUR_TPU_COLLECTIVE_IMPORT, the gate of the collective import
    fold (parallel.sharded.CollectiveWireFold), as the reference reads
    it.  Unset defers to TableConfig.collective_import.  "auto"
    resolves at the first apply to ON iff the import mesh has more
    than one place; "on"/"off" force.  The serial per-wire scan stays
    available under "off" as the bit-parity oracle."""
    raw = os.environ.get("VENEUR_TPU_COLLECTIVE_IMPORT", "").lower()
    if raw == "":
        raw = str(cfg_default).lower()
    if raw in ("0", "false", "off", "no"):
        return "off"
    if raw in ("1", "true", "on", "yes"):
        return "on"
    return "auto"


class _Late:
    """Resolves ``module.<name>`` at call time, not wrap time: the
    route tests replace module attributes to spy on which path fired,
    and a captured reference would go dark."""

    def __init__(self, module, name: str):
        self._module = module
        self._name = name

    def __call__(self, *args, **kwargs):
        return getattr(self._module, self._name)(*args, **kwargs)


# The device steps of the apply paths, registered with the device-cost
# registry under the reference's entry names: /debug/vars shows each
# step's calls, host dispatch time, CUDA-event device time and bytes,
# and veneur.device.dispatches_total their sum per interval.
_counter_dense_step = observe.instrument(
    "table.counter_dense", segment.counter_dense_update)
_gauge_dense_step = observe.instrument(
    "table.gauge_dense", segment.gauge_dense_update)
# global-tier merge steps (forwarded partial state)
_histo_stats_merge = observe.instrument(
    "table.histo_stats_merge", segment.merge_histo_stats)
_hll_merge_rows = observe.instrument("table.hll_merge_rows",
                                     hll.merge_rows)
# elementwise fold of host-computed per-row batch aggregates
_histo_stats_fold = observe.instrument(
    "table.histo_stats_fold", tdigest._combine_row_stats)
_superbatch_apply = observe.instrument(
    "table.superbatch_apply", _Late(superbatch, "step"))
# the digest merges (each launches the cluster merge kernel on a card)
_td_step = {
    name: observe.instrument("table.td_" + name, _Late(tdigest, name))
    for name in (
        "ingest_ranked", "ingest_ranked_unit",
        "ingest_ranked_rows", "ingest_ranked_unit_rows",
        "add_samples_ranked", "add_samples_ranked_unit",
        "add_samples_ranked_rows", "add_samples_ranked_unit_rows",
        "ingest_plane_pre", "ingest_plane_pre_unit",
        "add_samples_ranked_scan", "add_samples_ranked_scan_rows",
        "merge_dense_scan", "merge_dense_scan_rows",
        "merge_wire_stack_rows")}


# the collective import fold (its merges launch the cluster merge
# kernel on a card)
_collective_fold_step = observe.instrument(
    "table.collective_wire_fold",
    lambda fold, *args: fold(*args))


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
    # the collective import fold ("auto" = on iff the import mesh has
    # more than one place; VENEUR_TPU_COLLECTIVE_IMPORT overrides)
    collective_import: str = "auto"


@dataclass
class RowMeta:
    name: str
    tags: tuple[str, ...]
    scope: str
    type: str
    key_hash: int = 0


class _ClassIndex:
    """Host-side MetricKey -> row allocation for one metric class."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.rows: dict[tuple, int] = {}
        self.meta: list[RowMeta] = []
        self.touched = np.zeros(capacity, dtype=bool)
        self.last_gen = np.zeros(capacity, dtype=np.int64)
        self.drops = ClassDropTally()

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
        """Vectorized touch for batch imports."""
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
                 "hll_regs", "hll_host_plane", "hll_host_ez",
                 "hll_host_inv", "hll_device_touched", "pending",
                 "histo_compact", "set_sparse", "set_dense_overflow",
                 "tier_frozen")

    def __init__(self, gen: int):
        self.gen = gen
        self.fresh: set = set()
        # detached work (take_staged) not yet applied to this state
        self.pending = 0
        self.hll_host_plane: np.ndarray | None = None
        # per-row LogLog-Beta statistics kept by the native fold
        self.hll_host_ez: np.ndarray | None = None
        self.hll_host_inv: np.ndarray | None = None
        self.hll_device_touched = False
        # tiered tables: the compact-tier stores (exact host sketches of
        # below-threshold series), refused promotions' imported
        # registers, and the (tier, slot) maps frozen at begin_swap so
        # late pipelined applies route as this interval's earlier data
        # did (see tiers.TierSnapshot)
        self.histo_compact: Any = None
        self.set_sparse: Any = None
        self.set_dense_overflow: dict[int, np.ndarray] | None = None
        self.tier_frozen: dict | None = None


class _StagedWork:
    """Staging buffers detached for one apply."""

    __slots__ = ("state", "counter", "gauge", "histo", "digest",
                 "wire_parts", "set_parts", "stats_parts", "set_import",
                 "empty")


class _PendingSwap:
    """begin_swap's output: the final detached staging plus the row
    metadata captured at the interval boundary."""

    __slots__ = ("work", "state", "counter_meta", "counter_touched",
                 "gauge_meta", "gauge_touched", "histo_meta",
                 "histo_touched", "set_meta", "set_touched",
                 "overflow", "ingested", "row_maps")


_SCRATCH_COLS = (("hr", np.int32), ("hv", np.float32), ("hw", np.float32),
                 ("sr", np.int32), ("sp", np.int32), ("mk", np.uint64),
                 ("mt", np.uint8), ("mv", np.float64), ("mm", np.uint64),
                 ("mw", np.float32), ("mo", np.int64), ("ml", np.int32),
                 ("oo", np.int64), ("ol", np.int32), ("ok", np.uint8))


def _grow_scratch(sc: dict | None, n_lines: int) -> dict:
    """The fused pass's per-line scratch columns for ``n_lines``
    lines: histo/set appends, the compact miss columns, the other
    lines' spans.  Grow-only."""
    if sc is None or len(sc["hr"]) < n_lines:
        cap = max(n_lines, 4096)
        sc = {name: np.empty(cap, dt) for name, dt in _SCRATCH_COLS}
    return sc


def _others(sc: dict, meta: np.ndarray) -> list[tuple[int, int, int]]:
    """[(offset, length, type_code)] of a pass's event, service-check
    and malformed lines."""
    return [(int(sc["oo"][i]), int(sc["ol"][i]), int(sc["ok"][i]))
            for i in range(int(meta[11]))]


class _MissLines:
    """ParsedBatch-shaped view over the fused pass's compact miss
    columns: just the surface ``_resolve_misses`` reads (line bytes and
    type codes)."""

    def __init__(self, buf: np.ndarray, off: np.ndarray,
                 ln: np.ndarray, types: np.ndarray):
        self._buf = buf
        self._off = off
        self._len = ln
        self.type_code = types

    def line(self, i: int) -> bytes:
        o = int(self._off[i])
        return self._buf[o:o + int(self._len[i])].tobytes()


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
    # the native fold's per-row statistics for the host plane (None
    # for a plane from elsewhere, e.g. ``convert``)
    hll_host_ez: np.ndarray | None = None
    hll_host_inv: np.ndarray | None = None
    overflow: dict[str, int] = field(default_factory=dict)
    ingested: int = 0
    # set by swap(): hands the host set plane back to the table's reuse
    # pool (``release``)
    recycle: Any = None
    # tiered tables: the interval's tier view (tiers.TierSnapshot): the
    # frozen (tier, slot) assignments its data was routed under and the
    # compact-tier stores.  None for an untiered table.
    tiers: Any = None

    @property
    def host_only_sets(self) -> bool:
        """True when the interval's set state is all on the host.  A
        tiered interval always is (sparse store and slot-indexed host
        plane), but its plane is read through ``tiers``."""
        if self.tiers is not None:
            return True
        return (self.hll_host_plane is not None and
                not self.hll_device_touched)

    def host_set_estimates(self) -> np.ndarray:
        """Estimates for a host-only-sets interval, row-indexed in both
        modes: O(rows) from the fold's statistics when present, else a
        rescan of the plane; a tiered interval through its tier view."""
        if self.tiers is not None:
            return self.tiers.set_estimates(
                self, np.nonzero(self.set_touched)[0])
        if self.hll_host_ez is not None:
            return hll.estimate_from_stats(self.hll_host_ez,
                                           self.hll_host_inv)
        return hll.estimate_np(self.hll_host_plane)

    def release(self) -> None:
        """Return the host set plane to the owning table's pool once
        every read of it is done (a recycled plane is cleared instead
        of faulted in anew next interval).  The plane and its
        statistics are invalid afterwards."""
        if self.recycle is not None and self.hll_host_plane is not None:
            plane, self.hll_host_plane = self.hll_host_plane, None
            self.hll_host_ez = None
            self.hll_host_inv = None
            self.recycle(plane)

    def set_registers(self) -> np.ndarray:
        """The interval's effective HLL registers as a host array: the
        host-folded plane unioned with any device register state
        (imports), read back only when the device plane was touched.  A
        tiered interval materializes the row-space dense plane (a
        parity view, O(rows x 16 KiB): for tests and small tables)."""
        if self.tiers is not None:
            return self.tiers.materialize_registers(self)
        if self.host_only_sets:
            return self.hll_host_plane
        regs = self.hll_regs.cpu().numpy()
        if self.hll_host_plane is not None:
            regs = np.maximum(regs, self.hll_host_plane)
        return regs


class MetricTable:
    """The port's metric table.  ``device`` defaults to ``"cuda"``
    and raises without CUDA unless the caller passes ``"cpu"``.
    ``places`` are the collective import fold's places (default: the
    visible devices of ``device``'s type)."""

    _KINDS = ("counter", "gauge", "histo", "hll")

    def __init__(self, config: TableConfig | None = None,
                 device: "str | torch.device" = "cuda", places=None):
        self.device = resolve_device(device)
        self.config = config or TableConfig()
        c = self.config
        self.places = list(places) if places is not None else None
        self.collective_import_mode = _collective_import_mode(
            c.collective_import)
        # "unset" until the first stacked apply resolves the gate: None
        # (the serial scan) or the fold object
        self._collective_fold: object = "unset"
        self.gen = 0
        self.capacity = tdigest.capacity_for(c.compression)

        self.counter_idx = _ClassIndex(c.counter_rows)
        self.gauge_idx = _ClassIndex(c.gauge_rows)
        self.histo_idx = _ClassIndex(c.histo_rows)
        self.set_idx = _ClassIndex(c.set_rows)

        # adaptive sketch tiers: past the auto budget of dense sketch
        # planes (or when VENEUR_TPU_PLANE_TIERS forces it) the centroid
        # planes and set registers pool at a fraction of the rows; an
        # untiered table keeps self.tiers None and every tiered branch
        # below is dead code
        dense_bytes = (c.set_rows * hll.M +
                       c.histo_rows * 2 * self.capacity * 4)
        self.tiers = (tiersmod.TierDirectory(c.histo_rows, c.set_rows)
                      if tiersmod.tiers_enabled(dense_bytes) else None)
        if self.tiers is not None:
            self._histo_pool_rows = self.tiers.histo.wide_slots
            self._set_pool_rows = self.tiers.set.wide_slots
        else:
            self._histo_pool_rows = c.histo_rows
            self._set_pool_rows = c.set_rows

        # counters and gauges stage as DENSE per-row host buffers (f64
        # counter accumulator: one f32 round-off at ship time)
        # released snapshots' host set planes, cleared for reuse
        self._plane_pool: list[np.ndarray] = []
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
        # the native library (raises if it cannot be built) and its
        # identity index: key hash -> row, probed inside the C++ pass
        self._lib = native.load()
        self.key_index = intern.NativeHashIndex(self._lib)
        # fused parse+ingest scratch (see ingest_buffer), grow-only
        self._fused_scratch: dict | None = None
        self.status: dict[tuple, tuple[float, str, tuple[str, ...]]] = {}

        # merge chunk width, capped so state + chunk stays inside the
        # cluster merge kernel's width bound
        self._eff_histo_slots = c.histo_slots
        mb = cluster_merge.max_batch_slots(self.capacity)
        if mb >= _MIN_BUCKET:
            self._eff_histo_slots = min(c.histo_slots, mb)
        self._staged_n = 0
        self._interval_ingested = 0
        # samples that left host staging mid-interval (threshold device
        # steps): a checkpoint cannot see them, so its header names the
        # count (checkpoint_capture)
        self._interval_device_staged = 0
        # overload pressure: set_pressure_level walks the histogram
        # merge width down the ladder; the base restores it on release
        self._eff_histo_slots_base = self._eff_histo_slots
        self._pressure_level = 0

        # global-tier import staging: forwarded digests merged item by
        # item (digest-only samples), forwarded stat rows, register rows
        # folded into a host import plane, and one centroid part per
        # decoded wire, stacked at apply time (_wire_digest_step)
        self._digest_stage = _Staging()
        self._stats_import_parts: list[tuple[np.ndarray, np.ndarray]] = []
        self._set_import_plane: np.ndarray | None = None
        self._set_import_touched: np.ndarray | None = None
        self._wire_digest_parts: list[tuple] = []
        self._wire_digest_n = 0
        self.fused_import_mode = _fused_import_mode()
        # widest ladder bucket the stacked merge may use per wire; rows
        # deeper than this in one wire spill to the ranked path
        self._wire_stack_kmax = _ladder_floor(self._eff_histo_slots)
        # reference-schema /import row plans (forward/http_import),
        # stamped with the epoch a compaction bumps
        self._http_plan_cache: dict = {}
        self._reindex_epoch = 0
        # gRPC import (forward/grpc_forward): native import-identity
        # hash -> (name length << 32) | row, or -1 (overflow) / -2
        # (malformed); cleared on compaction and at its size bound
        self.import_row_cache: dict[int, int] = {}
        self.import_row_cache_limit = 4 * (
            c.counter_rows + c.gauge_rows + c.histo_rows +
            c.set_rows) + 1024
        # a whole MetricList's hash vector (bytes) -> (epoch, rows,
        # per-class overflow counts), and how often it served a wire
        self._wire_plan_cache: dict[bytes, tuple] = {}
        self.wire_plan_hits = 0
        self.wire_plan_misses = 0

        self._sb_bufs = superbatch.DoubleBuffer(
            pin=self.device.type == "cuda")
        self._sb_plane_factor = superbatch.plane_scatter_factor(
            self.device.type)
        # fused superbatch applies (one host-to-device copy each)
        self.superbatch_applies = 0
        # batches by the route they took: histograms (superbatch,
        # plane_f16, plane_f32, spill, ranked, deep_scan, precluster),
        # wire folds (wire_stack, wire_collective, wire_perwire,
        # wire_flat), sets
        # (set_plane, set_plane_full, set_pos, set_host_fold,
        # set_import); and bytes handed to the device (a copy on the
        # card)
        self.routes: dict[str, int] = {}
        self.h2d_bytes = 0
        self._device_lock = threading.Lock()
        # guards every state's pending count (take_staged bumps it under
        # the ingest lock, apply_staged drops it, complete_swap waits)
        self._pending_cv = threading.Condition()
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
            # stat planes stay row-indexed in both modes; the centroid
            # planes pool down to wide slots under tiering
            st.histo_means, st.histo_weights = tdigest.empty_state(
                self._histo_pool_rows, self.capacity, dev)
        elif kind == "hll":
            st.hll_regs = hll.empty_state(self._set_pool_rows, dev)

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

    def _touch_ptrs(self) -> dict:
        """Staging pointers the native combine writes through: the
        dense counter/gauge accumulators and each class's touched mask
        (bool arrays viewed as u8 in place)."""
        u8 = ctypes.c_uint8
        return dict(
            counter_dense=native.ptr(self._counter_dense, ctypes.c_double),
            counter_touch=native.ptr(
                self.counter_idx.touched.view(np.uint8), u8),
            gauge_dense=native.ptr(self._gauge_dense, ctypes.c_float),
            gauge_mask=native.ptr(self._gauge_mask, u8),
            gauge_touch=native.ptr(self.gauge_idx.touched.view(np.uint8),
                                   u8),
            histo_touch=native.ptr(self.histo_idx.touched.view(np.uint8),
                                   u8),
            set_touch=native.ptr(self.set_idx.touched.view(np.uint8), u8))

    def _ingest_pass(self, t: dict, keys, types, vals, members, wts,
                     n: int, miss: np.ndarray, subset_n: int, hr, hv, hw,
                     sr, sp, meta: np.ndarray) -> None:
        """One vtpu_ingest pass: probe each metric line's key and
        combine it into staging; misses are recorded in ``miss``."""
        i64 = ctypes.c_int64
        self._lib.vtpu_ingest(
            self.key_index.handle,
            native.ptr(keys, ctypes.c_uint64),
            native.ptr(types, ctypes.c_uint8),
            native.ptr(vals, ctypes.c_double),
            native.ptr(members, ctypes.c_uint64),
            native.ptr(wts, ctypes.c_float), n,
            native.ptr(miss, i64), subset_n, hashing.HLL_P,
            t["counter_dense"], t["counter_touch"], t["gauge_dense"],
            t["gauge_mask"], t["gauge_touch"],
            native.ptr(hr, ctypes.c_int32), native.ptr(hv, ctypes.c_float),
            native.ptr(hw, ctypes.c_float), t["histo_touch"],
            native.ptr(sr, ctypes.c_int32), native.ptr(sp, ctypes.c_int32),
            t["set_touch"], native.ptr(miss, i64), native.ptr(meta, i64))

    def _commit_pass(self, meta: np.ndarray, hr, hv, hw, sr, sp
                     ) -> tuple[int, int]:
        """Book one native pass: drops per class, dirty flags, and the
        histo/set append columns into staging.  Returns (processed,
        dropped)."""
        processed = int(meta[3])
        dropped = int(meta[6:11].sum())
        if dropped:
            self.counter_idx.drops.add(int(meta[6]))
            self.gauge_idx.drops.add(int(meta[7]))
            self.histo_idx.drops.add(int(meta[8] + meta[9]))
            self.set_idx.drops.add(int(meta[10]))
        if meta[4]:
            self._counter_dirty = True
        if meta[5]:
            self._gauge_dirty = True
        # copies: the scratch is per-line sized and reused by the next
        # call, while staging holds its parts until the swap
        hn = int(meta[0])
        if hn:
            self._histo_stage.append(hr[:hn].copy(), hv[:hn].copy(),
                                     hw[:hn].copy())
        sn = int(meta[1])
        if sn:
            self._set_pos_rows.append(sr[:sn].copy())
            self._set_pos.append(sp[:sn].copy())
        self._note_staged(processed - dropped)
        return processed, dropped

    def ingest_columns(self, pb: columnar.ParsedBatch
                       ) -> tuple[int, int]:
        """Ingest a parsed buffer's metric lines (type codes 0-4; the
        others are the caller's per-line business) in one native pass
        (vtpu_ingest): probe + combine.  Never-seen keys are resolved
        in Python, then a second pass runs over just those lines.
        Returns (processed, dropped)."""
        n = pb.n
        if n == 0:
            return 0, 0
        hr = np.empty(n, np.int32)
        hv = np.empty(n, np.float32)
        hw = np.empty(n, np.float32)
        sr = np.empty(n, np.int32)
        sp = np.empty(n, np.int32)
        miss = np.empty(n, np.int64)
        meta = np.zeros(11, np.int64)
        t = self._touch_ptrs()
        cols = (np.ascontiguousarray(pb.key_hash[:n], np.uint64),
                np.ascontiguousarray(pb.type_code[:n], np.uint8),
                np.ascontiguousarray(pb.value[:n], np.float64),
                np.ascontiguousarray(pb.member_hash[:n], np.uint64),
                np.ascontiguousarray(pb.weight[:n], np.float32))
        self._ingest_pass(t, *cols, n, miss, -1, hr, hv, hw, sr, sp, meta)
        n_miss = int(meta[2])
        if n_miss:
            miss_lines = miss[:n_miss].copy()
            self._resolve_misses(pb, miss_lines, cols[0][miss_lines])
            # resolved keys now hit; unparseable ones are DROPPED
            self._ingest_pass(t, *cols, n, miss, n_miss, hr, hv, hw, sr,
                              sp, meta)
        return self._commit_pass(meta, hr, hv, hw, sr, sp)

    def _parse_ingest(self, buf_np: np.ndarray, t: dict, sc: dict,
                      meta: np.ndarray) -> None:
        """One vtpu_parse_ingest pass over ``buf_np``: combine into the
        staging ``t`` points at (the table's, or a reader shard's
        private copy), per-line appends into the scratch columns
        ``sc``."""
        def p(name, ctype):
            return native.ptr(sc[name], ctype)

        i32, i64, u8 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint8
        f32, f64, u64 = ctypes.c_float, ctypes.c_double, ctypes.c_uint64
        self._lib.vtpu_parse_ingest(
            native.ptr(buf_np, u8), len(buf_np), self.key_index.handle,
            hashing.HLL_P,
            t["counter_dense"], t["counter_touch"], t["gauge_dense"],
            t["gauge_mask"], t["gauge_touch"],
            p("hr", i32), p("hv", f32), p("hw", f32), t["histo_touch"],
            p("sr", i32), p("sp", i32), t["set_touch"],
            p("mk", u64), p("mt", u8), p("mv", f64), p("mm", u64),
            p("mw", f32), p("mo", i64), p("ml", i32),
            p("oo", i64), p("ol", i32), p("ok", u8),
            native.ptr(meta, i64))

    def _replay_misses(self, buf_np: np.ndarray, t: dict, sc: dict,
                       meta: np.ndarray) -> None:
        """Resolve a fused pass's misses (rows for never-seen series),
        then replay the compact miss columns through vtpu_ingest into
        the same staging and scratch (appends continue at ``meta``'s
        cursors).  Caller holds the ingest lock."""
        n_miss = int(meta[2])
        if not n_miss:
            return
        shim = _MissLines(buf_np, sc["mo"], sc["ml"], sc["mt"])
        self._resolve_misses(shim, np.arange(n_miss), sc["mk"][:n_miss])
        miss2 = np.empty(n_miss, np.int64)
        self._ingest_pass(t, sc["mk"], sc["mt"], sc["mv"], sc["mm"],
                          sc["mw"], n_miss, miss2, -1, sc["hr"], sc["hv"],
                          sc["hw"], sc["sr"], sc["sp"], meta)

    def ingest_buffer(self, buf
                      ) -> tuple[int, int, list[tuple[int, int, int]]]:
        """Fused parse + probe + combine over a raw newline-separated
        buffer (vtpu_parse_ingest): no columns between the grammar and
        the table.  Misses resolve in Python and replay through
        vtpu_ingest into the same staging.

        Returns (processed, dropped, others): others is
        [(offset, length, type_code)] for event, service-check and
        malformed lines, the caller's per-line business."""
        buf_b = buf if isinstance(buf, bytes) else bytes(buf)
        buf_np = np.frombuffer(buf_b, np.uint8)
        sc = self._fused_scratch = _grow_scratch(
            self._fused_scratch, buf_b.count(b"\n") + 1)
        meta = np.zeros(12, np.int64)
        t = self._touch_ptrs()
        self._parse_ingest(buf_np, t, sc, meta)
        self._replay_misses(buf_np, t, sc, meta)
        processed, dropped = self._commit_pass(
            meta, sc["hr"], sc["hv"], sc["hw"], sc["sr"], sc["sp"])
        return processed, dropped, _others(sc, meta)

    def staged(self) -> int:
        return self._staged_n

    def overflow_total(self) -> int:
        """Interval overflow drops summed over the classes."""
        return (self.counter_idx.overflow + self.gauge_idx.overflow +
                self.histo_idx.overflow + self.set_idx.overflow)

    def set_pressure_level(self, level: int) -> None:
        """Overload pressure hook (core/overload.py): level > 0 steps the
        effective histogram merge width down the ladder, one halving a
        level floored at the ladder minimum, so deep batches collapse
        earlier (less sketch resolution, no dropped samples); level 0
        restores the configured width.  It takes effect at the next
        merge; the stacked wire fold's width (``_wire_stack_kmax``)
        stays as the table was built.  On a tiered table, levels >= 2
        also freeze boundary promotions."""
        level = max(0, int(level))
        if level == self._pressure_level:
            return
        self._pressure_level = level
        base = self._eff_histo_slots_base
        if level == 0:
            self._eff_histo_slots = base
        else:
            self._eff_histo_slots = _ladder_floor(max(base >> level, 1))
        if self.tiers is not None:
            with self.tiers.lock:
                self.tiers.promote_frozen = level >= 2

    def checkpoint_capture(self) -> dict | None:
        """Copy the open interval's host staging for a crash checkpoint
        (``ops/checkpoint.py``).  Runs under the caller's ingest lock,
        detaches nothing and touches no device tensor: every buffer it
        reads is host numpy, so it never waits on the card.  Dense
        counter and gauge accumulators are copied; the staging lists are
        shallow-copied (their ndarray chunks are never mutated after
        they are appended); each class's meta list is captured as
        (reference, length) since it is append-only and compaction
        replaces the list at a swap.  ``device_staged`` counts what
        mid-interval device steps already moved out of reach.  Returns
        None when nothing is staged."""
        cap: dict = {"gen": self.gen,
                     "ingested": self._interval_ingested,
                     "device_staged": self._interval_device_staged}
        data = False
        if self._counter_dirty:
            cap["counter"] = self._counter_dense.copy()
            data = True
        if self._gauge_dirty:
            cap["gauge"] = (self._gauge_dense.copy(),
                            self._gauge_mask.copy())
            data = True
        for key, stage in (("histo", self._histo_stage),
                           ("digest", self._digest_stage)):
            if stage.rows:
                cap[key] = (list(stage.rows), list(stage.values),
                            list(stage.weights))
                data = True
        if self._wire_digest_parts:
            cap["wire_parts"] = list(self._wire_digest_parts)
            data = True
        if self._stats_import_parts:
            cap["stats_parts"] = list(self._stats_import_parts)
            data = True
        if self._set_rows:
            cap["set_members"] = (list(self._set_rows),
                                  list(self._set_members))
            data = True
        if self._set_pos_rows:
            cap["set_pos"] = (list(self._set_pos_rows),
                              list(self._set_pos))
            data = True
        if (self._set_import_touched is not None and
                self._set_import_touched.any()):
            rows = np.flatnonzero(self._set_import_touched)
            cap["set_import"] = (rows.astype(np.int32),
                                 self._set_import_plane[rows].copy())
            data = True
        if not data:
            return None
        for key, idx in (("counter_meta", self.counter_idx),
                         ("gauge_meta", self.gauge_idx),
                         ("histo_meta", self.histo_idx),
                         ("set_meta", self.set_idx)):
            cap[key] = (idx.meta, len(idx.meta))
        return cap

    def _note_staged(self, n: int) -> None:
        self._staged_n += n
        self._interval_ingested += n

    # ------------------------------------------------------------------
    # global-tier import (merge of forwarded mergeable state).  Imported
    # counters and gauges are forced to global scope (the reference's
    # worker.go:445-447); histograms and sets keep the wire's scope.

    def import_counter_row(self, name: str,
                           tags: tuple[str, ...]) -> int | None:
        key = (name, dsd.COUNTER, tags, dsd.SCOPE_GLOBAL)
        return self.counter_idx.lookup(key, name, tags, dsd.SCOPE_GLOBAL,
                                       dsd.COUNTER, self.gen)

    def import_gauge_row(self, name: str,
                         tags: tuple[str, ...]) -> int | None:
        key = (name, dsd.GAUGE, tags, dsd.SCOPE_GLOBAL)
        return self.gauge_idx.lookup(key, name, tags, dsd.SCOPE_GLOBAL,
                                     dsd.GAUGE, self.gen)

    def import_set_row(self, name: str, tags: tuple[str, ...],
                       scope: str = dsd.SCOPE_DEFAULT) -> int | None:
        key = (name, dsd.SET, tags, scope)
        return self.set_idx.lookup(key, name, tags, scope, dsd.SET,
                                   self.gen)

    def import_histo_row(self, name: str, mtype: str,
                         tags: tuple[str, ...],
                         scope: str = dsd.SCOPE_DEFAULT) -> int | None:
        key = (name, mtype, tags, scope)
        return self.histo_idx.lookup(key, name, tags, scope, mtype,
                                     self.gen)

    def import_counter_batch(self, rows: np.ndarray,
                             values: np.ndarray) -> None:
        """Vectorized import_counter over resolved rows (+=; duplicate
        rows accumulate)."""
        rows = np.ascontiguousarray(rows, np.int64)
        np.add.at(self._counter_dense, rows,
                  np.asarray(values, np.float64))
        self.counter_idx.touch_rows(rows, self.gen)
        self._counter_dirty = True
        self._note_staged(len(rows))

    def import_gauge_batch(self, rows: np.ndarray,
                           values: np.ndarray) -> None:
        """Vectorized import_gauge: last write wins in wire order (the
        last occurrence of a duplicate row, chosen explicitly)."""
        rows = np.ascontiguousarray(rows, np.int64)
        values = np.asarray(values, np.float64)
        rev_u, rev_first = np.unique(rows[::-1], return_index=True)
        last = len(rows) - 1 - rev_first
        self._gauge_dense[rev_u] = values[last]
        self._gauge_mask[rev_u] = 1
        self.gauge_idx.touch_rows(rows, self.gen)
        self._gauge_dirty = True
        self._note_staged(len(rows))

    def _import_plane(self) -> np.ndarray:
        if self._set_import_plane is None:
            c = self.config
            self._set_import_plane = np.zeros((c.set_rows, hll.M),
                                              np.uint8)
            self._set_import_touched = np.zeros(c.set_rows, bool)
        return self._set_import_plane

    def import_set_at(self, row: int, regs: np.ndarray) -> None:
        """Max one register row into the host import plane (Set.Merge,
        samplers/samplers.go:423) for a resolved row."""
        regs = np.asarray(regs, np.uint8)
        if regs.shape != (hll.M,):
            raise ValueError(f"bad register plane shape {regs.shape}")
        prow = self._import_plane()[row]
        np.maximum(prow, regs, out=prow)
        self._set_import_touched[row] = True
        self.set_idx.touched[row] = True
        self.set_idx.last_gen[row] = self.gen
        self._note_staged(1)

    def import_set_sketches(self, buf: np.ndarray, sk, items: np.ndarray,
                            rows: np.ndarray) -> int:
        """``import_set_at`` for a wire's classified sketches at once:
        one native byte-max pass of ``items`` (``native.Sketches`` of
        the wire bytes ``buf``, each dense or sparse) into resolved
        ``rows``, then the bookkeeping per wire.  Returns the sketches
        folded."""
        n = native.hll_fold(buf, sk, items, rows, self._import_plane())
        self._set_import_touched[rows] = True
        self.set_idx.touched[rows] = True
        self.set_idx.last_gen[rows] = self.gen
        self._note_staged(n)
        return n

    def import_counter(self, name: str, tags: tuple[str, ...],
                       value: float) -> bool:
        """Merge a forwarded counter total (+=, samplers.go:208)."""
        row = self.import_counter_row(name, tags)
        if row is None:
            return False
        self._counter_dense[row] += value
        self._counter_dirty = True
        self._note_staged(1)
        return True

    def import_gauge(self, name: str, tags: tuple[str, ...],
                     value: float) -> bool:
        row = self.import_gauge_row(name, tags)
        if row is None:
            return False
        self._gauge_dense[row] = value
        self._gauge_mask[row] = 1
        self._gauge_dirty = True
        self._note_staged(1)
        return True

    def import_histo(self, name: str, mtype: str, tags: tuple[str, ...],
                     stats: np.ndarray, means: np.ndarray,
                     weights: np.ndarray,
                     scope: str = dsd.SCOPE_DEFAULT) -> bool:
        """Merge one forwarded digest: its live centroids re-enter as
        weighted samples through the digest-only merge, its stat row
        merges into the import stat plane.  Shapes are checked before
        anything stages (a bad entry staged would fail every later
        device step)."""
        stats = np.asarray(stats, np.float32)
        means = np.asarray(means, np.float32)
        weights = np.asarray(weights, np.float32)
        if stats.shape != (segment.HISTO_STAT_COLS,):
            raise ValueError(f"bad stats shape {stats.shape}")
        if means.shape != weights.shape or means.ndim != 1:
            raise ValueError(
                f"centroid shape mismatch {means.shape}/{weights.shape}")
        row = self.import_histo_row(name, mtype, tags, scope)
        if row is None:
            return False
        self._stats_import_parts.append(
            (np.asarray([row], np.int32), stats[None, :]))
        self._note_staged(1)
        live = weights > 0
        if live.any():
            n_live = int(live.sum())
            self._digest_stage.append(np.full(n_live, row, np.int32),
                                      means[live], weights[live])
            # every staged centroid counts toward the staging bound
            self._staged_n += n_live
        return True

    def import_histo_batch(self, rows: np.ndarray, stats: np.ndarray,
                           cent_rows: np.ndarray, cent_means: np.ndarray,
                           cent_weights: np.ndarray) -> None:
        """A whole wire's digests in one staging append: row-aligned
        ``rows``/``stats`` (N,)/(N, 5) and its live centroids with
        their target rows.  The caller has dropped malformed items."""
        if len(rows):
            self._stats_import_parts.append(
                (np.ascontiguousarray(rows, np.int32),
                 np.ascontiguousarray(stats, np.float32)))
            self.histo_idx.touch_rows(np.asarray(rows, np.int64),
                                      self.gen)
            self._note_staged(len(rows))
        if len(cent_rows):
            part = (np.ascontiguousarray(cent_rows, np.int32),
                    np.ascontiguousarray(cent_means, np.float32),
                    np.ascontiguousarray(cent_weights, np.float32))
            if self.fused_import_mode == "legacy":
                self._digest_stage.append(*part)
            else:
                self._wire_digest_parts.append(part)
                self._wire_digest_n += len(cent_rows)
            self._staged_n += len(cent_rows)

    def import_set(self, name: str, tags: tuple[str, ...],
                   regs: np.ndarray,
                   scope: str = dsd.SCOPE_DEFAULT) -> bool:
        """Merge a forwarded HLL register row (union by max)."""
        regs = np.asarray(regs, np.uint8)
        if regs.shape != (hll.M,):
            raise ValueError(f"bad register plane shape {regs.shape}")
        row = self.import_set_row(name, tags, scope)
        if row is None:
            return False
        self.import_set_at(row, regs)
        return True

    # ------------------------------------------------------------------
    # device step

    def device_step(self, final: bool = False) -> None:
        """Push staged samples to the device (the serial form: detach
        and apply back to back; the pipelined form is ``take_staged`` /
        ``apply_staged``).  Counters and gauges ship only at the swap
        (they are dense interval accumulators); histo and set staging
        ship at the swap or past ``histo_merge_samples``."""
        w = self._detach_staged(final)
        if w.empty:
            return
        with self._device_lock:
            self._apply_work(w)

    def take_staged(self, final: bool = False) -> _StagedWork | None:
        """Pipelined half 1: detach the staging buffers and pin the
        current interval state.  Must run under the lock that serializes
        ingest and ``begin_swap``: the pending count it bumps is what
        ``complete_swap`` waits out, so the bump is atomic with the
        detach (a swap between them could snapshot before this work
        lands).  Returns None when nothing was detached."""
        w = self._detach_staged(final)
        if w.empty:
            return None
        with self._pending_cv:
            w.state.pending += 1
        return w

    def apply_staged(self, w: _StagedWork) -> None:
        """Pipelined half 2: apply detached work outside the ingest
        lock.  Any thread may call it; applies serialize on the device
        lock.  Two mid-interval applies commute (counter add, set max,
        digest merges that only move centroid placement; gauges ship
        only in the final work), and the pinned state keeps the work in
        its interval."""
        try:
            with self._device_lock:
                self._apply_work(w)
        finally:
            with self._pending_cv:
                w.state.pending -= 1
                self._pending_cv.notify_all()

    def _detach_staged(self, final: bool) -> _StagedWork:
        c = self.config
        w = _StagedWork()
        w.state = self._state
        w.counter = w.gauge = w.histo = w.digest = None
        w.wire_parts = w.set_parts = w.stats_parts = w.set_import = None
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
        if self._digest_stage.rows and (
                final or
                len(self._digest_stage) >= c.histo_merge_samples):
            w.digest = self._digest_stage
            self._digest_stage = _Staging()
        if self._wire_digest_parts and (
                final or self._wire_digest_n >= c.histo_merge_samples):
            w.wire_parts = self._wire_digest_parts
            self._wire_digest_parts = []
            self._wire_digest_n = 0
        staged_sets = (len(self._set_rows) +
                       sum(len(r) for r in self._set_pos_rows))
        if (staged_sets and
                (final or staged_sets >= c.histo_merge_samples)):
            w.set_parts = (self._set_rows, self._set_members,
                           self._set_pos_rows, self._set_pos)
            self._set_rows, self._set_members = [], []
            self._set_pos_rows, self._set_pos = [], []
        # import stat rows and register rows ship at the swap (a global
        # taking K wires a cycle would otherwise pay K small applies;
        # register rows of one series from K wires dedupe on the host),
        # stat rows also past a size bound
        if self._stats_import_parts and (
                final or
                sum(len(p[0]) for p in self._stats_import_parts)
                >= (1 << 16)):
            w.stats_parts = self._stats_import_parts
            self._stats_import_parts = []
        if (final and self._set_import_touched is not None and
                self._set_import_touched.any()):
            w.set_import = (self._set_import_plane,
                            self._set_import_touched)
            self._set_import_plane = None
            self._set_import_touched = None
        w.empty = (w.counter is None and w.gauge is None and
                   w.histo is None and w.digest is None and
                   w.wire_parts is None and w.set_parts is None and
                   w.stats_parts is None and w.set_import is None)
        if not final and not w.empty:
            # mid-interval detach: out of any later checkpoint's view
            n = 0
            for stage in (w.histo, w.digest):
                if stage is not None:
                    n += sum(len(r) for r in stage.rows)
            if w.wire_parts is not None:
                n += sum(len(p[0]) for p in w.wire_parts)
            if w.set_parts is not None:
                sr, _sm, spr, _sp = w.set_parts
                n += len(sr) + sum(len(r) for r in spr)
            if w.stats_parts is not None:
                n += sum(len(p[0]) for p in w.stats_parts)
            self._interval_device_staged += n
        return w

    def _apply_work(self, w: _StagedWork) -> None:
        """Apply detached staging to its interval state: the superbatch
        takes every family its schema carries; deep histo batches and
        the host set fold run on their own.  A tiered table skips the
        superbatch and applies class by class: counters and gauges as
        dense updates, histograms and sets through the tier routing.
        Caller holds _device_lock."""
        st = w.state
        c = self.config
        tiered = self.tiers is not None
        if not tiered:
            self._superbatch_apply(w)
        else:
            self._tiered_scalar_histo_apply(w)
        if w.digest is not None:
            batch = w.digest.take()
            if batch is not None:
                if tiered:
                    self._tiered_histo_step(st, *batch, with_stats=False)
                else:
                    self._histo_device_step(st, *batch, with_stats=False)
        if w.wire_parts:
            if tiered:
                self._tiered_wire_digest_step(st, w.wire_parts)
            else:
                self._wire_digest_step(st, w.wire_parts)
        if w.set_parts is not None:
            # the superbatch left the sets: the plane fits the host
            # bound (or the table is tiered), so they fold on the host
            parts_rows, parts_pos = self._set_parts(w.set_parts)
            if parts_rows:
                srows = np.concatenate(parts_rows)
                spos = np.concatenate(parts_pos)
                if tiered:
                    self._tiered_set_step(st, srows, spos)
                else:
                    self._route("set_host_fold")
                    self._hll_host_fold(st, srows, spos)
        if w.stats_parts is not None:
            rows = np.concatenate([p[0] for p in w.stats_parts])
            vals = np.concatenate([p[1] for p in w.stats_parts])
            # pad rows (== histo_rows) are masked out by the merge
            b = _bucket_len(len(rows), wide=True)
            padded = np.zeros((b, vals.shape[1]), np.float32)
            padded[:len(vals)] = vals
            self._ensure_fresh(st, "histo")
            st.histo_import_stats = _histo_stats_merge(
                st.histo_import_stats,
                self._dev(_pad_np(rows, b, c.histo_rows)),
                self._dev(padded))
        if w.set_import is not None:
            plane, touched = w.set_import
            # imports folded into the host plane at receive time: the
            # swap ships each touched series once, however many wires
            # carried it
            rows = np.nonzero(touched)[0].astype(np.int32)
            if tiered:
                self._route("set_import")
                self._tiered_set_import(st, rows, plane[rows])
                return
            b = _bucket_len(len(rows), wide=True)
            padded = np.zeros((b, hll.M), np.uint8)
            padded[:len(rows)] = plane[rows]
            self._route("set_import")
            self._ensure_fresh(st, "hll")
            st.hll_device_touched = True
            st.hll_regs = _hll_merge_rows(
                st.hll_regs, self._dev(_pad_np(rows, b, c.set_rows)),
                self._dev(padded))

    @staticmethod
    def _set_parts(set_parts) -> tuple[list, list]:
        """Staged set members as lists of (rows, packed positions)
        parts: slow-path members hashed here, native-ingest positions
        as staged."""
        set_rows, set_members, pos_rows, pos = set_parts
        parts_rows, parts_pos = [], []
        if set_rows:
            idx, rank = hashing.hash_members(set_members)
            parts_rows.append(np.asarray(set_rows, np.int32))
            parts_pos.append(hll.pack_positions(idx, rank))
        parts_rows.extend(np.ascontiguousarray(p, np.int32)
                          for p in pos_rows)
        parts_pos.extend(np.ascontiguousarray(p, np.int32) for p in pos)
        return parts_rows, parts_pos

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
            sets = self._sb_set_pack(w.set_parts)
            w.set_parts = None
            if sets is not None:
                self._route("set_" + sets[0])
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
            kw.update(sets[1])
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
            self._sb_fill_set(buf, off, spec, sets)
        if spec.counter_rows:
            self._ensure_fresh(st, "counter")
        if spec.gauge_rows:
            self._ensure_fresh(st, "gauge")
        if spec.histo_n:
            self._ensure_fresh(st, "histo")
        if spec.pos_n or spec.plane_rows:
            self._ensure_fresh(st, "hll")
            st.hll_device_touched = True
        self.h2d_bytes += tbuf.numel() * 4
        observe.REGISTRY.note_h2d(tbuf.numel() * 4)
        dbuf = superbatch.to_device(tbuf, self.device, self._sb_bufs)
        out = _superbatch_apply(spec, st.counters, st.gauges,
                              st.histo_means, st.histo_weights,
                              st.histo_stats, st.hll_regs, dbuf)
        self.superbatch_applies += 1
        if spec.counter_rows:
            st.counters = out[0]
        if spec.gauge_rows:
            st.gauges = out[1]
        if spec.histo_n:
            st.histo_means, st.histo_weights, st.histo_stats = out[2:5]
        if spec.pos_n or spec.plane_rows:
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
        # batches the host-densified plane takes leave the superbatch
        # (the plane and the deep scan ship fewer bytes in their own
        # shapes); the thresholds are _histo_device_step's own
        if self._plane_choice(rows, vals, unit, n)[2]:
            self._histo_device_step(st, rows, vals, wts, with_stats=True)
            return None
        rank, max_count = self._rank(rows)
        if max_count > self._eff_histo_slots:
            self._histo_device_step(st, rows, vals, wts, with_stats=True)
            return None
        self._route("superbatch")
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

    def _sb_set_pack(self, set_parts):
        """Choose the superbatch's set arm for the cycle's staged
        members, cheapest device operation first: a compact PLANE
        (touched rows folded on the host into a T-row register plane;
        the device takes a row max) when it is the smaller transfer; a
        full PLANE (one elementwise max) where a scattered member costs
        more than ``plane_scatter_factor`` plane bytes and the plane
        fits that budget; else packed POSITIONS (a scatter-max).  All
        arms give the same registers (byte max is order-free).
        Returns (arm, spec_kw, parts_rows, parts_pos, touched) or None
        when nothing is staged."""
        parts_rows, parts_pos = self._set_parts(set_parts)
        n = sum(len(p) for p in parts_rows)
        if not n:
            return None
        pool = self.config.set_rows
        nb = _bucket_len(n)
        counts = np.zeros(pool, np.int64)
        for pr in parts_rows:
            counts += np.bincount(pr, minlength=pool)[:pool]
        touched = np.nonzero(counts)[0].astype(np.int32)
        tb = _bucket_len(len(touched), wide=True)
        if tb * hll.M <= 8 * nb:
            return ("plane", dict(plane_rows=tb), parts_rows, parts_pos,
                    touched)
        if (self._sb_plane_factor > 1 and
                pool * hll.M <= self._sb_plane_factor * 8 * nb):
            return ("plane_full", dict(plane_rows=pool, plane_full=True),
                    parts_rows, parts_pos, None)
        return ("pos", dict(pos_n=nb), parts_rows, parts_pos, None)

    def _sb_fill_set(self, buf, off, spec, sets) -> None:
        _arm, _kw, parts_rows, parts_pos, touched = sets
        pool = self.config.set_rows
        if spec.pos_n:
            native.sb_gather_i32(
                parts_rows, buf[off["pos_rows"]:off["pos_rows"] +
                                spec.pos_n], pool)
            native.sb_gather_i32(
                parts_pos, buf[off["pos_pk"]:off["pos_pk"] + spec.pos_n],
                0)
            return
        # plane arms: zero the register segment, then fold every staged
        # part straight into it (no intermediate concatenate)
        words = spec.plane_rows * (hll.M // 4)
        seg = buf[off["plane_regs"]:off["plane_regs"] + words]
        seg[:] = 0
        plane = seg.view(np.uint8).reshape(spec.plane_rows, hll.M)
        remap = None
        if not spec.plane_full:
            t = len(touched)
            remap = np.full(pool, -1, np.int32)
            remap[touched] = np.arange(t, dtype=np.int32)
            o = off["plane_idx"]
            buf[o:o + t] = touched
            # pad sentinel = pool rows: merge_rows drops them
            buf[o + t:o + spec.plane_rows] = pool
        for pr, pp in zip(parts_rows, parts_pos):
            if remap is not None:
                pr = remap[pr]
            native.hll_plane(pr, pp, plane)

    # ------------------------------------------------------------------
    # histogram steps outside the superbatch

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        arr = np.ascontiguousarray(arr)
        self.h2d_bytes += arr.nbytes
        observe.REGISTRY.note_h2d(arr.nbytes)
        return torch.from_numpy(arr).to(self.device)

    def _route(self, name: str) -> None:
        self.routes[name] = self.routes.get(name, 0) + 1

    def _histo_device_step(self, st: _IntervalState, rows: np.ndarray,
                           vals: np.ndarray, wts: np.ndarray,
                           with_stats: bool = True) -> None:
        """Histo ingest.  A batch dense enough takes the host-densified
        plane first (``_histo_plane_step``); its rows past the plane
        width spill back here digest-only, since the plane step's host
        stats already counted them.  A batch that fits one merge width
        merges in one ranked pass; a deep batch folds its local
        aggregates on the host (exact) and merges digest-only, one
        chunk width at a time (or, past 64 chunk widths in one row,
        pre-clusters on the host first)."""
        unit = bool(np.all(wts == 1.0))
        spilled = False
        if with_stats and len(rows):
            handled, spill = self._histo_plane_step(st, rows, vals, wts,
                                                    unit)
            if handled:
                if spill is None:
                    return
                # the ranked path chunks iteratively: a plane retry
                # would strip only `width` samples of a hot row per level
                rows, vals, wts = spill
                with_stats = False
                spilled = True
        rank, max_count = self._rank(rows)
        eff = self._eff_histo_slots
        if max_count <= eff:
            self._route("spill" if spilled else "ranked")
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
                self._route("precluster")
                self._digest_merge(st, rows, vals, wts, rank, False,
                                   False)
                return
            n_chunks = -(-max_count // eff)
        self._route("deep_scan")
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
        st.histo_stats = _histo_stats_fold(st.histo_stats,
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

    def _plane_choice(self, rows, vals, unit, n):
        """Width / f16 / engagement of the host-densified plane for one
        batch, shared by _histo_plane_step and the superbatch router so
        the two never disagree.  Returns (width, f16, engage); width 0
        means the batch touched no rows."""
        c = self.config
        counts_full = np.bincount(rows, minlength=c.histo_rows)
        occupied = counts_full[counts_full > 0]
        if not len(occupied):
            return 0, False, True
        w_hi = int(occupied.max())
        w_p99 = int(np.percentile(occupied, 99.5))
        # width at 128-lane granularity around the p99.5 row count; the
        # hotter rows spill instead of padding every row
        width = min(max(128, -(-w_p99 // 128) * 128),
                    _bucket_len(w_hi, wide=True),
                    self._eff_histo_slots)
        # f16 only for unit-weight batches whose nonzero values all sit
        # in f16's normal range (relative quantization 2^-11); the stats
        # stay exact either way
        f16 = False
        if unit:
            av = np.abs(vals)
            vmax = float(av.max(initial=0.0))
            nz = av[av > 0]
            vmin_nz = float(nz.min()) if len(nz) else 1.0
            f16 = vmax < 6.0e4 and vmin_nz >= 6.2e-5
        vbytes = 2 if f16 else 4
        planes = 1 if unit else 2
        engage = c.histo_rows * width * vbytes * planes <= 12 * n
        return width, f16, engage

    def _histo_plane_step(self, st, rows, vals, wts, unit):
        """Host-densified plane ingest (vtpu_dense_plane, then
        tdigest.ingest_plane_pre*): ships an (R, width) value plane,
        as f16 when the range allows, instead of 12 bytes a sample.
        The native pass accumulates exact f64 per-row stats over every
        sample, spilled ones included.

        Returns (handled, spill): handled False when the batch is too
        sparse for the plane to be the smaller transfer; spill holds
        the samples of rows past the plane width, for the caller to
        merge digest-only."""
        c = self.config
        n = len(rows)
        rows = np.ascontiguousarray(rows, np.int32)
        vals = np.ascontiguousarray(vals, np.float32)
        width, f16, engage = self._plane_choice(rows, vals, unit, n)
        if width == 0:
            return True, None
        if not engage:
            return False, None
        plane_v, plane_w, counts, ov, batch_stats = native.dense_plane(
            rows, vals, None if unit else wts, c.histo_rows, width)
        batch_stats = batch_stats.astype(np.float32)
        if f16:
            plane_v = plane_v.astype(np.float16)
        self._route("plane_f16" if f16 else "plane_f32")
        self._ensure_fresh(st, "histo")
        if unit:
            (st.histo_means, st.histo_weights,
             st.histo_stats) = _td_step["ingest_plane_pre_unit"](
                st.histo_means, st.histo_weights, st.histo_stats,
                self._dev(batch_stats), self._dev(counts),
                self._dev(plane_v), compression=c.compression)
        else:
            (st.histo_means, st.histo_weights,
             st.histo_stats) = _td_step["ingest_plane_pre"](
                st.histo_means, st.histo_weights, st.histo_stats,
                self._dev(batch_stats), self._dev(plane_v),
                self._dev(plane_w), compression=c.compression)
        ov_rows, ov_vals, ov_wts = ov
        if len(ov_rows):
            return True, (ov_rows, ov_vals,
                          np.ones(len(ov_rows), np.float32) if unit
                          else ov_wts)
        return True, None

    def _ensure_host_plane(self, st: _IntervalState) -> None:
        if st.hll_host_plane is None:
            pool = self._set_pool_rows
            st.hll_host_plane = (self._plane_pool.pop() if self._plane_pool
                                 else np.zeros((pool, hll.M), np.uint8))
            # all-zero rows: every register counts in ez and adds 2^0
            # to the inverse-power sum
            st.hll_host_ez = np.full(pool, hll.M, np.int32)
            st.hll_host_inv = np.full(pool, float(hll.M), np.float64)

    def _hll_host_fold(self, st: _IntervalState, rows: np.ndarray,
                       pos: np.ndarray) -> None:
        """Fold packed member positions into the interval's host
        register plane and its per-row estimate statistics
        (vtpu_hll_plane_stats) — no device work at all."""
        self._ensure_host_plane(st)
        native.hll_plane_stats(rows, pos, st.hll_host_plane,
                               st.hll_host_inv, st.hll_host_ez)

    def _rank(self, rows: np.ndarray,
              num_rows: int | None = None) -> tuple[np.ndarray, int]:
        """Within-row occurrence rank + max per-row count (vtpu_rank).
        ``rows`` may be local (union-row) indices bounded by
        ``num_rows``."""
        return native.rank(rows, self.config.histo_rows
                           if num_rows is None else num_rows)

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
            fn = {(True, True): _td_step["ingest_ranked_unit_rows"],
                  (True, False): _td_step["ingest_ranked_unit"],
                  (False, True): _td_step["ingest_ranked_rows"],
                  (False, False): _td_step["ingest_ranked"]}[(unit, sub)]
            (st.histo_means, st.histo_weights, st.histo_stats) = fn(
                st.histo_means, st.histo_weights, st.histo_stats, *pre,
                rows_dev, rank_dev, vals_dev, *wts_dev, **kw)
        else:
            fn = {(True, True): _td_step["add_samples_ranked_unit_rows"],
                  (True, False): _td_step["add_samples_ranked_unit"],
                  (False, True): _td_step["add_samples_ranked_rows"],
                  (False, False): _td_step["add_samples_ranked"]}[(unit, sub)]
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
        # the whole-plane form densifies every digest row: a tiered
        # table's pool rows (its merges take slot ids)
        n_plane_rows = mb if sub else self._histo_pool_rows
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
            fn = (_td_step["merge_dense_scan_rows"] if sub
                  else _td_step["merge_dense_scan"])
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
            fn = _td_step["add_samples_ranked_scan_rows"]
        else:
            rows_dev = self._dev(_pad_np(rows, b, c.histo_rows))
            fn = _td_step["add_samples_ranked_scan"]
        st.histo_means, st.histo_weights = fn(
            st.histo_means, st.histo_weights, *pre, rows_dev, rank_dev,
            vals_dev, wts_dev, **kw)

    def import_mode(self) -> str:
        """The fused-import mode this table's applies use: ``auto``
        resolves to ``stack`` on the card and ``legacy`` on the CPU."""
        mode = self.fused_import_mode
        if mode == "auto":
            return "stack" if self.device.type == "cuda" else "legacy"
        return mode

    def _collective_wire_fold(self):
        """Resolve the collective-import gate once and cache it: a
        ``parallel.sharded.CollectiveWireFold`` when the fold runs
        collectively (mode "on", or "auto" with more than one place in
        the import mesh), else None — the serial scan."""
        if self._collective_fold == "unset":
            fold = None
            mode = self.collective_import_mode
            if mode != "off":
                from veneur_tpu_torch.parallel import sharded
                mesh = sharded.make_import_mesh(
                    self.places if self.places is not None
                    else sharded.default_places(self.device))
                if mode == "on" or mesh.size > 1:
                    fold = sharded.CollectiveWireFold(
                        mesh, compression=self.config.compression)
            self._collective_fold = fold
        return self._collective_fold

    def _wire_digest_step(self, st: _IntervalState,
                          parts: list[tuple]) -> None:
        """Fold a cycle's decoded wire digests — one (rows, means,
        weights) part per forwarded wire — into the digest planes.

        ``stack`` builds (wires, union_rows, K) centroid planes and
        folds them with ``tdigest.merge_wire_stack_rows``: one cluster
        merge per live wire, in wire order, on the gathered union rows.
        ``perwire`` makes the same merges one call per wire, on the
        same union rows and width, so the two are bit-identical.  Rows
        deeper than the stack width within one wire spill to the flat
        ranked path.  ``legacy``, a single wire, or a union-row bucket
        past half the plane take the flat path: every wire's centroids
        in one digest-only ranked (or deep) merge."""
        c = self.config
        parts = [p for p in parts if len(p[0])]
        if not parts:
            return
        mode = self.import_mode()

        def _flat() -> None:
            self._route("wire_flat")
            self._histo_device_step(
                st, np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]),
                np.concatenate([p[2] for p in parts]),
                with_stats=False)

        if mode == "legacy" or len(parts) == 1:
            _flat()
            return
        uniq = np.unique(np.concatenate([p[0] for p in parts]))
        mb = _bucket_len(len(uniq))
        if mb * 2 > c.histo_rows:
            _flat()
            return
        kmax = self._wire_stack_kmax
        built = []
        spill = _Staging()
        kdeep = 0
        for rows, means, wts in parts:
            rows = np.ascontiguousarray(rows, np.int32)
            local = np.searchsorted(uniq, rows).astype(np.int32)
            rank, maxc = self._rank(local, num_rows=len(uniq))
            if maxc > kmax:
                over = rank >= kmax
                spill.append(rows[over], means[over], wts[over])
                keep = ~over
                local, rank = local[keep], rank[keep]
                means, wts = means[keep], wts[keep]
                maxc = kmax
            built.append((local, rank, means, wts))
            kdeep = max(kdeep, maxc)
        K = _bucket_len(kdeep, wide=True)
        idx_dev = self._dev(_pad_np(uniq.astype(np.int32), mb,
                                    c.histo_rows))
        self._ensure_fresh(st, "histo")
        if mode == "stack":
            fold = self._collective_wire_fold()
            wb = _bucket_len(len(built), wide=True)
            if fold is not None:
                # the fold scans equal per-place wire slices: pad the
                # wire axis to a multiple of the places (padding wires
                # stay dead, skipped)
                wb = fold.pad_wires(wb)
            stack_m = np.zeros((wb, mb, K), np.float32)
            stack_w = np.zeros((wb, mb, K), np.float32)
            live = np.zeros(wb, bool)
            for i, (local, rank, means, wts) in enumerate(built):
                stack_m[i, local, rank] = means
                stack_w[i, local, rank] = wts
                live[i] = True
            if fold is not None:
                self._route("wire_collective")
                st.histo_means, st.histo_weights = _collective_fold_step(
                    fold, st.histo_means, st.histo_weights, idx_dev,
                    self._dev(stack_m), self._dev(stack_w), live)
            else:
                self._route("wire_stack")
                st.histo_means, st.histo_weights = \
                    _td_step["merge_wire_stack_rows"](
                        st.histo_means, st.histo_weights, idx_dev,
                        self._dev(stack_m), self._dev(stack_w), live,
                        compression=c.compression)
        else:
            # one wire per call: a one-wire stack (the reference pads it
            # to 8 dead wires, which are skipped either way)
            self._route("wire_perwire")
            live = np.ones(1, bool)
            for local, rank, means, wts in built:
                stack_m = np.zeros((1, mb, K), np.float32)
                stack_w = np.zeros((1, mb, K), np.float32)
                stack_m[0, local, rank] = means
                stack_w[0, local, rank] = wts
                st.histo_means, st.histo_weights = \
                    _td_step["merge_wire_stack_rows"](
                        st.histo_means, st.histo_weights, idx_dev,
                        self._dev(stack_m), self._dev(stack_w), live,
                        compression=c.compression)
        batch = spill.take()
        if batch is not None:
            self._histo_device_step(st, *batch, with_stats=False)

    # ------------------------------------------------------------------
    # tiered apply routing (self.tiers is not None; an untiered table
    # never reaches these)

    def _tiered_scalar_histo_apply(self, w: _StagedWork) -> None:
        """The superbatch's families on a tiered table, class by class:
        counters and gauges as dense updates, raw histogram samples
        through the tier routing.  Consumed families are nulled on
        ``w``."""
        st = w.state
        if w.counter is not None:
            self._ensure_fresh(st, "counter")
            st.counters = _counter_dense_step(
                st.counters, self._dev(w.counter.astype(np.float32)))
            w.counter = None
        if w.gauge is not None:
            dense, mask = w.gauge
            self._ensure_fresh(st, "gauge")
            st.gauges = _gauge_dense_step(
                st.gauges, self._dev(dense), self._dev(mask.astype(bool)))
            w.gauge = None
        if w.histo is not None:
            batch = w.histo.take()
            w.histo = None
            if batch is not None:
                self._tiered_histo_step(st, *batch, with_stats=True)

    def _tier_partition(self, st: _IntervalState, rows, name: str):
        """(wide positions, their pool slots, compact positions) of a
        batch's rows of class ``name``: by the state's frozen view once
        begin_swap froze it, else by the live directory.  Caller holds
        the directory lock."""
        frozen = st.tier_frozen
        if frozen is None:
            return tiersmod.split_by_tier(rows, getattr(self.tiers, name))
        ftier, fslot = frozen[name]
        mask = ftier[rows] != 0
        wpos = np.nonzero(mask)[0]
        return wpos, fslot[rows[wpos]], np.nonzero(~mask)[0]

    def _tiered_histo_step(self, st: _IntervalState, rows, vals, wts,
                           with_stats: bool) -> None:
        """Tiered histogram apply: the exact row-space stats fold first
        (stat planes are row-indexed in both modes), then a partition by
        tier bit.  Wide rows translate to pool slots and take the ranked
        merge; compact rows keep their raw weighted samples on the host
        (below the promote threshold that list IS the digest).  A row
        crossing the threshold escalates mid-interval: a slot, and its
        retained samples drained through the cluster merge — the
        lossless upgrade.  A frozen (post-begin_swap) state never
        escalates: its data stays in the compact store and the boundary
        promotes the row for the next interval."""
        dirs = self.tiers
        th = dirs.thresholds
        rows = np.ascontiguousarray(rows, np.int32)
        vals = np.ascontiguousarray(vals, np.float32)
        wts = np.ascontiguousarray(wts, np.float32)
        if with_stats:
            self._host_stats_fold(st, rows, vals, wts)
        dev_parts = []
        with dirs.lock:
            frozen = st.tier_frozen
            wpos, wslots, cpos = self._tier_partition(st, rows, "histo")
            if len(wpos):
                dev_parts.append((np.asarray(wslots, np.int32),
                                  vals[wpos], wts[wpos]))
            if len(cpos):
                store = st.histo_compact
                if store is None:
                    store = st.histo_compact = \
                        tiersmod.CompactHistoStore(self.config.histo_rows)
                crows = rows[cpos]
                store.append(crows, vals[cpos], wts[cpos])
                if frozen is None:
                    cand = np.unique(crows)
                    cand = cand[store.counts[cand] >= th.histo_samples]
                    for r in cand:
                        s = dirs.histo.ensure_wide(int(r),
                                                   escalation=True)
                        if s is None:
                            # pool exhausted: the row stays compact,
                            # exact on the host; a refused promotion
                            continue
                        dv, dw = store.drain_row(int(r))
                        dev_parts.append(
                            (np.full(len(dv), s, np.int32), dv, dw))
        if dev_parts:
            self._histo_device_step(
                st, np.concatenate([p[0] for p in dev_parts]),
                np.concatenate([p[1] for p in dev_parts]),
                np.concatenate([p[2] for p in dev_parts]),
                with_stats=False)

    def _tiered_set_step(self, st: _IntervalState, srows, spos) -> None:
        """Tiered set apply: wide rows fold into the slot-indexed host
        register plane; compact rows append to the sparse register list
        (exact: the dense row is a function of the deduped list).
        Occupancy crossing the promote threshold escalates: the sparse
        list scatters into a new pool slot."""
        dirs = self.tiers
        th = dirs.thresholds
        srows = np.ascontiguousarray(srows, np.int32)
        spos = np.ascontiguousarray(spos, np.int32)
        fold_rows, fold_pos = [], []
        with dirs.lock:
            frozen = st.tier_frozen
            wpos, wslots, cpos = self._tier_partition(st, srows, "set")
            if len(wpos):
                fold_rows.append(np.asarray(wslots, np.int32))
                fold_pos.append(spos[wpos])
            if len(cpos):
                store = st.set_sparse
                if store is None:
                    store = st.set_sparse = tiersmod.SparseSetStore(
                        self.config.set_rows)
                crows = srows[cpos]
                store.append(crows, spos[cpos])
                if frozen is None:
                    cand = np.unique(crows)
                    cand = cand[store.counts[cand] >= th.set_entries]
                    if len(cand):
                        # raw append counts over-estimate occupancy:
                        # dedup before deciding
                        store.consolidate()
                        for r in cand:
                            if store.counts[r] < th.set_entries:
                                continue
                            s = dirs.set.ensure_wide(int(r),
                                                     escalation=True)
                            if s is None:
                                continue
                            p = store.drain_row(int(r))
                            fold_rows.append(np.full(len(p), s, np.int32))
                            fold_pos.append(p)
        if fold_rows:
            self._route("set_host_fold")
            self._hll_host_fold(st, np.concatenate(fold_rows),
                                np.concatenate(fold_pos))

    def _tiered_set_import(self, st: _IntervalState, rows, regs) -> None:
        """Forwarded dense register rows on a tiered table: the target
        row force-promotes (a peer already holds dense state) and the
        row unions into its slot, the fold statistics recomputed
        exactly.  Rows the pool refuses keep their registers in the
        interval's overflow sidecar: exact, never lost, unpromoted."""
        self._ensure_host_plane(st)
        plane = st.hll_host_plane
        dirs = self.tiers
        for i, r in enumerate(np.asarray(rows, np.int64)):
            r = int(r)
            with dirs.lock:
                frozen = st.tier_frozen
                if frozen is not None:
                    ftier, fslot = frozen["set"]
                    s = int(fslot[r]) if ftier[r] else -1
                else:
                    s0 = dirs.set.ensure_wide(r, escalation=True)
                    s = -1 if s0 is None else int(s0)
                    if s >= 0 and st.set_sparse is not None and \
                            st.set_sparse.counts[r] > 0:
                        p = st.set_sparse.drain_row(r)
                        if len(p):
                            plane[s, p >> 6] = np.maximum(
                                plane[s, p >> 6],
                                (p & 0x3F).astype(np.uint8))
            if s < 0:
                ov = st.set_dense_overflow
                if ov is None:
                    ov = st.set_dense_overflow = {}
                prev = ov.get(r)
                ov[r] = (regs[i].copy() if prev is None
                         else np.maximum(prev, regs[i]))
                continue
            prow = plane[s]
            np.maximum(prow, regs[i], out=prow)
            ez = int((prow == 0).sum())
            st.hll_host_ez[s] = ez
            nz = prow[prow != 0].astype(np.int64)
            st.hll_host_inv[s] = float(ez) + float(
                np.ldexp(1.0, -nz).sum())

    def _tiered_wire_digest_step(self, st: _IntervalState,
                                 parts: list[tuple]) -> None:
        """Forwarded centroid parts translate row -> slot before the
        wire fold: forwarded digests are wide-tier traffic by
        definition, so their rows force-promote (draining any compact
        samples through the merge).  Centroids of rows the pool refuses
        stay in the compact store as weighted samples — a centroid IS a
        weighted sample, so no mass is lost."""
        dirs = self.tiers
        out_parts = []
        extra = []
        with dirs.lock:
            frozen = st.tier_frozen
            store = st.histo_compact
            smap = np.full(self.config.histo_rows, -1, np.int32)
            smapped = np.zeros(self.config.histo_rows, bool)
            for rows, means, wts in parts:
                if not len(rows):
                    continue
                rows = np.ascontiguousarray(rows, np.int32)
                for r in np.unique(rows):
                    r = int(r)
                    if smapped[r]:
                        continue
                    smapped[r] = True
                    if frozen is not None:
                        ftier, fslot = frozen["histo"]
                        smap[r] = fslot[r] if ftier[r] else -1
                        continue
                    s = dirs.histo.ensure_wide(r, escalation=True)
                    if s is None:
                        continue
                    smap[r] = s
                    if store is not None and store.counts[r] > 0:
                        dv, dw = store.drain_row(r)
                        if len(dv):
                            extra.append(
                                (np.full(len(dv), s, np.int32), dv, dw))
                slots = smap[rows]
                ok = slots >= 0
                if not ok.all():
                    if store is None:
                        store = st.histo_compact = \
                            tiersmod.CompactHistoStore(
                                self.config.histo_rows)
                    bad = ~ok
                    store.append(rows[bad],
                                 np.asarray(means, np.float32)[bad],
                                 np.asarray(wts, np.float32)[bad])
                if ok.any():
                    out_parts.append((slots[ok], np.asarray(means)[ok],
                                      np.asarray(wts)[ok]))
        if out_parts:
            self._wire_digest_step(st, out_parts)
        for erows, ev, ew in extra:
            self._histo_device_step(st, erows, ev, ew, with_stats=False)

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
        # freeze the outgoing interval's tier routing first: late
        # pipelined applies pinned to this state partition by these
        # copies (an escalation re-checks tier_frozen under the same
        # lock, so it either lands before the freeze and the copy sees
        # it, or is skipped).  Pre-compaction row space, as the metadata
        # captured below.
        if self.tiers is not None:
            with self.tiers.lock:
                st.tier_frozen = {
                    "histo": (self.tiers.histo.tier.copy(),
                              self.tiers.histo.slot.copy()),
                    "set": (self.tiers.set.tier.copy(),
                            self.tiers.set.slot.copy()),
                }
        work = self._detach_staged(final=True)
        pend = _PendingSwap()
        pend.work = work
        pend.state = st
        # the native ingest marks touched[] but not last_gen (the
        # generation is constant within an interval): stamp it here
        for idx in (self.counter_idx, self.gauge_idx, self.histo_idx,
                    self.set_idx):
            idx.last_gen[idx.touched] = self.gen
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
        self._interval_device_staged = 0
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
        pend.row_maps = {}
        for idx in (self.counter_idx, self.gauge_idx, self.histo_idx,
                    self.set_idx):
            idx.drops.take()
            occ = idx.occupancy()
            if occ > idx.capacity * self.config.compact_threshold:
                freed = occ - int(
                    (idx.last_gen[:occ] >= self.gen - 1).sum())
                if (freed >= max(1, idx.capacity // 8) or
                        (occ >= idx.capacity and freed > 0)):
                    mapping = idx.compact(keep_gen=self.gen - 1)
                    if idx is self.histo_idx:
                        pend.row_maps["histo"] = mapping
                    elif idx is self.set_idx:
                        pend.row_maps["set"] = mapping
                    compacted = True
                else:
                    idx.reset_interval()
            else:
                idx.reset_interval()
        if compacted and self.tiers is not None:
            # the tier directory is row-keyed: it follows the
            # renumbering (dropped wide rows hand their slots back).  The
            # outgoing state's frozen copies stay in the old row space:
            # they pair with the pend metadata, and the boundary
            # translates through pend.row_maps.
            with self.tiers.lock:
                if "histo" in pend.row_maps:
                    self.tiers.histo.renumber(pend.row_maps["histo"])
                if "set" in pend.row_maps:
                    self.tiers.set.renumber(pend.row_maps["set"])
        if compacted:
            # rows renumbered: rebuild the columnar key index from the
            # surviving metas
            self.key_index.clear()
            for idx in (self.counter_idx, self.gauge_idx,
                        self.histo_idx, self.set_idx):
                for row, m in enumerate(idx.meta):
                    if m.key_hash:
                        self.key_index.insert(m.key_hash, row)
            # /import and gRPC row plans and the gRPC row cache name the
            # old rows: the epoch stamp invalidates the plans, and
            # dropping them frees the row vectors
            self._reindex_epoch += 1
            self._http_plan_cache.clear()
            self._wire_plan_cache.clear()
            self.import_row_cache.clear()
        return pend

    def complete_swap(self, pend: _PendingSwap) -> Snapshot:
        """Swap half 2 (no ingest lock needed): wait out every pipelined
        apply still pinned to the outgoing state (its pending count
        reaches zero only once each pre-swap ``take_staged`` has landed:
        no sample is lost or counted twice across the swap), apply the
        final staging and assemble the snapshot."""
        with self._pending_cv:
            while pend.state.pending:
                self._pending_cv.wait()
        if not pend.work.empty:
            with self._device_lock:
                self._apply_work(pend.work)
        st = pend.state
        snap_tiers = None
        if self.tiers is not None:
            # every apply pinned to this state has landed, so the
            # boundary sees the interval's final stores and no apply
            # races its tier flips
            with self._device_lock:
                snap_tiers = self._tier_boundary(pend, st)
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
            hll_host_ez=st.hll_host_ez,
            hll_host_inv=st.hll_host_inv,
            overflow=pend.overflow,
            ingested=pend.ingested,
            recycle=self._recycle_plane,
            tiers=snap_tiers,
        )

    def _recycle_plane(self, plane: np.ndarray) -> None:
        """Take a released snapshot's host set plane back, cleared (on
        the releasing flush thread, off the ingest path).  At most four
        are kept: more in flight is a leak, not a pool."""
        if (len(self._plane_pool) < 4 and
                plane.shape == (self._set_pool_rows, hll.M)):
            plane.fill(0)
            self._plane_pool.append(plane)

    def _tier_boundary(self, pend: _PendingSwap, st: _IntervalState):
        """End-of-interval promotions and demotions, and the interval's
        tier view.  Runs under _device_lock after the final apply, so
        its flips affect the NEXT interval only.  A row that already has
        next-interval data (live touched) keeps its tier until the
        following boundary: a flipped row never has one interval's data
        on both sides.  Boundary promotions are tier flips only (the
        planes reset at every swap); escalations did the in-place
        upgrades."""
        dirs = self.tiers
        th = dirs.thresholds
        if st.histo_compact is not None:
            st.histo_compact.consolidate()
        if st.set_sparse is not None:
            st.set_sparse.consolidate()
        with dirs.lock:
            for name, cls, idx, store, thresh in (
                    ("histo", dirs.histo, self.histo_idx,
                     st.histo_compact, th.histo_samples),
                    ("set", dirs.set, self.set_idx,
                     st.set_sparse, th.set_entries)):
                mapping = pend.row_maps.get(name)
                touched = (pend.histo_touched if name == "histo"
                           else pend.set_touched)
                if mapping is not None:
                    tn = np.zeros(cls.rows, bool)
                    live = np.nonzero(mapping >= 0)[0]
                    tn[mapping[live]] = touched[live]
                    touched = tn
                wide = cls.tier != 0
                cls.idle[wide & touched] = 0
                cls.idle[wide & ~touched] += 1
                for r in np.nonzero(
                        wide & (cls.idle >= th.demote_idle) &
                        ~idx.touched)[0]:
                    cls.demote(int(r))
                if store is not None and not dirs.promote_frozen:
                    for ro in np.nonzero(store.counts >= thresh)[0]:
                        rn = (int(ro) if mapping is None
                              else int(mapping[ro]))
                        if rn < 0 or cls.tier[rn] or idx.touched[rn]:
                            continue
                        cls.ensure_wide(rn)
            frozen = st.tier_frozen or {}
            fh = frozen.get("histo") or (dirs.histo.tier.copy(),
                                         dirs.histo.slot.copy())
            fs = frozen.get("set") or (dirs.set.tier.copy(),
                                       dirs.set.slot.copy())
            movements = {"histo": dirs.histo.take_delta(),
                         "set": dirs.set.take_delta()}
            occupancy = {"histo": dirs.histo.occupancy(),
                         "set": dirs.set.occupancy()}
        pb = self.plane_bytes()
        return tiersmod.TierSnapshot(
            histo_tier=fh[0], histo_slot=fh[1],
            set_tier=fs[0], set_slot=fs[1],
            histo_compact=st.histo_compact,
            set_sparse=st.set_sparse,
            set_dense_overflow=st.set_dense_overflow or {},
            movements=movements,
            occupancy=occupancy,
            plane_bytes=pb,
            device_bytes_per_series=pb["device_bytes_per_series"],
            pool_rows={"histo": self._histo_pool_rows,
                       "set": self._set_pool_rows})

    def plane_bytes(self) -> dict:
        """Per-class, per-tier sketch-memory accounting of the current
        interval's live allocations (tensor ``nbytes`` on the device,
        array ``nbytes`` on the host), so a promotion or demotion shows
        the flush after it happens.  Reads race ingest benignly: these
        are gauges, not invariants."""
        st = self._state

        def _b(x) -> int:
            return int(x.nbytes) if x is not None else 0

        counter_b = _b(st.counters) + self._counter_dense.nbytes
        gauge_b = (_b(st.gauges) + self._gauge_dense.nbytes +
                   self._gauge_mask.nbytes)
        histo_wide = _b(st.histo_means) + _b(st.histo_weights)
        histo_stats = _b(st.histo_stats) + _b(st.histo_import_stats)
        histo_compact = (st.histo_compact.nbytes()
                         if st.histo_compact is not None else 0)
        set_wide = _b(st.hll_regs)
        for arr in (st.hll_host_plane, st.hll_host_ez, st.hll_host_inv):
            set_wide += _b(arr)
        set_compact = (st.set_sparse.nbytes()
                       if st.set_sparse is not None else 0)
        ov = st.set_dense_overflow
        if ov:
            set_compact += sum(r.nbytes for r in ov.values())
        directory = 0
        tier_info = None
        if self.tiers is not None:
            with self.tiers.lock:
                for cls in (self.tiers.histo, self.tiers.set):
                    directory += (cls.tier.nbytes + cls.slot.nbytes +
                                  cls.idle.nbytes + cls.slot_row.nbytes)
                tier_info = {
                    "occupancy": {
                        "histo": self.tiers.histo.occupancy(),
                        "set": self.tiers.set.occupancy()},
                    "movements": self.tiers.counters(),
                    "promote_frozen": self.tiers.promote_frozen,
                }
        total = (counter_b + gauge_b + histo_wide + histo_stats +
                 histo_compact + set_wide + set_compact + directory)
        occ = (self.counter_idx.occupancy() +
               self.gauge_idx.occupancy() +
               self.histo_idx.occupancy() +
               self.set_idx.occupancy())
        return {
            "counter": {"wide": counter_b, "compact": 0},
            "gauge": {"wide": gauge_b, "compact": 0},
            "histo": {"wide": histo_wide, "stats": histo_stats,
                      "compact": histo_compact},
            "set": {"wide": set_wide, "compact": set_compact},
            "directory": directory,
            "total": total,
            "occupancy": occ,
            "device_bytes_per_series": total / max(1, occ),
            "tiers": tier_info,
        }

    def take_status(self):
        out = self.status
        self.status = {}
        return out

    def make_reader_shard(self) -> "ReaderShard":
        """Private fused-ingest scratch for one reader thread of a
        multi-reader server (``ReaderShard``)."""
        return ReaderShard(self)


class ReaderShard:
    """One reader thread's private half of the fused native ingest.

    ``ingest_buffer`` holds the table lock across the whole parse +
    probe + combine pass; with several SO_REUSEPORT readers that
    serializes them.  A shard splits it so the O(lines) work runs on
    every reader at once:

    - ``parse(buf)``, no lock: ``vtpu_parse_ingest`` combines into this
      shard's private dense and append scratch.  Index probes need no
      lock (the native index publishes an immutable-capacity inner
      table and counts its readers); every output buffer is the
      shard's own.
    - ``commit()``, under the caller's ingest lock: resolve misses (row
      allocation for new series, once per identity), replay them, and
      merge the shard's touched rows into the shared staging in
      O(touched rows + appended samples).
    - ``reset()``, no lock: zero the rows ``commit`` merged.

    ``parse_ring(ring, ...)`` is ``parse`` fed by an io_uring reader
    (``native.uring.UringReader``): the datagrams are parsed in place
    in the ring's arena, miss and slow-path offsets index that arena,
    and the buffers behind them stay held out of the pool until the
    caller's ``ring.release()`` after ``commit``.

    A compaction between ``parse`` and ``commit`` renumbers rows; the
    table's ``_reindex_epoch`` shows it, and ``commit`` then discards
    the scratch and re-ingests the raw buffer (on the ring path, a copy
    of the held datagrams) through ``ingest_buffer``.

    Gauge last-write-wins resolves in commit order across shards, as
    in any concurrent UDP arrival order; counter, histogram and set
    merges do not depend on order.
    """

    def __init__(self, table: MetricTable):
        self.table = table
        c = table.config
        self._c_dense = np.zeros(c.counter_rows, np.float64)
        self._c_touch = np.zeros(c.counter_rows, np.uint8)
        self._g_dense = np.zeros(c.gauge_rows, np.float32)
        self._g_mask = np.zeros(c.gauge_rows, np.uint8)
        self._g_touch = np.zeros(c.gauge_rows, np.uint8)
        self._h_touch = np.zeros(c.histo_rows, np.uint8)
        self._s_touch = np.zeros(c.set_rows, np.uint8)
        u8 = ctypes.c_uint8
        self._ptrs = dict(
            counter_dense=native.ptr(self._c_dense, ctypes.c_double),
            counter_touch=native.ptr(self._c_touch, u8),
            gauge_dense=native.ptr(self._g_dense, ctypes.c_float),
            gauge_mask=native.ptr(self._g_mask, u8),
            gauge_touch=native.ptr(self._g_touch, u8),
            histo_touch=native.ptr(self._h_touch, u8),
            set_touch=native.ptr(self._s_touch, u8))
        self._cols: dict | None = None  # per-line columns, grow-only
        self._meta = np.zeros(12, np.int64)
        self._buf: bytes | None = None
        self._ring = None  # the UringReader parse_ring read from
        # what commit's slow-path offsets index: the parsed buffer, the
        # ring's arena, or the replay copy of the epoch fall-back
        self.last_slow_src = None
        self._epoch = -1
        # rows commit() merged, for the off-lock zeroing in reset()
        self._zc = self._zg = self._zh = self._zs = None

    def parse(self, buf) -> None:
        """Fused parse + probe + combine into private scratch, without
        the lock.  ctypes releases the GIL for the C pass, so readers
        parse in parallel."""
        t = self.table
        buf_b = buf if isinstance(buf, bytes) else bytes(buf)
        self._buf = buf_b
        self._ring = None
        # the epoch BEFORE the probes: a compaction landing during the
        # pass bumps it, and commit discards
        self._epoch = t._reindex_epoch
        self._cols = _grow_scratch(self._cols, buf_b.count(b"\n") + 1)
        self._meta[:] = 0
        t._parse_ingest(np.frombuffer(buf_b, np.uint8), self._ptrs,
                        self._cols, self._meta)

    def parse_ring(self, ring, max_msgs: int, max_len: int,
                   wait_ms: int, wait_batch: int = 1
                   ) -> tuple[int, int, int, int]:
        """``parse`` straight from an io_uring buffer pool, without the
        lock: wait up to ``wait_ms`` for completions (``wait_batch`` > 1
        asks the kernel to pool that many before waking), then parse
        each datagram in place in the ring's arena.  Returns
        (payload bytes, datagrams, oversize, ENOBUFS); raises
        ``UringError`` when the ring is dead, and the caller drops to
        the recvmmsg tier."""
        from veneur_tpu_torch.native.uring import UringError
        t = self.table
        self._buf = None
        self._ring = ring
        # the epoch BEFORE the probes, as in parse()
        self._epoch = t._reindex_epoch
        # the C side stops taking completions before the lines it has
        # seen could overrun the scratch
        sc = self._cols = _grow_scratch(self._cols, 8192)
        self._meta[:] = 0
        io_out = ring.io_out
        io_out[:] = 0
        tp = self._ptrs

        def p(name, ctype):
            return native.ptr(sc[name], ctype)

        i32, i64, u8 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint8
        f32, f64, u64 = ctypes.c_float, ctypes.c_double, ctypes.c_uint64
        nbytes = t._lib.vtpu_uring_parse_ingest(
            ring.handle, max_msgs, max_len, wait_ms, wait_batch,
            len(sc["hr"]), t.key_index.handle, hashing.HLL_P,
            tp["counter_dense"], tp["counter_touch"], tp["gauge_dense"],
            tp["gauge_mask"], tp["gauge_touch"],
            p("hr", i32), p("hv", f32), p("hw", f32), tp["histo_touch"],
            p("sr", i32), p("sp", i32), tp["set_touch"],
            p("mk", u64), p("mt", u8), p("mv", f64), p("mm", u64),
            p("mw", f32), p("mo", i64), p("ml", i32),
            p("oo", i64), p("ol", i32), p("ok", u8),
            native.ptr(self._meta, i64), native.ptr(io_out, i32))
        if nbytes < 0:
            self._ring = None
            raise UringError(int(nbytes), "io_uring parse")
        return (int(nbytes), int(io_out[0]), int(io_out[1]),
                int(io_out[2]))

    def commit(self) -> tuple[int, int, list[tuple[int, int, int]]]:
        """The locked merge: the caller holds the lock that serializes
        every other table mutation.  Returns (processed, dropped,
        others) as ``ingest_buffer`` does, offsets into
        ``last_slow_src``."""
        t = self.table
        if self._epoch != t._reindex_epoch:
            # rows renumbered since the probes: drop the scratch and run
            # the raw buffer through the locked single-reader pass (on
            # the ring path the raw bytes are the held buffers: one
            # copy a compaction)
            buf = (self._ring.pending_copy() if self._ring is not None
                   else self._buf)
            self._discard()
            self.last_slow_src = buf
            return t.ingest_buffer(buf)
        sc, meta = self._cols, self._meta
        src = (self._ring.arena if self._ring is not None
               else np.frombuffer(self._buf, np.uint8))
        t._replay_misses(src, self._ptrs, sc, meta)
        processed = int(meta[3])
        dropped = int(meta[6:11].sum())
        if dropped:
            t.counter_idx.drops.add(int(meta[6]))
            t.gauge_idx.drops.add(int(meta[7]))
            t.histo_idx.drops.add(int(meta[8] + meta[9]))
            t.set_idx.drops.add(int(meta[10]))
        cr = np.nonzero(self._c_touch)[0]
        if len(cr):
            t._counter_dense[cr] += self._c_dense[cr]
            t.counter_idx.touched[cr] = True
            t._counter_dirty = True
        gr = np.nonzero(self._g_mask)[0]
        if len(gr):
            t._gauge_dense[gr] = self._g_dense[gr]
            t._gauge_mask[gr] = 1
            t.gauge_idx.touched[gr] = True
            t._gauge_dirty = True
        hn = int(meta[0])
        hr = None
        if hn:
            t._histo_stage.append(sc["hr"][:hn].copy(),
                                  sc["hv"][:hn].copy(),
                                  sc["hw"][:hn].copy())
            hr = np.nonzero(self._h_touch)[0]
            t.histo_idx.touched[hr] = True
        sn = int(meta[1])
        sr = None
        if sn:
            t._set_pos_rows.append(sc["sr"][:sn].copy())
            t._set_pos.append(sc["sp"][:sn].copy())
            sr = np.nonzero(self._s_touch)[0]
            t.set_idx.touched[sr] = True
        t._note_staged(processed - dropped)
        self._zc, self._zg, self._zh, self._zs = cr, gr, hr, sr
        self.last_slow_src = (self._ring.arena if self._ring is not None
                              else self._buf)
        self._buf = None
        self._ring = None
        return processed, dropped, _others(sc, meta)

    def reset(self) -> None:
        """Zero the rows commit merged, off the lock, so the scrub never
        lengthens the critical section."""
        if self._zc is not None and len(self._zc):
            self._c_dense[self._zc] = 0.0
            self._c_touch[self._zc] = 0
        if self._zg is not None and len(self._zg):
            self._g_dense[self._zg] = 0.0
            self._g_mask[self._zg] = 0
            self._g_touch[self._zg] = 0
        if self._zh is not None and len(self._zh):
            self._h_touch[self._zh] = 0
        if self._zs is not None and len(self._zs):
            self._s_touch[self._zs] = 0
        self._zc = self._zg = self._zh = self._zs = None

    def _discard(self) -> None:
        """Full scrub, for the epoch fall-back."""
        for a in (self._c_dense, self._c_touch, self._g_dense,
                  self._g_mask, self._g_touch, self._h_touch,
                  self._s_touch):
            a.fill(0)
        self._buf = None
        self._ring = None
        self._zc = self._zg = self._zh = self._zs = None
