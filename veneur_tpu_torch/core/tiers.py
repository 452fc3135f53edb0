"""Adaptive-precision sketch tiers: per-series plane-pool economics.

Port of ``veneur_tpu/core/tiers.py``.  Sketch planes are fixed-shape per
metric class, so memory scales with the WIDEST series while most of a
Zipf population is cold: every set row carries u8[16384] HLL registers
and every histogram row a full-capacity centroid plane.  Here precision
follows per-series weight (SALSA, arxiv 2102.12531): new series land in
a COMPACT tier whose state is exact and tiny —

- sets keep a short packed (index<<6)|rank register list instead of the
  dense 16384-register row.  The sparse form is EXACT: its LogLog-Beta
  sufficient statistics (ez = M - distinct indices, inv_sum =
  (M - distinct) + sum 2^-rank) equal the dense fold's, so the
  estimate is continuous across the sparse->dense upgrade;
- histograms keep their raw weighted samples.  Below the promote
  threshold a t-digest at compression delta holds every sample as its
  own centroid ("The Size of a t-Digest", arxiv 1903.09921), so the
  retained sample list IS the digest the wide tier would have built.

Series whose interval weight / register occupancy crosses a promote
threshold move to the WIDE tier with a lossless upgrade (sparse HLL
scatters into dense registers, retained samples re-cluster through the
cluster merge kernel); idle wide series demote back at the interval
boundary, returning their pool slot.  The wide pools hold a FRACTION of
the row table (default 1/8), which is what bounds device bytes per
series at high cardinality.

Concurrency: the directory's tier/slot arrays are read and flipped
under ``TierDirectory.lock`` (a few O(batch) numpy ops, never device
work).  Mid-interval escalations happen inside the table's
``_apply_work`` (under its device lock); ``begin_swap`` freezes a
(tier, slot) copy onto the outgoing interval state under the same
directory lock, so late pipelined applies route by the assignments the
interval's earlier data used, and the boundary pass in
``complete_swap`` flips tiers for the NEXT interval only.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from veneur_tpu_torch import native
from veneur_tpu_torch.ops import hll


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return max(1, int(raw))
    except ValueError:
        return default


def tier_mode() -> str:
    """VENEUR_TPU_PLANE_TIERS: "auto" (default — tiered iff the dense
    wide allocation would exceed VENEUR_TPU_TIER_AUTO_BYTES),
    "1"/"off" single tier (today's exact code paths), "2"/"on" force
    tiered."""
    raw = os.environ.get("VENEUR_TPU_PLANE_TIERS", "").lower()
    if raw in ("1", "off", "false", "no", "single"):
        return "off"
    if raw in ("2", "on", "true", "yes", "tiered"):
        return "on"
    return "auto"


def tiers_enabled(dense_plane_bytes: int) -> bool:
    mode = tier_mode()
    if mode == "off":
        return False
    if mode == "on":
        return True
    auto_bytes = _env_int("VENEUR_TPU_TIER_AUTO_BYTES", 256 << 20)
    return dense_plane_bytes > auto_bytes


@dataclass(frozen=True)
class TierThresholds:
    """Promote/demote economics, env-overridable."""
    # distinct HLL register positions before a set row goes wide
    set_entries: int = 512
    # retained samples before a histogram row goes wide — kept well
    # inside the singleton regime (~delta/pi ≈ 31·delta/100) so the
    # compact tier's sample list equals the wide digest exactly
    histo_samples: int = 64
    # consecutive untouched intervals before a wide row demotes
    demote_idle: int = 2

    @staticmethod
    def from_env() -> "TierThresholds":
        return TierThresholds(
            set_entries=_env_int("VENEUR_TPU_PROMOTE_SET_ENTRIES", 512),
            histo_samples=_env_int(
                "VENEUR_TPU_PROMOTE_HISTO_SAMPLES", 64),
            demote_idle=_env_int(
                "VENEUR_TPU_DEMOTE_IDLE_INTERVALS", 2))


def wide_slots_for(rows: int) -> int:
    """Wide-pool size for a row table: an eighth of the rows (the
    steady-state hot fraction a Zipf population promotes), floored so
    tiny tables still have a working pool, clamped to the table."""
    w = _env_int("VENEUR_TPU_TIER_WIDE_SLOTS", 0) or max(8, rows // 8)
    return min(rows, w)


class ClassTiers:
    """Tier directory for one metric class (histo or set): per-row
    tier bit, wide-pool slot map, idle ages, and cumulative movement
    counters.  All mutation happens under the owning directory's
    lock."""

    COMPACT, WIDE = 0, 1

    def __init__(self, rows: int, wide: int):
        self.rows = rows
        self.wide_slots = wide
        self.tier = np.zeros(rows, np.uint8)
        self.slot = np.full(rows, -1, np.int32)
        self.slot_row = np.full(wide, -1, np.int32)
        self.free = list(range(wide - 1, -1, -1))
        self.idle = np.zeros(rows, np.int16)
        # cumulative movement counters (the ledger reads interval
        # deltas captured at each boundary)
        self.promotions = 0
        self.demotions = 0
        self.escalations = 0
        self.promote_refused = 0
        self._reported = {"promotions": 0, "demotions": 0,
                          "escalations": 0, "promote_refused": 0}

    def ensure_wide(self, row: int, escalation: bool = False
                    ) -> int | None:
        """Promote ``row`` to the wide tier, allocating a pool slot.
        Returns the slot (existing or new), or None when the pool is
        exhausted — the caller keeps the row compact (exact, just
        bigger host-side) and the refusal is counted, never lost."""
        row = int(row)
        if self.tier[row]:
            return int(self.slot[row])
        if not self.free:
            self.promote_refused += 1
            return None
        s = self.free.pop()
        self.slot_row[s] = row
        self.slot[row] = s
        self.tier[row] = self.WIDE
        self.idle[row] = 0
        if escalation:
            self.escalations += 1
        else:
            self.promotions += 1
        return s

    def demote(self, row: int) -> None:
        row = int(row)
        s = int(self.slot[row])
        if not self.tier[row] or s < 0:
            return
        self.tier[row] = self.COMPACT
        self.slot[row] = -1
        self.slot_row[s] = -1
        self.free.append(s)
        self.idle[row] = 0
        self.demotions += 1

    def renumber(self, mapping: np.ndarray) -> None:
        """Carry tier state through an index compaction: ``mapping``
        is old-row -> new-row (-1 dropped).  Dropped wide rows return
        their slots to the pool (a named demotion — compaction already
        decided the series is dead)."""
        old_tier, old_slot = self.tier, self.slot
        old_idle = self.idle
        self.tier = np.zeros(self.rows, np.uint8)
        self.slot = np.full(self.rows, -1, np.int32)
        self.idle = np.zeros(self.rows, np.int16)
        self.slot_row.fill(-1)
        live = np.nonzero(mapping >= 0)[0]
        new = mapping[live]
        self.tier[new] = old_tier[live]
        self.slot[new] = old_slot[live]
        self.idle[new] = old_idle[live]
        dropped_wide = np.nonzero((mapping < 0) &
                                  (old_tier != 0))[0]
        for r in dropped_wide:
            s = int(old_slot[r])
            if s >= 0:
                self.free.append(s)
                self.demotions += 1
        wide_rows = np.nonzero(self.tier)[0]
        self.slot_row[self.slot[wide_rows]] = wide_rows

    def occupancy(self) -> dict:
        wide = int((self.tier != 0).sum())
        return {"wide": wide,
                "wide_slots": self.wide_slots,
                "free_slots": len(self.free)}

    def counters(self) -> dict:
        return {"promotions": self.promotions,
                "demotions": self.demotions,
                "escalations": self.escalations,
                "promote_refused": self.promote_refused}

    def take_delta(self) -> dict:
        """Interval movement deltas since the previous boundary —
        what the conservation ledger attributes each flush."""
        cur = self.counters()
        out = {k: cur[k] - self._reported[k] for k in cur}
        self._reported = cur
        return out


class TierDirectory:
    """Per-table tier state: one ClassTiers per sketch class plus the
    shared lock and the pressure-freeze flag.  The flag freezes
    BOUNDARY promotions while an overload ladder narrows the wide pool
    (correctness escalations still run); ``MetricTable.
    set_pressure_level`` sets it at levels >= 2 under the lock."""

    def __init__(self, histo_rows: int, set_rows: int,
                 thresholds: TierThresholds | None = None):
        import threading
        self.lock = threading.Lock()
        self.thresholds = thresholds or TierThresholds.from_env()
        self.histo = ClassTiers(histo_rows, wide_slots_for(histo_rows))
        self.set = ClassTiers(set_rows, wide_slots_for(set_rows))
        self.promote_frozen = False

    def counters(self) -> dict:
        return {"histo": self.histo.counters(),
                "set": self.set.counters()}


def split_by_tier(rows: np.ndarray, cls: ClassTiers
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Partition a batch's row ids by tier bit: returns (wide_pos,
    wide_slots, compact_pos) where pos index into the batch and
    wide_slots are the translated pool slots, in one native pass
    (vtpu_tier_split)."""
    return native.tier_split(rows, cls.tier, cls.slot)


class SparseSetStore:
    """Compact-tier set state for one interval: packed member
    positions per row, chunk-appended at apply time and consolidated
    (dedup by register index keeping max rank) on demand.  Exact by
    construction — the consolidated list determines the dense row
    bit-for-bit, so promotion scatters it losslessly."""

    def __init__(self, rows: int):
        self.rows = rows
        self._chunks: list[tuple[np.ndarray, np.ndarray]] = []
        # raw appended entries per row (upper bound on distinct):
        # cheap escalation trigger without consolidating every batch
        self.counts = np.zeros(rows, np.int32)
        self._flat: dict[int, np.ndarray] = {}

    def append(self, rows: np.ndarray, pos: np.ndarray) -> None:
        if not len(rows):
            return
        rows = np.asarray(rows, np.int32)
        pos = np.asarray(pos, np.int32)
        self._chunks.append((rows, pos))
        np.add.at(self.counts, rows, 1)

    def consolidate(self) -> None:
        """Fold chunk backlog into the per-row deduped lists."""
        if not self._chunks:
            return
        rows = np.concatenate([c[0] for c in self._chunks])
        pos = np.concatenate([c[1] for c in self._chunks])
        self._chunks = []
        order = np.lexsort((pos, rows))
        rows, pos = rows[order], pos[order]
        cut = np.nonzero(rows[1:] != rows[:-1])[0] + 1
        starts = np.concatenate(([0], cut))
        ends = np.concatenate((cut, [len(rows)]))
        for s, e in zip(starts, ends):
            r = int(rows[s])
            p = pos[s:e]
            prev = self._flat.get(r)
            if prev is not None:
                p = np.concatenate((prev, p))
                p.sort()
            # dedup by register index keeping MAX rank: packed is
            # (idx << 6) | rank, ascending sort puts the max-rank
            # entry last within each idx run
            idx = p >> 6
            last = np.nonzero(
                np.concatenate((idx[1:] != idx[:-1], [True])))[0]
            self._flat[r] = np.ascontiguousarray(p[last])
            self.counts[r] = len(last)

    def distinct(self, row: int) -> int:
        self.consolidate()
        p = self._flat.get(int(row))
        return 0 if p is None else len(p)

    def drain_row(self, row: int) -> np.ndarray:
        """Remove and return the row's consolidated packed positions
        (escalation: the caller scatters them into the wide pool)."""
        self.consolidate()
        p = self._flat.pop(int(row), None)
        self.counts[int(row)] = 0
        return p if p is not None else np.empty(0, np.int32)

    def touched_rows(self) -> np.ndarray:
        self.consolidate()
        return np.fromiter(self._flat.keys(), np.int64,
                           len(self._flat))

    def stats(self, row: int) -> tuple[int, float]:
        """Exact LogLog-Beta sufficient statistics for the row, equal
        to what the dense fold maintains: ez = M - distinct, inv_sum
        = (M - distinct) + sum 2^-rank."""
        self.consolidate()
        p = self._flat.get(int(row))
        if p is None or not len(p):
            return hll.M, float(hll.M)
        ranks = (p & 0x3F).astype(np.int64)
        ez = hll.M - len(p)
        inv = float(ez) + float(np.ldexp(1.0, -ranks).sum())
        return ez, inv

    def materialize(self, row: int) -> np.ndarray:
        """Dense u8[M] register row from the sparse list — the exact
        lossless upgrade (and the forward-wire form)."""
        self.consolidate()
        regs = np.zeros(hll.M, np.uint8)
        p = self._flat.get(int(row))
        if p is not None and len(p):
            regs[p >> 6] = (p & 0x3F).astype(np.uint8)
        return regs

    def nbytes(self) -> int:
        n = self.counts.nbytes
        n += sum(r.nbytes + p.nbytes for r, p in self._chunks)
        n += sum(p.nbytes for p in self._flat.values())
        return n


class CompactHistoStore:
    """Compact-tier histogram state for one interval: the row's raw
    weighted samples, retained exactly.  Below the promote threshold
    this IS the t-digest the wide tier would build (singleton regime),
    so flush quantiles run the SAME kernel over these arrays and
    promotion replays them through the normal merge path losslessly."""

    def __init__(self, rows: int):
        self.rows = rows
        self._chunks: list[tuple[np.ndarray, np.ndarray,
                                 np.ndarray]] = []
        self.counts = np.zeros(rows, np.int32)
        self._flat: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def append(self, rows: np.ndarray, vals: np.ndarray,
               wts: np.ndarray) -> None:
        if not len(rows):
            return
        self._chunks.append((np.asarray(rows, np.int32),
                             np.asarray(vals, np.float32),
                             np.asarray(wts, np.float32)))
        np.add.at(self.counts, np.asarray(rows, np.int64), 1)

    def consolidate(self) -> None:
        if not self._chunks:
            return
        rows = np.concatenate([c[0] for c in self._chunks])
        vals = np.concatenate([c[1] for c in self._chunks])
        wts = np.concatenate([c[2] for c in self._chunks])
        self._chunks = []
        order = np.argsort(rows, kind="stable")
        rows, vals, wts = rows[order], vals[order], wts[order]
        cut = np.nonzero(rows[1:] != rows[:-1])[0] + 1
        starts = np.concatenate(([0], cut))
        ends = np.concatenate((cut, [len(rows)]))
        for s, e in zip(starts, ends):
            r = int(rows[s])
            v, w = vals[s:e], wts[s:e]
            prev = self._flat.get(r)
            if prev is not None:
                v = np.concatenate((prev[0], v))
                w = np.concatenate((prev[1], w))
            self._flat[r] = (v, w)

    def count(self, row: int) -> int:
        self.consolidate()
        p = self._flat.get(int(row))
        return 0 if p is None else len(p[0])

    def drain_row(self, row: int) -> tuple[np.ndarray, np.ndarray]:
        self.consolidate()
        p = self._flat.pop(int(row), None)
        self.counts[int(row)] = 0
        if p is None:
            return (np.empty(0, np.float32), np.empty(0, np.float32))
        return p

    def touched_rows(self) -> np.ndarray:
        self.consolidate()
        return np.fromiter(self._flat.keys(), np.int64,
                           len(self._flat))

    def samples(self, row: int) -> tuple[np.ndarray, np.ndarray]:
        self.consolidate()
        p = self._flat.get(int(row))
        if p is None:
            return (np.empty(0, np.float32), np.empty(0, np.float32))
        return p

    def max_count(self) -> int:
        self.consolidate()
        return max((len(v) for v, _ in self._flat.values()),
                   default=0)

    def nbytes(self) -> int:
        n = self.counts.nbytes
        n += sum(r.nbytes + v.nbytes + w.nbytes
                 for r, v, w in self._chunks)
        n += sum(v.nbytes + w.nbytes for v, w in self._flat.values())
        return n


@dataclass
class TierSnapshot:
    """One interval's tier view, captured at the swap for the flusher:
    the FROZEN (tier, slot) assignments the interval's data was routed
    under, the compact-tier stores, and the boundary's movement
    deltas.  The flusher reads wide rows from the pool planes through
    ``slot`` and compact rows from the stores — never both for the
    same row (the boundary only flips rows with no data in flight)."""
    histo_tier: np.ndarray
    histo_slot: np.ndarray
    set_tier: np.ndarray
    set_slot: np.ndarray
    histo_compact: CompactHistoStore | None
    set_sparse: SparseSetStore | None
    set_dense_overflow: dict[int, np.ndarray] = field(
        default_factory=dict)
    # this boundary's movement deltas (ledger attribution) and the
    # directory's occupancy + byte accounting after the boundary ran
    movements: dict = field(default_factory=dict)
    occupancy: dict = field(default_factory=dict)
    plane_bytes: dict = field(default_factory=dict)
    device_bytes_per_series: float = 0.0
    pool_rows: dict = field(default_factory=dict)

    # -- set readout ---------------------------------------------------

    def set_row_regs(self, snap: Any, row: int) -> np.ndarray:
        """Dense u8[M] registers for one row — the forward-wire form
        (upgrade-on-pack: compact rows materialize here so the frozen
        VPLN schema never sees a sparse row)."""
        row = int(row)
        if self.set_tier[row]:
            s = int(self.set_slot[row])
            if snap.hll_host_plane is not None:
                regs = snap.hll_host_plane[s].copy()
            else:
                regs = np.zeros(hll.M, np.uint8)
        elif self.set_sparse is not None:
            regs = self.set_sparse.materialize(row)
        else:
            regs = np.zeros(hll.M, np.uint8)
        ov = self.set_dense_overflow.get(row)
        if ov is not None:
            np.maximum(regs, ov, out=regs)
        return regs

    def set_estimates(self, snap: Any, rows: np.ndarray) -> np.ndarray:
        """Row-space cardinality estimates f32[set_rows] for the
        touched rows: wide rows from the pool's fold statistics,
        compact rows from the sparse form's EXACT equivalents — the
        same estimator over the same sufficient statistics, which is
        what pins estimate continuity across the upgrade."""
        out = np.zeros(len(self.set_tier), np.float32)
        if not len(rows):
            return out
        rows = np.asarray(rows, np.int64)
        wide = rows[self.set_tier[rows] != 0]
        if len(wide):
            slots = self.set_slot[wide]
            if snap.hll_host_ez is not None:
                out[wide] = hll.estimate_from_stats(
                    snap.hll_host_ez[slots],
                    snap.hll_host_inv[slots])
            elif snap.hll_host_plane is not None:
                out[wide] = hll.estimate_np(
                    snap.hll_host_plane[slots])
        comp = rows[self.set_tier[rows] == 0]
        for r in comp:
            ov = self.set_dense_overflow.get(int(r))
            if ov is not None:
                # refused-promotion row with a dense import: union
                # the sparse traffic into the dense regs and rescan
                regs = self.set_row_regs(snap, int(r))
                out[r] = hll.estimate_np(regs[None, :])[0]
            elif self.set_sparse is not None:
                ez, inv = self.set_sparse.stats(int(r))
                out[r] = hll.estimate_from_stats(
                    np.asarray([ez], np.int32),
                    np.asarray([inv], np.float64))[0]
        return out

    def materialize_registers(self, snap: Any) -> np.ndarray:
        """Full row-space dense register plane [set_rows, M] — the
        single-tier-compatible view (parity suites and gob interop
        read it; O(rows*16KiB), meant for tests and small tables)."""
        out = np.zeros((len(self.set_tier), hll.M), np.uint8)
        wide = np.nonzero(self.set_tier)[0]
        if len(wide) and snap.hll_host_plane is not None:
            out[wide] = snap.hll_host_plane[self.set_slot[wide]]
        if self.set_sparse is not None:
            for r in self.set_sparse.touched_rows():
                np.maximum(out[r], self.set_sparse.materialize(int(r)),
                           out=out[r])
        for r, regs in self.set_dense_overflow.items():
            np.maximum(out[r], regs, out=out[r])
        return out
