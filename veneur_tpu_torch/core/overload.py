"""Overload control: admission, priority shedding, flush coalescing.

Port of ``veneur_tpu/core/overload.py`` (host numpy; no device work).

A saturated local must degrade *predictably and provably* instead of
collapsing.  This module is the ingest-side twin of the forward
path's breakers + spool: every sample the server turns away under
pressure is attributed — to a tenant and a reason — in the interval
conservation ledger (``received == staged + status + shed + drops``)
and in ``veneur.overload.shed_total{tenant,reason}``.  Three
mechanisms hang off one :class:`Overload` object:

1. **Admission control** — per-tenant token buckets (tenant = a
   configurable tag on the series, ``tpu_overload_tenant_tag``)
   evaluated *vectorized* over the columnar ingest batch: a
   keyhash→bucket slot gather plus a clip against each bucket's
   available tokens, no per-line Python.  Tenant slots resolve
   lazily through the same parse-one-representative-line pattern as
   the table's miss resolution, so steady state is pure numpy.

2. **Priority-tiered shedding** — when the pressure signal engages,
   new-series admission freezes (series not already in the table's
   key index shed as ``series_freeze``) and class-by-class sampling
   kicks in in COST order: sets degrade first, then histograms, then
   gauges.  Counters are NEVER shed — their increments always fold
   into the exact dense accumulator (and a coalesced flush folds two
   intervals of increments into one report: reduced *temporal*
   resolution, zero lost increments).  Histograms additionally drop
   down the width ladder (``MetricTable.set_pressure_level``), so
   the expensive classes lose precision before anyone loses data —
   the SALSA/t-digest-size tradeoff (arxiv 2102.12531, 1903.09921).

3. **Flush-overrun watchdog** — a flush that exceeds its interval
   budget arms a coalesce: the next tick skips its swap so ONE swap
   covers two intervals, named in the ledger record (``coalesced``)
   and ``veneur.flush.coalesced_total``.  Staging memory stays
   bounded by the mid-interval device steps; the overrun becomes an
   attributed event instead of silent drift.

The pressure signal itself (:class:`PressureSignals`) folds staging
depth, class-index occupancy, a flush-lag EWMA, and the kernel
socket-drop delta into one score, with hysteresis on entry/exit so
the system doesn't flap.  It surfaces in ``/debug/vars`` (block
``overload``) and ``/debug/overload``.

When no tenant budget is configured and pressure is disengaged the
hot path is untouched: the fused native ingest branches run exactly
as before and ``admission_active`` is False — the whole subsystem
costs one boolean check per batch.
"""

from __future__ import annotations

import logging
import os
import threading
import time

import numpy as np

from veneur_tpu_torch.protocol import columnar
from veneur_tpu_torch.protocol import dogstatsd as dsd
from veneur_tpu_torch.utils import intern

log = logging.getLogger("veneur_tpu_torch.overload")

# shed attribution reasons (stable names: ledger keys + metric tags)
REASON_TENANT = "tenant_budget"
REASON_FREEZE = "series_freeze"
REASON_CLASS = {
    columnar.CODE_SET: "pressure:set",
    columnar.CODE_TIMER: "pressure:histogram",
    columnar.CODE_HISTOGRAM: "pressure:histogram",
    columnar.CODE_GAUGE: "pressure:gauge",
}
_R_TENANT, _R_FREEZE, _R_SET, _R_HISTO, _R_GAUGE = 1, 2, 3, 4, 5
_REASON_NAMES = {_R_TENANT: REASON_TENANT, _R_FREEZE: REASON_FREEZE,
                 _R_SET: "pressure:set", _R_HISTO: "pressure:histogram",
                 _R_GAUGE: "pressure:gauge"}

# tenant slot 0 is the unattributed default (series without the
# tenant tag); slot 1 aggregates tenants past the table cap
_SLOT_DEFAULT = 0
_SLOT_OTHER = 1
_TENANT_DEFAULT = "default"
_TENANT_OTHER = "other"

_PHI64 = np.uint64(0x9E3779B97F4A7C15)

# per-pressure-level shed fractions by class, cost order: sets
# degrade first, then histograms, then gauges; counters never
_LEVEL_FRACTIONS = {
    0: (0.0, 0.0, 0.0),
    1: (0.5, 0.0, 0.0),
    2: (1.0, 0.5, 0.0),
    3: (1.0, 1.0, 0.5),
}


def _sample_hash16(kh: np.ndarray, salt: np.ndarray) -> np.ndarray:
    """Cheap per-SAMPLE 16-bit mix (series hash x a per-line salt) for
    deterministic unbiased shed sampling — per-sample, not
    per-series, so a sampled class thins instead of blacking out
    individual series."""
    with np.errstate(over="ignore"):
        h = (kh ^ (salt.astype(np.uint64) << np.uint64(32))) * _PHI64
    return (h >> np.uint64(48)).astype(np.int64)


class PressureSignals:
    """One overload score from four saturation signals, with
    hysteresis.  Each signal normalizes to "1.0 = at its configured
    ceiling"; the score is their max, so any single saturated
    dimension engages.  Entry at score >= 1.0, exit only once the
    score falls to ``exit_ratio`` — the band is the anti-flap."""

    def __init__(self, staging_hi: int, occupancy_hi: float,
                 lag_hi: float, exit_ratio: float):
        self.staging_hi = max(1, int(staging_hi))
        self.occupancy_hi = occupancy_hi
        self.lag_hi = lag_hi
        self.exit_ratio = exit_ratio
        self.staging_depth = 0
        self.occupancy = 0.0
        self.flush_lag_ewma = 0.0
        self.socket_drop_delta = 0
        self.score = 0.0
        self.engaged = False
        self.level = 0
        self.transitions = 0

    def update(self, staging_depth: int, occupancy: float,
               flush_lag_ratio: float, socket_drop_delta: int) -> None:
        self.staging_depth = int(staging_depth)
        self.occupancy = float(occupancy)
        # EWMA so one slow flush doesn't engage and one fast flush
        # doesn't disengage (alpha 0.5: ~2 intervals of memory)
        self.flush_lag_ewma = (0.5 * self.flush_lag_ewma +
                               0.5 * float(flush_lag_ratio))
        self.socket_drop_delta = int(socket_drop_delta)
        sig = max(
            self.staging_depth / self.staging_hi,
            self.occupancy / max(self.occupancy_hi, 1e-9),
            self.flush_lag_ewma / max(self.lag_hi, 1e-9),
            # any kernel drop this interval is saturation by
            # definition: the kernel is already discarding
            1.0 if self.socket_drop_delta > 0 else 0.0,
        )
        self.score = sig
        if self.engaged:
            if sig <= self.exit_ratio:
                self.engaged = False
                self.transitions += 1
        elif sig >= 1.0:
            self.engaged = True
            self.transitions += 1
        if not self.engaged:
            self.level = 0
        elif sig < 1.5:
            self.level = 1
        elif sig < 2.5:
            self.level = 2
        else:
            self.level = 3

    def to_dict(self) -> dict:
        return {
            "engaged": self.engaged,
            "level": self.level,
            "score": round(self.score, 4),
            "transitions": self.transitions,
            "signals": {
                "staging_depth": self.staging_depth,
                "staging_hi": self.staging_hi,
                "occupancy": round(self.occupancy, 4),
                "occupancy_hi": self.occupancy_hi,
                "flush_lag_ewma": round(self.flush_lag_ewma, 4),
                "flush_lag_hi": self.lag_hi,
                "socket_drop_delta": self.socket_drop_delta,
            },
        }


class Overload:
    """The server's overload-control state: tenant buckets, pressure
    tiers, and the flush-overrun coalesce arm.  All admission entry
    points run under the server's ingest lock (the same critical
    section that credits the ledger), so the token arrays and tenant
    maps need no lock of their own; readers (``/debug``) take cheap
    snapshots of scalars."""

    def __init__(self, tenant_tag: str = "tenant",
                 tenant_rate: float = 0.0,
                 tenant_burst: float = 0.0,
                 max_tenants: int = 256,
                 staging_hi: int = 1_000_000,
                 occupancy_hi: float = 0.95,
                 lag_hi: float = 1.0,
                 exit_ratio: float = 0.7,
                 coalesce: bool = True):
        self.tenant_tag = tenant_tag
        self._tag_prefix = tenant_tag + ":"
        self.tenant_rate = float(tenant_rate)
        self.tenant_burst = float(tenant_burst) or 2.0 * tenant_rate
        self.coalesce_enabled = bool(coalesce)
        n = max(8, int(max_tenants)) + 2
        self._n_slots = n
        self._tokens = np.full(n, self.tenant_burst, np.float64)
        self._last_refill = time.monotonic()
        self._tenant_slot: dict[str, int] = {
            _TENANT_DEFAULT: _SLOT_DEFAULT, _TENANT_OTHER: _SLOT_OTHER}
        self._tenant_names: list[str] = [_TENANT_DEFAULT, _TENANT_OTHER]
        # series-hash -> tenant slot; the sorted twin arrays are the
        # vectorized gather (np.searchsorted), rebuilt lazily after
        # inserts — one rebuild per batch that saw a new series
        self._slots: dict[int, int] = {}
        self._kh_sorted = np.empty(0, np.uint64)
        self._slot_sorted = np.empty(0, np.int32)
        self._map_dirty = False
        self.pressure = PressureSignals(staging_hi, occupancy_hi,
                                        lag_hi, exit_ratio)
        # cumulative attribution for telemetry (the ledger holds the
        # per-interval truth; these are the monotone counters)
        self.shed_total = 0
        self.shed_by_total: dict[tuple[str, str], int] = {}
        self.coalesced_total = 0
        self._coalesce_armed = False
        self.flush_overruns = 0

    # -- activity gates -----------------------------------------------

    @property
    def buckets_enabled(self) -> bool:
        return self.tenant_rate > 0.0

    @property
    def admission_active(self) -> bool:
        """True when batches must route through the columnar
        admission check (tenant budgets configured, or pressure
        engaged).  False = the fused hot paths run untouched."""
        return self.buckets_enabled or self.pressure.engaged

    # -- tenant resolution --------------------------------------------

    def _tenant_of_tags(self, tags) -> str:
        for t in tags:
            if t.startswith(self._tag_prefix):
                return t[len(self._tag_prefix):]
        return _TENANT_DEFAULT

    def _slot_for_tenant(self, tenant: str) -> int:
        slot = self._tenant_slot.get(tenant)
        if slot is None:
            if len(self._tenant_names) >= self._n_slots:
                return _SLOT_OTHER
            slot = len(self._tenant_names)
            self._tenant_slot[tenant] = slot
            self._tenant_names.append(tenant)
        return slot

    def _insert_series(self, key_hash: int, slot: int) -> None:
        self._slots[int(key_hash)] = slot
        self._map_dirty = True

    def _rebuild_map(self) -> None:
        kh = np.fromiter(self._slots.keys(), np.uint64,
                         len(self._slots))
        sl = np.fromiter(self._slots.values(), np.int32,
                         len(self._slots))
        order = np.argsort(kh)
        self._kh_sorted = kh[order]
        self._slot_sorted = sl[order]
        self._map_dirty = False

    def _gather_slots(self, kh: np.ndarray) -> np.ndarray:
        """Vectorized keyhash -> tenant-slot gather; -1 for series
        this subsystem hasn't attributed yet."""
        if self._map_dirty:
            self._rebuild_map()
        if not len(self._kh_sorted):
            return np.full(len(kh), -1, np.int32)
        pos = np.searchsorted(self._kh_sorted, kh)
        pos = np.minimum(pos, len(self._kh_sorted) - 1)
        hit = self._kh_sorted[pos] == kh
        out = np.where(hit, self._slot_sorted[pos],
                       np.int32(-1)).astype(np.int32)
        return out

    def _refill(self) -> None:
        now = time.monotonic()
        dt = now - self._last_refill
        self._last_refill = now
        if dt > 0 and self.tenant_rate > 0:
            np.minimum(self._tokens + dt * self.tenant_rate,
                       self.tenant_burst, out=self._tokens)

    # -- vectorized admission (columnar batches) ----------------------

    def admit_columns(self, pb, table) -> tuple[int, dict]:
        """Evaluate admission over a parsed columnar batch IN PLACE:
        shed lines get ``type_code = CODE_SHED`` so the table's
        ingest skips them (and the slow-path sweep ignores them).
        Returns ``(n_shed, {(tenant, reason): n})`` for the caller to
        credit to the ledger in the same critical section.  Runs
        under the server's ingest lock."""
        tc = pb.type_code[:pb.n] if hasattr(pb, "n") else pb.type_code
        sel = np.nonzero(tc <= columnar.CODE_SET)[0]
        if len(sel) == 0:
            return 0, {}
        kh = pb.key_hash[sel]
        codes = tc[sel]
        slots = self._gather_slots(kh)
        miss = slots < 0
        freeze = self.pressure.engaged
        # new-series test against the TABLE's key index (authoritative:
        # series alive before overload engaged are known there even if
        # this map never saw them); DROPPED rows count as known — their
        # samples are already attributed overflow, not shed
        if freeze and miss.any():
            index = getattr(table, "key_index", None)
            if index is not None:
                known = index.lookup(kh) != intern.MISSING
            else:
                known = self._known_by_class(pb, sel, miss, table)
        else:
            known = None
        if miss.any():
            self._resolve_tenants(pb, sel[miss], kh[miss])
            slots = self._gather_slots(kh)
            np.maximum(slots, _SLOT_DEFAULT, out=slots)

        shed = np.zeros(len(sel), bool)
        reasons = np.zeros(len(sel), np.uint8)
        noncounter = codes != columnar.CODE_COUNTER

        # 1) new-series freeze (pressure only): counters exempt
        if freeze and known is not None:
            f = miss & ~known & noncounter
            shed |= f
            reasons[f] = _R_FREEZE

        # 2) per-tenant token buckets: gather + clip, no per-line work
        if self.buckets_enabled:
            self._refill()
            cand = np.nonzero(~shed & noncounter)[0]
            if len(cand):
                cs = slots[cand]
                counts = np.bincount(cs, minlength=self._n_slots)
                avail = np.floor(self._tokens).astype(np.int64)
                admit_n = np.minimum(counts, np.maximum(avail, 0))
                order = np.argsort(cs, kind="stable")
                sorted_slots = cs[order]
                starts = np.cumsum(counts) - counts
                rank = (np.arange(len(order))
                        - np.repeat(starts, counts))
                over = rank >= admit_n[sorted_slots]
                if over.any():
                    hit = cand[order[over]]
                    shed[hit] = True
                    reasons[hit] = _R_TENANT
                self._tokens -= admit_n

        # 3) pressure tiers: sampled sheds in class cost order
        f_set, f_histo, f_gauge = _LEVEL_FRACTIONS[self.pressure.level]
        if f_set or f_histo or f_gauge:
            salt = (pb.line_off[sel] if hasattr(pb, "line_off")
                    else np.arange(len(sel)))
            h16 = _sample_hash16(kh, np.asarray(salt))
            for code_mask, frac, rcode in (
                    (codes == columnar.CODE_SET, f_set, _R_SET),
                    ((codes == columnar.CODE_TIMER)
                     | (codes == columnar.CODE_HISTOGRAM),
                     f_histo, _R_HISTO),
                    (codes == columnar.CODE_GAUGE, f_gauge, _R_GAUGE)):
                if frac <= 0.0:
                    continue
                m = code_mask & ~shed & (h16 < int(frac * 65536))
                shed |= m
                reasons[m] = rcode

        n_shed = int(shed.sum())
        if not n_shed:
            return 0, {}
        tc[sel[shed]] = columnar.CODE_SHED
        breakdown = self._breakdown(slots[shed], reasons[shed])
        self._note_shed(breakdown)
        return n_shed, breakdown

    def _resolve_tenants(self, pb, miss_lines: np.ndarray,
                         miss_keys: np.ndarray) -> None:
        """Slow-parse ONE representative line per unknown series hash
        to learn its tenant tag (the same pattern as the table's
        ``_resolve_misses``); unparseable lines attribute to the
        default tenant and fail later in the table, where they're
        counted as parse errors/overflow, not shed."""
        _, first = np.unique(miss_keys, return_index=True)
        for fp in first:
            i = int(miss_lines[fp])
            k = int(miss_keys[fp])
            try:
                s = dsd.parse_metric(pb.line(i))
                tenant = self._tenant_of_tags(s.tags)
            except dsd.ParseError:
                tenant = _TENANT_DEFAULT
            self._insert_series(k, self._slot_for_tenant(tenant))

    def _breakdown(self, slots: np.ndarray,
                   reasons: np.ndarray) -> dict:
        packed = slots.astype(np.int64) * 8 + reasons
        uniq, counts = np.unique(packed, return_counts=True)
        out = {}
        for p, n in zip(uniq, counts):
            slot, rcode = int(p) // 8, int(p) % 8
            tenant = (self._tenant_names[slot]
                      if 0 <= slot < len(self._tenant_names)
                      else _TENANT_OTHER)
            out[(tenant, _REASON_NAMES.get(rcode, "unknown"))] = int(n)
        return out

    def _note_shed(self, breakdown: dict) -> None:
        for key, n in breakdown.items():
            self.shed_total += n
            self.shed_by_total[key] = (
                self.shed_by_total.get(key, 0) + n)

    # -- scalar admission (per-line Python paths) ---------------------

    def admit_sample(self, s, table) -> tuple[bool, str, str]:
        """Scalar twin of ``admit_columns`` for the per-datagram
        Python path: returns ``(admitted, tenant, reason)``.  Runs
        under the ingest lock."""
        if s.type in ("counter", dsd.STATUS):
            return True, "", ""
        tenant = self._tenant_of_tags(s.tags)
        slot = self._slot_for_tenant(tenant)
        if self.pressure.engaged:
            idx = self._class_index(table, s.type)
            if idx is not None and (
                    (s.name, s.type, s.tags, s.scope)
                    not in idx.rows):
                self._note_shed({(tenant, REASON_FREEZE): 1})
                return False, tenant, REASON_FREEZE
        if self.buckets_enabled:
            self._refill()
            if self._tokens[slot] < 1.0:
                self._note_shed({(tenant, REASON_TENANT): 1})
                return False, tenant, REASON_TENANT
            self._tokens[slot] -= 1.0
        lvl = self.pressure.level
        if lvl:
            f_set, f_histo, f_gauge = _LEVEL_FRACTIONS[lvl]
            frac = {"set": f_set, "timer": f_histo,
                    "histogram": f_histo, "gauge": f_gauge
                    }.get(s.type, 0.0)
            if frac > 0.0:
                h = _sample_hash16(
                    np.array([hash(s.key()) & 0xFFFFFFFFFFFFFFFF],
                             np.uint64),
                    np.array([time.monotonic_ns() & 0xFFFFFFFF]))
                if int(h[0]) < int(frac * 65536):
                    reason = {"set": "pressure:set",
                              "gauge": "pressure:gauge"}.get(
                                  s.type, "pressure:histogram")
                    self._note_shed({(tenant, reason): 1})
                    return False, tenant, reason
        return True, tenant, ""

    def _known_by_class(self, pb, sel, miss, table) -> np.ndarray:
        """The new-series test for a table without a native key index
        (the mesh table): each missed line's sample key against its
        class index, as ``admit_sample`` tests it.  Lines that do not
        parse count as known (the caller's sweep counts them)."""
        known = np.ones(len(sel), bool)
        for j in np.nonzero(miss)[0]:
            try:
                s = dsd.parse_line(pb.line(int(sel[j])))
            except dsd.ParseError:
                continue
            idx = self._class_index(table, s.type)
            known[j] = idx is None or (
                (s.name, s.type, s.tags, s.scope) in idx.rows)
        return known

    @staticmethod
    def _class_index(table, mtype: str):
        attr = {"gauge": "gauge_idx", "timer": "histo_idx",
                "histogram": "histo_idx", "set": "set_idx"}.get(mtype)
        return getattr(table, attr, None) if attr else None

    # -- pressure + watchdog ------------------------------------------

    def tick(self, staging_depth: int, occupancy: float,
             flush_lag_ratio: float,
             socket_drop_delta: int) -> None:
        """Per-flush pressure update (called from the flush path)."""
        was = self.pressure.engaged
        self.pressure.update(staging_depth, occupancy,
                             flush_lag_ratio, socket_drop_delta)
        if self.pressure.engaged != was:
            log.warning(
                "overload pressure %s (score=%.2f level=%d "
                "staging=%d occupancy=%.2f lag=%.2f kernel_drops=%d)",
                "ENGAGED" if self.pressure.engaged else "released",
                self.pressure.score, self.pressure.level,
                staging_depth, occupancy,
                self.pressure.flush_lag_ewma, socket_drop_delta)

    def note_flush(self, duration_s: float, budget_s: float,
                   compiled: bool = False) -> None:
        """Flush-overrun watchdog input: a flush past its interval
        budget arms ONE coalesce for the next tick.  A flush that
        built a library (the port's nvcc or g++ builds, counted as
        ``compile_total`` in the device-cost registry) is exempt —
        warm-up is a one-time cost, not sustained overload (if the
        overrun is real it recurs on the next, compile-free flush and
        arms then)."""
        if duration_s > budget_s and not compiled:
            self.flush_overruns += 1
            if self.coalesce_enabled:
                self._coalesce_armed = True

    def take_coalesce(self) -> bool:
        """Consume the armed coalesce (the flush loop skips its swap
        once; the following flush covers both intervals)."""
        if self._coalesce_armed:
            self._coalesce_armed = False
            self.coalesced_total += 1
            return True
        return False

    # -- readers ------------------------------------------------------

    def shed_by_nested(self) -> dict:
        out: dict[str, dict[str, int]] = {}
        for (tenant, reason), n in self.shed_by_total.items():
            out.setdefault(tenant, {})[reason] = n
        return out

    def snapshot(self) -> dict:
        return {
            "admission_active": self.admission_active,
            "buckets": {
                "enabled": self.buckets_enabled,
                "tenant_tag": self.tenant_tag,
                "rate_per_s": self.tenant_rate,
                "burst": self.tenant_burst,
                "tenants": len(self._tenant_names),
                "series_mapped": len(self._slots),
            },
            "pressure": self.pressure.to_dict(),
            "shed_total": self.shed_total,
            "shed_by": self.shed_by_nested(),
            "flush_overruns": self.flush_overruns,
            "coalesced_total": self.coalesced_total,
            "coalesce_armed": self._coalesce_armed,
        }


# ---------------------------------------------------------------------
# kernel-level UDP receive drops (/proc/net/udp{,6} per-socket)

def read_kernel_drops(socks) -> dict[int, int]:
    """Cumulative kernel receive-drop count per socket inode for the
    given datagram sockets — the ``drops`` column of
    ``/proc/net/udp{,6}``.  Loss at the kernel boundary happens
    BEFORE the process sees a packet, so the server reports the
    delta as an observed-unattributed line in the interval record
    (and as ``veneur.socket.kernel_drops_total``) instead of letting
    saturation loss stay invisible.  Returns {} off-Linux."""
    import socket as socket_mod
    inodes = {}
    for s in socks:
        try:
            if s.type != socket_mod.SOCK_DGRAM or \
                    s.family not in (socket_mod.AF_INET,
                                     socket_mod.AF_INET6):
                continue
            inodes[os.fstat(s.fileno()).st_ino] = 0
        except (OSError, ValueError):
            continue
    if not inodes:
        return {}
    out: dict[int, int] = {}
    for path in ("/proc/net/udp", "/proc/net/udp6"):
        try:
            with open(path) as f:
                lines = f.readlines()[1:]
        except OSError:
            continue
        for line in lines:
            parts = line.split()
            # sl local rem st queues tr retrnsmt uid timeout inode
            # ref pointer drops
            if len(parts) < 13:
                continue
            try:
                inode = int(parts[9])
                drops = int(parts[12])
            except ValueError:
                continue
            if inode in inodes:
                out[inode] = drops
    return out
