"""Per-node signal history: one fixed-schema row per flush seal.

The port's copy of ``veneur_tpu/observe/signals.py``.

Every observability surface before this module was a point-in-time
snapshot (``/debug/vars``, ``/debug/overload``) or an unindexed ring
(``/debug/ledger``, ``/debug/flushes``).  A control loop — and an
operator riding an incident — needs *history*: rates, derivatives,
and the shape of the last N intervals, per SALSA's
self-adjusting-from-observed-signals design (arxiv 2102.12531).

``SignalHistory`` is a bounded columnar ring: float64 column per
signal × the last ``capacity`` intervals (``VENEUR_TPU_SIGNAL_HISTORY``
rows, default 512).  The schema is FIXED at construction — the
sampler always provides every signal (0.0 when a subsystem is
disabled), so a column never appears or vanishes mid-history and a
scraper can index by position.  At every append the ring also
computes, per signal:

- ``delta``: value minus the previous row's value (0 on the first
  row) — the per-interval derivative of a cumulative counter;
- ``rate``: an EWMA (``alpha`` = 0.3) of delta/dt in per-second
  units — the smoothed rate an autopilot thresholds on without
  re-deriving it from raw history.

Served at ``/debug/signals?window=<sec>`` as compact columnar JSON
(one array per signal, not one object per row) on BOTH the server and
the proxy (the proxy samples its ProxyLedger/destpool signal set at
its discovery-refresh cadence).  ``summary()`` is the one-row shape
``vtop`` and ``/debug/cluster`` scrape.

The module is deliberately numpy-only (no torch): a pure-proxy process
imports it without pulling a device runtime.
"""

from __future__ import annotations

import json
import math
import threading
import time

import numpy as np

DEFAULT_CAPACITY = 512
DEFAULT_ALPHA = 0.3


def _col(arr) -> list:
    """A float column as a JSON-safe list: non-finite -> None,
    everything else rounded to keep the columnar dump compact."""
    out = []
    for v in arr:
        if not math.isfinite(v):
            out.append(None)
        elif v == int(v) and abs(v) < 2**53:
            out.append(int(v))
        else:
            out.append(round(float(v), 6))
    return out


class SignalHistory:
    """Bounded columnar ring of signal rows with at-append EWMA rate
    and delta columns.  Thread-safe; appends are a vectorized numpy
    write under a lock."""

    def __init__(self, schema, capacity: int = DEFAULT_CAPACITY,
                 node: str = "", role: str = "",
                 alpha: float = DEFAULT_ALPHA):
        self.schema = tuple(schema)
        if not self.schema:
            raise ValueError("signal schema must not be empty")
        self.node = node
        self.role = role
        self.alpha = float(alpha)
        self._cap = max(2, int(capacity))
        n = len(self.schema)
        self._idx = {name: i for i, name in enumerate(self.schema)}
        self._lock = threading.Lock()
        # columnar storage: (capacity, n_signals) per plane
        self._vals = np.zeros((self._cap, n), dtype=np.float64)
        self._deltas = np.zeros((self._cap, n), dtype=np.float64)
        self._rates = np.zeros((self._cap, n), dtype=np.float64)
        self._t = np.zeros(self._cap, dtype=np.float64)
        self._seq = np.zeros(self._cap, dtype=np.int64)
        self._count = 0          # rows currently retained
        self._head = 0           # next write slot
        self._prev: np.ndarray | None = None
        self._prev_t = 0.0
        self._ewma = np.zeros(n, dtype=np.float64)
        self.appended_total = 0  # lifetime rows (monotone)

    # -- write ---------------------------------------------------------

    def append(self, row: dict, t: float | None = None,
               seq: int = 0) -> None:
        """Append one row.  ``row`` maps signal name -> value; a name
        missing from the fixed schema is ignored, a schema name
        missing from the row records NaN (rendered null)."""
        t = time.time() if t is None else float(t)
        vec = np.full(len(self.schema), np.nan, dtype=np.float64)
        for name, v in row.items():
            i = self._idx.get(name)
            if i is not None:
                try:
                    vec[i] = float(v)
                except (TypeError, ValueError):
                    pass
        with self._lock:
            if self._prev is None:
                delta = np.zeros_like(vec)
                dt = 0.0
            else:
                delta = np.where(
                    np.isfinite(vec) & np.isfinite(self._prev),
                    vec - self._prev, 0.0)
                dt = max(t - self._prev_t, 1e-9)
            if dt > 0.0:
                inst = delta / dt
                self._ewma = (self.alpha * inst
                              + (1.0 - self.alpha) * self._ewma)
            h = self._head
            self._vals[h] = vec
            self._deltas[h] = delta
            self._rates[h] = self._ewma
            self._t[h] = t
            self._seq[h] = int(seq)
            self._head = (h + 1) % self._cap
            self._count = min(self._count + 1, self._cap)
            self._prev = vec
            self._prev_t = t
            self.appended_total += 1

    # -- read ----------------------------------------------------------

    def _order(self) -> np.ndarray:
        """Retained row slots, oldest -> newest (caller holds lock)."""
        if self._count < self._cap:
            return np.arange(self._count)
        return (np.arange(self._cap) + self._head) % self._cap

    def rows(self) -> int:
        with self._lock:
            return self._count

    def window(self, seconds: float = 0.0,
               limit: int = 0) -> dict:
        """Columnar slice of the last ``seconds`` of history (all
        retained rows when <= 0), newest-last; ``limit`` further caps
        to the newest N rows (the flight recorder's last-K slice)."""
        with self._lock:
            order = self._order()
            t = self._t[order]
            if seconds > 0.0 and len(order):
                order = order[t >= (time.time() - seconds)]
            if limit > 0:
                order = order[-limit:]
            vals = self._vals[order]
            deltas = self._deltas[order]
            rates = self._rates[order]
            out = {
                "node": self.node,
                "role": self.role,
                "capacity": self._cap,
                "rows": int(len(order)),
                "appended_total": self.appended_total,
                "alpha": self.alpha,
                "unix": _col(self._t[order]),
                "seq": [int(s) for s in self._seq[order]],
                "signals": {
                    name: {"v": _col(vals[:, i]),
                           "d": _col(deltas[:, i]),
                           "r": _col(rates[:, i])}
                    for i, name in enumerate(self.schema)},
            }
        return out

    def latest(self) -> dict | None:
        """The newest row as {name: value} (None before any append)."""
        with self._lock:
            if not self._count:
                return None
            h = (self._head - 1) % self._cap
            return {name: (None if not math.isfinite(self._vals[h, i])
                           else float(self._vals[h, i]))
                    for i, name in enumerate(self.schema)}

    def summary(self) -> dict:
        """One-row fleet-scrape shape: latest values + EWMA rates —
        what ``vtop`` and ``/debug/cluster`` consume."""
        with self._lock:
            out = {
                "node": self.node,
                "role": self.role,
                "rows": self._count,
                "appended_total": self.appended_total,
            }
            if not self._count:
                out.update({"unix": None, "seq": None,
                            "signals": {}, "rates": {}})
                return out
            h = (self._head - 1) % self._cap
            out["unix"] = round(float(self._t[h]), 3)
            out["seq"] = int(self._seq[h])
            out["signals"] = {
                name: (None if not math.isfinite(self._vals[h, i])
                       else (int(self._vals[h, i])
                             if self._vals[h, i] == int(self._vals[h, i])
                             and abs(self._vals[h, i]) < 2**53
                             else round(float(self._vals[h, i]), 6)))
                for i, name in enumerate(self.schema)}
            out["rates"] = {
                name: round(float(self._ewma[i]), 6)
                for i, name in enumerate(self.schema)}
            return out

    def to_json(self, seconds: float = 0.0) -> bytes:
        return json.dumps(self.window(seconds),
                          separators=(",", ":")).encode()
