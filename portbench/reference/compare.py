"""A flush held against ``expected``.

The numbers compared, each against a limit (``portbench/limits/``):

- ``exact_off``: values that must be exact and are not, summed over the
  intervals compared: a series missing from the flush or one it should
  not hold, a counter not its sum, a gauge not among its last writes, a
  timer's ``.count``, ``.min`` or ``.max`` not its samples', the marker
  not the interval's, and an interval whose ledger record is unsealed,
  unbalanced, or received other than the samples or items acknowledged;
- ``pct_err_median`` and ``pct_err_max``: the median and the largest
  relative error of every percentile against the exact quantile;
- ``set_err_max``: the largest relative error of a set's cardinality
  against its distinct members.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from reference.expected import MARKER, Expected, key, percentile_suffix

SELF_PREFIX = "veneur."  # the node's own telemetry, not the traffic's


@dataclass
class Readings:
    exact: dict = field(default_factory=lambda: dict.fromkeys(
        ("missing", "extra", "counter", "gauge", "aggregate", "marker",
         "ledger"), 0))
    pct_err: list = field(default_factory=list)
    set_err: list = field(default_factory=list)

    def numbers(self) -> dict:
        """The numbers compared; None where nothing could be compared
        (which fails any limit)."""
        pe = np.concatenate(self.pct_err) if self.pct_err else np.empty(0)
        se = np.concatenate(self.set_err) if self.set_err else np.empty(0)
        return {
            "exact_off": int(sum(self.exact.values())),
            "pct_err_median": float(np.median(pe)) if len(pe) else None,
            "pct_err_max": float(pe.max()) if len(pe) else None,
            "set_err_max": float(se.max()) if len(se) else None,
        }


def flush_values(packed) -> dict:
    """``{(name, sorted tags): value}`` of a packed flush: a key a
    metric (its sorted tags, then its name, joined by NUL) and a value
    array (``pbench.framesink.pack``)."""
    out = {}
    for k, v in zip(packed[0], packed[1].tolist()):
        *tags, name = k.split("\0")
        out[(name, tuple(tags))] = v
    return out


def compare_interval(got: dict, ex: Expected, interval: int,
                     ledger_ok: bool, r: Readings) -> None:
    """Add one interval's flush ``got`` (``flush_values``) to ``r``."""
    e = r.exact
    seen = set()

    def take(k):
        seen.add(k)
        v = got.get(k)
        if v is None:
            e["missing"] += 1
        return v

    for k, want in ex.counters.items():
        v = take(k)
        e["counter"] += int(v is not None and v != want)
    for k, allowed in ex.gauges.items():
        v = take(k)
        e["gauge"] += int(v is not None and v not in allowed)
    v = take(key(MARKER, ()))
    e["marker"] += int(v is not None and v != float(interval + 1))
    suffixes = [percentile_suffix(p) for p in ex.percentiles]
    for t in ex.timers:
        if t.aggregates:
            for agg, want in (("count", t.count), ("min", t.vmin),
                              ("max", t.vmax)):
                if agg not in ex.aggregates:
                    continue
                vals = [take((n + "." + agg, tags)) for n, tags in t.names]
                e["aggregate"] += sum(1 for v, w in zip(vals, want.tolist())
                                      if v is not None and v != w)
        for pi, suf in enumerate(suffixes):
            vals = np.array([np.nan if v is None else v for v in (
                take((n + suf, tags)) for n, tags in t.names)])
            ok = ~np.isnan(vals)
            want = t.quantiles[ok, pi]
            r.pct_err.append(np.abs(vals[ok] - want)
                             / np.maximum(np.abs(want), 1e-12))
    for k, want in ex.sets.items():
        v = take(k)
        if v is not None:
            r.set_err.append(np.array([abs(v - want) / max(want, 1)]))
    e["extra"] += sum(1 for k in got if k not in seen
                      and not k[0].startswith(SELF_PREFIX))
    e["ledger"] += int(not ledger_ok)


def ledger_ok(rec, protocol: str, acknowledged: int) -> bool:
    """The interval's ledger record (``observe/ledger.py``): sealed,
    balanced, and what it received over the traffic's protocol is what
    was acknowledged (the node's own telemetry arrives under another)."""
    return (rec is not None and rec.sealed and rec.balanced
            and rec.received.get(protocol, 0) == acknowledged)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: [number, limit]})."""
    out = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name)
        out[name] = [v, limit]
        if v is None or v > limit:
            ok = False
    return ok, out
