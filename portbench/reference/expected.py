"""What one interval must flush, worked out from a traffic plan.

Veneur's flush, as a user reads it:
- a counter: the sum of its samples (DogStatsD parses each value to a
  float32 addend; the sum is read out as a float32);
- a gauge: the last value written, as a float32.  Several readers (or
  several locals) write concurrently, so the last write is one of the
  values each writer wrote last;
- a timer: ``.min``, ``.max``, ``.count`` and the configured
  percentiles of its samples (percentiles against the exact quantile
  of the float32 samples, linear between order statistics).  A global
  emits only the percentiles of a series of mixed scope: its
  aggregates are the locals' to emit;
- a set: the number of distinct members;
- ``portbench.interval``: the benchmark's marker counter, the
  interval's number plus one, so a stale flush cannot pass.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from pbench import plan as planmod

MARKER = "portbench.interval"


def percentile_suffix(p: float) -> str:
    """``.50percentile`` for 0.5, ``.999percentile`` for 0.999."""
    scaled = p * 100
    if abs(scaled - round(scaled)) < 1e-9:
        return f".{int(round(scaled))}percentile"
    return "." + str(scaled).replace(".", "") + "percentile"


def key(name: str, tags) -> tuple[str, tuple[str, ...]]:
    return name, tuple(sorted(tags))


@dataclass
class Timers:
    """The timer series of one class and what each must read."""
    names: list[tuple[str, tuple[str, ...]]]
    aggregates: bool
    count: np.ndarray
    vmin: np.ndarray
    vmax: np.ndarray
    quantiles: np.ndarray   # (series, percentiles)


@dataclass
class Expected:
    percentiles: tuple[float, ...]
    aggregates: tuple[str, ...]
    counters: dict = field(default_factory=dict)
    gauges: dict = field(default_factory=dict)
    timers: list[Timers] = field(default_factory=list)
    sets: dict = field(default_factory=dict)


def f32(x) -> np.ndarray:
    return np.asarray(x, np.float64).astype(np.float32).astype(np.float64)


def exact_quantiles(series: np.ndarray, values: np.ndarray, n_series: int,
                    ps: tuple[float, ...]) -> np.ndarray:
    """(n_series, len(ps)) exact quantiles, linear between order
    statistics, of each series' values."""
    out = np.full((n_series, len(ps)), np.nan)
    order = np.lexsort((values, series))
    sv = values[order]
    counts = np.bincount(series, minlength=n_series)
    starts = np.cumsum(counts) - counts
    for c in np.unique(counts[counts > 0]):
        rows = np.nonzero(counts == c)[0]
        mat = sv[starts[rows][:, None] + np.arange(c)[None, :]]
        out[rows] = np.quantile(mat, ps, axis=1, method="linear").T
    return out


def _timers(names: planmod.SeriesNames, series: np.ndarray,
            values: np.ndarray, ps, aggregates: bool) -> Timers:
    S = names.n_series
    v = f32(values)
    count = np.bincount(series, minlength=S).astype(np.float64)
    vmin = np.full(S, np.inf)
    vmax = np.full(S, -np.inf)
    np.minimum.at(vmin, series, v)
    np.maximum.at(vmax, series, v)
    return Timers([key(names.name(j), names.tags(j)) for j in range(S)],
                  aggregates, count, vmin, vmax,
                  exact_quantiles(series, v, S, ps))


def _distinct(series: np.ndarray, members: np.ndarray, S: int) -> np.ndarray:
    pairs = np.unique(np.stack([series, members]), axis=1)
    return np.bincount(pairs[0], minlength=S)


def dogstatsd_expected(plan: planmod.DsdPlan, ps, aggregates) -> Expected:
    """A node that takes DogStatsD and forwards nothing: every timer
    emits its aggregates and percentiles."""
    ex = Expected(tuple(ps), tuple(aggregates))
    F = plan.feeders
    for c in plan.classes:
        S = c.names.n_series
        if c.type == "counter":
            sums = f32(np.bincount(c.series, weights=f32(c.values.value),
                                   minlength=S))
            for j in range(S):
                ex.counters[key(c.names.name(j), c.names.tags(j))] = sums[j]
        elif c.type == "gauge":
            # each feeder's last write of each series, in send order
            who = c.series * F + plan.feeder_of(c.pos)
            order = np.argsort(c.pos)
            rank = np.empty(len(order), np.int64)
            rank[order] = np.arange(len(order))
            last = np.full(S * F, -1, np.int64)
            np.maximum.at(last, who, rank)
            vals = f32(c.values.value)
            for j in range(S):
                ranks = last[j * F:(j + 1) * F]
                ex.gauges[key(c.names.name(j), c.names.tags(j))] = frozenset(
                    vals[order[ranks[ranks >= 0]]].tolist())
        elif c.type == "timer":
            ex.timers.append(_timers(c.names, c.series, c.values.value, ps,
                                     True))
        elif c.type == "set":
            d = _distinct(c.series, c.values.text, S)
            for j in range(S):
                ex.sets[key(c.names.name(j), c.names.tags(j))] = int(d[j])
        else:
            raise ValueError(f"unknown class type {c.type!r}")
    return ex


def fleet_expected(traffic: dict, seed: int, ps, aggregates,
                   scale: int = 1, keep: float | None = None) -> Expected:
    """A global that imports every local's wire once an interval.  With
    ``keep``, only that share of each local's samples, drawn from the
    seed (the control's broken guarantee)."""
    ex = Expected(tuple(ps), tuple(aggregates))
    per_class: list[list] = []
    for i in range(int(traffic["locals"])):
        for ci, c in enumerate(planmod.fleet_local(traffic, seed, i, scale)):
            if keep is not None:
                m = planmod.rng_for(seed, 78, i, ci).random(
                    len(c.series)) < keep
                v = c.values
                c = planmod.FleetClass(c.type, c.scope, c.names, c.series[m],
                                       planmod.Values(v.text[m], v.decimals,
                                                      v.value[m]))
            if len(per_class) <= ci:
                per_class.append([c, [], []])
            S = c.names.n_series
            if c.type == "counter":
                per_class[ci][1].append(np.bincount(
                    c.series, weights=c.values.text, minlength=S))
            elif c.type == "gauge":
                per_class[ci][1].append(c.values.value[
                    planmod.last_per_series(c.series, S)])
            else:
                per_class[ci][1].append(c.series)
                per_class[ci][2].append(
                    c.values.text if c.type == "set" else c.values.value)
    for c, a, b in per_class:
        S = c.names.n_series
        keys = [key(c.names.name(j), c.names.tags(j)) for j in range(S)]
        if c.type == "counter":
            sums = f32(np.sum(a, axis=0))
            ex.counters.update(zip(keys, sums.tolist()))
        elif c.type == "gauge":
            vals = f32(np.stack(a))
            for j, k in enumerate(keys):
                ex.gauges[k] = frozenset(vals[:, j].tolist())
        elif c.type == "timer":
            ex.timers.append(_timers(c.names, np.concatenate(a),
                                     np.concatenate(b), ps,
                                     c.scope == "global"))
        elif c.type == "set":
            d = _distinct(np.concatenate(a), np.concatenate(b), S)
            ex.sets.update(zip(keys, d.tolist()))
        else:
            raise ValueError(f"unknown class type {c.type!r}")
    return ex
