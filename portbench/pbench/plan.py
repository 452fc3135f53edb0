"""One interval of traffic drawn from a seed.

A traffic file (``portbench/traffic/<name>.json``) lists classes of
series; ``dogstatsd_plan`` and ``fleet_plan`` turn it and a seed into
arrays: every sample's series, its value as written on the wire and as
DogStatsD's decimal parse reads it, and (DogStatsD) its position in the
interval's line order.  The program gets these as text or forward
wires (``pbench.dsd``, ``pbench.wire``); the plain reference
(``reference/``) gets the arrays.

Every seed gives the same sizes: each series of a class takes
``samples // series`` or one more sample, the first ``samples %
series`` series the extra one; only values and order follow the seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

TYPE_CODE = {"counter": b"c", "gauge": b"g", "timer": b"ms", "set": b"s"}


def seed_key(seed: int) -> int:
    """A seed as the non-negative integer numpy's SeedSequence takes
    (a seed may pass 32 bits)."""
    return int(seed) % (1 << 63)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed_key(seed), *stream])


@dataclass
class Values:
    """Drawn values: ``text`` is what the wire writes (an integer, the
    value scaled by ``10**decimals``, or a set member), ``value`` what
    DogStatsD's parse reads back in float64 (NaN for set members)."""
    text: np.ndarray
    decimals: int
    value: np.ndarray


def parse_decimal(m: np.ndarray, decimals: int) -> np.ndarray:
    """The value of ``m / 10**decimals`` written with all its decimals,
    as DogStatsD's parse reads it: integer part plus the fraction's
    digits over the power of ten, in float64."""
    a = np.abs(m)
    if decimals == 0:
        v = a.astype(np.float64)
    else:
        p = 10 ** decimals
        v = (a // p).astype(np.float64) + (a % p).astype(np.float64) / float(p)
    return np.where(m < 0, -v, v)


def draw_values(rng: np.random.Generator, spec: dict, n: int) -> Values:
    dist = spec["dist"]
    if dist == "integers":
        t = rng.integers(spec["low"], spec["high"], n, dtype=np.int64)
        return Values(t, 0, t.astype(np.float64))
    if dist == "members":
        t = rng.integers(0, 1 << 62, n, dtype=np.int64)
        return Values(t, 0, np.full(n, np.nan))
    if dist == "gamma":
        v = rng.gamma(spec["shape"], spec["scale"], n)
    elif dist == "normal":
        v = rng.normal(spec["loc"], spec["scale"], n)
    else:
        raise ValueError(f"unknown value distribution {dist!r}")
    d = int(spec.get("decimals", 3))
    m = np.rint(v * 10.0 ** d).astype(np.int64)
    if dist == "gamma":
        # positive by nature: a draw that rounds to zero is written as
        # the smallest step (a zero would give an infinite reciprocal)
        m = np.maximum(m, 1)
    return Values(m, d, parse_decimal(m, d))


def balanced_series(n: int, n_series: int) -> np.ndarray:
    """Series of ``n`` samples over ``n_series`` series, every seed the
    same sizes."""
    return np.arange(n, dtype=np.int64) % n_series


@dataclass
class SeriesNames:
    """The identities of one class: series ``j`` is named
    ``prefix + str(j // tag_values)`` and, with ``tag_values`` > 1,
    tagged ``tag_key:(j % tag_values)`` after the traffic's tags."""
    prefix: str
    n_series: int
    tag_values: int
    tag_key: str
    common_tags: tuple[str, ...]

    def name(self, j: int) -> str:
        return f"{self.prefix}{j // self.tag_values}"

    def tags(self, j: int) -> tuple[str, ...]:
        if self.tag_values > 1:
            return self.common_tags + (f"{self.tag_key}:{j % self.tag_values}",)
        return self.common_tags


def series_names(traffic: dict, cls: dict) -> SeriesNames:
    return SeriesNames(cls["prefix"], int(cls["series"]),
                       int(cls.get("tag_values", 1)),
                       cls.get("tag_key", "shard"),
                       tuple(traffic.get("tags", ())))


@dataclass
class DsdClass:
    """One class of a DogStatsD interval: every sample's series, value
    and line position."""
    type: str
    names: SeriesNames
    series: np.ndarray
    values: Values
    pos: np.ndarray


@dataclass
class DsdPlan:
    classes: list[DsdClass]
    n_lines: int
    lines_per_sweep: int
    feeders: int

    def feeder_of(self, pos: np.ndarray) -> np.ndarray:
        """The feeder that sends the line at each position: sweeps are
        dealt round robin."""
        return (pos // self.lines_per_sweep) % self.feeders

    def n_sweeps(self) -> int:
        return -(-self.n_lines // self.lines_per_sweep)


def reader_shape(server: dict) -> tuple[int, int]:
    """(feeders, datagrams a sweep) for a node's settings: one feeder a
    reader shard (``num_readers``), each handing over sweeps as full as
    a UDP reader's recvmmsg sweep under load (``reader_batch_packets``
    less one datagrams)."""
    return int(server["num_readers"]), int(server["reader_batch_packets"]) - 1


def dogstatsd_plan(traffic: dict, server: dict, seed: int,
                   scale: int = 1) -> DsdPlan:
    """One interval of DogStatsD lines for a node with the settings
    ``server``.  ``scale`` divides every count (series and samples) for
    tests at a small size."""
    rng = rng_for(seed, 0)
    classes = []
    for ci, cls in enumerate(traffic["classes"]):
        names = series_names(traffic, cls)
        names.n_series = max(1, names.n_series // scale)
        n = max(1, int(cls["samples"]) // scale)
        vals = draw_values(rng_for(seed, 1, ci), cls["values"], n)
        classes.append(DsdClass(cls["type"], names,
                                balanced_series(n, names.n_series), vals,
                                np.empty(0, np.int64)))
    total = sum(len(c.series) for c in classes)
    order = rng.permutation(total)
    off = 0
    for c in classes:
        c.pos = order[off:off + len(c.series)]
        off += len(c.series)
    feeders, dgrams = reader_shape(server)
    per_sweep = int(traffic["lines_per_datagram"]) * dgrams
    return DsdPlan(classes, total, per_sweep, feeders)


@dataclass
class FleetClass:
    """One class of one local's interval: series and values of every
    sample, in the local's order."""
    type: str
    scope: str
    names: SeriesNames
    series: np.ndarray
    values: Values


def fleet_local(traffic: dict, seed: int, local: int,
                scale: int = 1) -> list[FleetClass]:
    """Local ``local``'s interval, drawn from its own stream."""
    out = []
    for ci, cls in enumerate(traffic["classes"]):
        names = series_names(traffic, cls)
        names.n_series = max(1, names.n_series // scale)
        n = max(1, int(cls["samples_per_local"]) // scale)
        vals = draw_values(rng_for(seed, 2, local, ci), cls["values"], n)
        out.append(FleetClass(cls["type"], cls.get("scope", "mixed"), names,
                              balanced_series(n, names.n_series), vals))
    return out


def last_per_series(series: np.ndarray, n_series: int) -> np.ndarray:
    """Index of each series' last sample (-1 where it has none)."""
    last = np.full(n_series, -1, np.int64)
    idx = np.arange(len(series), dtype=np.int64)
    np.maximum.at(last, series, idx)
    return last
