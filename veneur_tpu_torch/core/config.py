"""YAML configuration: the subset of the reference's keys this port runs.

Port of ``veneur_tpu/core/config.py``.  Key names are the reference's,
so one YAML file drives either server.  A key this port does not know
is refused with an error naming it — never silently ignored, since a
setting the port would not honour must not look accepted.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field, fields

_DURATION_RE = re.compile(r"^\s*([\d.]+)\s*(ms|s|m|h|us)?\s*$")
_DURATION_UNITS = {"us": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0,
                   "h": 3600.0, None: 1.0}


def parse_duration(text: str | float | int) -> float:
    """'10s' / '50ms' / 10 -> seconds."""
    if isinstance(text, (int, float)):
        return float(text)
    m = _DURATION_RE.match(text)
    if not m:
        raise ValueError(f"bad duration: {text!r}")
    return float(m.group(1)) * _DURATION_UNITS[m.group(2)]


@dataclass
class Config:
    hostname: str = ""
    interval: str = "10s"
    statsd_listen_addresses: list[str] = field(default_factory=list)
    flush_file: str = ""
    flush_file_format: str = "native"
    percentiles: list[float] = field(
        default_factory=lambda: [0.5, 0.75, 0.99])
    aggregates: list[str] = field(
        default_factory=lambda: ["min", "max", "count"])
    tpu_counter_rows: int = 16384
    tpu_gauge_rows: int = 16384
    tpu_histo_rows: int = 16384
    tpu_set_rows: int = 1024

    def interval_seconds(self) -> float:
        return parse_duration(self.interval)

    def validate(self) -> list[str]:
        problems = []
        try:
            if self.interval_seconds() <= 0:
                problems.append("interval must be positive")
        except ValueError as e:
            problems.append(str(e))
        for p in self.percentiles:
            if not (0.0 < p < 1.0):
                problems.append(f"percentile out of range: {p}")
        known_aggs = {"min", "max", "median", "avg", "count", "sum",
                      "hmean"}
        for a in self.aggregates:
            if a not in known_aggs:
                problems.append(f"unknown aggregate: {a}")
        if self.flush_file_format not in ("native", "reference"):
            problems.append(
                "flush_file_format must be 'native' or 'reference'")
        for n in ("tpu_counter_rows", "tpu_gauge_rows", "tpu_histo_rows",
                  "tpu_set_rows"):
            if getattr(self, n) <= 0:
                problems.append(f"{n} must be positive")
        for addr in self.statsd_listen_addresses:
            if not addr.startswith("udp://"):
                problems.append(
                    f"only udp:// statsd listeners are supported: {addr}")
        return problems


def read_config(path: str | None = None,
                data: dict | None = None) -> Config:
    """Load a YAML file (and/or a dict), refuse unknown keys, validate."""
    known = {f.name for f in fields(Config)}
    raw: dict = {}
    if path is not None:
        with open(path) as f:
            text = f.read()
        try:
            import yaml
        except ImportError:
            # JSON is a subset of YAML: a JSON-written config loads
            # where PyYAML is not installed
            import json
            raw = json.loads(text) if text.strip() else {}
        else:
            raw = yaml.safe_load(text) or {}
    if data:
        raw.update(data)
    unknown = sorted(k for k in raw if k not in known)
    if unknown:
        raise ValueError(f"config keys not supported by this port: "
                         f"{unknown}")
    cfg = Config()
    for key, value in raw.items():
        if value is not None:
            setattr(cfg, key, value)
    problems = cfg.validate()
    if problems:
        raise ValueError("; ".join(problems))
    return cfg
