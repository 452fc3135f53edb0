"""YAML configuration: the subset of the reference's keys this port runs.

Port of ``veneur_tpu/core/config.py``.  Key names are the reference's,
so one YAML file drives either server.  A key this port does not know
is refused with an error naming it — never silently ignored, since a
setting the port would not honour must not look accepted.  The
reference's ``VENEUR_<KEY>`` environment overrides apply to the keys in
``_ENV_KEYS``.
"""

from __future__ import annotations

import os
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
    # samples per row per digest merge (the table's histo_slots)
    tpu_histo_slots: int = 512
    # a datagram longer than this is rejected whole as a packet error
    metric_max_length: int = 4096
    # datagrams a reader drains per batch (one recvmmsg sweep, <= 512)
    reader_batch_packets: int = 512
    # UDP reader threads per statsd address (SO_REUSEPORT sockets when
    # more than one)
    num_readers: int = 1
    # with num_readers > 1, each reader runs the fused native parse +
    # probe + combine without the lock into a ReaderShard and merges
    # under it; false: the split columnar parse outside the lock and
    # ingest_columns under it
    tpu_multi_reader_fused: bool = True
    # reader i pinned to one core: "auto" (core i when there are at
    # least as many cores as readers), "off", or a comma list of cores
    tpu_reader_pin_cores: str = "auto"
    # staged samples that trigger a mid-interval device step
    tpu_stage_flush_samples: int = 65536
    # detach staged work under the ingest lock and apply it outside it
    # (the flush waits for every pending apply); false: the step runs
    # inline under the lock
    tpu_pipeline: bool = True
    # emit the flush as a columnar MetricFrame (false: the per-row
    # emit)
    tpu_columnar_emit: bool = True
    # HTTP listener ("host:port"): /healthcheck, /debug/vars and
    # POST /import
    http_address: str = ""
    # gRPC listeners ("tcp://host:port"): forward import, DogStatsD
    # packets and grpc health on one port each
    grpc_listen_addresses: list[str] = field(default_factory=list)
    # deprecated single-listener alias of grpc_listen_addresses
    # (reference config.go GrpcAddress), folded in by resolve_aliases
    grpc_address: str = ""
    # a global's address: set, this node is a local and sends its
    # mergeable state there after every flush
    forward_address: str = ""
    # send it as a gRPC MetricList (forward_address is host:port) instead
    # of an HTTP /import POST
    forward_use_grpc: bool = False
    # the /import body a local sends: "native" (carries scope) or
    # "reference" (the Go JSONMetric wire: gob digests)
    forward_json_schema: str = "native"
    # t-digest compression of the histogram planes
    tpu_compression: float = 100.0
    # -- self-observation (the reference's keys and defaults) ---------
    # self-telemetry: DogStatsD datagrams to this host:port (or
    # udp://host:port); empty injects them into the server's own table
    stats_address: str = ""
    # scope of the server's own metrics by type ({counter: local |
    # global | default, gauge: ..., ...}) and extra tags on them
    veneur_metrics_scopes: dict = field(default_factory=dict)
    veneur_metrics_additional_tags: list[str] = field(
        default_factory=list)
    # a torch.profiler trace (CPU and CUDA) for the process lifetime,
    # written to ./torch_profile/trace.json at shutdown
    enable_profiling: bool = False
    # an imbalanced conservation-ledger interval logs an ERROR instead
    # of a warning (it bumps ledger_imbalance either way)
    tpu_ledger_strict: bool = False
    # stamp the flush cycle's (trace_id, span_id) onto forward wires
    # and parent import spans under the remote forward span
    tpu_trace_propagation: bool = True
    # rows of the per-flush signal history (/debug/signals); 0 disables
    # it and the flight recorder
    tpu_signal_history: int = 512
    # flight-recorder bundles: directory (empty: a bounded in-memory
    # store), retention by count and bytes, per-trigger cooldown
    tpu_flight_dir: str = ""
    tpu_flight_max_bundles: int = 64
    tpu_flight_max_bytes: int = 67108864
    tpu_flight_cooldown: str = "30s"
    # /debug/cluster peers ("host:port,...")
    tpu_cluster_peers: str = ""

    def interval_seconds(self) -> float:
        return parse_duration(self.interval)

    def is_local(self) -> bool:
        """A node with a forward destination is a local (reference
        server.go:1609 IsLocal)."""
        return bool(self.forward_address)

    def resolve_aliases(self) -> None:
        """Fold the deprecated ``grpc_address`` into
        ``grpc_listen_addresses`` when that is still empty."""
        if self.grpc_address and not self.grpc_listen_addresses:
            addr = self.grpc_address
            if "://" not in addr:
                addr = "tcp://" + addr
            self.grpc_listen_addresses = [addr]

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
                  "tpu_set_rows", "tpu_histo_slots", "metric_max_length",
                  "reader_batch_packets", "tpu_stage_flush_samples"):
            if getattr(self, n) <= 0:
                problems.append(f"{n} must be positive")
        pin = self.tpu_reader_pin_cores
        if pin not in ("auto", "off"):
            try:
                cores = [int(c) for c in pin.split(",") if c.strip()]
                if not cores or any(c < 0 for c in cores):
                    raise ValueError
            except ValueError:
                problems.append(
                    "tpu_reader_pin_cores must be auto, off or a "
                    "comma list of core ids")
        for addr in self.statsd_listen_addresses:
            if not addr.startswith("udp://"):
                problems.append(
                    f"only udp:// statsd listeners are supported: {addr}")
        for addr in self.grpc_listen_addresses:
            if not addr.startswith("tcp://"):
                problems.append(
                    f"grpc listener must be tcp://: {addr}")
        if self.forward_json_schema not in ("reference", "native"):
            problems.append(
                "forward_json_schema must be 'reference' or 'native'")
        if "," in self.forward_address:
            problems.append("forward_address takes one destination")
        if self.http_address and not self.http_address.rpartition(
                ":")[2].isdigit():
            problems.append(
                f"http_address needs host:port: {self.http_address}")
        if self.tpu_compression <= 0:
            problems.append("tpu_compression must be positive")
        for scope_type, scope in self.veneur_metrics_scopes.items():
            if scope_type not in ("counter", "gauge", "histogram",
                                  "set", "status"):
                problems.append(
                    f"veneur_metrics_scopes: unknown type "
                    f"{scope_type!r}")
            if scope not in ("local", "global", "default"):
                problems.append(
                    f"veneur_metrics_scopes: unknown scope {scope!r}")
        try:
            parse_duration(self.tpu_flight_cooldown)
        except ValueError as e:
            problems.append(f"tpu_flight_cooldown: {e}")
        if self.tpu_signal_history < 0:
            problems.append("tpu_signal_history must be >= 0")
        return problems


# keys the reference lets VENEUR_<KEY upper-cased> override, among those
# the port runs
_ENV_KEYS = ("tpu_pipeline", "tpu_multi_reader_fused",
             "tpu_reader_pin_cores", "tpu_columnar_emit",
             "stats_address", "veneur_metrics_scopes",
             "veneur_metrics_additional_tags", "enable_profiling", "tpu_ledger_strict",
             "tpu_trace_propagation", "tpu_signal_history",
             "tpu_flight_dir", "tpu_flight_max_bundles",
             "tpu_flight_max_bytes", "tpu_flight_cooldown",
             "tpu_cluster_peers")


def _coerce(name: str, raw: str):
    """An environment string as the field's type (the reference's
    ``_coerce``, for the types of ``_ENV_KEYS``)."""
    current = getattr(Config(), name)
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, list):
        return [x.strip() for x in raw.split(",") if x.strip()]
    if isinstance(current, dict):
        # "k1:v1,k2:v2"
        out = {}
        for item in raw.split(","):
            if item.strip():
                k, _, v = item.partition(":")
                out[k.strip()] = v.strip()
        return out
    return raw


def read_config(path: str | None = None, data: dict | None = None,
                env: dict | None = None) -> Config:
    """Load a YAML file (and/or a dict), refuse unknown keys, apply the
    environment overrides (``env``, default ``os.environ``), validate."""
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
    env = os.environ if env is None else env
    for name in _ENV_KEYS:
        env_key = "VENEUR_" + name.upper()
        if env_key in env:
            setattr(cfg, name, _coerce(name, env[env_key]))
    cfg.resolve_aliases()
    problems = cfg.validate()
    if problems:
        raise ValueError("; ".join(problems))
    return cfg
