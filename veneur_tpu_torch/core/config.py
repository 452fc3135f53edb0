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

from veneur_tpu_torch.protocol import addr as addrmod

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
    # common tags on every flushed metric ("k:v" or bare) and, as a
    # map of the "k:v" ones, on every span that lacks the key
    tags: list[str] = field(default_factory=list)
    interval: str = "10s"
    # debug-level logging
    debug: bool = False
    # the flush watchdog: this many intervals without a flush and the
    # process exits (code 2) for its supervisor to restart it; 0: off
    flush_watchdog_missed_flushes: int = 0
    # the first flush lands on a multiple of the interval (wall clock)
    synchronize_with_interval: bool = False
    # statsd listeners: udp:// (num_readers readers each), tcp://
    # (newline-delimited lines per connection), unix:// or unixgram://
    # (a datagram socket, locked against a second owner)
    statsd_listen_addresses: list[str] = field(default_factory=list)
    # SSF listeners: udp:// (one span per datagram) or unix:// (framed
    # spans on a stream socket)
    ssf_listen_addresses: list[str] = field(default_factory=list)
    # GET /quitquitquit shuts the server down
    http_quit: bool = False
    # a datagram SSF span longer than this is cut at 64 KiB, the UDP
    # limit
    trace_max_length_bytes: int = 16 * 1024 * 1024
    # SO_RCVBUF of every datagram listener
    read_buffer_size_bytes: int = 2 * 1048576
    # parsed for the reference's config surface; the one table replaces
    # its worker shards (num_readers sizes the readers)
    num_workers: int = 0
    # "precise" names 0.999 .999percentile; "reference" keeps the Go
    # fleet's int(p*100) truncation (.99percentile)
    percentile_naming: str = "precise"
    # "interp" (singleton-exact rank-space interpolation) or
    # "reference" (the Go digest's uniform-bounds walk)
    quantile_interpolation: str = "interp"
    # an empty hostname stays empty on emitted metrics instead of
    # taking the machine's
    omit_empty_hostname: bool = False
    # veneur.flush.unique_timeseries_total each flush
    count_unique_timeseries: bool = False
    # the span plane: ssfmetrics extraction's indicator and objective
    # timers (empty: off), the span queue and its worker threads, and a
    # debug log line per ingested span
    indicator_span_timer_name: str = ""
    objective_span_timer_name: str = ""
    span_channel_capacity: int = 1024
    num_span_workers: int = 1
    debug_ingested_spans: bool = False
    # the simple sinks: discard everything, or log every flushed metric
    blackhole_sink: bool = False
    debug_flushed_metrics: bool = False
    # start-up: load the native and kernel libraries and take one
    # sample of each kind through a scratch table before READY
    tpu_warmup: bool = False
    # the directory nvcc and g++ build into (empty: the package's
    # _build/)
    compile_cache_dir: str = ""
    # the reference probes its accelerator for this long and falls back
    # to the CPU; the port's server runs where it was asked and raises
    # when the card is missing (parsed, not a fallback)
    accelerator_probe_timeout: str = "60s"
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
    # the UDP readers' drain tier: "uring" (an io_uring multishot
    # receive into a registered buffer pool, parsed in place),
    # "recvmmsg" (one bulk-drain syscall a batch), "python" (one recv a
    # packet); "auto" picks uring where the start-up probe grants it,
    # else recvmmsg.  A ring refused or dead at runtime drops that
    # reader one tier, counted by reason.
    tpu_ingest_backend: str = "auto"
    # provided buffers per reader ring (a power of two in [2, 32768]),
    # each one datagram of up to metric_max_length bytes
    tpu_uring_buffers: int = 2048
    # staged samples that trigger a mid-interval device step
    tpu_stage_flush_samples: int = 65536
    # detach staged work under the ingest lock and apply it outside it
    # (the flush waits for every pending apply); false: the step runs
    # inline under the lock
    tpu_pipeline: bool = True
    # emit the flush as a columnar MetricFrame (false: the per-row
    # emit)
    tpu_columnar_emit: bool = True
    # HTTP listener ("host:port", or "einhorn@N": adopt einhorn's
    # inherited listening fd N and ack its master): /healthcheck,
    # /debug/vars and POST /import
    http_address: str = ""
    # TLS on the TCP statsd and gRPC listeners (file path or inline
    # PEM); with an authority certificate, clients must present a
    # certificate it signed (mutual TLS)
    tls_key: str = ""
    tls_certificate: str = ""
    tls_authority_certificate: str = ""
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
    # dial the gRPC global (and the recovery and handoff peers) over
    # TLS: system roots, or the CA pinned by forward_grpc_tls_ca (file
    # path or inline PEM, which implies TLS); tls_key/tls_certificate
    # double as the client pair for mutual TLS
    forward_grpc_tls: bool = False
    forward_grpc_tls_ca: str = ""
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
    # -- the sharded global tier and outage riding --------------------
    # split each flush's gRPC forward wire by route-key consistent hash
    # across the comma-separated forward_address members (one bounded
    # worker per destination); gRPC forwards only, the HTTP path falls
    # back to one POST
    tpu_sharded_global: bool = False
    # live membership for the sharded ring: poll Consul's health API for
    # passing instances of this service (needs tpu_sharded_global and
    # forward_use_grpc)
    consul_forward_service_name: str = ""
    consul_url: str = "http://127.0.0.1:8500"
    consul_refresh_interval: str = "30s"
    # on shutdown a local runs one final flush whose forward wires are
    # flagged drain, so a rolling restart conserves the staged interval
    tpu_drain_on_shutdown: bool = True
    # per-destination circuit breaker on the sharded forward workers:
    # this many consecutive failures open it until the cooldown passes
    # and one probe is let through; 0 disables it
    tpu_breaker_threshold: int = 5
    tpu_breaker_cooldown: str = "5s"
    # wires that cannot ship (breaker open, retries or deadline spent)
    # park in a bounded per-destination spool and replay, flagged
    # veneur-replay, when the destination recovers
    tpu_forward_spool: bool = True
    tpu_forward_spool_max_bytes: int = 32 * 1024 * 1024
    tpu_forward_spool_max_age: str = "300s"
    # disk segments for the spool (<dir>/<dest>/<...>.wire); empty keeps
    # it in memory
    tpu_forward_spool_dir: str = ""
    # -- overload, checkpoints and crash riding ------------------------
    # overload control (core/overload.py): per-tenant admission buckets,
    # class-ordered shedding under pressure, the histogram width ladder
    # and the flush-overrun coalesce; with no tenant rate and pressure
    # disengaged the ingest paths pay one boolean a batch
    tpu_overload: bool = True
    # the tag whose value names a series' tenant ("default" without it)
    tpu_overload_tenant_tag: str = "tenant"
    # admitted non-counter samples a second per tenant (0: no budget)
    # and the bucket depth (0: twice the rate)
    tpu_overload_tenant_rate: float = 0.0
    tpu_overload_tenant_burst: float = 0.0
    # tenants tracked before the rest share the "other" bucket
    tpu_overload_max_tenants: int = 256
    # pressure ceilings (1.0 = saturated): staged samples, class-index
    # occupancy, flush time over the interval (EWMA); engaged at a score
    # of 1.0, released at the exit ratio
    tpu_overload_staging_hi: int = 1_000_000
    tpu_overload_occupancy_hi: float = 0.95
    tpu_overload_lag_hi: float = 1.0
    tpu_overload_exit_ratio: float = 0.7
    # a flush past its budget makes the next tick coalesce (one swap
    # covers two intervals, named in the ledger)
    tpu_overload_coalesce: bool = True
    # crash-riding checkpoints (ops/checkpoint.py): the open interval's
    # host staging written as a cumulative segment under the directory
    # at this cadence, replayed by the next incarnation; on iff the
    # directory is set and the interval > 0
    tpu_checkpoint_interval: str = "1s"
    tpu_checkpoint_dir: str = ""
    # a global's scale-out arc handoff (Server.arc_handoff)
    tpu_arc_handoff: bool = True

    def interval_seconds(self) -> float:
        return parse_duration(self.interval)

    def accelerator_probe_timeout_seconds(self) -> float:
        return parse_duration(self.accelerator_probe_timeout)

    def is_local(self) -> bool:
        """A node with a forward destination — a static address or a
        discovered service — is a local (reference server.go:1609
        IsLocal)."""
        return bool(self.forward_address
                    or self.consul_forward_service_name)

    def consul_refresh_interval_seconds(self) -> float:
        return parse_duration(self.consul_refresh_interval)

    def breaker_cooldown_seconds(self) -> float:
        return parse_duration(self.tpu_breaker_cooldown)

    def forward_spool_max_age_seconds(self) -> float:
        return parse_duration(self.tpu_forward_spool_max_age)

    def checkpoint_interval_seconds(self) -> float:
        return parse_duration(self.tpu_checkpoint_interval or "0")

    def checkpoint_enabled(self) -> bool:
        return bool(self.tpu_checkpoint_dir) and \
            self.checkpoint_interval_seconds() > 0

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
        if self.percentile_naming not in ("precise", "reference"):
            problems.append(
                "percentile_naming must be 'precise' or 'reference'")
        if self.quantile_interpolation not in ("interp", "reference"):
            problems.append(
                "quantile_interpolation must be 'interp' or "
                "'reference'")
        for n in ("tpu_counter_rows", "tpu_gauge_rows", "tpu_histo_rows",
                  "tpu_set_rows", "tpu_histo_slots", "metric_max_length",
                  "span_channel_capacity", "reader_batch_packets",
                  "tpu_stage_flush_samples"):
            if getattr(self, n) <= 0:
                problems.append(f"{n} must be positive")
        if self.tpu_ingest_backend not in ("auto", "uring",
                                           "recvmmsg", "python"):
            problems.append(
                "tpu_ingest_backend must be auto, uring, recvmmsg "
                "or python")
        if self.tpu_uring_buffers < 2 or \
                self.tpu_uring_buffers > 32768 or \
                self.tpu_uring_buffers & (self.tpu_uring_buffers - 1):
            problems.append(
                "tpu_uring_buffers must be a power of two in "
                "[2, 32768]")
        if self.num_span_workers <= 0:
            problems.append("num_span_workers must be positive")
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
        for key, schemes in (("statsd_listen_addresses",
                              ("udp", "tcp", "unix")),
                             ("ssf_listen_addresses", ("udp", "unix"))):
            for addr in getattr(self, key):
                try:
                    scheme = addrmod.parse_addr(addr)[0]
                except ValueError as e:
                    problems.append(f"{key}: {e}")
                    continue
                if scheme not in schemes:
                    problems.append(f"{key}: unsupported address "
                                    f"{addr!r}")
        for addr in self.grpc_listen_addresses:
            if not addr.startswith("tcp://"):
                problems.append(
                    f"grpc listener must be tcp://: {addr}")
        if self.forward_json_schema not in ("reference", "native"):
            problems.append(
                "forward_json_schema must be 'reference' or 'native'")
        if "," in self.forward_address and not self.tpu_sharded_global:
            problems.append(
                "multiple forward_address members need "
                "tpu_sharded_global (the single-global path dials one)")
        if self.consul_forward_service_name:
            if not self.tpu_sharded_global:
                problems.append(
                    "consul_forward_service_name needs "
                    "tpu_sharded_global (discovery drives the ring)")
            if not self.forward_use_grpc:
                problems.append(
                    "consul_forward_service_name needs "
                    "forward_use_grpc (the sharded ring is gRPC-only)")
            try:
                if self.consul_refresh_interval_seconds() <= 0:
                    problems.append(
                        "consul_refresh_interval must be positive")
            except ValueError as e:
                problems.append(str(e))
        if self.tpu_breaker_threshold < 0:
            problems.append("tpu_breaker_threshold must be >= 0")
        try:
            if self.breaker_cooldown_seconds() <= 0:
                problems.append("tpu_breaker_cooldown must be positive")
        except ValueError as e:
            problems.append(str(e))
        if self.tpu_forward_spool_max_bytes <= 0:
            problems.append(
                "tpu_forward_spool_max_bytes must be positive")
        try:
            if self.forward_spool_max_age_seconds() <= 0:
                problems.append(
                    "tpu_forward_spool_max_age must be positive")
        except ValueError as e:
            problems.append(str(e))
        if self.tpu_overload_tenant_rate < 0:
            problems.append("tpu_overload_tenant_rate must be >= 0")
        if self.tpu_overload_tenant_burst < 0:
            problems.append("tpu_overload_tenant_burst must be >= 0")
        if self.tpu_overload_max_tenants <= 0:
            problems.append("tpu_overload_max_tenants must be positive")
        if self.tpu_overload_staging_hi <= 0:
            problems.append("tpu_overload_staging_hi must be positive")
        if not (0.0 < self.tpu_overload_occupancy_hi <= 1.0):
            problems.append(
                "tpu_overload_occupancy_hi must be in (0, 1]")
        if self.tpu_overload_lag_hi <= 0:
            problems.append("tpu_overload_lag_hi must be positive")
        if not (0.0 < self.tpu_overload_exit_ratio <= 1.0):
            problems.append(
                "tpu_overload_exit_ratio must be in (0, 1]")
        if self.http_address.startswith("einhorn@"):
            if not self.http_address[len("einhorn@"):].isdigit():
                problems.append(
                    f"http_address einhorn@N needs a listener number: "
                    f"{self.http_address}")
        elif self.http_address and not self.http_address.rpartition(
                ":")[2].isdigit():
            problems.append(
                f"http_address needs host:port or einhorn@N: "
                f"{self.http_address}")
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
_ENV_KEYS = ("tags", "debug", "flush_watchdog_missed_flushes",
             "synchronize_with_interval", "ssf_listen_addresses",
             "http_quit", "trace_max_length_bytes",
             "read_buffer_size_bytes", "num_workers",
             "percentile_naming", "quantile_interpolation",
             "omit_empty_hostname", "count_unique_timeseries",
             "indicator_span_timer_name", "objective_span_timer_name",
             "span_channel_capacity", "num_span_workers",
             "debug_ingested_spans", "blackhole_sink",
             "debug_flushed_metrics", "tpu_warmup", "compile_cache_dir",
             "accelerator_probe_timeout",
             "tpu_pipeline", "tpu_multi_reader_fused",
             "tpu_reader_pin_cores", "tpu_columnar_emit",
             "tpu_ingest_backend", "tpu_uring_buffers", "http_address",
             "tls_key", "tls_certificate", "tls_authority_certificate",
             "forward_grpc_tls", "forward_grpc_tls_ca",
             "stats_address", "veneur_metrics_scopes",
             "veneur_metrics_additional_tags", "enable_profiling", "tpu_ledger_strict",
             "tpu_trace_propagation", "tpu_signal_history",
             "tpu_flight_dir", "tpu_flight_max_bundles",
             "tpu_flight_max_bytes", "tpu_flight_cooldown",
             "tpu_cluster_peers", "tpu_sharded_global",
             "consul_forward_service_name", "consul_url",
             "consul_refresh_interval", "tpu_drain_on_shutdown",
             "tpu_breaker_threshold", "tpu_breaker_cooldown",
             "tpu_forward_spool", "tpu_forward_spool_max_bytes",
             "tpu_forward_spool_max_age", "tpu_forward_spool_dir",
             "tpu_overload", "tpu_overload_tenant_tag",
             "tpu_overload_tenant_rate", "tpu_overload_tenant_burst",
             "tpu_overload_max_tenants", "tpu_overload_staging_hi",
             "tpu_overload_occupancy_hi", "tpu_overload_lag_hi",
             "tpu_overload_exit_ratio", "tpu_overload_coalesce",
             "tpu_checkpoint_interval", "tpu_checkpoint_dir",
             "tpu_arc_handoff")


def _coerce(cls, name: str, raw: str):
    """An environment string as the field's type (the reference's
    ``_coerce``)."""
    current = getattr(cls(), name)
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
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


@dataclass
class ProxyConfig:
    """veneur-proxy configuration (reference config_proxy.go), with the
    reference's defaults and validation.  ``sentry_dsn`` alone is not
    ported and is refused by name."""
    debug: bool = False
    http_address: str = ""
    grpc_address: str = ""
    # static destination list (comma separated), XOR consul discovery
    forward_address: str = ""
    consul_forward_service_name: str = ""
    consul_refresh_interval: str = "30s"
    consul_url: str = "http://127.0.0.1:8500"
    forward_timeout: float = 10.0
    stats_address: str = ""
    # a separate destination set for gRPC-forwarded metrics (reference
    # proxy.go:138,184 ForwardGRPCDestinations); unset: the main ring
    grpc_forward_address: str = ""
    consul_forward_grpc_service_name: str = ""
    # datadog-format trace proxying: POST /spans bodies hash by trace
    # id across these destinations (proxy.go:543 ProxyTraces)
    trace_address: str = ""
    consul_trace_service_name: str = ""
    # accepted for config compatibility; unused, as in proxy.go
    trace_api_address: str = ""
    # the proxy's own telemetry as SSF spans to this address
    # (proxy.go:219-250), with the trace client's buffer knobs
    ssf_destination_address: str = ""
    tracing_client_capacity: int = 1024
    tracing_client_flush_interval: str = "500ms"
    tracing_client_metrics_interval: str = "1s"
    # cadence of the proxy's periodic runtime stats (proxy.go:210)
    runtime_metrics_interval: str = "10s"
    # Go http.Transport pool tuning: parsed for compatibility, no-ops
    # (one persistent HTTP connection and one gRPC channel per
    # destination)
    idle_connection_timeout: str = ""
    max_idle_conns: int = 0
    max_idle_conns_per_host: int = 0
    # Go pprof flag: a no-op (the proxy does no device work)
    enable_profiling: bool = False
    # dial TLS gRPC globals (the server's forward_grpc_tls and
    # forward_grpc_tls_ca: system roots, or a pinned CA as a file path
    # or inline PEM)
    forward_grpc_tls: bool = False
    forward_grpc_tls_ca: str = ""
    # the columnar route (native decode, vectorized ring assignment,
    # per-destination workers); false: the per-item loop, the oracle
    tpu_columnar_proxy: bool = True
    # per-destination worker queue depth, in-worker retries and the
    # backoff base between them
    tpu_proxy_dest_queue: int = 8
    tpu_proxy_send_retries: int = 2
    tpu_proxy_send_backoff: float = 0.25
    # the proxy's signal history, sampled at the discovery-refresh
    # cadence; 0 disables it
    tpu_signal_history: int = 512

    def consul_refresh_interval_seconds(self) -> float:
        return parse_duration(self.consul_refresh_interval)

    def runtime_metrics_interval_seconds(self) -> float:
        return parse_duration(self.runtime_metrics_interval or "10s")

    def validate(self) -> list[str]:
        problems = []
        # any ONE routing surface suffices (the reference runs
        # trace-only or grpc-only proxies, proxy.go:131-139)
        if not (self.forward_address or
                self.consul_forward_service_name or
                self.grpc_forward_address or
                self.consul_forward_grpc_service_name or
                self.trace_address or
                self.consul_trace_service_name):
            problems.append(
                "proxy needs at least one destination surface: "
                "forward_address / grpc_forward_address / "
                "trace_address (or their consul service names)")
        try:
            if self.consul_refresh_interval_seconds() <= 0:
                problems.append(
                    "consul_refresh_interval must be positive")
        except ValueError as e:
            problems.append(str(e))
        return problems


def read_config(path: str | None = None, data: dict | None = None,
                env: dict | None = None, cls=Config):
    """Load a YAML file (and/or a dict) into ``cls`` (``Config`` or
    ``ProxyConfig``), refuse unknown keys, apply the environment
    overrides (``env``, default ``os.environ``), validate."""
    known = {f.name for f in fields(cls)}
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
    cfg = cls()
    for key, value in raw.items():
        if value is not None:
            setattr(cfg, key, value)
    env = os.environ if env is None else env
    # the proxy's every key takes its override, as in the reference
    env_keys = _ENV_KEYS if cls is Config else sorted(known)
    for name in env_keys:
        env_key = "VENEUR_" + name.upper()
        if env_key in env:
            setattr(cfg, name, _coerce(cls, name, env[env_key]))
    if cls is Config:
        cfg.resolve_aliases()
    problems = cfg.validate()
    if problems:
        raise ValueError("; ".join(problems))
    return cfg
