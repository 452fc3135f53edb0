"""The server: DogStatsD, SSF spans and HTTP /import in, interval
flushes out.

Port of ``veneur_tpu/core/server.py``.  Each ``udp://`` statsd address
gets ``num_readers`` reader threads, each on its own socket (bound with
SO_REUSEPORT when there is more than one, so the kernel spreads the
senders over them), on the drain tier ``tpu_ingest_backend`` resolves
to once, before the first reader starts.  On ``uring`` (where the
start-up probe grants it) a reader's io_uring multishot receive lands
datagrams in a registered buffer pool and ``ReaderShard.parse_ring``
parses them in place (no syscall or copy a packet); a ring refused or
dead at runtime puts that reader on recvmmsg, counted by reason, and
its ENOBUFS drops join the kernel drops the ledger and the pressure
tick read.  On ``recvmmsg`` a reader blocks on its first datagram, then
drains whatever else is queued with one native recvmmsg sweep
(``vtpu_recv_drain``; datagrams over ``metric_max_length`` are rejected
whole and counted as packet errors) and hands the batch to
``handle_packet_batch``; on ``python``, one ``recv`` a datagram.  One
reader runs the fused native parse +
probe + combine (``MetricTable.ingest_buffer``) under the table lock;
several each parse into a ``ReaderShard`` of their own without the
lock and merge under it (or, with ``tpu_multi_reader_fused: false``,
parse into columns outside the lock and ``ingest_columns`` under it).
Events, service checks and malformed lines take the per-line parser.
A ``tcp://`` statsd address gets an acceptor and a thread a connection
(each read's complete lines go through ``handle_packet_batch``), under
TLS with ``tls_key`` and ``tls_certificate`` (mutual with
``tls_authority_certificate``; a failed handshake is counted in
``tls_handshake_errors``); a
``unix://`` one (``unixgram://``) a datagram reader on a path held by a
``<path>.lock`` flock.

SSF spans arrive over ``ssf_listen_addresses`` (``udp://``: one span a
datagram; ``unix://``: framed spans on a stream) and gRPC
``ssf.SSFGRPC/SendSpan``; ``handle_ssf`` queues them for the span
worker, whose first sink is ssfmetrics extraction: each span's samples,
and the indicator and objective timers of an indicator span, go through
``ingest_samples`` (admission, the ledger; one span under one hold of
the lock) into the table.  With ``tpu_warmup`` a scratch table takes
one sample of each kind through a device step, swap and readout before
``start``; with ``flush_watchdog_missed_flushes`` a watchdog exits the
process (code 2) when flushes stop; ``http_quit`` serves
``/quitquitquit``.

Every ingest and import site checks the staging against
``tpu_stage_flush_samples``: past it the staged work is detached under
the lock and applied to the device after the lock is released
(``tpu_pipeline``; the flush's ``complete_swap`` waits for every pending
apply), or, with the pipeline off, applied inline.  DogStatsD events
and service checks join the interval's buffers (a check also enters the
table as a STATUS sample), taken in the swap's lock round.  A flush
thread swaps the table every interval, reads it out as a columnar
``MetricFrame`` (``tpu_columnar_emit``) and routes it (whitelists and
``tags_exclude``) to each metric sink built from the config
(``_build_sinks``: datadog, prometheus, signalfx, newrelic, kafka and
the span sinks, in the reference's order): each sink's flush, then its
``flush_other_samples`` with the interval's events and checks, runs on
its own fan-out worker (``tpu_sink_workers``; retries with full-jitter
backoff, a breaker, a busy drop when the previous flush still runs),
the plugins (flush file, s3) and the span sinks' flush on a shared
pool; the flush waits for them only within ``max(0.9 interval, 1 s)``
and counts what overran (``flush_once``).

With ``http_address`` set (``host:port``, or ``einhorn@N``: einhorn's
inherited listening fd N, acked to its master), a
``ThreadingHTTPServer`` answers ``/healthcheck``, ``/debug/vars`` (the
server's counters) and ``POST /import``: each body is decoded and
merged into the table under the table lock
(``http_import.apply_import``); a malformed body is answered 400 and
counted.  Each ``grpc_listen_addresses`` entry starts an
``ImportServer`` (``forward/grpc_forward.py``; over TLS with the same
key material): ``forwardrpc.Forward/SendMetrics`` decodes each wire
natively outside the table lock and
merges it under the lock, ``dogstatsd.DogstatsdGRPC/SendPacket`` feeds
``handle_packet``, and ``grpc.health.v1.Health/Check`` answers.  With
``forward_address`` set the node is a local: its flusher forwards
mergeable state after every flush, POSTed to the global's ``/import``
or, with ``forward_use_grpc``, sent as one MetricList through a client
dialled once (a failed send is counted and logged, never retried); with
``forward_grpc_tls`` or ``forward_grpc_tls_ca`` every gRPC dialer (the
forward, the sharded forward's workers, the recovery client, the
handoff shipper) dials over TLS.
With ``tpu_sharded_global`` (gRPC only) the MetricList is split by
route-key consistent hash across the ``forward_address`` members, or
the members Consul names, through a ``ShardedForwarder``: one bounded
worker per destination with a circuit breaker, a deadline per interval,
and a ``WireSpool`` that parks a destination's wires while its breaker
is open and replays them, flagged replay, once it recovers; the
interval's ledger record credits the split, the spool and any reshard,
and a ``SpoolLedger`` snapshot seals the spool each flush.  On
``shutdown`` a local drains: one last flush whose forward wires are
flagged drain (``tpu_drain_on_shutdown``).  A global counts the drain
and replay wires it receives and books them under their own ledger
protocols.
Every cycle observes itself as the reference's server does: a flush
tracer (``observe.FlushTracer``) hangs a span per stage off the cycle's
root, sends them through a loopback trace client into the span worker
and indexes them for ``/debug/trace/<id>``; the cycle's record lands in
the ``/debug/flushes`` ring; every ingest and import site credits the
conservation ledger under the lock it already holds, the interval
closes in the swap's lock round and seals after the sinks (``/debug/
ledger``); each seal samples a signal row (``/debug/signals``) that the
flight recorder's triggers read (``/debug/flight``), and self-telemetry
(``core/telemetry.py``) emits the operator metrics, into the server's
own table unless ``stats_address`` is set.  A local stamps its forward
with the cycle's trace context; a global parents its ``import`` span
under it, so one interval's tree stitches across the tiers.
With ``tpu_mesh_shards`` the table is the mesh table
(``parallel/sharded.py``) over the server's places (a constructor
argument; default the visible devices of its device type): no pipeline,
one shard merge at the swap.  With ``tpu_collective_peers`` a sharded
local's rows for those destinations ride one plane exchange a flush
(``forward/collective.py``) before the wire split, falling open to the
wire on any failure, counted; a global folds landed planes under the
``collective-import`` ledger protocol.  With ``sentry_dsn`` every
long-lived thread runs under ``_crashguard`` and error-level records of
the package's loggers go to Sentry.
``shutdown`` stops every listener, joins every thread and closes every
socket and channel.
"""

from __future__ import annotations

import ctypes
import http.server
import json
import logging
import os
import socket
import ssl
import threading
import time
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FuturesTimeout
from pathlib import Path

import grpc
import numpy as np
import torch

from veneur_tpu_torch import __version__, native, observe, resolve_device
from veneur_tpu_torch import trace as vtrace
from veneur_tpu_torch.core import debughttp
from veneur_tpu_torch.core import metrics as im
from veneur_tpu_torch.core import overload as ovl
from veneur_tpu_torch.core.config import Config, parse_duration
from veneur_tpu_torch.core.spans import SpanWorker
from veneur_tpu_torch.core.telemetry import Telemetry
from veneur_tpu_torch.core.flusher import FlushResult, Flusher, ForwardRow
from veneur_tpu_torch.core.table import MetricTable, TableConfig
from veneur_tpu_torch.forward import grpc_forward, handoff, http_import
from veneur_tpu_torch.forward.ring import ConsistentRing
from veneur_tpu_torch.forward.discovery import ConsulDiscoverer
from veneur_tpu_torch.forward.shard import (DeadlineExceeded,
                                            ShardedForwarder)
from veneur_tpu_torch.forward.spool import Spooled, WireSpool
from veneur_tpu_torch.native import uring
from veneur_tpu_torch.ops import checkpoint as ckpt
from veneur_tpu_torch.ops import cluster_merge, fdpass
from veneur_tpu_torch.protocol import addr as addrmod
from veneur_tpu_torch.protocol import columnar, wire
from veneur_tpu_torch.protocol import dogstatsd as dsd
from veneur_tpu_torch.sinks import base as sinks_base
from veneur_tpu_torch.sinks.datadog import DatadogMetricSink
from veneur_tpu_torch.sinks.fanout import SinkFanout
from veneur_tpu_torch.sinks.prometheus import PrometheusRepeaterSink
from veneur_tpu_torch.sinks.simple import (BlackholeSink, DebugSink,
                                           LocalFilePlugin)
from veneur_tpu_torch.sinks.ssfmetrics import MetricExtractionSink
from veneur_tpu_torch.trace.spans import Span

log = logging.getLogger("veneur_tpu_torch.server")

# drain sweep bound: vtpu_recv_drain takes at most this many datagrams
_DRAIN_MAX = 512
# /debug/cluster: seconds a peer's scraped summary is served from cache
_CLUSTER_TTL = 10.0
# a TCP statsd connection idle this long is closed (reference
# server.go:80)
_TCP_IDLE_S = 600.0
# the largest SSF datagram (a UDP payload)
_SSF_DATAGRAM_MAX = 65536


def tags_to_dict(tags) -> dict[str, str]:
    """``["k:v", ...]`` config tags -> dict, skipping bare tags: the
    shape the span worker takes its common tags in."""
    return dict(t.split(":", 1) for t in tags if ":" in t)


def _check_sample(check) -> "dsd.Sample":
    """A service check's STATUS sample for the table."""
    return dsd.Sample(name=check.name, type=dsd.STATUS,
                      value=float(check.status), tags=check.tags,
                      message=check.message)


def generate_excluded_tags(rules: list[str],
                           sink_name: str) -> list[str]:
    """tags_exclude rules -> tag names excluded for one sink:
    "tagname" applies everywhere, "tagname|sink1|sink2" only on the
    named sinks (reference server.go generateExcludedTags)."""
    out = []
    for rule in rules:
        parts = rule.split("|")
        if len(parts) == 1 or sink_name in parts[1:]:
            out.append(parts[0])
    return out


def use_build_dir(path: str) -> None:
    """``compile_cache_dir``: nvcc and g++ build into (and load from)
    ``path`` instead of the package's ``_build/``."""
    d = Path(path).resolve()
    native.BUILD_DIR = d
    cluster_merge.BUILD_DIR = d


def _is_inline_pem(value: str) -> bool:
    """TLS config values are PEM material inline (the reference's
    example.yaml style) or file paths."""
    return value.lstrip().startswith("-----BEGIN")


def _pem_bytes(value: str) -> bytes:
    if _is_inline_pem(value):
        return value.encode()
    with open(value, "rb") as f:
        return f.read()


def _matfile(value: str) -> str:
    """A TLS value as a file path: inline PEM is written to a 0600
    temporary file that is unlinked at exit, so a private key never
    outlives the process on disk."""
    if not _is_inline_pem(value):
        return value
    import atexit
    import tempfile
    fd, path = tempfile.mkstemp(suffix=".pem")
    with os.fdopen(fd, "w") as f:  # mkstemp creates it 0600
        f.write(value)
    atexit.register(lambda: os.path.exists(path) and os.unlink(path))
    return path


def _is_deadline_error(err) -> bool:
    """True when a forward wire failed on a deadline: our own pre-send
    cutoff (``DeadlineExceeded``) or gRPC's DEADLINE_EXCEEDED status."""
    if isinstance(err, DeadlineExceeded):
        return True
    code = getattr(err, "code", None)
    if callable(code):
        try:
            return getattr(code(), "name", "") == "DEADLINE_EXCEEDED"
        except Exception:
            return False
    return False


class Server:
    def __init__(self, config: Config,
                 device: "str | torch.device" = "cuda",
                 extra_sinks: list | None = None,
                 extra_span_sinks: list | None = None,
                 extra_plugins: list | None = None,
                 places: list | None = None):
        self.config = config
        self.device = resolve_device(device)
        # the places of the mesh global (tpu_mesh_shards) and of the
        # collective import fold; None: the visible devices of the
        # device's type
        self.places = list(places) if places is not None else None
        # the reference's accelerator probe falls back to the CPU; the
        # port runs where it was asked (resolve_device raises without
        # a card), so the key is only read
        config.accelerator_probe_timeout_seconds()
        if config.compile_cache_dir:
            use_build_dir(config.compile_cache_dir)
        self.interval = config.interval_seconds()
        if config.tpu_mesh_shards:
            # the mesh global: sharded planes over a (shard, series)
            # grid of places; the shard merge runs at the flush
            from veneur_tpu_torch.parallel import sharded
            mesh = sharded.make_mesh(
                self.places if self.places is not None
                else sharded.default_places(self.device),
                n_shard=config.tpu_mesh_shards)
            self.table = sharded.ShardedTable(mesh, sharded.ShardedConfig(
                rows=config.tpu_histo_rows,
                set_rows=config.tpu_set_rows,
                counter_rows=config.tpu_counter_rows,
                gauge_rows=config.tpu_gauge_rows,
                compression=float(config.tpu_compression),
                slots=config.tpu_histo_slots,
                batch=max(1024, config.tpu_stage_flush_samples)))
        else:
            self.table = MetricTable(TableConfig(
                counter_rows=config.tpu_counter_rows,
                gauge_rows=config.tpu_gauge_rows,
                histo_rows=config.tpu_histo_rows,
                set_rows=config.tpu_set_rows,
                compression=float(config.tpu_compression),
                histo_slots=config.tpu_histo_slots,
                collective_import=str(config.tpu_collective_import)),
                device=self.device, places=self.places)
        self.is_local = config.is_local()
        # the pipelined device step needs the single table's detach;
        # the mesh table steps and flushes synchronously
        want_pipeline = bool(config.tpu_pipeline)
        self.pipeline = want_pipeline and hasattr(self.table,
                                                  "take_staged")
        if want_pipeline and not self.pipeline:
            log.warning(
                "tpu_pipeline is ignored with the mesh-sharded table "
                "(tpu_mesh_shards=%s): ShardedTable runs its own step "
                "machinery and flushes synchronously",
                config.tpu_mesh_shards)
        self.flusher = Flusher(
            is_local=self.is_local,
            percentiles=tuple(config.percentiles),
            aggregates=tuple(config.aggregates),
            hostname=(config.hostname if (config.hostname or
                                          config.omit_empty_hostname)
                      else socket.gethostname()),
            device=self.device, columnar=bool(config.tpu_columnar_emit),
            tags=tuple(config.tags),
            percentile_naming=config.percentile_naming,
            quantile_interpolation=config.quantile_interpolation)
        self.metric_sinks = list(extra_sinks or [])
        self.span_sinks = list(extra_span_sinks or [])
        self.plugins = list(extra_plugins or [])
        # the Sentry client and its error-level log handler
        # (sentry_dsn; built by _build_sinks)
        self.sentry = None
        self._sentry_handler = None
        self._build_sinks()
        self.lock = threading.Lock()
        # the counters have a lock of their own: a reader never takes
        # the ingest lock only to count
        self._stats_lock = threading.Lock()
        self._parsers = threading.local()  # split path: one per reader
        self._flush_serial = threading.Lock()
        self._shutdown = threading.Event()
        self._threads: list[threading.Thread] = []
        # set once shutdown() has finished (the CLI waits on it after a
        # /quitquitquit)
        self.stopped = threading.Event()
        self._shutdown_lock = threading.Lock()
        # the UDP statsd readers' sockets; the other listeners (TCP and
        # unixgram statsd, SSF) and their live connections; flocks held
        # on unix socket paths (lock path, fd)
        self.sockets: list[socket.socket] = []
        self._listeners: list[socket.socket] = []
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        self._socket_locks: list[tuple[str, int]] = []
        self.ssf_ports: list[int] = []
        self._httpd: http.server.ThreadingHTTPServer | None = None
        self.http_port: int | None = None
        self.grpc_servers: list[grpc_forward.ImportServer] = []
        self.grpc_ports: list[int] = []
        self._grpc_client: grpc_forward.ForwardClient | None = None
        # the interval's DogStatsD events and service checks, taken in
        # the swap's lock round and handed to every metric sink's
        # flush_other_samples (service checks also enter the table as
        # STATUS samples)
        self.events: list[dsd.Event] = []
        self.checks: list[dsd.ServiceCheck] = []
        self.stats = {"packets_received": 0, "packet_errors": 0,
                      "metrics_processed": 0, "metrics_dropped": 0,
                      "flushes": 0, "imports_received": 0,
                      "import_errors": 0, "import_flagged_wires": 0,
                      "received_grpc": 0, "received_dogstatsd-grpc": 0,
                      "forward_errors": 0, "forwarded_rows": 0}
        self._pprof_lock = threading.Lock()
        self._profiler = None
        self.last_flush = time.monotonic()

        # the span plane: ssfmetrics extraction runs first, as part of
        # the metric hot path (reference server.go:444-452); the
        # server's loopback trace client feeds the same worker
        # (server.go:347-354)
        self.span_sinks.insert(0, MetricExtractionSink(
            self, indicator_timer_name=config.indicator_span_timer_name,
            objective_timer_name=config.objective_span_timer_name))
        self.span_worker = SpanWorker(
            self.span_sinks, common_tags=tags_to_dict(config.tags),
            capacity=config.span_channel_capacity, stats_cb=self.bump,
            workers=config.num_span_workers)
        # per-sink tag exclusion (reference server.go:1642
        # setSinkExcludedTags), once every sink exists
        if config.tags_exclude:
            for sink in self.metric_sinks + self.span_sinks:
                if hasattr(sink, "set_excluded_tags"):
                    sink.set_excluded_tags(generate_excluded_tags(
                        config.tags_exclude, sink.name))
        self.trace_client = vtrace.Client(
            vtrace.ChannelBackend(self.span_worker.submit), capacity=256)
        # flush self-observation: every cycle leaves a span tree (also
        # indexed by trace id for /debug/trace) and a record in the
        # /debug/flushes ring; the device-cost registry is the
        # process-global one the table and flusher steps report to
        self.device_costs = observe.REGISTRY
        self.flush_ring = observe.FlushRing()
        self.trace_index = observe.TraceIndex()
        self.flush_tracer = observe.FlushTracer(
            self.trace_client, self.flush_ring,
            registry=self.device_costs, index=self.trace_index)
        # the collector's time from here to shutdown, on each flush
        # record's span_ns["gc"] (/debug/flushes)
        self.flush_tracer.start_gc_spans()
        # the sample-conservation ledger: ingest sites credit under
        # self.lock, the interval closes in the swap's lock round and
        # seals after the sinks (/debug/ledger)
        self.ledger = observe.Ledger(
            strict=bool(config.tpu_ledger_strict),
            node="local" if self.is_local else "global",
            on_imbalance=lambda rec: self.bump("ledger_imbalance"))
        # the outage spool's cross-interval conservation: one snapshot
        # sealed per flush from WireSpool.stats()
        self._spool_ledger = observe.SpoolLedger(
            strict=bool(config.tpu_ledger_strict),
            node="local" if self.is_local else "global",
            on_imbalance=lambda rec: self.bump("spool_ledger_imbalance"))
        # the sharded forward (built at the first forward), its
        # discovery poll, the replayed items already credited to a
        # ledger record, and the drain flag of the shutdown flush
        self._sharded_fwd: ShardedForwarder | None = None
        self._fwd_refresh_interval = 0.0
        self._fwd_refresh_next = 0.0
        self._replayed_credited = 0
        self._draining = False
        # the collective forward (tpu_collective_forward), built at the
        # first forward; ``collective_exchange`` is the injectable
        # exchange (tests set a loopback hub or a failure injector
        # before the first flush)
        self._collective_fwd = None
        self.collective_exchange = None
        # tier byte accounting from the last boundary (None until a
        # tiered flush; always None on a single-tier table)
        self._last_plane_bytes = None
        # overload control (core/overload.py; on by default, as in the
        # reference): admission buckets, class shedding under pressure,
        # the width ladder and the flush-overrun coalesce.  None when
        # tpu_overload is off; every call site guards
        self.overload = None
        if config.tpu_overload:
            self.overload = ovl.Overload(
                tenant_tag=config.tpu_overload_tenant_tag,
                tenant_rate=float(config.tpu_overload_tenant_rate),
                tenant_burst=float(config.tpu_overload_tenant_burst),
                max_tenants=int(config.tpu_overload_max_tenants),
                staging_hi=int(config.tpu_overload_staging_hi),
                occupancy_hi=float(config.tpu_overload_occupancy_hi),
                lag_hi=float(config.tpu_overload_lag_hi),
                exit_ratio=float(config.tpu_overload_exit_ratio),
                coalesce=bool(config.tpu_overload_coalesce))
        # kernel UDP receive drops: socket inode -> the cumulative count
        # at the last flush, so each interval records its delta; the
        # ring's ENOBUFS drops likewise
        self._kernel_drops_last: dict[int, int] = {}
        self._uring_enobufs_last = 0
        # the UDP readers' drain tier, resolved once before the first
        # reader starts ("uring", "recvmmsg" or "python"), the start-up
        # probe's -errno, and the live rings by reader thread name
        self.ingest_backend: str | None = None
        self._uring_probe_err = 0
        self._backend_fallback_logged = False
        self._urings: dict[str, object] = {}
        # TLS on the TCP statsd listener (None: plaintext); a bad
        # combination of keys fails here, before any listener binds
        self._tls_context = self._build_tls()
        # crash riding: listener fds a predecessor handed down
        # (VENEUR_TPU_SOCK_CLOAKED), the live listeners by slot name for
        # a successor, the incarnation id stamping checkpoint segments
        # and spool files, and the recovery ids already applied here
        # (under self.lock, atomic with the apply)
        self.start_epoch = time.time()
        self.statsd_ports: list[int] = []
        self._adopted_socks: dict[str, socket.socket] = {}
        for slot, fd in fdpass.parse_cloak().items():
            try:
                self._adopted_socks[slot] = fdpass.adopt_socket(fd)
            except OSError as e:
                # a dead fd degrades its slot to a fresh bind
                log.warning("cloaked fd %d for slot %s unusable: %s",
                            fd, slot, e)
        self.restarts_adopted = 0
        self._cloak_slots: dict[str, socket.socket] = {}
        self.incarnation = 0
        self._checkpointer: ckpt.Checkpointer | None = None
        if config.checkpoint_enabled():
            self.incarnation = ckpt.next_incarnation(
                config.tpu_checkpoint_dir)
        self._recovery_seen: set[str] = set()
        # scale-out arc handoff: (ring, self_member) for the one flush
        # arc_handoff runs, the shipper (built at the first handoff) and
        # the last handoff's stats
        self._handoff_pending = None
        self._handoff_shipper: handoff.HandoffShipper | None = None
        self._handoff_last: dict = {}
        self.telemetry = Telemetry(self)
        self._sink_durations: dict[str, int] = {}
        # the plugins, the forward, the handoff and the span flush run
        # on a shared pool, each key's previous task awaited before the
        # next is queued (a wedged one skips, counted)
        self._pool = ThreadPoolExecutor(max_workers=8,
                                        thread_name_prefix="flush-pool")
        self._flush_pending: dict[str, object] = {}
        # per-sink flush fan-out (tpu_sink_workers > 0): every metric
        # sink has a worker and a one-slot queue, so a stalled sink
        # times out alone; 0 runs the sinks on the shared pool
        self._fanout: SinkFanout | None = None
        if int(config.tpu_sink_workers) > 0:
            self._fanout = SinkFanout(
                [s.name for s in self.metric_sinks],
                on_error=lambda name, exc: self.bump("flush_errors"),
                retry_budget=max(self.interval * 0.9, 1.0))
        # the fan-out's cumulative (busy drops, retries, timeouts) at
        # the last seal, so each record is credited its delta
        self._ledger_fanout_last = (0, 0, 0)
        # the signal history (one fixed-schema row per seal) and the
        # flight recorder watching its rows; the schema is derived
        # here, once, before any subsystem has data
        self.signals = None
        self.flight = None
        self._flight_record = None
        if config.tpu_signal_history > 0:
            self.signals = observe.SignalHistory(
                schema=tuple(self._signal_row()),
                capacity=config.tpu_signal_history,
                node=config.hostname or "",
                role="local" if self.is_local else "global")
            self.flight = observe.FlightRecorder(
                self.signals, context_fn=self._flight_context,
                directory=config.tpu_flight_dir,
                max_bundles=config.tpu_flight_max_bundles,
                max_bytes=config.tpu_flight_max_bytes,
                cooldown=parse_duration(config.tpu_flight_cooldown),
                node=config.hostname or "")
        # /debug/cluster peer-summary cache: addr -> (monotonic, summary)
        self._cluster_cache: dict = {}
        self._cluster_lock = threading.Lock()
        # the start-up warm-up's seconds, launches and flush tally
        self.warmup: dict | None = None
        if config.tpu_warmup and hasattr(self.table, "take_staged"):
            self._warmup()

    def _build_sinks(self) -> None:
        """The configured sinks and plugins, in the reference's order
        (server.go ``_build_sinks``): blackhole, debug, datadog,
        prometheus, signalfx, newrelic (metrics and spans), kafka
        (metrics and spans), the datadog trace agent, splunk, X-Ray,
        LightStep, Falconer; then the flush file and s3 plugins."""
        c = self.config
        if c.blackhole_sink:
            self.metric_sinks.append(BlackholeSink())
        if c.debug_flushed_metrics:
            self.metric_sinks.append(DebugSink())
        if c.datadog_api_key:
            self.metric_sinks.append(DatadogMetricSink(
                c.datadog_api_key, c.datadog_api_hostname,
                self.interval, hostname=c.hostname,
                flush_max_per_body=c.datadog_flush_max_per_body,
                metric_name_prefix_drops=tuple(
                    c.datadog_metric_name_prefix_drops),
                exclude_tags_prefix_by_prefix_metric=(
                    c.datadog_exclude_tags_prefix_by_prefix_metric)))
        if c.prometheus_repeater_address:
            self.metric_sinks.append(PrometheusRepeaterSink(
                c.prometheus_repeater_address, c.prometheus_network_type))
        if c.signalfx_api_key:
            from veneur_tpu_torch.sinks.signalfx import SignalFxSink
            self.metric_sinks.append(SignalFxSink(
                c.signalfx_api_key, endpoint=c.signalfx_endpoint_base,
                vary_key_by=c.signalfx_vary_key_by,
                per_tag_api_keys=c.signalfx_per_tag_api_keys,
                max_per_body=c.signalfx_flush_max_per_body,
                hostname=c.hostname,
                hostname_tag=c.signalfx_hostname_tag,
                metric_name_prefix_drops=tuple(
                    c.signalfx_metric_name_prefix_drops),
                metric_tag_prefix_drops=tuple(
                    c.signalfx_metric_tag_prefix_drops),
                dynamic_per_tag_api_keys_enable=(
                    c.signalfx_dynamic_per_tag_api_keys_enable),
                dynamic_per_tag_api_keys_refresh_period=parse_duration(
                    c.signalfx_dynamic_per_tag_api_keys_refresh_period
                    or "10m"),
                endpoint_api=c.signalfx_endpoint_api))
        if c.newrelic_insert_key:
            from veneur_tpu_torch.sinks.newrelic import (
                NewRelicMetricSink, NewRelicSpanSink)
            common = {k: v for k, _, v in
                      (t.partition(":") for t in c.newrelic_common_tags)}
            self.metric_sinks.append(NewRelicMetricSink(
                c.newrelic_insert_key,
                endpoint=c.newrelic_metric_endpoint,
                common_attributes=common, interval=self.interval,
                account_id=c.newrelic_account_id,
                region=c.newrelic_region,
                event_type=c.newrelic_event_type,
                service_check_event_type=(
                    c.newrelic_service_check_event_type)))
            self.span_sinks.append(NewRelicSpanSink(
                c.newrelic_insert_key,
                endpoint=c.newrelic_trace_endpoint,
                trace_observer_url=c.newrelic_trace_observer_url,
                region=c.newrelic_region))
        if c.kafka_broker:
            from veneur_tpu_torch.sinks.kafka import (KafkaMetricSink,
                                                      KafkaSpanSink)
            self.metric_sinks.append(KafkaMetricSink(
                c.kafka_broker, check_topic=c.kafka_check_topic,
                event_topic=c.kafka_event_topic,
                metric_topic=c.kafka_metric_topic,
                require_acks=c.kafka_metric_require_acks,
                partitioner=c.kafka_partitioner,
                retry_max=c.kafka_retry_max,
                buffer_bytes=c.kafka_metric_buffer_bytes,
                buffer_messages=c.kafka_metric_buffer_messages))
            if c.kafka_span_topic:
                self.span_sinks.append(KafkaSpanSink(
                    c.kafka_broker, span_topic=c.kafka_span_topic,
                    serialization=c.kafka_span_serialization_format,
                    require_acks=c.kafka_span_require_acks,
                    partitioner=c.kafka_partitioner,
                    retry_max=c.kafka_retry_max,
                    buffer_bytes=c.kafka_span_buffer_bytes,
                    buffer_messages=c.kafka_span_buffer_mesages,
                    sample_rate_percent=(
                        c.kafka_span_sample_rate_percent),
                    sample_tag=c.kafka_span_sample_tag))
        if c.datadog_trace_api_address:
            from veneur_tpu_torch.sinks.datadog import DatadogSpanSink
            self.span_sinks.append(DatadogSpanSink(
                c.datadog_trace_api_address, hostname=c.hostname,
                buffer_size=c.datadog_span_buffer_size))
        if c.splunk_hec_address and c.splunk_hec_token:
            from veneur_tpu_torch.sinks.splunk import SplunkSpanSink

            def _dur(text: str) -> float:
                return parse_duration(text) if text else 0.0

            self.span_sinks.append(SplunkSpanSink(
                c.splunk_hec_address, c.splunk_hec_token,
                sample_rate=c.splunk_span_sample_rate,
                hostname=c.hostname,
                batch_size=c.splunk_hec_batch_size,
                submission_workers=c.splunk_hec_submission_workers,
                send_timeout=_dur(c.splunk_hec_send_timeout),
                ingest_timeout=_dur(c.splunk_hec_ingest_timeout),
                max_connection_lifetime=_dur(
                    c.splunk_hec_max_connection_lifetime),
                connection_lifetime_jitter=_dur(
                    c.splunk_hec_connection_lifetime_jitter),
                tls_validate_hostname=(
                    c.splunk_hec_tls_validate_hostname)))
        if c.xray_address:
            from veneur_tpu_torch.sinks.xray import XRaySpanSink
            # the server's common tags ride in segment metadata
            # (reference server.go passes Config.Tags as commonTags)
            self.span_sinks.append(XRaySpanSink(
                c.xray_address,
                sample_percentage=c.xray_sample_percentage,
                annotation_tags=tuple(c.xray_annotation_tags),
                common_tags=tags_to_dict(c.tags)))
        if c.lightstep_access_token:
            from veneur_tpu_torch.sinks.lightstep import LightStepSpanSink
            self.span_sinks.append(LightStepSpanSink(
                c.lightstep_access_token,
                collector_host=c.lightstep_collector_host,
                maximum_spans=c.lightstep_maximum_spans,
                num_clients=c.lightstep_num_clients,
                reconnect_period=parse_duration(
                    c.lightstep_reconnect_period or "5m")))
        if c.falconer_address:
            from veneur_tpu_torch.sinks.grpsink import FalconerSpanSink
            self.span_sinks.append(FalconerSpanSink(c.falconer_address))
        if c.flush_file:
            self.plugins.append(LocalFilePlugin(
                c.flush_file, self.flusher.hostname,
                fmt=c.flush_file_format, interval=self.interval))
        if c.aws_s3_bucket:
            from veneur_tpu_torch.sinks.s3 import S3Plugin
            self.plugins.append(S3Plugin(
                c.aws_s3_bucket, hostname=c.hostname,
                region=c.aws_region, endpoint=c.aws_s3_endpoint,
                access_key=c.aws_access_key_id,
                secret_key=c.aws_secret_access_key,
                fmt=c.flush_file_format, interval=self.interval))
        if c.sentry_dsn:
            # SDK-free DSN client (core/sentry.py), as the reference
            # initializes it when configured (server.go:357-365), with
            # the error-level log hook attached once (server.go:391-403)
            from veneur_tpu_torch.core.sentry import (SentryClient,
                                                      SentryLogHandler)
            self.sentry = SentryClient(c.sentry_dsn,
                                       server_name=c.hostname)
            # the latest server wins, like the SDK's global hub: drop a
            # handler an earlier server attached, then add ours;
            # shutdown removes it again
            root = logging.getLogger("veneur_tpu_torch")
            for h in list(root.handlers):
                if isinstance(h, SentryLogHandler):
                    root.removeHandler(h)
            self._sentry_handler = SentryLogHandler(self.sentry)
            root.addHandler(self._sentry_handler)

    def _warmup(self) -> None:
        """Load the native and kernel libraries and take one sample of
        each kind through a scratch table with the server's geometry:
        device step, swap and flush readout (``tpu_warmup``; reference
        server.go ``_warmup``), so the first interval's launches find
        everything loaded.  The scratch steps stay out of the launch
        registry; ``self.warmup`` keeps their seconds, the cluster
        merge kernel's launches and the flush's tally."""
        t0 = time.monotonic()
        with self.device_costs.excluded() as launched:
            native.load()
            if self.device.type == "cuda":
                cluster_merge.load()
            scratch = MetricTable(TableConfig(
                counter_rows=self.config.tpu_counter_rows,
                gauge_rows=self.config.tpu_gauge_rows,
                histo_rows=self.config.tpu_histo_rows,
                set_rows=self.config.tpu_set_rows,
                compression=float(self.config.tpu_compression),
                histo_slots=self.config.tpu_histo_slots),
                device=self.device)
            for s in (dsd.Sample("veneur.warmup", dsd.COUNTER, 1.0),
                      dsd.Sample("veneur.warmup", dsd.GAUGE, 1.0),
                      dsd.Sample("veneur.warmup", dsd.HISTOGRAM, 1.0),
                      dsd.Sample("veneur.warmup", dsd.TIMER, 1.0),
                      dsd.Sample("veneur.warmup", dsd.SET, "w")):
                scratch.ingest(s)
            res = self.flusher.flush(scratch.swap())
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        secs = time.monotonic() - t0
        self.warmup = {"seconds": secs,
                       "merge_launches": sum(launched.values()),
                       "tally": dict(res.tally),
                       "metrics": res.metric_count()}
        log.info("kernel warmup finished in %.2fs", secs)

    # ------------------------------------------------------------------

    def start(self) -> None:
        """Bind (or adopt) the listeners and start every thread; with
        checkpoints on, start the checkpointer and replay a crashed
        predecessor's surviving segments."""
        for ai, a in enumerate(self.config.statsd_listen_addresses):
            self._start_statsd(a, ai)
        for a in self.config.ssf_listen_addresses:
            self._start_ssf(a)
        self.span_worker.start()
        for sink in self.span_sinks:
            if hasattr(sink, "start"):
                sink.start()
        if self.config.enable_profiling:
            self._start_profiling()
        if self.config.http_address:
            self._start_http(self.config.http_address)
        for a in self.config.grpc_listen_addresses:
            _, host, port, _ = addrmod.parse_addr(a)
            srv = grpc_forward.ImportServer(
                self, f"{host}:{port}",
                credentials=self._grpc_credentials())
            srv.start()
            self.grpc_servers.append(srv)
            self.grpc_ports.append(srv.port)
        self._spawn("flush-loop", self._flush_loop)
        if self.config.flush_watchdog_missed_flushes > 0:
            self._spawn("watchdog", self._watchdog)
        for sink in self.metric_sinks:
            if hasattr(sink, "start"):
                sink.start()
        # cloak slots no listener claimed: close them (their queued
        # datagrams are orphaned, so say so)
        for name, sock in self._adopted_socks.items():
            log.warning("unclaimed cloaked listener %r; closing it", name)
            sock.close()
        self._adopted_socks.clear()
        if (self.config.checkpoint_enabled()
                and hasattr(self.table, "checkpoint_capture")):
            self._checkpointer = ckpt.Checkpointer(
                self, self.config.tpu_checkpoint_dir,
                self.config.checkpoint_interval_seconds(),
                self.incarnation)
            self._checkpointer.start()
            try:
                self._recover_from_checkpoints()
            except Exception:
                self.bump("recovery_errors")
                log.exception("checkpoint recovery failed")

    # ------------------------------------------------------------------
    # TLS

    def _build_tls(self) -> ssl.SSLContext | None:
        """TLS, mutual with an authority certificate, for the TCP statsd
        listener (reference server.go:484-518): ``tls_key`` and
        ``tls_certificate`` turn it on; ``tls_authority_certificate``
        alone is a configuration error."""
        c = self.config
        if not (c.tls_key and c.tls_certificate):
            if c.tls_authority_certificate:
                raise ValueError(
                    "tls_authority_certificate requires tls_key and "
                    "tls_certificate")
            return None
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(certfile=_matfile(c.tls_certificate),
                            keyfile=_matfile(c.tls_key))
        if c.tls_authority_certificate:
            ctx.load_verify_locations(
                cafile=_matfile(c.tls_authority_certificate))
            ctx.verify_mode = ssl.CERT_REQUIRED
        return ctx

    def _grpc_credentials(self):
        """Server credentials for the gRPC listeners from the same TLS
        material (reference networking.go:333-340); an authority
        certificate makes client certificates mandatory."""
        c = self.config
        if not (c.tls_key and c.tls_certificate):
            return None
        root = (_pem_bytes(c.tls_authority_certificate)
                if c.tls_authority_certificate else None)
        return grpc.ssl_server_credentials(
            [(_pem_bytes(c.tls_key), _pem_bytes(c.tls_certificate))],
            root_certificates=root,
            require_client_auth=root is not None)

    def _forward_grpc_credentials(self):
        """Channel credentials for dialing a TLS gRPC global, its
        recovery peer or a handoff peer (``forward_grpc_tls`` /
        ``forward_grpc_tls_ca``); the node's key and certificate, when
        set, are the client pair for mutual TLS.  None: insecure."""
        c = self.config
        if not (c.forward_grpc_tls or c.forward_grpc_tls_ca):
            return None
        root = (_pem_bytes(c.forward_grpc_tls_ca)
                if c.forward_grpc_tls_ca else None)
        key = cert = None
        if c.tls_key and c.tls_certificate:
            key = _pem_bytes(c.tls_key)
            cert = _pem_bytes(c.tls_certificate)
        return grpc.ssl_channel_credentials(
            root_certificates=root, private_key=key,
            certificate_chain=cert)

    def _start_statsd(self, addr: str, index: int) -> None:
        """One statsd address: ``udp://`` gets ``num_readers`` readers,
        each on its own socket (SO_REUSEPORT when there are several, a
        cloak slot each for fd adoption); ``tcp://`` an acceptor and a
        thread per connection; ``unix://`` (``unixgram://``) one
        datagram reader on a path no other server holds."""
        scheme, host, port, path = addrmod.parse_addr(addr)
        rcvbuf = self.config.read_buffer_size_bytes
        if scheme == "udp":
            # the drain tier (and, under "auto" or "uring", the probe)
            # before the readers spawn, so a refused probe counts once
            self._resolve_ingest_backend()
            n = max(1, self.config.num_readers)
            for i in range(n):
                slot = f"statsd.udp.{index}.{i}"
                sock = self._adopted_socks.pop(slot, None)
                if sock is not None:
                    # the predecessor's bound socket: datagrams queued
                    # in the kernel across the restart are read here
                    self.restarts_adopted += 1
                    self.bump("listener_fds_adopted")
                else:
                    sock = socket.socket(socket.AF_INET,
                                         socket.SOCK_DGRAM)
                    if n > 1:
                        sock.setsockopt(socket.SOL_SOCKET,
                                        socket.SO_REUSEPORT, 1)
                    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                    rcvbuf)
                    sock.bind((host, port))
                # the kernel hashes a wake datagram to one member of a
                # reuseport group: the timeout is what makes every
                # reader see shutdown
                sock.settimeout(0.2)
                port = sock.getsockname()[1]  # port 0 resolved once
                self.sockets.append(sock)
                self._cloak_slots[slot] = sock
                self._spawn(f"udp-reader-{len(self.sockets) - 1}",
                            self._udp_reader, sock, i)
            self.statsd_ports.append(port)
        elif scheme == "tcp":
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((host, port))
            sock.listen(128)
            sock.settimeout(0.2)
            if self._tls_context is not None:
                # TLS on the listener (reference server.go:484-518);
                # each handshake runs in its connection's thread, so a
                # slow client cannot hold the acceptor
                sock = self._tls_context.wrap_socket(
                    sock, server_side=True,
                    do_handshake_on_connect=False)
            self._listeners.append(sock)
            self.statsd_ports.append(sock.getsockname()[1])
            self._spawn("tcp-acceptor", self._acceptor, sock,
                        self._tcp_conn)
        else:
            self._acquire_socket_lock(path)
            if os.path.exists(path):
                os.unlink(path)
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
            sock.bind(path)
            sock.settimeout(0.2)
            self._listeners.append(sock)
            self._spawn("unixgram-reader", self._udp_reader, sock, 0,
                        "dogstatsd-unixgram")

    def _acquire_socket_lock(self, path: str) -> None:
        """A single-owner flock on ``<path>.lock`` before binding a unix
        socket (reference networking.go:362 acquireLockForSocket): a
        second server refuses the path instead of unlinking it and
        splitting the stream.  Held until shutdown; the lock file
        stays."""
        import fcntl
        lockname = path + ".lock"
        fd = os.open(lockname, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            raise RuntimeError(
                f"lock file {lockname!r} is held by another process "
                f"already; refusing to take over {path!r}")
        self._socket_locks.append((lockname, fd))

    def _start_ssf(self, addr: str) -> None:
        """An SSF listener (reference networking.go:205 StartSSF):
        ``udp://`` datagrams carry one bare SSFSpan each, ``unix://``
        streams carry framed spans."""
        scheme, host, port, path = addrmod.parse_addr(addr)
        if scheme == "udp":
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                            self.config.read_buffer_size_bytes)
            sock.bind((host, port))
            sock.settimeout(0.2)
            self._listeners.append(sock)
            self.ssf_ports.append(sock.getsockname()[1])
            self._spawn("ssf-udp", self._ssf_packet_reader, sock)
        else:
            self._acquire_socket_lock(path)
            if os.path.exists(path):
                os.unlink(path)
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.bind(path)
            sock.listen(64)
            sock.settimeout(0.2)
            self._listeners.append(sock)
            self._spawn("ssf-unix", self._acceptor, sock,
                        self._ssf_stream_conn)

    def _acceptor(self, sock: socket.socket, handler) -> None:
        """Accept stream connections until shutdown, one thread each
        (tracked, so shutdown can end them)."""
        while not self._shutdown.is_set():
            try:
                conn, _ = sock.accept()
            except socket.timeout:
                continue
            except ssl.SSLError:
                # a failed handshake: count it and keep accepting
                if not self._shutdown.is_set():
                    self.bump("tls_handshake_errors")
                continue
            except OSError:
                return
            conn.settimeout(None)
            with self._conns_lock:
                self._conns.add(conn)
            # not in self._threads: shutdown ends connections by
            # shutting their sockets down
            threading.Thread(target=handler, args=(conn,), daemon=True,
                             name=f"{threading.current_thread().name}"
                                  f"-conn").start()

    def _close_conn(self, conn: socket.socket) -> None:
        with self._conns_lock:
            self._conns.discard(conn)
        conn.close()

    def _tcp_conn(self, conn: socket.socket) -> None:
        """Newline-delimited statsd over TCP (reference server.go:1374
        handleTCPGoroutine): each read's complete lines go through
        ``handle_packet_batch`` as one packet each; a partial line
        longer than ``metric_max_length`` is a packet error; the
        connection closes after ``_TCP_IDLE_S`` idle."""
        conn.settimeout(_TCP_IDLE_S)
        if isinstance(conn, ssl.SSLSocket):
            # the handshake, in this connection's thread; a client
            # without a certificate the authority signed fails here
            try:
                conn.do_handshake()
            except (OSError, ssl.SSLError):
                if not self._shutdown.is_set():
                    self.bump("tls_handshake_errors")
                self._close_conn(conn)
                return
        max_len = self.config.metric_max_length
        buf = b""
        try:
            while not self._shutdown.is_set():
                chunk = conn.recv(65536)
                if not chunk:
                    break
                buf += chunk
                *lines, buf = buf.split(b"\n")
                lines = [ln for ln in lines if ln]
                if lines:
                    self.handle_packet_batch(lines)
                    self.bump("received_dogstatsd-tcp", len(lines))
                if len(buf) > max_len:
                    self.bump("packet_errors")
                    buf = b""
        except OSError:
            pass
        finally:
            self._close_conn(conn)

    def _ssf_packet_reader(self, sock: socket.socket) -> None:
        """UDP SSF: one span per datagram (reference server.go:1300
        ReadSSFPacketSocket); an unparsable datagram counts in
        ``ssf_errors``."""
        bufsize = min(self.config.trace_max_length_bytes,
                      _SSF_DATAGRAM_MAX)
        while not self._shutdown.is_set():
            try:
                data = sock.recv(bufsize)
            except socket.timeout:
                continue
            except OSError:
                return
            if not data:
                continue
            try:
                span = wire.parse_ssf(data)
            except wire.SSFParseError:
                self.bump("ssf_errors")
                continue
            self.bump("received_ssf-udp")
            self.handle_ssf(span)

    def _ssf_stream_conn(self, conn: socket.socket) -> None:
        """Framed SSF on a unix stream (reference server.go:1335
        ReadSSFStreamSocket): a framing error drops the connection, a
        bad payload only its span."""
        f = conn.makefile("rb")
        try:
            while not self._shutdown.is_set():
                try:
                    span = wire.read_ssf(f)
                except wire.SSFParseError:
                    self.bump("ssf_errors")
                    continue
                except wire.FramingError:
                    self.bump("ssf_errors")
                    return
                if span is None:
                    return
                self.bump("received_ssf-unix")
                self.handle_ssf(span)
        except OSError:
            pass
        finally:
            f.close()
            self._close_conn(conn)

    def handle_ssf(self, span) -> None:
        """Enqueue one span for the span workers (reference
        server.go:1190 handleSSF); the listeners count receipts."""
        if self.config.debug_ingested_spans:
            log.debug("ingested span service=%s name=%s trace=%s",
                      span.service, span.name, span.trace_id)
        self.span_worker.submit(span)

    def ingest_parsed(self, parsed, bump: bool = True) -> tuple[int, int]:
        """Ingest one parsed sample, service check or event through
        ``ingest_samples``.  Returns (processed, dropped)."""
        events, checks = (), ()
        if isinstance(parsed, dsd.ServiceCheck):
            checks = (parsed,)
            parsed = _check_sample(parsed)
        elif isinstance(parsed, dsd.Event):
            events = (parsed,)
        elif not isinstance(parsed, dsd.Sample):
            return 0, 0
        processed, dropped, _shed = self.ingest_samples(
            [parsed] if not events else [], bump, events=events,
            checks=checks)
        return processed, dropped

    def ingest_samples(self, samples: list, bump: bool = False,
                       events=(), checks=()) -> tuple[int, int, int]:
        """Ingest parsed samples (service checks as STATUS samples) under
        one hold of the lock: overload admission for all but STATUS, the
        table, the ledger credit in the same critical section, and the
        mid-interval device step.  ``events`` and ``checks`` (the parsed
        service checks whose STATUS samples are among ``samples``) join
        the interval's buffers for the sinks' ``flush_other_samples`` in
        the same hold.  The per-line path and the span plane's extracted
        samples come here.  With ``bump`` the counts go to the server's
        stats.  Returns (processed, dropped, shed)."""
        if not samples:
            if events:
                with self.lock:
                    self.events.extend(events)
            return 0, 0, 0
        adm = self.overload is not None and self.overload.admission_active
        n_status = sum(1 for s in samples if s.type == dsd.STATUS)
        dropped = shed = 0
        shed_by: dict = {}
        with self.lock:
            for sample in samples:
                if adm and sample.type != dsd.STATUS:
                    ok, tenant, reason = self.overload.admit_sample(
                        sample, self.table)
                    if not ok:
                        shed += 1
                        k = (tenant, reason)
                        shed_by[k] = shed_by.get(k, 0) + 1
                        continue
                if not self.table.ingest(sample):
                    dropped += 1
            if events:
                self.events.extend(events)
            if checks:
                self.checks.extend(checks)
            self.ledger.ingest(
                "dogstatsd", processed=len(samples),
                staged=len(samples) - dropped - n_status - shed,
                overflow=dropped, status=n_status, shed=shed)
            if shed:
                self.ledger.credit_shed(shed_by)
            work = self._maybe_device_step_locked()
        self._apply_staged(work)
        if bump:
            with self._stats_lock:
                st = self.stats
                st["metrics_processed"] += len(samples)
                st["metrics_dropped"] += dropped
                if shed:
                    st["metrics_shed"] = st.get("metrics_shed", 0) + shed
        return len(samples), dropped, shed

    def _start_http(self, address: str) -> None:
        host, _, port = address.rpartition(":")
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _ok(self, body: bytes = b"ok",
                    ctype: str = "text/plain") -> None:
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path
                if path == "/healthcheck":
                    self._ok()
                elif path == "/version":
                    self._ok(__version__.encode())
                elif path == "/builddate":
                    self._ok(b"dev")
                elif path == "/quitquitquit" and server.config.http_quit:
                    # graceful shutdown (reference server.go:82
                    # httpQuit): answer, then stop from another thread
                    self._ok(b"terminating")
                    threading.Thread(target=server.shutdown,
                                     daemon=True).start()
                elif path.startswith("/debug/pprof"):
                    debughttp.pprof(self, server._pprof_lock)
                elif path.startswith("/debug/flushes"):
                    debughttp.respond_ok(
                        self, server.flush_ring.to_json(
                            limit=debughttp.query_int(path, "n", 0)),
                        "application/json")
                elif path.startswith("/debug/ledger"):
                    debughttp.ledger_dump(
                        self, server.ledger,
                        limit=debughttp.query_int(path, "n", 0))
                elif path.startswith("/debug/signals"):
                    debughttp.signals_dump(self, server.signals, path)
                elif path.startswith("/debug/flight"):
                    debughttp.flight_dump(self, server.flight, path)
                elif path.startswith("/debug/cluster"):
                    debughttp.respond_ok(
                        self, json.dumps(server._cluster_view(),
                                         indent=1).encode(),
                        "application/json")
                elif path.startswith("/debug/trace"):
                    debughttp.trace_dump(self, server.trace_index, path)
                elif path.startswith("/debug/overload"):
                    debughttp.respond_ok(
                        self, json.dumps(
                            server.overload.snapshot()
                            if server.overload is not None
                            else {"enabled": False}, indent=2).encode(),
                        "application/json")
                elif path.startswith("/debug/vars"):
                    debughttp.vars_dump(self, server.debug_vars())
                else:
                    self.send_error(404)

            def do_POST(self):
                if self.path != "/import":
                    self.send_error(404)
                    return
                body = self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))
                try:
                    acc = server.handle_import(
                        body, self.headers.get("Content-Encoding", ""),
                        self.headers)
                except (ValueError, zlib.error) as e:
                    server.bump("import_errors")
                    self.send_error(400, str(e))
                    return
                self._ok(json.dumps({"accepted": acc}).encode(),
                         "application/json")

        adopted = self._adopted_socks.pop("http", None)
        if adopted is not None:
            # the predecessor's listening socket: connections queued in
            # its accept backlog are served and the port never frees
            self._httpd = http.server.ThreadingHTTPServer(
                adopted.getsockname()[:2], Handler,
                bind_and_activate=False)
            self._httpd.socket.close()
            self._httpd.socket = adopted
            (self._httpd.server_name,
             self._httpd.server_port) = adopted.getsockname()[:2]
            self.restarts_adopted += 1
            self.bump("listener_fds_adopted")
        elif address.startswith("einhorn@"):
            # einhorn's inherited listening socket (reference README
            # "Einhorn Usage": http_address einhorn@0), then the worker
            # ack, so the master stops routing to the old worker
            _, _, fd_idx, _ = addrmod.parse_addr(address)
            sock = socket.fromfd(int(os.environ[f"EINHORN_FD_{fd_idx}"]),
                                 socket.AF_INET, socket.SOCK_STREAM)
            self._httpd = http.server.ThreadingHTTPServer(
                sock.getsockname()[:2], Handler, bind_and_activate=False)
            self._httpd.socket.close()
            self._httpd.socket = sock
            (self._httpd.server_name,
             self._httpd.server_port) = sock.getsockname()[:2]
            self._einhorn_ack()
        else:
            self._httpd = http.server.ThreadingHTTPServer(
                (host or "127.0.0.1", int(port)), Handler)
        self._httpd.daemon_threads = True
        self.http_port = self._httpd.server_port
        self._cloak_slots["http"] = self._httpd.socket
        self._spawn("http", self._httpd.serve_forever)

    def _einhorn_ack(self) -> None:
        """The einhorn worker ack over ``EINHORN_SOCK_PATH`` (a wedged
        master gets 5 s, then a warning: start-up goes on)."""
        path = os.environ.get("EINHORN_SOCK_PATH")
        if not path:
            return
        try:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
                c.settimeout(5.0)
                c.connect(path)
                c.sendall((json.dumps({"command": "worker:ack",
                                       "pid": os.getpid()})
                           + "\n").encode())
        except OSError as e:
            log.warning("einhorn ack failed: %s", e)

    def handle_import(self, body: bytes, content_encoding: str = "",
                      headers=None) -> int:
        """Decode one ``/import`` body and merge it into the table under
        the table lock (past the staging bound, the device step follows
        the lock's release) through ``apply_import_locked``: a recovery
        wire already applied here is accepted and discarded, the rest
        credit the ledger under the protocol the wire's flags name.  A
        trace header parents the ``import`` span under the sender's
        forward span.  Raises ValueError (or zlib.error) on a malformed
        body, before anything is merged.  Returns the accepted item
        count."""
        t0 = time.monotonic_ns()
        items = http_import.decode_body(body, content_encoding)
        flags = http_import.decode_headers(headers or {})
        flagged = any(flags[k] for k in ("drain", "replay", "recovery",
                                         "handoff"))
        with self.lock:
            acc, dropped, deduped = self.apply_import_locked(
                "http-import", flags,
                lambda: http_import.apply_import(self.table, items))
            work = (None if deduped
                    else self._maybe_device_step_locked())
        self._apply_staged(work)
        self.note_import_span("http", acc, dropped, *flags["trace"],
                              nbytes=len(body))
        self.bump("imports_received", acc)
        self.bump("metrics_dropped", dropped)
        self.bump("import_flagged_wires", int(flagged))
        self.note_flagged_import(flags, acc, deduped)
        self.bump("import_response_ns", time.monotonic_ns() - t0)
        self.bump("import_responses")
        return acc

    def apply_import_locked(self, base: str, flags: dict, apply
                            ) -> tuple[int, int, bool]:
        """Apply one decoded import wire (``apply()`` returns
        (accepted, dropped)) and credit the ledger, under ``base``
        suffixed by the wire's flag.  The caller holds ``self.lock``, so
        the recovery dedup is atomic with the apply: a recovery id
        already applied here is not applied again (returns deduped
        True).  A recovery wire also credits the ledger's ``recover``
        arm, a handoff wire the reshard arrival.  Returns (accepted,
        dropped, deduped)."""
        rid = flags["recovery"]
        if rid:
            if rid in self._recovery_seen:
                return 0, 0, True
            self._recovery_seen.add(rid)
        # the overflow delta splits the drops into overflow (the table
        # counted them) and invalid (dropped before it)
        ov0 = self.table.overflow_total()
        acc, dropped = apply()
        ov = self.table.overflow_total() - ov0
        self.ledger.ingest(http_import.import_protocol(base, flags),
                           processed=acc + dropped, staged=acc,
                           overflow=ov, invalid=dropped - ov)
        if rid:
            self.ledger.recover(f"incarnation:{rid.split(':', 1)[0]}",
                                acc)
        if flags["handoff"]:
            self.ledger.credit_reshard_received(acc)
        return acc, dropped, False

    def note_flagged_import(self, flags: dict, accepted: int,
                            deduped: bool = False) -> None:
        """Count a flagged wire: a peer's drain (its shutdown flush),
        replay (its spool, after riding out our outage), recovery (a
        crashed peer's checkpoint; a retransmit counts as deduped) or
        handoff (arcs this node now owns).  All stage into the current
        interval, late but counted."""
        if deduped:
            self.bump("recovery_wires_deduped")
            return
        for key in ("drain", "replay", "recovery", "handoff"):
            if flags[key]:
                self.bump(f"{key}_wires_received")
                self.bump(f"{key}_items_received", accepted)

    def note_import_span(self, protocol: str, accepted: int,
                         dropped: int, trace_id: int, span_id: int,
                         nbytes: int = 0) -> None:
        """Record this tier's half of a cross-process flush trace: the
        sending tier stamped its cycle's (trace_id, span_id) onto the
        wire, so the import span recorded here parents under the remote
        forward span and the interval stitches into one tree at
        /debug/trace/<trace_id> on either end."""
        if not trace_id or not self.config.tpu_trace_propagation:
            return
        sp = Span("import", service="veneur", trace_id=trace_id,
                  parent_id=span_id,
                  tags={"protocol": protocol, "accepted": str(accepted),
                        "dropped": str(dropped), "bytes": str(nbytes)})
        sp.finish(self.trace_client)
        self.trace_index.add(sp.proto)

    def bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] = self.stats.get(key, 0) + n

    def _crashguard(self, fn):
        """Wrap a thread target so a crashing exception is reported to
        Sentry (with its stack, flushed within the timeout) before it
        propagates — the reference defers ConsumePanic in every
        long-lived goroutine (server.go:434,897,994,1040,1376)."""
        from veneur_tpu_torch.core import sentry as _sentry

        def run(*a, **kw):
            try:
                return fn(*a, **kw)
            except BaseException as e:
                # consume_panic re-raises; threading.excepthook prints
                # the traceback.  Not logged through the package logger:
                # the SentryLogHandler would report it twice.
                _sentry.consume_panic(self.sentry, self.flusher.hostname,
                                      e)
        return run

    def _spawn(self, name: str, fn, *args) -> None:
        """Start a long-lived thread under ``_crashguard``."""
        t = threading.Thread(target=self._crashguard(fn), args=args,
                             name=name, daemon=True)
        t.start()
        self._threads.append(t)

    def bound_ports(self) -> list[int]:
        """The statsd sockets' ports, then the gRPC listeners'."""
        return [s.getsockname()[1] for s in self.sockets] + self.grpc_ports

    def _pin_reader_core(self, index: int) -> bool:
        """Pin this reader thread to one core (``tpu_reader_pin_cores``:
        "auto" = reader i on the i-th usable core when there are at
        least as many cores as readers, "off", or a comma list).
        Returns whether it pinned; pinning never fails a reader."""
        pin = self.config.tpu_reader_pin_cores
        if pin == "off" or not hasattr(os, "sched_setaffinity"):
            return False
        try:
            avail = sorted(os.sched_getaffinity(0))
            if pin == "auto":
                if len(avail) < max(1, self.config.num_readers):
                    return False  # oversubscribed: pins would stack
                core = avail[index % len(avail)]
            else:
                cores = [int(c) for c in pin.split(",") if c.strip()]
                core = cores[index % len(cores)]
                if core not in avail:
                    return False
            os.sched_setaffinity(0, {core})
        except (OSError, ValueError):
            return False
        return True

    def _reader_shard(self):
        """A reader's ReaderShard on the multi-reader fused path, None
        where one reader (``ingest_buffer``) or the split columnar path
        (``tpu_multi_reader_fused: false``) runs."""
        make = getattr(self.table, "make_reader_shard", None)
        if (make is not None and self.config.num_readers > 1 and
                self.config.tpu_multi_reader_fused):
            return make()
        return None

    def _resolve_ingest_backend(self) -> str:
        """``tpu_ingest_backend`` as the tier the UDP readers run:
        "uring", "recvmmsg" or "python"; "auto" and "uring" probe the
        kernel, and a refusal lands on recvmmsg, counted by reason.
        Resolved once: the answer cannot change within a process."""
        if self.ingest_backend is not None:
            return self.ingest_backend
        mode = self.config.tpu_ingest_backend
        if mode in ("python", "recvmmsg"):
            self.ingest_backend = mode
            return mode
        err = uring.probe(native.load())
        self._uring_probe_err = err
        if err == 0:
            self.ingest_backend = "uring"
        else:
            self.ingest_backend = "recvmmsg"
            self._note_backend_fallback(
                uring.probe_reason(err),
                "start-up probe refused (%s)" % os.strerror(-err))
        return self.ingest_backend

    def _note_backend_fallback(self, reason: str, detail: str) -> None:
        """Count (by reason) and log once a drop from the ring to the
        recvmmsg tier."""
        self.bump("socket_backend_fallback")
        self.bump(f"socket_backend_fallback_{reason}")
        if not self._backend_fallback_logged:
            self._backend_fallback_logged = True
            log.warning("io_uring ingest unavailable: %s; readers run "
                        "the recvmmsg drain tier", detail)

    def _udp_reader(self, sock: socket.socket, index: int = 0,
                    proto: str = "dogstatsd-udp") -> None:
        """One datagram reader on the resolved tier.  "uring": the
        multishot ring, parsed in place (``_uring_reader``); a ring
        refused or dead at runtime continues this reader on recvmmsg,
        never ends it.  "recvmmsg": block on the first datagram, then
        drain the queue with one ``vtpu_recv_drain`` sweep.  "python":
        one ``recv`` and one batch a datagram."""
        self._pin_reader_core(index)
        shard = self._reader_shard()
        backend = self._resolve_ingest_backend()
        if (backend == "uring" and proto == "dogstatsd-udp"
                and sock.family == socket.AF_INET
                and hasattr(self.table, "make_reader_shard")):
            # the ring's in-place parse is a shard pass, one reader too
            if self._uring_reader(sock, proto,
                                  shard or self.table.make_reader_shard()):
                return  # clean shutdown on the ring
        max_len = self.config.metric_max_length
        # one byte past the limit: a longer datagram arrives truncated
        # to max_len + 1 and is rejected
        bufsize = max_len + 1
        if backend == "python":
            while not self._shutdown.is_set():
                try:
                    data = sock.recv(bufsize)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if data:
                    self.handle_packet_batch([data], shard=shard)
                    self.bump(f"received_{proto}")
            return
        lib = native.load()
        sweep = min(self.config.reader_batch_packets - 1, _DRAIN_MAX)
        drain_buf = np.empty(max(1, sweep) * (bufsize + 1), np.uint8)
        drain_ptr = native.ptr(drain_buf, ctypes.c_uint8)
        n_msgs = ctypes.c_int32(0)
        n_over = ctypes.c_int32(0)
        while not self._shutdown.is_set():
            try:
                data = sock.recv(bufsize)
            except socket.timeout:
                continue
            except OSError:
                return
            if not data:
                continue
            # the first read blocks (shutdown and socket errors surface
            # here); the rest of the queue comes in one recvmmsg sweep
            nbytes = lib.vtpu_recv_drain(
                sock.fileno(), drain_ptr, drain_buf.nbytes, sweep, max_len,
                ctypes.byref(n_msgs), ctypes.byref(n_over))
            n_pkts = 1 + (int(n_msgs.value) if nbytes else 0) + int(
                n_over.value)
            t0 = time.monotonic_ns()
            processed = self.handle_packet_batch(
                [data], drained=drain_buf[:nbytes].tobytes() if nbytes
                else None,
                drained_pkts=int(n_msgs.value) if nbytes else 0,
                oversize=int(n_over.value), shard=shard)
            self.device_costs.add_reader_batch(
                threading.current_thread().name, n_pkts, processed,
                time.monotonic_ns() - t0, fused=shard is not None)
            self.bump(f"received_{proto}", n_pkts)

    def _uring_reader(self, sock: socket.socket, proto: str,
                      shard) -> bool:
        """The io_uring tier: True on a clean shutdown, False when the
        ring could not be built or died (the caller goes on with the
        recvmmsg tier).  The kernel lands datagrams in the ring's
        buffer pool while the previous batch parses, and
        ``ReaderShard.parse_ring`` reads them in place; the buffers
        behind slow-path lines are released after the commit.  While
        overload admission is active the ring drains by copy into
        ``handle_packet_batch``, whose columnar branch admits."""
        max_len = self.config.metric_max_length
        try:
            ring = uring.UringReader(native.load(), sock.fileno(),
                                     self.config.tpu_uring_buffers,
                                     max_len + 1)
        except (uring.UringError, ValueError) as e:
            self._note_backend_fallback(getattr(e, "reason", "error"),
                                        "ring setup failed (%s)" % e)
            return False
        name = threading.current_thread().name
        self._urings[name] = ring
        drain_buf = np.empty(min(ring.buf_count, _DRAIN_MAX)
                             * (max_len + 2), np.uint8)
        # a walk takes at most half the pool: the in-place pass holds
        # its buffers through the commit, and a walk that held them all
        # would end the multishot receive with ENOBUFS every cycle
        max_msgs = max(1, ring.buf_count // 2)
        # the last walk's size asks the kernel to pool completions
        # under load; at a trickle, a wake a datagram
        wait_batch = 1
        max_batch = min(max_msgs, _DRAIN_MAX)
        try:
            while not self._shutdown.is_set():
                # idle, a walk waits 200 ms: the readers' shutdown check
                # (the sockets' timeout), where the reference waits 1 s
                wait_ms = 50 if wait_batch > 1 else 200
                try:
                    t0 = time.monotonic_ns()
                    if (self.overload is not None
                            and self.overload.admission_active):
                        nbytes, n_msgs, n_over, n_eb = ring.drain(
                            drain_buf, max_batch, max_len, wait_ms,
                            wait_batch)
                        self._uring_batch_stats(proto, n_over, n_eb)
                        wait_batch = min(max_batch, max(1, n_msgs // 2))
                        if n_msgs == 0:
                            continue
                        processed = self.handle_packet_batch(
                            [], drained=drain_buf[:nbytes].tobytes(),
                            drained_pkts=n_msgs)
                        fused = False
                    else:
                        nbytes, n_msgs, n_over, n_eb = shard.parse_ring(
                            ring, max_msgs, max_len, wait_ms, wait_batch)
                        self._uring_batch_stats(proto, n_over, n_eb)
                        wait_batch = min(max_batch, max(1, n_msgs // 2))
                        if n_msgs == 0:
                            continue
                        processed = self._commit_ring(shard, ring, n_msgs)
                        fused = True
                    self.device_costs.add_reader_batch(
                        name, n_msgs, processed,
                        time.monotonic_ns() - t0, fused=fused)
                    self.bump(f"received_{proto}", n_msgs)
                except uring.UringError as e:
                    self._note_backend_fallback(
                        e.reason, "ring died at runtime (%s)" % e)
                    return False
        finally:
            self._urings.pop(name, None)
            ring.close()
        return True

    def _commit_ring(self, shard, ring, n_msgs: int) -> int:
        """Merge a ring walk under the lock, copy its slow-path lines out
        of the arena, hand the held buffers back, then parse those lines
        (``handle_packet_batch``'s shard branch, fed from the ring).
        Returns the processed sample count."""
        with self.lock:
            processed, dropped, others = shard.commit()
            self.ledger.ingest("dogstatsd", processed=processed,
                               staged=processed - dropped,
                               overflow=dropped)
            work = self._maybe_device_step_locked()
        self._apply_staged(work)
        shard.reset()
        # the offsets index the arena (or the epoch fall-back's copy):
        # slice before release returns the buffers to the kernel
        src = shard.last_slow_src
        if isinstance(src, bytes):
            lines = [src[off:off + ln] for off, ln, _kind in others]
        else:
            lines = [src[off:off + ln].tobytes()
                     for off, ln, _kind in others]
        ring.release()
        return self._finish_batch(lines, n_msgs, 0, processed, dropped, 0)

    def _uring_batch_stats(self, proto: str, n_over: int,
                           n_eb: int) -> None:
        """Oversize datagrams were received and rejected whole (a parse
        error in the ledger, as a truncated recvmmsg datagram is);
        ENOBUFS completions are drops at the buffer pool, a kernel-side
        loss like ``/proc/net/udp``'s."""
        if n_over:
            self.bump(f"received_{proto}", n_over)
            self.bump("packet_errors", n_over)
            self.ledger.ingest("dogstatsd", parse_errors=n_over)
        if n_eb:
            self.bump("socket_uring_enobufs", n_eb)

    def handle_packet(self, data: bytes) -> None:
        """Ingest one datagram (possibly multi-line)."""
        self.handle_packet_batch([data])

    def handle_packet_batch(self, packets: list[bytes],
                            drained: bytes | None = None,
                            drained_pkts: int = 0,
                            oversize: int = 0, shard=None) -> int:
        """Ingest many datagrams in one native pass.  ``drained`` is the
        recvmmsg sweep's newline-joined chunk of ``drained_pkts``
        datagrams, already length-checked; ``oversize`` counts datagrams
        the sweep rejected.  With ``shard`` (this reader's ReaderShard)
        the pass runs without the lock and only the merge holds it; a
        single-reader server runs ``ingest_buffer`` under the lock;
        otherwise (the split path, and a multi-reader server's packets
        from elsewhere, e.g. gRPC SendPacket) the batch parses into
        columns outside the lock and ``ingest_columns`` runs under it.
        Each branch credits the ledger in the critical section of its
        merge (a shard's lock-free ``parse`` does no ledger work).  While
        overload admission is active (tenant budgets, or pressure
        engaged) the batch takes the columnar branch, whose
        ``admit_columns`` rewrites shed lines to ``CODE_SHED`` under the
        lock, and the per-line samples pass ``admit_sample``; otherwise
        the fused branches run with one boolean check.  Returns the
        processed sample count."""
        errors = oversize
        good = []
        for p in packets:
            if len(p) > self.config.metric_max_length:
                errors += 1
            else:
                good.append(p)
        n_pkts = len(good) + drained_pkts
        if drained is not None:
            good.append(drained)
        buf = b"\n".join(good)
        adm = self.overload is not None and self.overload.admission_active
        shed = 0
        if shard is not None and not adm:
            shard.parse(buf)
            with self.lock:
                processed, dropped, others = shard.commit()
                self.ledger.ingest("dogstatsd", processed=processed,
                                   staged=processed - dropped,
                                   overflow=dropped)
                work = self._maybe_device_step_locked()
            self._apply_staged(work)
            shard.reset()
            lines = [buf[off:off + ln] for off, ln, _kind in others]
        elif (self.config.num_readers <= 1 and not adm
              and hasattr(self.table, "ingest_buffer")):
            with self.lock:
                processed, dropped, others = self.table.ingest_buffer(buf)
                self.ledger.ingest("dogstatsd", processed=processed,
                                   staged=processed - dropped,
                                   overflow=dropped)
                work = self._maybe_device_step_locked()
            self._apply_staged(work)
            lines = [buf[off:off + ln] for off, ln, _kind in others]
        else:
            # views into this thread's own parser scratch, consumed
            # before the thread parses again
            parser = getattr(self._parsers, "p", None)
            if parser is None:
                parser = self._parsers.p = columnar.ColumnarParser()
            pb = parser.parse(buf, copy=False)
            with self.lock:
                if adm:
                    # shed lines leave this critical section attributed
                    shed, shed_by = self.overload.admit_columns(
                        pb, self.table)
                processed, dropped = self.table.ingest_columns(pb)
                self.ledger.ingest("dogstatsd", processed=processed + shed,
                                   staged=processed - dropped,
                                   overflow=dropped, shed=shed)
                if shed:
                    self.ledger.credit_shed(shed_by)
                work = self._maybe_device_step_locked()
            self._apply_staged(work)
            processed += shed
            # shed lines are accounted above: not errors, not events
            tc = pb.type_code[:pb.n]
            lines = [pb.line(int(i)) for i in np.nonzero(
                (tc > columnar.CODE_SET) & (tc != columnar.CODE_SHED))[0]]
        return self._finish_batch(lines, n_pkts, errors, processed,
                                  dropped, shed)

    def _finish_batch(self, lines: list[bytes], n_pkts: int, errors: int,
                      processed: int, dropped: int, shed: int) -> int:
        """A batch's events, service checks and malformed lines through
        the per-line parse, then its counts into the stats and its parse
        errors into the ledger.  Returns the processed sample count."""
        slow = []
        events = []
        checks = []
        for line in lines:
            try:
                parsed = dsd.parse_line(line)
            except dsd.ParseError:
                errors += 1
                continue
            if isinstance(parsed, dsd.Sample):
                slow.append(parsed)
            elif isinstance(parsed, dsd.ServiceCheck):
                slow.append(_check_sample(parsed))
                checks.append(parsed)
            elif isinstance(parsed, dsd.Event):
                events.append(parsed)
        if slow or events:
            n, slow_dropped, slow_shed = self.ingest_samples(
                slow, events=events, checks=checks)
            processed += n
            dropped += slow_dropped
            shed += slow_shed
        if errors:
            # informational, not a balance input: out of the lock
            self.ledger.ingest("dogstatsd", parse_errors=errors)
        with self._stats_lock:
            self.stats["packets_received"] += n_pkts
            self.stats["packet_errors"] += errors
            self.stats["metrics_processed"] += processed
            self.stats["metrics_dropped"] += dropped
            if shed:
                self.stats["metrics_shed"] = (
                    self.stats.get("metrics_shed", 0) + shed)
        return processed

    def _maybe_device_step_locked(self):
        """Past ``tpu_stage_flush_samples`` staged samples, the
        mid-interval device step (it bounds host staging).  Caller
        holds the lock.  Pipelined, it returns the detached work, which
        the caller hands to ``_apply_staged`` once the lock is released;
        serial, it applies inline and returns None."""
        if self.table.staged() < self.config.tpu_stage_flush_samples:
            return None
        if self.pipeline:
            return self.table.take_staged()
        self.table.device_step()
        return None

    def _apply_staged(self, work) -> None:
        """Apply detached work outside the lock (``complete_swap`` waits
        for it, so nothing crosses the swap)."""
        if work is not None:
            self.table.apply_staged(work)

    # ------------------------------------------------------------------

    def _first_tick(self, wall: float, mono: float) -> float:
        """The flush loop's first deadline (monotonic): one interval
        out, or with ``synchronize_with_interval`` the next multiple of
        the interval on the wall clock."""
        if self.config.synchronize_with_interval:
            return mono + (self.interval - wall % self.interval)
        return mono + self.interval

    def _flush_loop(self) -> None:
        next_tick = self._first_tick(time.time(), time.monotonic())
        while not self._shutdown.wait(
                max(0.0, next_tick - time.monotonic())):
            next_tick += self.interval
            try:
                self.flush_once()
            except Exception:
                log.exception("flush failed")

    def _watchdog(self) -> None:
        """Exit the process (code 2) once ``flush_watchdog_missed_flushes``
        intervals pass without a flush, for the supervisor to restart
        it (reference server.go:1031 FlushWatchdog)."""
        allowed = self.config.flush_watchdog_missed_flushes
        while not self._shutdown.wait(self.interval):
            missed = (time.monotonic() - self.last_flush) / self.interval
            if missed > allowed:
                log.critical(
                    "flush watchdog: %.1f intervals without a flush "
                    "(allowed %d); exiting for a supervisor restart",
                    missed, allowed)
                if self.sentry is not None:
                    # the log handler queued the fatal event: bound its
                    # drain as ConsumePanic's Flush does before dying
                    from veneur_tpu_torch.core.sentry import FLUSH_TIMEOUT
                    self.sentry.flush(FLUSH_TIMEOUT)
                os._exit(2)

    def flush_once(self) -> FlushResult:
        """One flush: swap the table (pipelined: detach under the lock,
        apply the final staging outside it), read it out, route it to
        every sink and plugin, forward on a local, then seal the
        interval's ledger record, tick overload pressure, sample the
        signal row, prune delivered checkpoints and tick
        self-telemetry.  The cycle is traced: one span per stage, a
        record in the /debug/flushes ring.  After a flush that overran
        its budget the next tick coalesces: no swap, an empty result,
        the skip named in the ledger (a drain flush never coalesces).
        Returns the FlushResult with the frame materialized into
        ``metrics``."""
        with self._flush_serial:
            return self._flush_once_locked()

    def _flush_once_locked(self) -> FlushResult:
        if (self.overload is not None and not self._draining
                and self.overload.take_coalesce()):
            self.bump("flush_coalesced")
            self.ledger.note_coalesced()
            log.warning("flush overran its budget last interval; "
                        "coalescing this tick (one swap will cover two "
                        "intervals)")
            return FlushResult()
        t_flush0 = time.monotonic_ns()
        with self.flush_tracer.cycle() as cyc:
            return self._flush_stages(cyc, t_flush0)

    def _flush_stages(self, cyc, t_flush0: int) -> FlushResult:
        # kernel receive drops of the closing interval: lost before the
        # process saw them, named on the record and fed to the pressure
        # signal
        kdrops = self._sample_kernel_drops()
        compiles0 = self.device_costs.totals()["compile_total"]
        with cyc.stage("snapshot"):
            with self.lock:
                if self.pipeline:
                    pend = self.table.begin_swap()
                    swapped = pend
                else:
                    snap = swapped = self.table.swap()
                events, checks = self.events, self.checks
                self.events, self.checks = [], []
                status = self.table.take_status()
                # the interval closes in the swap's lock round, so the
                # site credits and the table's own counters describe
                # the same samples
                led = self.ledger.close_interval(
                    seq=cyc.record.seq, trace_id=cyc.record.trace_id,
                    table_staged=swapped.ingested,
                    table_overflow=swapped.overflow,
                    kernel_drops=kdrops)
                # the interval's host spans close with its ledger record
                cyc.take_interval()
        if self.pipeline:
            with cyc.stage("swap_apply"):
                snap = self.table.complete_swap(pend)
        res = self.flusher.flush(snap, cycle=cyc, retain_frame=True)
        # the flusher's routing counts are synchronous: balance inputs
        self.ledger.credit_rows(led, res.row_accounting)
        if snap.tiers is not None:
            # tier movements are named on the record (never balance
            # inputs); the boundary's byte accounting feeds telemetry
            # and the signal row
            self.ledger.credit_tiers(led, snap.tiers.movements)
            self._last_plane_bytes = snap.tiers.plane_bytes
        # the interval's reads are done (forward rows hold copies): the
        # host set plane goes back to the table's pool
        snap.release()
        self.last_flush = time.monotonic()
        self.bump("flushes")
        ts = int(time.time())
        for (name, _, _, _), (val, msg, stags) in status.items():
            res.metrics.append(im.InterMetric(
                name=name, timestamp=ts, value=val, tags=stags,
                type=im.STATUS, message=msg,
                hostname=self.flusher.hostname))
        t_sink0 = time.monotonic_ns()
        futures = []

        def submit(key, fn, *args):
            # a key whose previous interval's task still runs skips
            # this interval's, counted, instead of queueing behind it
            prev = self._flush_pending.get(key)
            if prev is not None and not prev.done():
                self.bump("flush_skipped_busy")
                log.warning("%s still busy from a previous interval; "
                            "skipping its flush", key)
                return
            try:
                fut = self._pool.submit(fn, *args)
            except RuntimeError:
                return  # shutdown closed the pool mid-flush
            self._flush_pending[key] = fut
            futures.append(fut)

        with cyc.stage("sink_flush"):
            fanout_tasks = []
            other = events + checks
            for sink in self.metric_sinks:
                fn = self._sink_flush_fn(sink, res, other, cyc, led)
                if self._fanout is not None:
                    task = self._fanout.dispatch(sink.name, fn)
                    if task is not None:
                        fanout_tasks.append(task)
                    else:
                        self.bump("flush_skipped_busy")
                else:
                    submit(f"sink:{sink.name}", self._guarded_sink_flush,
                           fn)
            for plugin in self.plugins:
                submit(f"plugin:{plugin.name}", plugin.flush,
                       list(res.all_metrics()), self.flusher.hostname)
            handoff_pending = self._handoff_pending
            if handoff_pending is not None and res.forward:
                # the arcs the new ring gives other members leave over
                # the import wire flagged handoff, not the forward path
                def traced_handoff(rows):
                    with cyc.stage("handoff") as sp:
                        sp.add_tag("rows", str(len(rows)))
                        self._ship_handoff(rows, *handoff_pending, led,
                                           cyc.wire_context(sp))
                submit("handoff", traced_handoff, res.forward)
            elif self.is_local and res.forward:
                def traced_forward(rows):
                    with cyc.stage("forward") as sp:
                        sp.add_tag("rows", str(len(rows)))
                        split = self._forward(rows, cyc.wire_context(sp),
                                              led, cyc, sp)
                        if split:
                            res.account_forward_split(split)
                submit("forward", traced_forward, res.forward)
            submit("spans", self.span_worker.flush)
            # the sinks, plugins, forward, handoff and span flush are
            # awaited only within the interval budget (the reference
            # gives a flush one interval, server.go:1022-1026); an
            # overrunning task keeps running and is counted, never
            # cancelled
            deadline = t_flush0 / 1e9 + max(self.interval * 0.9, 1.0)
            if fanout_tasks:
                for name in self._fanout.wait(fanout_tasks, deadline):
                    self.bump("flush_slow_tasks")
                    log.warning("sink %s overran the interval budget; its "
                                "worker keeps running", name)
            for f in futures:
                try:
                    f.result(timeout=max(0.0, deadline - time.monotonic()))
                except (TimeoutError, _FuturesTimeout):
                    self.bump("flush_slow_tasks")
                    log.warning("flush task overran the interval budget; "
                                "continuing without it")
                except Exception:
                    self.bump("flush_errors")
                    log.exception("flush task failed")
        sink_ns = time.monotonic_ns() - t_sink0
        with self._stats_lock:
            sink_durs = dict(self._sink_durations)
            self._sink_durations.clear()
        cyc.record.metrics_emitted = res.metric_count()
        cyc.record.forward_rows = len(res.forward)
        cyc.record.tally = dict(res.tally)
        if self._fanout is not None:
            # the fan-out's busy drops, retries and timeouts since the
            # last seal, named on this record
            fstats = self._fanout.stats()
            now = tuple(sum(v.get(k, 0) for v in fstats.values())
                        for k in ("busy_drops", "retries", "timeouts"))
            last = self._ledger_fanout_last
            self.ledger.credit_fanout(
                led, busy_drops=now[0] - last[0], retries=now[1] - last[1],
                timeouts=now[2] - last[2])
            self._ledger_fanout_last = now
        if self.overload is not None:
            self._overload_tick(t_flush0, sink_ns, compiles0, kdrops)
        self.ledger.seal(led)
        self._sample_signals(led, cyc.record,
                             time.monotonic_ns() - t_flush0)
        if self._checkpointer is not None:
            # the sealed interval is delivered: its segments (and every
            # older gen's) would double-deliver if replayed
            try:
                self._checkpointer.on_flush(int(snap.gen))
            except Exception:
                log.exception("checkpoint prune after flush failed")
        try:
            self.telemetry.flush_tick(
                res.tally, time.monotonic_ns() - t_flush0, sink_durs,
                record=cyc.record)
        except Exception:
            log.exception("self-telemetry emission failed")
        if res.frame is not None:
            # the return value's metric objects: the record's
            # span_ns["flush.materialize"]
            with cyc.host_span("materialize"):
                res.metrics = res.frame.materialize() + res.metrics
            res.frame = None
        return res

    def _overload_tick(self, t_flush0: int, sink_ns: int, compiles0: int,
                       kdrops: int) -> None:
        """Once a flush: the overrun watchdog and the pressure tick,
        then the width ladder follows the pressure level.  The sink,
        forward and handoff stage is left out of the flush's duration,
        as the reference leaves out its bounded sink waits; a flush that
        built a library is exempt from the watchdog."""
        ov = self.overload
        dur_s = max(0, time.monotonic_ns() - t_flush0 - sink_ns) / 1e9
        compiled = (self.device_costs.totals()["compile_total"]
                    - compiles0) > 0
        ov.note_flush(dur_s, max(self.interval * 0.9, 1.0),
                      compiled=compiled)
        ov.tick(staging_depth=int(self.table.staged()),
                occupancy=self._occupancy(),
                flush_lag_ratio=dur_s / max(self.interval, 1e-9),
                socket_drop_delta=kdrops)
        setp = getattr(self.table, "set_pressure_level", None)
        if setp is not None:
            with self.lock:
                setp(ov.pressure.level)

    def _occupancy(self) -> float:
        """The fullest class index's occupied share."""
        occ = 0.0
        for idx in (self.table.counter_idx, self.table.gauge_idx,
                    self.table.histo_idx, self.table.set_idx):
            if idx.capacity:
                occ = max(occ, idx.occupancy() / idx.capacity)
        return occ

    def _sample_kernel_drops(self) -> int:
        """The interval's kernel receive drops over the UDP listeners,
        statsd and SSF (``/proc/net/udp{,6}``' drops column), cumulative
        in ``stats[socket_kernel_drops]``, plus the rings' ENOBUFS drops
        (a datagram that found no pool buffer; cumulative in
        ``stats[socket_uring_enobufs]``).  Both are loss before the
        process saw a packet: the interval's ledger record names them
        and the pressure tick reads them."""
        cur = ovl.read_kernel_drops(self.sockets + self._listeners)
        delta = sum(max(0, drops - self._kernel_drops_last.get(inode, 0))
                    for inode, drops in cur.items())
        self._kernel_drops_last = cur
        if delta:
            self.bump("socket_kernel_drops", delta)
        with self._stats_lock:
            eb = self.stats.get("socket_uring_enobufs", 0)
        eb_delta = max(0, eb - self._uring_enobufs_last)
        self._uring_enobufs_last = eb
        return delta + eb_delta

    def _sink_flush_fn(self, sink, res: FlushResult, other: list, cyc,
                       led):
        """One sink's flush closure.  Routing (whitelists and excluded
        tags) runs here, on the flush thread: a sink with
        ``flush_frame`` gets the routed frame, any other the routed
        list.  The closure flushes, hands the interval's events and
        service checks to ``flush_other_samples``, credits what the sink
        took to the ledger (after success; it may land after the seal)
        and raises on failure, so the fan-out worker can retry."""
        base = sink if isinstance(sink, sinks_base.SinkBase) else None
        if res.frame is not None and hasattr(sink, "flush_frame"):
            payload = res.frame.route(
                sink.name, sink,
                extra=sinks_base.route(res.metrics, sink.name, base))
            n_routed = payload.total_len()

            def call():
                sink.flush_frame(payload)
        else:
            batch = sinks_base.route(res.all_metrics(), sink.name, base)
            n_routed = len(batch)

            def call():
                sink.flush(batch)

        def fn():
            t0 = time.monotonic_ns()
            try:
                with cyc.stage(f"sink.{sink.name}"):
                    call()
                    if other:
                        sink.flush_other_samples(other)
                self.ledger.credit_sink(led, sink.name, n_routed)
            finally:
                with self._stats_lock:
                    self._sink_durations[sink.name] = (
                        self._sink_durations.get(sink.name, 0)
                        + time.monotonic_ns() - t0)
        return fn

    def _guarded_sink_flush(self, fn) -> None:
        """The shared pool's sink task (``tpu_sink_workers: 0``): a
        failure is counted and logged."""
        try:
            fn()
        except Exception:
            self.bump("flush_errors")
            log.exception("sink flush failed")

    def _forward(self, rows: list[ForwardRow], trace_ctx, led, cyc=None,
                 span=None) -> dict | None:
        """Ship a flush's mergeable state upstream, over gRPC or HTTP
        (flusher.go:82-99); ``trace_ctx`` is the forward stage span's
        (trace_id, span_id), stamped on the wire unless
        ``tpu_trace_propagation`` is off.  ``cyc``/``span`` are the flush
        cycle and its forward span: the sharded path hangs one child
        span per destination off it.  Returns the rows by destination
        when the sharded router ran, else None.  A failure here never
        aborts the flush."""
        t0 = time.monotonic_ns()
        if not self.config.tpu_trace_propagation:
            trace_ctx = None
        try:
            if self.config.forward_use_grpc:
                fwd = self._sharded_forwarder()
                if fwd is not None:
                    return self._forward_sharded(fwd, rows, trace_ctx,
                                                 led, cyc, span)
                self._forward_grpc(rows, trace_ctx, led)
                return None
            if self.config.tpu_sharded_global:
                # the split rides MetricList wires: the HTTP path falls
                # back to one POST
                self.bump("sharded_forward_fallbacks")
            self._forward_http(rows, trace_ctx, led)
        except Exception as e:
            self.bump("metrics_dropped", len(rows))
            self.bump("forward_errors")
            if led is not None:
                self.ledger.credit_forward_wire(led, errors=1)
            log.exception("forward failed: %s", e)
        finally:
            self.bump("forward_duration_ns", time.monotonic_ns() - t0)
            self.bump("forward_post_metrics", len(rows))
        return None

    def _sharded_forwarder(self) -> ShardedForwarder | None:
        """The ShardedForwarder, built at the first forward, when
        ``tpu_sharded_global`` is on; None keeps the single-global
        path."""
        if not self.config.tpu_sharded_global:
            return None
        if self._sharded_fwd is None:
            cfg = self.config
            addrs = [a.strip() for a in cfg.forward_address.split(",")
                     if a.strip()]
            discoverer = None
            service = "forward"
            if cfg.consul_forward_service_name:
                discoverer = ConsulDiscoverer(cfg.consul_url)
                service = cfg.consul_forward_service_name
                self._fwd_refresh_interval = \
                    cfg.consul_refresh_interval_seconds()
            spool = None
            if cfg.tpu_forward_spool:
                spool = WireSpool(
                    max_bytes=cfg.tpu_forward_spool_max_bytes,
                    max_age=cfg.forward_spool_max_age_seconds(),
                    dir=cfg.tpu_forward_spool_dir or None,
                    incarnation=self.incarnation)
            self._sharded_fwd = ShardedForwarder(
                addrs, compression=float(cfg.tpu_compression),
                credentials=self._forward_grpc_credentials(),
                discoverer=discoverer, service=service,
                retry_budget=max(self.interval * 0.9, 1.0),
                breaker_threshold=cfg.tpu_breaker_threshold,
                breaker_cooldown=cfg.breaker_cooldown_seconds(),
                spool=spool, on_replay=self._on_spool_replay)
        return self._sharded_fwd

    def _on_spool_replay(self, dest: str, n_items: int) -> None:
        """Worker-thread callback: one spooled wire replayed to a
        recovered destination (the ledger takes the replay by delta at
        the next flush)."""
        self.bump("replay_wires_sent")
        self.bump("replay_items_sent", n_items)

    def _collective_transport(self):
        """The CollectiveTransport, built at the first use, when the
        ``tpu_collective_forward`` gate resolves on; None keeps every
        destination on the wire.  "auto" engages iff
        ``tpu_collective_peers`` names at least one mesh peer."""
        gate = str(self.config.tpu_collective_forward).lower()
        if gate in ("off", "0", "false", "no"):
            return None
        peers_spec = self.config.tpu_collective_peers
        if gate == "auto" and not peers_spec:
            return None
        if self._collective_fwd is None:
            from veneur_tpu_torch.forward.collective import (
                CollectiveTransport, parse_peers)
            from veneur_tpu_torch.parallel.collective_forward import \
                PlaneSchema
            schema = PlaneSchema(
                compression=float(self.config.tpu_compression),
                max_rows=int(self.config.tpu_collective_max_rows),
                key_bytes=int(self.config.tpu_collective_key_bytes))
            self._collective_fwd = CollectiveTransport(
                schema, peers=parse_peers(peers_spec),
                exchange=self.collective_exchange,
                deadline=max(self.interval * 0.9, 1.0),
                on_late=self.apply_collective_blocks)
        return self._collective_fwd

    def collective_receive_cycle(self, timeout=None) -> tuple:
        """One receive-side rendezvous: join the mesh's plane exchange
        with nothing to send and fold whatever lands.  A receiving
        global drives this in a loop paced by the senders' flushes (the
        collective blocks until they arrive).  Returns (accepted,
        dropped)."""
        coll = self._collective_transport()
        if coll is None:
            raise RuntimeError("collective forward is off (gate/peers)")
        landed = coll.exchange_empty(timeout)
        return self.apply_collective_blocks(landed)

    def apply_collective_blocks(self, landed) -> tuple:
        """Fold every non-empty landed plane block into the table — the
        collective twin of the gRPC import, with its ledger discipline:
        intake credited under protocol "collective-import", the
        overflow delta splitting drops into overflow and invalid.
        Takes the ingest lock per block, so the late-land path may call
        it off the exchange worker."""
        from veneur_tpu_torch.parallel import collective_forward as cplanes
        coll = self._collective_fwd
        schema = coll.schema
        total_acc = total_drop = blocks = 0
        for s in range(landed.shape[0]):
            block = landed[s]
            try:
                counts = cplanes.block_counts(block)
            except cplanes.PlaneFormatError:
                self.bump("collective_bad_blocks")
                continue
            if not any(counts):
                continue
            blocks += 1
            with self.lock:
                ov0 = self.table.overflow_total()
                acc, dropped = cplanes.fold_block(self.table, block,
                                                  schema)
                ov = self.table.overflow_total() - ov0
                self.ledger.ingest(
                    "collective-import", processed=acc + dropped,
                    staged=acc, overflow=ov, invalid=dropped - ov)
                work = self._maybe_device_step_locked()
            self._apply_staged(work)
            self.bump("imports_received", acc)
            self.bump("collective_items_received", acc)
            self.bump("collective_blocks_received")
            if dropped:
                self.bump("metrics_dropped", dropped)
            total_acc += acc
            total_drop += dropped
        if blocks:
            coll.note_landed(blocks)
        return total_acc, total_drop

    def _forward_sharded(self, fwd: ShardedForwarder, rows, trace_ctx,
                         led, cyc, span) -> dict:
        """Split the flush's forward wire by route-key hash across the
        global ring and hand each destination's body to its worker
        (``veneur_tpu/core/server.py`` ``_forward_sharded``).  First the
        collective stage: rows whose destination is a mesh peer ride the
        plane exchange (never on a drain flush); an exchange failure
        falls open, the whole cycle's peer rows joining the wire,
        counted as ``collective_forward_fallbacks``.  The routing counts
        credit the ledger's split synchronously; wire outcomes land
        through the workers' callbacks.  A destination whose breaker is open gets
        its wire spooled without taking a queue slot; a drain flush
        never spools.  The tail waits for this flush's wires until the
        deadline, then sweeps the spool, credits replays since the last
        flush and seals a spool-ledger snapshot.  Returns the rows
        handed to each destination (its worker, or the exchange)."""
        # throttled discovery poll, so a scale-out reshards the ring
        # before this flush routes (keep-last-good on failure)
        if self._fwd_refresh_interval > 0 and not self._draining:
            now = time.monotonic()
            if now >= self._fwd_refresh_next:
                self._fwd_refresh_next = now + self._fwd_refresh_interval
                try:
                    fwd.refresh()
                except Exception:
                    log.exception("forward discovery refresh failed")
        # one ring snapshot per flush: the collective grouping and the
        # wire routing hash against the same membership
        ring = fwd.ring
        coll = None if self._draining else self._collective_transport()
        coll_groups: dict[str, list] = {}
        if coll is not None and rows:
            from veneur_tpu_torch.forward.shard import row_route_key
            wire_rows = []
            for row in rows:
                dest = ring.get(row_route_key(row))
                if coll.is_peer(dest):
                    coll_groups.setdefault(dest, []).append(row)
                else:
                    wire_rows.append(row)
            if coll_groups:
                rows = wire_rows
        coll_split: dict[str, int] = {}
        if coll_groups:
            rows, coll_groups, coll_split = self._forward_collective(
                coll, coll_groups, rows, led, cyc, span)
        data = fwd.serialize(rows)
        routed = None
        try:
            routed = fwd.route(data, ring=ring)
        except Exception:
            log.exception("columnar forward route failed; falling back "
                          "to the per-row path")
        if routed is not None:
            batches = [(routed.members[d], body, n)
                       for d, body, n in routed.batches]
            if routed.dropped:
                self.bump("metrics_dropped", routed.dropped)
                if led is not None:
                    self.ledger.credit_forward_split(
                        led, dropped=routed.dropped)
        else:
            self.bump("sharded_route_fallbacks")
            batches = fwd.route_rows_scalar(rows)
        # a membership change since the last flush: credit the moved
        # arcs (rows whose owner differs under the pre-swap ring) so the
        # record names a rebalance, not a loss
        resh = fwd.take_reshard()
        if resh is not None:
            epoch, added, removed, prev_ring = resh
            moved = 0
            prev_routed = None
            if routed is not None:
                try:
                    prev_routed = fwd.route(data, ring=prev_ring)
                except Exception:
                    log.exception("pre-reshard route diff failed")
            if prev_routed is not None:
                old_counts: dict[str, int] = {}
                for d, _body, n in prev_routed.batches:
                    m = prev_routed.members[d]
                    old_counts[m] = old_counts.get(m, 0) + n
                new_counts: dict[str, int] = {}
                for d, _body, n in routed.batches:
                    m = routed.members[d]
                    new_counts[m] = new_counts.get(m, 0) + n
                moved = sum(max(0, new_counts.get(m, 0)
                                - old_counts.get(m, 0))
                            for m in set(new_counts) | set(old_counts))
            if coll_groups:
                # the collective rows' moved arcs are the same
                # rebalance, counted row by row against the old ring
                from veneur_tpu_torch.forward.shard import row_route_key
                old_cc: dict[str, int] = {}
                for g in coll_groups.values():
                    for row in g:
                        d = prev_ring.get(row_route_key(row))
                        old_cc[d] = old_cc.get(d, 0) + 1
                moved += sum(max(0, len(g) - old_cc.get(d, 0))
                             for d, g in coll_groups.items())
            if led is not None:
                self.ledger.credit_reshard(led, epoch, added, removed,
                                           moved)
            self.bump("forward_reshards")
            self.bump("forward_reshard_moved_rows", moved)
        # no send may block past the interval budget (a drain gets a
        # wider floor so the final wires land before exit)
        budget = max(self.interval * 0.9, 1.0)
        if self._draining:
            budget = max(self.interval, 5.0)
        deadline = time.monotonic() + budget
        split: dict[str, int] = {}
        done: list[threading.Event] = []
        for dest, body, n in batches:
            if not self._draining and fwd.should_spool(dest):
                if fwd.spool.put(dest, body, n):
                    self.bump("forward_spooled_wires")
                    self.bump("forward_spooled_items", n)
                    if led is not None:
                        self.ledger.credit_forward_spooled(led, n)
                else:
                    # one body over the spool's byte cap: an attributed
                    # drop
                    self.bump("forward_spool_rejected_items", n)
                    self.bump("metrics_dropped", n)
                    if led is not None:
                        self.ledger.credit_forward_split(led, dropped=n)
                continue
            ch = None
            if cyc is not None and span is not None:
                ch = cyc.child(span, "forward.shard",
                               {"dest": dest, "rows": str(n)})
            wire_ctx = trace_ctx
            if trace_ctx and ch is not None and ch.trace_id:
                # each shard's wire parents the remote import span
                # under its own branch
                wire_ctx = (ch.trace_id, ch.span_id)
            landed = threading.Event()

            def _result(dest, n_items, err, retries, ch=ch,
                        nbytes=len(body), landed=landed):
                if err is None:
                    if led is not None:
                        self.ledger.credit_forward_wire(
                            led, rows=n_items, nbytes=nbytes)
                elif isinstance(err, Spooled):
                    # absorbed into the spool, not dropped: the spool
                    # ledger owns these rows from here
                    self.bump("forward_spooled_async_items", n_items)
                    self.bump("forward_errors")
                    if led is not None:
                        self.ledger.credit_spool_outcome(
                            led, spooled_async=n_items)
                        self.ledger.credit_forward_wire(led, errors=1)
                else:
                    self.bump("metrics_dropped", n_items)
                    self.bump("forward_errors")
                    if _is_deadline_error(err):
                        self.bump("forward_timeout_dropped", n_items)
                        if led is not None:
                            self.ledger.credit_forward_timeout(
                                led, dest, n_items)
                    if led is not None:
                        self.ledger.credit_forward_wire(led, errors=1)
                if ch is not None:
                    if err is not None:
                        ch.set_error(err)
                    if retries:
                        ch.add_tag("retries", str(retries))
                    cyc.finish(ch)
                landed.set()

            if fwd.send(dest, body, n, trace_context=wire_ctx,
                        on_result=_result, deadline=deadline,
                        drain=self._draining):
                self.bump("forward_shard_wires")
                if self._draining:
                    self.bump("drain_wires_sent")
                    self.bump("drain_items_sent", n)
                split[dest] = split.get(dest, 0) + n
                done.append(landed)
                if led is not None:
                    self.ledger.credit_forward_split(led, dest, n)
            else:
                # bounded-queue busy-drop: the wedged shard loses its
                # own wire, the others sail on
                self.bump("forward_busy_dropped", n)
                self.bump("metrics_dropped", n)
                if led is not None:
                    self.ledger.credit_forward_split(led, dropped=n)
                if ch is not None:
                    ch.add_tag("busy_dropped", "true")
                    ch.set_error(True)
                    cyc.finish(ch)
        for landed in done:
            if not landed.wait(max(0.0, deadline - time.monotonic())):
                self.bump("forward_shard_overruns")
        if fwd.spool is not None:
            expired = fwd.spool.sweep()
            if expired:
                self.bump("spool_expired_swept_items", expired)
            replayed_now = fwd.replayed_items
            delta = replayed_now - self._replayed_credited
            if delta > 0:
                self._replayed_credited = replayed_now
                if led is not None:
                    self.ledger.credit_spool_outcome(led, replayed=delta)
            self._spool_ledger.seal_snapshot(
                fwd.spool.stats(), seq=led.seq if led is not None else 0)
        for dest, n in coll_split.items():
            split[dest] = split.get(dest, 0) + n
        return split

    def _forward_collective(self, coll, groups: dict, wire_rows: list,
                            led, cyc, span) -> tuple[list, dict, dict]:
        """The collective stage of a sharded forward: one plane
        exchange for the mesh peers' rows.  Returns (the rows left for
        the wire, the groups the exchange took, the rows it sent by
        destination); on a failure every peer row returns to the wire
        and the groups and counts come back empty."""
        ch = None
        if cyc is not None and span is not None:
            ch = cyc.child(span, "forward.collective",
                           {"dests": str(len(groups)),
                            "rows": str(sum(len(g)
                                            for g in groups.values()))})
        try:
            sent, rejected, landed = coll.send_cycle(groups)
        except Exception as e:
            n_back = sum(len(g) for g in groups.values())
            self.bump("collective_forward_fallbacks")
            self.bump("collective_fallback_rows", n_back)
            log.warning("collective forward fell open to the wire "
                        "(%d rows): %s", n_back, e)
            if ch is not None:
                ch.set_error(e)
                cyc.finish(ch)
            return (list(wire_rows) +
                    [r for g in groups.values() for r in g]), {}, {}
        self.bump("collective_forward_cycles")
        for dest, n in sent.items():
            self.bump("collective_forward_rows", n)
            if led is not None:
                self.ledger.credit_forward_collective(led, dest, n)
        if rejected:
            # schema-capacity rejects ship on the wire this cycle
            self.bump("collective_rejected_rows", len(rejected))
            wire_rows = list(wire_rows) + list(rejected)
        # the planes mesh peers addressed to this node
        self.apply_collective_blocks(landed)
        if ch is not None:
            if rejected:
                ch.add_tag("rejected", str(len(rejected)))
            cyc.finish(ch)
        return wire_rows, groups, dict(sent)

    def _forward_http(self, rows: list[ForwardRow], trace_ctx=None,
                      led=None) -> None:
        """POST a flush's forward rows to the global's /import (the
        reference's flusher.go flushForward); a failed send drops and
        counts the rows and logs, as the reference does.  The drain
        flush's POST carries the drain header."""
        try:
            if self.config.forward_json_schema == "reference":
                body, headers = http_import.encode_rows_reference(
                    rows, compression=float(self.config.tpu_compression))
            else:
                body, headers = http_import.encode_rows(rows)
            headers = dict(headers)
            if trace_ctx and trace_ctx[0]:
                headers[http_import.TRACE_HEADER] = \
                    http_import.encode_trace_header(*trace_ctx)
            if self._draining:
                headers[http_import.DRAIN_HEADER] = "1"
            url = self.config.forward_address.rstrip("/") + "/import"
            if not url.startswith("http"):
                url = "http://" + url
            req = urllib.request.Request(url, data=body, headers=headers,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=10.0) as r:
                r.read()
        except Exception as e:  # forwarding never aborts the flush
            self.bump("metrics_dropped", len(rows))
            self.bump("forward_errors")
            if led is not None:
                self.ledger.credit_forward_wire(led, errors=1)
            log.warning("forward failed: %s", e)
            return
        self.bump("forwarded_rows", len(rows))
        self._note_drain_sent(len(rows))
        if led is not None:
            self.ledger.credit_forward_wire(led, rows=len(rows),
                                            nbytes=len(body))

    def _forward_grpc(self, rows: list[ForwardRow], trace_ctx=None,
                      led=None) -> None:
        """Send a flush's forward rows to the global's Forward service
        through a client dialled once (flusher.go:499 forwardGRPC); a
        failed send drops and counts the rows and logs, never retried.
        The drain flush's wire carries the drain flag."""
        if self._grpc_client is None:
            self._grpc_client = grpc_forward.ForwardClient(
                self.config.forward_address,
                credentials=self._forward_grpc_credentials(),
                compression=float(self.config.tpu_compression))
        try:
            self._grpc_client.send(rows, trace_context=trace_ctx,
                                   drain=self._draining)
        except grpc.RpcError as e:
            self.bump("metrics_dropped", len(rows))
            self.bump("forward_errors")
            if led is not None:
                self.ledger.credit_forward_wire(led, errors=1)
            log.warning("grpc forward failed: %s", e)
            return
        self.bump("forwarded_rows", len(rows))
        self._note_drain_sent(len(rows))
        if led is not None:
            self.ledger.credit_forward_wire(led, rows=len(rows))

    def _note_drain_sent(self, n_rows: int) -> None:
        if self._draining:
            self.bump("drain_wires_sent")
            self.bump("drain_items_sent", n_rows)

    def _drain_handoff(self) -> None:
        """The final-interval handoff: one last flush whose forward
        wires are flagged drain, so the receiving global books this
        local's staged samples past its interval cutoff and a rolling
        restart conserves them.  Runs before the shutdown flag is
        set."""
        self._draining = True
        try:
            self.flush_once()
            self.bump("drain_flushes")
        except Exception:
            log.exception("drain handoff flush failed")
        finally:
            self._draining = False

    # ------------------------------------------------------------------
    # signal history, flight recorder, fleet view, /debug/vars

    def _signal_row(self, led=None, record=None, flush_ns: int = 0
                    ) -> dict:
        """One row of every internal signal, in the reference's fixed
        schema (``veneur_tpu/core/server.py`` ``_signal_row``): called
        with no arguments at construction to derive the schema.  The
        collective forward's columns sample 0 until its transport is
        built, as do the forward's columns until the sharded forwarder
        is built and the pressure columns with overload off."""
        with self._stats_lock:
            st = dict(self.stats)
        row = {
            "ingest.packets_received": st.get("packets_received", 0),
            "ingest.packet_errors": st.get("packet_errors", 0),
            "ingest.metrics_processed": st.get("metrics_processed", 0),
            "ingest.metrics_dropped": st.get("metrics_dropped", 0),
            "ingest.imports_received": st.get("imports_received", 0),
            "ingest.import_errors": st.get("import_errors", 0),
            "ingest.kernel_drops": st.get("socket_kernel_drops", 0),
            "flush.count": st.get("flushes", 0),
            "flush.errors": st.get("flush_errors", 0),
            "flush.slow_tasks": st.get("flush_slow_tasks", 0),
            "flush.duration_ns": int(flush_ns),
            "flush.compiles":
                self.device_costs.totals()["compile_total"],
            "handoff.shipped_items": st.get("handoff_items_sent", 0),
            "handoff.received_items": st.get("handoff_items_received", 0),
            "recover.recovered_items": st.get("recovery_items_received", 0),
            "recover.replay_wires": st.get("replay_wires_received", 0),
            "recover.segments_replayed":
                st.get("recovery_segments_replayed", 0),
            "trace.spans_sent": self.trace_client.sent,
            "trace.spans_dropped": self.trace_client.dropped,
        }
        stages = record.stages if record is not None else {}
        for stage in ("snapshot", "dispatch", "device_wait",
                      "host_emit", "sink_flush", "forward"):
            row[f"flush.stage.{stage}_ns"] = stages.get(stage, 0)
        row["flush.readback_bytes"] = (
            record.readback_bytes if record is not None else 0)
        ov = self.overload
        p = ov.pressure if ov is not None else None
        row["pressure.score"] = p.score if p is not None else 0.0
        row["pressure.level"] = p.level if p is not None else 0
        row["pressure.engaged"] = int(p.engaged if p is not None else False)
        row["pressure.transitions"] = p.transitions if p is not None else 0
        row["flush.overruns"] = ov.flush_overruns if ov is not None else 0
        row["flush.coalesced"] = ov.coalesced_total if ov is not None else 0
        row["shed.total"] = ov.shed_total if ov is not None else 0
        row["shed.tenants"] = (len({t for t, _ in ov.shed_by_total})
                               if ov is not None else 0)
        rec = led
        row["ledger.received"] = (
            rec.received_total() if rec is not None else 0)
        for key, attr in (("staged", "staged"), ("status", "status"),
                          ("shed", "shed"), ("overflow", "overflow"),
                          ("invalid", "invalid"), ("owed", "owed")):
            row[f"ledger.{key}"] = (getattr(rec, attr)
                                    if rec is not None else 0)
        row["ledger.balanced"] = int(
            rec.balanced if rec is not None else True)
        for key in ("emitted_rows", "forwarded_rows", "retained_rows",
                    "coalesced", "parse_errors"):
            row[f"ledger.{key}"] = (getattr(rec, key)
                                    if rec is not None else 0)
        row["ledger.imbalanced_total"] = self.ledger.imbalanced_total
        row["reshard.received_items"] = (
            rec.reshard_received_items if rec is not None else 0)
        table = self.table
        row["table.staged"] = int(table.staged())
        row["table.occupancy"] = round(self._occupancy(), 6)
        fwd = self._sharded_fwd
        states = fwd.breaker_states() if fwd is not None else {}
        for state in ("closed", "half_open", "open"):
            row[f"breaker.{state}"] = sum(
                1 for b in states.values() if b["state"] == state)
        tot = fwd.totals() if fwd is not None else {}
        row["breaker.opens_total"] = tot.get("breaker_opens", 0)
        row["forward.sent_items"] = tot.get("sent_items", 0)
        row["forward.error_items"] = tot.get("error_items", 0)
        row["forward.busy_dropped_items"] = tot.get(
            "busy_dropped_items", 0)
        row["forward.replayed_items"] = tot.get("replayed_items", 0)
        row["forward.queued"] = sum(
            w.get("queued", 0)
            for w in (fwd.stats() if fwd is not None else {}).values())
        disc = fwd.discovery_stats() if fwd is not None else {}
        row["forward.destinations"] = len(disc.get("members", ()))
        row["reshard.epoch"] = disc.get("epoch", 0)
        row["reshard.moved_rows"] = st.get("forward_reshard_moved_rows", 0)
        sp = (fwd.spool_stats() if fwd is not None else None) or {}
        for key in ("queued_items", "queued_bytes", "spooled_items",
                    "replayed_items", "expired_items", "inflight_items"):
            row[f"spool.{key}"] = sp.get(key, 0)
        # the collective forward (zeros until the transport builds)
        coll = getattr(self, "_collective_fwd", None)
        cst = coll.stats() if coll is not None else {}
        row["forward.collective.cycles"] = cst.get("cycles", 0)
        row["forward.collective.rows"] = cst.get("sent_rows", 0)
        row["forward.collective.rejected_rows"] = cst.get(
            "rejected_rows", 0)
        row["forward.collective.fallback_cycles"] = cst.get(
            "fallback_cycles", 0)
        row["forward.collective.landed_blocks"] = cst.get(
            "landed_blocks", 0)
        row["forward.collective.items_received"] = st.get(
            "collective_items_received", 0)
        # the metric sinks' fan-out workers, summed over the sinks
        fan = (self._fanout.stats()
               if getattr(self, "_fanout", None) is not None else {})
        for key in ("flushes", "errors", "busy_drops", "timeouts"):
            row[f"sink.{key}"] = sum(w.get(key, 0) for w in fan.values())
        pb = self._last_plane_bytes or {}
        row["table.plane_bytes_total"] = pb.get("total", 0)
        row["table.plane_bytes_histo_wide"] = pb.get(
            "histo", {}).get("wide", 0)
        row["table.plane_bytes_histo_compact"] = pb.get(
            "histo", {}).get("compact", 0)
        row["table.plane_bytes_set_wide"] = pb.get(
            "set", {}).get("wide", 0)
        row["table.plane_bytes_set_compact"] = pb.get(
            "set", {}).get("compact", 0)
        row["table.plane_bytes_per_series"] = round(
            pb.get("device_bytes_per_series", 0.0), 3)
        for key in ("promotions", "demotions", "escalations",
                    "promote_refused"):
            row[f"table.tier_{key}"] = (getattr(rec, f"tier_{key}")
                                        if rec is not None else 0)
        return row

    def _sample_signals(self, led, record, flush_ns: int) -> None:
        """The per-seal hook: append one row to the history ring and
        evaluate the flight recorder's triggers on it."""
        if self.signals is None:
            return
        try:
            row = self._signal_row(led, record, flush_ns)
            t_now = time.time()
            self.signals.append(row, t=t_now, seq=led.seq)
            # the triggering interval's flush record reaches the ring
            # only after this hook: hand it to _flight_context
            self._flight_record = record
            self.flight.observe(row, t=t_now, seq=led.seq)
            self.bump("signal_rows")
        except Exception:
            log.exception("signal sample failed")

    def _flight_context(self, trigger: str, row: dict) -> dict:
        """What a flight bundle carries beside the signal rows: the
        last sealed ledger records, the triggering interval's flush
        record and trace tree, and the counters."""
        out: dict = {"ledger_records": [
            r.to_dict() for r in self.ledger.records()[-4:]]}
        rec = self._flight_record
        if rec is None:
            flushes = self.flush_ring.records()
            rec = flushes[-1] if flushes else None
        if rec is not None:
            out["flush_record"] = rec.to_dict()
            out["trace"] = self.trace_index.get(rec.trace_id)
        out.update(self._forward_vars())
        out["spool_ledger"] = self._spool_ledger.summary()
        with self._stats_lock:
            out["stats"] = dict(self.stats)
        return out

    def _forward_vars(self) -> dict:
        """The sharded forward's state: ring membership and refresh
        health, per-destination breakers, and the spool (None when off
        or the forwarder never built)."""
        fwd = self._sharded_fwd
        coll = self._collective_fwd
        return {"discovery": fwd.discovery_stats() if fwd else {},
                "breakers": fwd.breaker_states() if fwd else {},
                "spool": fwd.spool_stats() if fwd else None,
                # the collective forward's cycle, row and fallback
                # counters, peer map and block schema (None until built)
                "forward.collective": (coll.stats() if coll is not None
                                       else None)}

    def _scrape_peer(self, addr: str) -> dict:
        url = addr if "://" in addr else f"http://{addr}"
        url = url.rstrip("/") + "/debug/signals?summary=1"
        with urllib.request.urlopen(url, timeout=1.0) as resp:
            return json.loads(resp.read().decode())

    def _cluster_view(self) -> dict:
        """This node's signal summary merged with its peers', each
        peer's cached for ``_CLUSTER_TTL`` seconds; a peer that stops
        answering serves its last summary flagged stale."""
        now = time.monotonic()
        peers = {}
        peers_cfg = self.config.tpu_cluster_peers.split(",")
        for addr in (p.strip() for p in peers_cfg if p.strip()):
            with self._cluster_lock:
                cached = self._cluster_cache.get(addr)
            if cached is not None and now - cached[0] < _CLUSTER_TTL:
                peers[addr] = cached[1]
                continue
            try:
                summ = self._scrape_peer(addr)
                summ["stale"] = False
                with self._cluster_lock:
                    self._cluster_cache[addr] = (now, summ)
                peers[addr] = summ
            except Exception as e:
                err = f"{type(e).__name__}: {e}"
                peers[addr] = (dict(cached[1], stale=True, error=err)
                               if cached is not None
                               else {"error": err, "stale": True})
        return {"node": self.config.hostname or "",
                "role": "local" if self.is_local else "global",
                "self": (self.signals.summary()
                         if self.signals is not None else None),
                "peers": peers}

    def debug_vars(self) -> dict:
        """The /debug/vars page: counters, the device-cost registry,
        the trace client, the tier byte accounting, overload control,
        the kernel receive drops, the crash-riding lifecycle
        (incarnation, adopted fds, the checkpointer), the last arc
        handoff, the start-up warm-up and summaries of the ledger,
        signal history and flight recorder."""
        with self._stats_lock:
            stats = dict(self.stats)
        return {
            "stats": stats,
            "warmup": self.warmup,
            "devicecost": self.device_costs.snapshot(),
            "trace_client": {"sent": self.trace_client.sent,
                             "dropped": self.trace_client.dropped,
                             "errors": self.trace_client.errors},
            "last_flush_age_s": round(
                time.monotonic() - self.last_flush, 3),
            # each metric sink's fan-out worker counters ({} with
            # tpu_sink_workers: 0)
            "sinks": (self._fanout.stats()
                      if self._fanout is not None else {}),
            # per-thread native decode scratch kept by the gRPC import
            # handlers
            "forward": {"decode_scratch_bytes":
                        grpc_forward.decode_scratch_bytes()},
            **self._forward_vars(),
            "planes": self.table.plane_bytes(),
            "ledger": self.ledger.summary(),
            "spool_ledger": self._spool_ledger.summary(),
            "overload": (self.overload.snapshot()
                         if self.overload is not None else None),
            "sockets": {
                "kernel_drops_total": stats.get("socket_kernel_drops", 0),
                "by_inode": dict(self._kernel_drops_last),
                # the readers' drain tier (None before the first UDP
                # listener) and the start-up probe's errno when refused
                "backend": self.ingest_backend,
                "uring_probe_errno": -self._uring_probe_err,
                "backend_fallback_total": stats.get(
                    "socket_backend_fallback", 0),
                # datagrams dropped at a ring's buffer pool
                "uring_enobufs_total": stats.get("socket_uring_enobufs",
                                                 0),
                # each live ring's pool, completion and batch counters
                "uring": {name: ring.stats() for name, ring in
                          sorted(self._urings.items())} or None},
            "start_epoch": self.start_epoch,
            "incarnation": self.incarnation,
            "restarts_adopted": self.restarts_adopted,
            "checkpoint": (dict(self._checkpointer.stats)
                           if self._checkpointer is not None else None),
            "handoff": dict(self._handoff_last),
            "signals": (self.signals.summary()
                        if self.signals is not None else None),
            "flight": (self.flight.stats()
                       if self.flight is not None else None),
        }

    # ------------------------------------------------------------------
    # crash recovery and the scale-out arc handoff

    def _recover_from_checkpoints(self) -> None:
        """Replay a crashed predecessor's surviving checkpoint segments
        (newest per incarnation and gen, unconsumed, younger than the
        recovery grace).  A local forwarding over gRPC sends each body
        to its (first) global flagged recovery, where it is deduped by
        its ``inc:seq`` id; any other node re-ingests it locally
        (``_recover_local``).  Each replayed id is registered in the
        checkpoint directory, so a crash during recovery replays
        nothing twice."""
        directory = self.config.tpu_checkpoint_dir
        max_age = ckpt.RECOVERY_GRACE * max(
            self.config.checkpoint_interval_seconds(), self.interval)
        segs = ckpt.scan_recoverable(directory, self.incarnation, max_age)
        if not segs:
            return
        client = None
        if (self.is_local and self.config.forward_use_grpc
                and self.config.forward_address):
            client = grpc_forward.ForwardClient(
                self.config.forward_address.split(",")[0].strip(),
                credentials=self._forward_grpc_credentials(),
                compression=float(self.config.tpu_compression))
        try:
            for seg in segs:
                rid = seg.recovery_id
                items = int(seg.header.get("items", 0))
                try:
                    if client is not None:
                        client.send_wire(
                            seg.body,
                            metadata=[(grpc_forward.RECOVERY_KEY, rid)])
                    else:
                        self._recover_local(seg, rid)
                except Exception:
                    self.bump("recovery_errors")
                    log.exception("recovery replay of %s failed",
                                  seg.path)
                    continue
                ckpt.mark_consumed(directory, rid)
                self.bump("recovery_segments_replayed")
                self.bump("recovery_items_replayed", items)
                log.info("recovered checkpoint %s (%d items; %d device-"
                         "staged beyond its reach) via %s", rid, items,
                         int(seg.header.get("device_staged", 0)),
                         "forward wire" if client is not None
                         else "local re-ingest")
        finally:
            if client is not None:
                client.close()

    def _recover_local(self, seg, rid: str) -> None:
        """Re-ingest one segment body through the gRPC import fold under
        the ingest lock, with the receiver's dedup, credited
        ``checkpoint-recovery`` and to the ledger's ``recover`` arm."""
        flags = {"recovery": rid, "handoff": False, "drain": False,
                 "replay": False}
        with self.lock:
            acc, dropped, deduped = self.apply_import_locked(
                "checkpoint", flags,
                lambda: grpc_forward.apply_metric_list_bytes(self.table,
                                                             seg.body))
            work = None if deduped else self._maybe_device_step_locked()
        self._apply_staged(work)
        if deduped:
            self.bump("recovery_wires_deduped")
            return
        self.bump("imports_received", acc)
        self.bump("metrics_dropped", dropped)

    def arc_handoff(self, members: list[str], self_member: str) -> dict:
        """Scale-out keyspace handoff on a global: one flush with the
        flusher's handoff gate installed, so every resident row whose
        route-key arc the ring of ``members`` gives another member
        forwards (only), and those rows ship to their new owners over
        the import wire flagged handoff (``_ship_handoff``).  Run on
        each incumbent before the locals' rings change.  Returns the
        shipped stats (``{"enabled": False}`` with
        ``tpu_arc_handoff`` off)."""
        if not self.config.tpu_arc_handoff:
            return {"enabled": False}
        ring = ConsistentRing(list(members))
        with self._flush_serial:
            self._handoff_last = {}
            self.flusher.handoff = handoff.make_flusher_gate(
                ring, self_member)
            self._handoff_pending = (ring, self_member)
            try:
                self._flush_once_locked()
            finally:
                self.flusher.handoff = None
                self._handoff_pending = None
        self.bump("arc_handoffs")
        return dict(self._handoff_last)

    def _ship_handoff(self, rows, ring, self_member, led,
                      trace_ctx=None) -> None:
        """Partition a handoff flush's forward rows by the new ring and
        send each member its arcs; a failed wire drops loudly (counted
        and credited to the ledger)."""
        if self._handoff_shipper is None:
            self._handoff_shipper = handoff.HandoffShipper(
                compression=float(self.config.tpu_compression),
                credentials=self._forward_grpc_credentials())
        by_member, kept = handoff.partition(rows, ring, self_member)
        moved = sum(len(v) for v in by_member.values())
        stats = self._handoff_shipper.ship(by_member, trace_ctx)
        stats["moved_rows"] = moved
        stats["kept_rows"] = kept
        self._handoff_last = stats
        self.bump("handoff_wires_sent", stats["wires"])
        self.bump("handoff_items_sent", stats["items"])
        if stats["errors"]:
            self.bump("handoff_errors", stats["errors"])
            self.bump("metrics_dropped", stats["dropped_items"])
        if led is not None:
            # the outward rebalance, named on the interval's record
            self.ledger.credit_reshard(
                led, 0, [m for m in ring.members if m != self_member], [],
                moved)
            self.ledger.credit_forward_wire(
                led, rows=stats["items"], errors=stats["errors"])

    def _start_profiling(self) -> None:
        """``enable_profiling``: a torch.profiler trace of CPU and CUDA
        activity for the process lifetime (reference server.go:1512),
        written to ./torch_profile/trace.json at shutdown.  It holds
        the profiler lock, so /debug/pprof/device answers 503."""
        from torch.profiler import ProfilerActivity, profile
        if not self._pprof_lock.acquire(blocking=False):
            return
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=acts)
        self._profiler.start()

    def _stop_profiling(self) -> None:
        prof, self._profiler = self._profiler, None
        if prof is None:
            return
        try:
            prof.stop()
            os.makedirs("torch_profile", exist_ok=True)
            prof.export_chrome_trace(
                os.path.join("torch_profile", "trace.json"))
        except Exception:
            log.exception("could not write the profile")
        finally:
            self._pprof_lock.release()

    def shutdown(self) -> None:
        """Stop the server.  A local first drains (``_drain_handoff``,
        unless ``tpu_drain_on_shutdown`` is off); a global never does.
        A second call waits for the first and returns."""
        with self._shutdown_lock:
            if self.stopped.is_set():
                return
            self._shutdown_locked()
            self.stopped.set()

    def _shutdown_locked(self) -> None:
        if (not self._shutdown.is_set()
                and self.config.tpu_drain_on_shutdown
                and self.config.is_local()):
            self._drain_handoff()
        self._shutdown.set()
        if self._checkpointer is not None:
            self._checkpointer.stop()
            self._checkpointer = None
        if self._handoff_shipper is not None:
            self._handoff_shipper.close()
            self._handoff_shipper = None
        if self._sentry_handler is not None:
            # error logs must not mirror to a closed client
            logging.getLogger("veneur_tpu_torch").removeHandler(
                self._sentry_handler)
            self._sentry_handler = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for g in self.grpc_servers:
            g.stop()
        self.grpc_servers = []
        for sock in self.sockets + self._listeners:
            try:
                sock.close()
            except OSError:
                pass  # an adopted fd its other owner already closed
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            # wakes the connection's thread out of its read
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        self.sockets = []
        self._listeners = []
        # closing releases the flock; the lock file stays, as the
        # reference's does
        for _lockname, fd in self._socket_locks:
            os.close(fd)
        self._socket_locks = []
        if self._grpc_client is not None:
            self._grpc_client.close()
            self._grpc_client = None
        if self._sharded_fwd is not None:
            self._sharded_fwd.stop()
        if self._collective_fwd is not None:
            self._collective_fwd.stop()
        self._stop_profiling()
        self.flush_tracer.stop_gc_spans()
        self.trace_client.close()
        self.span_worker.stop()
        if self.flight is not None:
            self.flight.stop()
        # the sinks' own threads and channels: signalfx's key refresh,
        # splunk's submission workers, the grpsink channel
        for sink in self.metric_sinks + self.span_sinks:
            if hasattr(sink, "stop"):
                try:
                    sink.stop()
                except Exception:
                    log.exception("sink %s stop failed", sink.name)
        self._pool.shutdown(wait=False, cancel_futures=True)
        if self._fanout is not None:
            self._fanout.stop()
        self.telemetry.close()
        if self.sentry is not None:
            self.sentry.close()
            self.sentry = None
