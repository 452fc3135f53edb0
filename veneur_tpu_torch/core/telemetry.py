"""Self-telemetry: the server reports its own operation under the
reference's documented operator metric names (README.md:253-299;
flusher.go:32-47 runtime stats, :305-361 flush-count reporting), so
existing veneur dashboards and alerts keep working.

The port's copy of ``veneur_tpu/core/telemetry.py``, cut to the
subsystems the port runs: worker, packet (SSF errors included), import
and forward counts, the unique timeseries (``count_unique_timeseries``),
the span sinks' delivery counts, the flush's total and per-stage
durations, the device-cost registry
(``veneur.device.*``; ``veneur.xla.*`` counts the builds of the port's
native and CUDA libraries), the ledger's verdict, the tier accounting,
the signal history and flight recorder, the sharded forward (its
wires, busy drops, fallbacks, reshards, deadline drops, breakers,
spool and discovery health), drain, replay, recovery and handoff
traffic in both directions, adopted listener fds, the checkpointer,
overload control (shed by tenant and reason, pressure, overruns,
coalesced ticks), kernel receive drops, gc and memory.  The metrics of
the other sinks and the collective path come with those subsystems.

Two emission paths, as in the reference:
- ``stats_address`` set: DogStatsD datagrams to an external agent
  (the scopedstatsd client role, server.go:335-345).
- otherwise: samples are injected into the server's own aggregation
  table (the reference's in-process loopback channel client,
  server.go:347-354 NewChannelClient), so they appear in the server's
  own flush from its second interval on.

All counters are per-interval deltas of the server's stats dict.
"""

from __future__ import annotations

import gc
import logging
import os
import resource
import socket
import time

from veneur_tpu_torch import observe
from veneur_tpu_torch.protocol import dogstatsd as dsd
from veneur_tpu_torch.protocol.addr import parse_addr

# cumulative GC pause time via gc callbacks — the Python stand-in for
# Go's MemStats.PauseTotalNs (reference flusher.go:36).  Installed
# once per process.
_GC_PAUSE = {"total_ns": 0, "t0": 0, "installed": False}


def _gc_cb(phase, info):
    if phase == "start":
        _GC_PAUSE["t0"] = time.monotonic_ns()
    elif _GC_PAUSE["t0"]:
        _GC_PAUSE["total_ns"] += time.monotonic_ns() - _GC_PAUSE["t0"]


def _install_gc_hook() -> None:
    # called from Telemetry.__init__, not at import: the process-global
    # gc.callbacks change is scoped to processes that emit the metric
    if not _GC_PAUSE["installed"]:
        _GC_PAUSE["installed"] = True
        gc.callbacks.append(_gc_cb)


def _gc_pause_total_ns() -> int:
    return _GC_PAUSE["total_ns"]


def _rss_bytes() -> int:
    """CURRENT resident set size (/proc/self/statm field 2); the
    lifetime peak ``ru_maxrss`` only where procfs is unavailable."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * (os.sysconf("SC_PAGE_SIZE") or 4096)
    except (OSError, ValueError, IndexError):
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


log = logging.getLogger("veneur_tpu_torch.telemetry")

# stats-dict key -> (metric name, extra tags)
_COUNTER_MAP = {
    "metrics_processed": ("veneur.worker.metrics_processed_total",
                          ("worker:0",)),
    "imports_received": ("veneur.worker.metrics_imported_total", ()),
    "packet_errors": ("veneur.packet.error_total", ()),
    "import_errors": ("veneur.import.request_error_total", ()),
    "flush_errors": ("veneur.flush.error_total", ()),
    "forward_errors": ("veneur.forward.error_total", ()),
    "spans_processed": ("veneur.worker.spans_processed_total", ()),
    "ssf_errors": ("veneur.packet.error_total",
                   ("packet_type:ssf_metric",)),
}

# per-protocol receive counters (README: veneur.listen.
# received_per_protocol_total tagged by protocol)
_PROTOCOLS = ("dogstatsd-udp", "dogstatsd-tcp", "dogstatsd-unixgram",
              "ssf-udp", "ssf-unix", "grpc")

_FLUSHED_TYPES = ("counters", "gauges", "histograms", "sets")


class Telemetry:
    def __init__(self, server):
        self.server = server
        self._last: dict[str, int] = {}
        self._sock: socket.socket | None = None
        self._addr = None
        addr = server.config.stats_address
        if addr:
            # url style (udp://host:port) or bare host:port; a value
            # with no numeric port fails here as a config error
            if "://" in addr:
                _, host, port, _ = parse_addr(addr)
            else:
                host, sep, port = addr.rpartition(":")
                if not sep or not port.isdigit():
                    raise ValueError(
                        f"stats_address {addr!r}: expected host:port "
                        f"with a numeric port (e.g. "
                        f"'127.0.0.1:8125' or 'udp://host:8125')")
                port = int(port)
            self._addr = (host or "127.0.0.1", port)
            self._sock = socket.socket(socket.AF_INET,
                                       socket.SOCK_DGRAM)
        self._send_errs = 0
        _install_gc_hook()

    # ------------------------------------------------------------------

    def _delta(self, key: str) -> int:
        cur = self.server.stats.get(key, 0)
        d = cur - self._last.get(key, 0)
        self._last[key] = cur
        return d

    def flush_tick(self, tally: dict, flush_duration_ns: float,
                   sink_durations: dict[str, float],
                   record=None) -> None:
        """Called once per flush with the interval's numbers; builds
        and emits the operator samples.  ``record`` is the cycle's
        observe.FlushRecord (per-stage durations)."""
        samples: list[dsd.Sample] = []
        cfg = self.server.config
        # per-type scope overrides + fixed extra tags on the server's
        # OWN metrics (reference scopesFromConfig server.go:278 +
        # veneur_metrics_additional_tags)
        name_to_scope = {"local": dsd.SCOPE_LOCAL,
                         "global": dsd.SCOPE_GLOBAL,
                         "default": dsd.SCOPE_DEFAULT}
        scope_cfg = cfg.veneur_metrics_scopes
        extra = tuple(cfg.veneur_metrics_additional_tags)

        def _scope(mtype: str) -> str:
            return name_to_scope.get(scope_cfg.get(mtype, "local"),
                                     dsd.SCOPE_LOCAL)

        def count(name, value, tags=()):
            if value:
                samples.append(dsd.Sample(
                    name=name, type=dsd.COUNTER, value=float(value),
                    tags=tuple(sorted(tuple(tags) + extra)),
                    scope=_scope("counter")))

        def gauge(name, value, tags=()):
            samples.append(dsd.Sample(
                name=name, type=dsd.GAUGE, value=float(value),
                tags=tuple(sorted(tuple(tags) + extra)),
                scope=_scope("gauge")))

        def timer(name, value_ns, tags=()):
            samples.append(dsd.Sample(
                name=name, type=dsd.TIMER, value=float(value_ns),
                tags=tuple(sorted(tuple(tags) + extra)),
                scope=_scope("histogram")))

        stats = self.server.stats
        for key, (name, tags) in _COUNTER_MAP.items():
            count(name, self._delta(key), tags)
        for proto in _PROTOCOLS:
            count("veneur.listen.received_per_protocol_total",
                  self._delta(f"received_{proto}"),
                  (f"protocol:{proto}",))
        for mtype in _FLUSHED_TYPES:
            count("veneur.worker.metrics_flushed_total",
                  tally.get(mtype, 0), (f"metric_type:{mtype}",))
        count("veneur.forward.post_metrics_total",
              self._delta("forward_post_metrics"))
        # sharded global forward: per-destination wires shipped, items
        # busy-dropped on a wedged shard's bounded queue, and the
        # fail-open takes (columnar router -> per-row path, or sharded
        # -> the single-destination HTTP POST)
        count("veneur.forward.shard.wires_total",
              self._delta("forward_shard_wires"))
        count("veneur.forward.shard.busy_dropped_total",
              self._delta("forward_busy_dropped"))
        count("veneur.forward.shard.fallback_total",
              self._delta("sharded_route_fallbacks"), ("reason:route",))
        count("veneur.forward.shard.fallback_total",
              self._delta("sharded_forward_fallbacks"),
              ("reason:forward",))
        # live reshards, the rows they moved, and rows dropped because
        # a send missed the interval deadline
        count("veneur.forward.shard.reshards_total",
              self._delta("forward_reshards"))
        count("veneur.forward.shard.moved_rows_total",
              self._delta("forward_reshard_moved_rows"))
        count("veneur.forward.shard.timeout_dropped_total",
              self._delta("forward_timeout_dropped"))
        # drain and replay traffic, both directions: wires this node
        # sent (its shutdown flush; its spool after a destination
        # recovered) and flagged wires accepted from peers
        for key, metric in (
                ("drain_wires_sent", "veneur.forward.drain.wires_total"),
                ("drain_items_sent", "veneur.forward.drain.items_total"),
                ("drain_wires_received",
                 "veneur.import.drain_wires_total"),
                ("drain_items_received",
                 "veneur.import.drain_items_total"),
                ("replay_wires_sent", "veneur.forward.replay.wires_total"),
                ("replay_items_sent", "veneur.forward.replay.items_total"),
                ("replay_wires_received",
                 "veneur.import.replay_wires_total"),
                ("replay_items_received",
                 "veneur.import.replay_items_total"),
                # crash recovery: segments this node replayed at start,
                # and recovery wires accepted from restarting peers
                # (deduped: retransmits the inc:seq registry absorbed)
                ("recovery_segments_replayed",
                 "veneur.recovery.segments_total"),
                ("recovery_items_replayed", "veneur.recovery.items_total"),
                ("recovery_errors", "veneur.recovery.errors_total"),
                ("recovery_wires_received",
                 "veneur.import.recovery_wires_total"),
                ("recovery_items_received",
                 "veneur.import.recovery_items_total"),
                ("recovery_wires_deduped",
                 "veneur.import.recovery_deduped_total"),
                # the scale-out arc handoff, both directions
                ("handoff_wires_sent", "veneur.forward.handoff.wires_total"),
                ("handoff_items_sent", "veneur.forward.handoff.items_total"),
                ("handoff_errors", "veneur.forward.handoff.errors_total"),
                ("handoff_wires_received",
                 "veneur.import.handoff_wires_total"),
                ("handoff_items_received",
                 "veneur.import.handoff_items_total"),
                # listener fds adopted from a predecessor at start
                ("listener_fds_adopted",
                 "veneur.restart.fds_adopted_total")):
            count(metric, self._delta(key))
        # the staged-plane checkpointer: segments written, pruned after
        # a seal, and stale captures a flush overtook
        ckpt = self.server._checkpointer
        if ckpt is not None:
            for attr, metric in (
                    ("written", "veneur.checkpoint.written_total"),
                    ("bytes", "veneur.checkpoint.bytes_total"),
                    ("rows", "veneur.checkpoint.rows_total"),
                    ("pruned", "veneur.checkpoint.pruned_total"),
                    ("stale_discarded",
                     "veneur.checkpoint.stale_discarded_total"),
                    ("errors", "veneur.checkpoint.errors_total")):
                key = f"checkpoint_{attr}"
                stats[key] = int(ckpt.stats[attr])
                count(metric, self._delta(key))
            gauge("veneur.checkpoint.last_items", ckpt.stats["last_items"])
        fwd = self.server._sharded_fwd
        if fwd is not None:
            # discovery refresh errors by reason (keep-last-good)
            disc = fwd.discovery_stats()
            for reason, total in sorted(
                    disc.get("refresh_errors", {}).items()):
                key = f"discovery_refresh_errors_{reason}"
                stats[key] = int(total)
                count("veneur.discovery.refresh_errors_total",
                      self._delta(key), (f"reason:{reason}",))
            # per-destination breakers: state gauge (0 closed, 1
            # half-open, 2 open), trips and short-circuited sends
            for dest, bs in sorted(fwd.breaker_states().items()):
                gauge("veneur.forward.breaker.state", bs["state_code"],
                      (f"destination:{dest}",))
                key = f"breaker_opens_{dest}"
                stats[key] = int(bs["opens"])
                count("veneur.forward.breaker.opens_total",
                      self._delta(key), (f"destination:{dest}",))
                key = f"breaker_short_circuits_{dest}"
                stats[key] = int(bs["short_circuits"])
                count("veneur.forward.breaker.short_circuit_total",
                      self._delta(key), (f"destination:{dest}",))
            # the spool: lifetime intake and replay, expiry by reason,
            # and the live backlog
            sp = fwd.spool_stats()
            if sp is not None:
                for skey, metric in (
                        ("spooled_items",
                         "veneur.forward.spool.spooled_items_total"),
                        ("replayed_items",
                         "veneur.forward.spool.replayed_items_total"),
                        ("rejected_items",
                         "veneur.forward.spool.rejected_items_total")):
                    key = f"spool_{skey}"
                    stats[key] = int(sp[skey])
                    count(metric, self._delta(key))
                for reason, n in sorted(sp["expired_by_reason"].items()):
                    key = f"spool_expired_{reason}"
                    stats[key] = int(n)
                    count("veneur.forward.spool.expired_items_total",
                          self._delta(key), (f"reason:{reason}",))
                gauge("veneur.forward.spool.queued_items",
                      sp["queued_items"])
                gauge("veneur.forward.spool.queued_bytes",
                      sp["queued_bytes"])
        count("veneur.ledger.spool_imbalance_total",
              self._delta("spool_ledger_imbalance"))
        fwd_ns = self._delta("forward_duration_ns")
        if fwd_ns:
            timer("veneur.forward.duration_ns", fwd_ns)

        timer("veneur.flush.total_duration_ns", flush_duration_ns)
        # per-stage flush timings (observe/tracer.py span tree): WHERE
        # the interval went — device dispatch vs readback vs host emit
        # vs sink I/O
        if record is not None:
            for stage, ns in list(record.stages.items()):
                timer("veneur.flush.stage_duration_ns", ns,
                      (f"stage:{stage}",))
        # device-cost registry deltas (observe/devicecost.py): library
        # builds under the reference's compile names, readback bytes,
        # step dispatches and host-to-device bytes
        dev = observe.REGISTRY.totals()
        stats["xla_compiles"] = dev["compile_total"]
        count("veneur.xla.compile_total", self._delta("xla_compiles"))
        stats["xla_compile_ns"] = dev["compile_duration_ns"]
        compile_ns = self._delta("xla_compile_ns")
        if compile_ns:
            timer("veneur.xla.compile_duration_ns", compile_ns)
        stats["device_readback_bytes"] = dev["readback_bytes_total"]
        count("veneur.device.readback_bytes_total",
              self._delta("device_readback_bytes"))
        stats["device_dispatches"] = dev["dispatch_total"]
        count("veneur.device.dispatches_total",
              self._delta("device_dispatches"))
        stats["device_h2d_bytes"] = dev["h2d_bytes_total"]
        count("veneur.device.h2d_bytes_total",
              self._delta("device_h2d_bytes"))
        # adaptive sketch tiers (core/tiers.py): per-class/per-tier
        # sketch memory as gauges and the boundary's cumulative
        # movement counters as deltas.  Absent entirely when the
        # table resolved single-tier (_last_plane_bytes stays None)
        pb = self.server._last_plane_bytes
        if pb is not None:
            for cls in ("counter", "gauge", "histo", "set"):
                for tier_name, nbytes in sorted(
                        pb.get(cls, {}).items()):
                    gauge("veneur.device.plane_bytes", int(nbytes),
                          (f"class:{cls}", f"tier:{tier_name}"))
            gauge("veneur.device.plane_bytes_per_series",
                  float(pb.get("device_bytes_per_series", 0.0)))
            ti = pb.get("tiers") or {}
            for cls, mv in sorted((ti.get("movements") or {}).items()):
                for mname, metric in (
                        ("promotions", "veneur.tier.promotions_total"),
                        ("demotions", "veneur.tier.demotions_total"),
                        ("escalations",
                         "veneur.tier.escalations_total"),
                        ("promote_refused",
                         "veneur.tier.promote_refused_total")):
                    key = f"tier_{cls}_{mname}"
                    stats[key] = int(mv.get(mname, 0))
                    count(metric, self._delta(key), (f"class:{cls}",))
            for cls, occ in sorted((ti.get("occupancy") or {}).items()):
                gauge("veneur.tier.wide_rows", int(occ.get("wide", 0)),
                      (f"class:{cls}",))
                gauge("veneur.tier.free_slots",
                      int(occ.get("free_slots", 0)), (f"class:{cls}",))
        stats["xla_cache_hits"] = dev["compile_cache_hits"]
        stats["xla_cache_misses"] = dev["compile_cache_misses"]
        count("veneur.xla.compile_cache_hits",
              self._delta("xla_cache_hits"))
        count("veneur.xla.compile_cache_misses",
              self._delta("xla_cache_misses"))
        if self.server.config.count_unique_timeseries:
            # touched rows are the unique timeseries (one table needs
            # no sketch, flusher.go:135)
            uniq = sum(tally.get(k, 0) for k in _FLUSHED_TYPES)
            is_global = not self.server.is_local
            count("veneur.flush.unique_timeseries_total", uniq,
                  (f"global_veneur:{str(is_global).lower()}",))
        for sink_name, dur_ns in sink_durations.items():
            timer("veneur.sink.metric_flush_total_duration_ns", dur_ns,
                  (f"sink:{sink_name}",))
        # per-span-sink delivery counters (reference sinks.go
        # MetricKeyTotalSpansFlushed/Dropped/Skipped): the sinks keep
        # plain counters, the tick reports their deltas
        for sink in self.server.span_sinks:
            sname = getattr(sink, "name", type(sink).__name__)
            for attr, metric in (
                    ("submitted", "veneur.sink.spans_flushed_total"),
                    ("dropped", "veneur.sink.spans_dropped_total"),
                    ("skipped", "veneur.sink.spans_skipped_total"),
                    ("metrics_generated",
                     "veneur.sink.metrics_flushed_total")):
                cur = getattr(sink, attr, None)
                if cur is None:
                    continue
                key = f"span_sink_{sname}_{attr}"
                stats[key] = int(cur)
                count(metric, self._delta(key), (f"sink:{sname}",))
        # conservation-ledger verdict for the interval just sealed
        # (the seal runs before this tick)
        rec = self.server.ledger.last()
        if rec is not None:
            count("veneur.ledger.received_total", rec.received_total())
            count("veneur.ledger.staged_total", rec.staged)
            count("veneur.ledger.dropped_total", rec.overflow,
                  ("reason:overflow",))
            count("veneur.ledger.dropped_total", rec.invalid,
                  ("reason:invalid",))
            count("veneur.ledger.parse_errors_total", rec.parse_errors)
            count("veneur.ledger.emitted_rows_total", rec.emitted_rows)
            count("veneur.ledger.forwarded_rows_total",
                  rec.forwarded_rows)
            count("veneur.ledger.owed_total",
                  abs(rec.owed) + abs(rec.staged_drift)
                  + abs(rec.overflow_drift) + abs(rec.rows_owed)
                  + abs(rec.split_owed))
            count("veneur.ledger.forward_split_dropped_total",
                  rec.forward_split_dropped)
            count("veneur.ledger.imbalance_total",
                  self._delta("ledger_imbalance"))
            count("veneur.ledger.shed_total", rec.shed)
            count("veneur.ledger.recovered_total", rec.recovered)
            count("veneur.ledger.recovered_owed_total",
                  abs(rec.recovered_owed))
            count("veneur.ledger.reshard_received_items_total",
                  rec.reshard_received_items)
        # overload control: every shed sample by tenant and reason, the
        # pressure state, the overrun watchdog and coalesced ticks, and
        # the kernel receive drops
        ovl = self.server.overload
        if ovl is not None:
            for (tenant, reason), total in sorted(
                    ovl.shed_by_total.items()):
                key = f"overload_shed_{tenant}_{reason}"
                stats[key] = int(total)
                count("veneur.overload.shed_total", self._delta(key),
                      (f"tenant:{tenant}", f"reason:{reason}"))
            gauge("veneur.overload.pressure_level", ovl.pressure.level)
            gauge("veneur.overload.pressure_score", ovl.pressure.score)
            stats["flush_overruns"] = int(ovl.flush_overruns)
            count("veneur.flush.overrun_total",
                  self._delta("flush_overruns"))
        count("veneur.flush.coalesced_total",
              self._delta("flush_coalesced"))
        count("veneur.socket.kernel_drops_total",
              self._delta("socket_kernel_drops"))
        # the io_uring tier: drops to recvmmsg by reason (the probe
        # refused, or a ring died at runtime) and datagrams dropped at a
        # ring's buffer pool
        for reason in ("enosys", "eperm", "enomem", "einval", "error"):
            d = self._delta(f"socket_backend_fallback_{reason}")
            if d:
                count("veneur.socket.backend_fallback_total", d,
                      (f"reason:{reason}",))
        count("veneur.socket.uring_enobufs_total",
              self._delta("socket_uring_enobufs"))
        # signal-history plane + flight recorder: rows sampled into
        # the columnar ring, bundles dumped by trigger, dumps the
        # cooldown suppressed and writer errors
        sig = self.server.signals
        if sig is not None:
            stats["signals_rows"] = int(sig.appended_total)
            count("veneur.signals.rows_total",
                  self._delta("signals_rows"))
        flt = self.server.flight
        if flt is not None:
            for trig, total in sorted(flt.by_trigger().items()):
                key = f"flight_bundles_{trig}"
                stats[key] = int(total)
                count("veneur.flight.bundles_total",
                      self._delta(key), (f"trigger:{trig}",))
            stats["flight_suppressed"] = int(flt.suppressed_total)
            count("veneur.flight.suppressed_total",
                  self._delta("flight_suppressed"))
            stats["flight_errors"] = int(flt.errors_total)
            count("veneur.flight.errors_total",
                  self._delta("flight_errors"))

        # import response timing (reference README:
        # veneur.import.response_duration_ns); ns read before the
        # count, so the average can only deflate transiently
        imp_ns = self._delta("import_response_ns")
        resp = self._delta("import_responses")
        if resp:
            timer("veneur.import.response_duration_ns",
                  imp_ns / resp, ("part:merge",))

        # runtime stats (flusher.go:32-43: gc.number, heap bytes)
        counts = gc.get_stats()
        gauge("veneur.gc.number",
              sum(s.get("collections", 0) for s in counts))
        gauge("veneur.gc.pause_total_ns", _gc_pause_total_ns())
        gauge("veneur.mem.heap_alloc_bytes", _rss_bytes())
        gauge("veneur.flush.flush_timestamp_ns", time.time_ns())

        self._emit(samples)

    # ------------------------------------------------------------------

    def _emit(self, samples: list[dsd.Sample]) -> None:
        if self._sock is not None:
            lines = []
            for s in samples:
                t = {dsd.COUNTER: "c", dsd.GAUGE: "g",
                     dsd.TIMER: "ms"}[s.type]
                tagstr = ("|#" + ",".join(s.tags)) if s.tags else ""
                lines.append(f"{s.name}:{s.value}|{t}{tagstr}")
            try:
                self._sock.sendto("\n".join(lines).encode(), self._addr)
            except OSError as e:
                self._send_errs += 1
                if self._send_errs <= 3:  # don't spam every interval
                    log.warning("stats_address %s send failed: %s",
                                self._addr, e)
            return
        # loopback: inject into our own table (the next interval's
        # flush carries them).  They are table samples like any other,
        # so they credit the conservation ledger
        srv = self.server
        with srv.lock:
            staged = dropped = 0
            for s in samples:
                if srv.table.ingest(s):
                    staged += 1
                else:
                    dropped += 1
            srv.ledger.ingest("self-telemetry",
                              processed=staged + dropped,
                              staged=staged, overflow=dropped)

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None
