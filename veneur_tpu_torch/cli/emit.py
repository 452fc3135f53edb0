"""veneur-emit equivalent: CLI metric emitter and load generator
(reference cmd/veneur-emit: statsd UDP/TCP modes, -command timing
wrapper).

Port of ``veneur_tpu/cli/emit.py``; it speaks the same protocols
through the port's own protocol, trace and discovery modules.

Examples:
  python -m veneur_tpu_torch.cli.emit -hostport udp://127.0.0.1:8126 \
      -name daemontools.service.starts -count 1 -tag svc:foo
  python -m veneur_tpu_torch.cli.emit -hostport udp://127.0.0.1:8126 \
      -name cmd.duration -command sleep 0.2
  python -m veneur_tpu_torch.cli.emit -hostport udp://127.0.0.1:8126 \
      -bench-count 1000000 -bench-names 1000   # load generator
"""

from __future__ import annotations

import argparse
import random
import socket
import subprocess
import sys
import time

from veneur_tpu_torch.protocol.addr import parse_addr


def _open(hostport: str):
    scheme, host, port, path = parse_addr(hostport)
    if scheme == "udp":
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect((host, port))
        return s, True
    if scheme == "tcp":
        s = socket.create_connection((host, port))
        return s, False
    s = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
    s.connect(path)
    return s, True


def _send(sock, datagram: bool, payload: bytes):
    if datagram:
        sock.send(payload)
    else:
        sock.sendall(payload + b"\n")


def build_line(name: str, value, mtype: str, tags: list[str],
               rate: float = 1.0) -> bytes:
    parts = [f"{name}:{value}|{mtype}"]
    if rate != 1.0:
        parts.append(f"@{rate}")
    if tags:
        parts.append("#" + ",".join(tags))
    return "|".join(parts).encode()


def run_bench(sock, datagram: bool, count: int, names: int,
              mtype: str, tags: list[str], batch: int = 25) -> float:
    """Blast ``count`` samples over ``names`` metric names; returns
    seconds elapsed (the role of the BASELINE load-generator configs)."""
    start = time.perf_counter()
    lines = []
    for i in range(count):
        lines.append(build_line(f"bench.metric.{i % names}",
                                round(random.random() * 100, 3), mtype,
                                tags))
        if len(lines) >= batch:
            _send(sock, datagram, b"\n".join(lines))
            lines = []
    if lines:
        _send(sock, datagram, b"\n".join(lines))
    return time.perf_counter() - start


def _build_span(args, samples, tags: dict, start_ns: int,
                end_ns: int):
    """SSFSpan wrapping the requested samples (and/or command timing),
    the shape the reference's -ssf mode produces.  -span_starttime /
    -span_endtime override the measured window; -span_tags add
    span-only tags (useful for high-cardinality values kept off the
    metrics)."""
    from veneur_tpu_torch.protocol.gen import ssf_pb2
    if args.span_starttime:
        start_ns = _parse_when(args.span_starttime)
    if args.span_endtime:
        end_ns = _parse_when(args.span_endtime)
    span = ssf_pb2.SSFSpan(
        trace_id=args.trace_id or random.getrandbits(63),
        id=random.getrandbits(63),
        parent_id=args.parent_span_id,
        service=args.span_service,
        name=args.span_name or args.name or "veneur-emit",
        start_timestamp=start_ns, end_timestamp=end_ns,
        indicator=args.indicator, error=args.error)
    span.metrics.extend(samples)
    for k, v in tags.items():
        span.tags[k] = v
    for t in (args.span_tags.split(",") if args.span_tags else ()):
        k, _, v = t.partition(":")
        if k:
            span.tags[k] = v
    return span


def _emit_ssf_or_grpc(args) -> int:
    """-ssf / -grpc sends: SSF span datagrams, or gRPC unary calls to
    the server's DogstatsdGRPC / SSFGRPC services."""
    from veneur_tpu_torch.trace import metrics as tm

    if args.name is None and not args.command:
        print("need -name (or -command)", file=sys.stderr)
        return 1
    # open/validate the transport BEFORE running -command, so a bad
    # hostport can't execute a side-effecting command and then lose
    # its metric and exit code
    sock = None
    if not args.grpc:
        sock, datagram = _open(args.hostport)
        if not datagram:
            print("-ssf needs a datagram transport (udp/unixgram)",
                  file=sys.stderr)
            return 1

    rc = 0
    tags = {k: v for k, _, v in (t.partition(":") for t in args.tag)}
    samples = []
    if args.count is not None:
        samples.append(tm.count(args.name, args.count, tags,
                                sample_rate=args.rate))
    if args.gauge is not None:
        samples.append(tm.gauge(args.name, args.gauge, tags))
    if args.timing is not None:
        samples.append(tm.timing(args.name, args.timing / 1000.0,
                                 tags, sample_rate=args.rate))
    if args.set is not None:
        samples.append(tm.set_sample(args.name, args.set, tags))
    start_ns = time.time_ns()
    command_ms = None
    if args.command:
        t0 = time.perf_counter()
        rc = subprocess.call(args.command)
        command_ms = (time.perf_counter() - t0) * 1000.0
        samples.append(tm.timing(args.name or "command.duration",
                                 command_ms / 1000.0, tags))
    end_ns = time.time_ns()

    if args.grpc and not args.ssf:
        # plain statsd lines over DogstatsdGRPC.SendPacket.  Rate
        # applies only to counters/timers, matching the plain path.
        import grpc as grpclib

        from veneur_tpu_torch.protocol.gen import dogstatsd_grpc_pb2 as dpb
        lines = []
        for kind, val, rate in (("c", args.count, args.rate),
                                ("g", args.gauge, 1.0),
                                ("ms", args.timing, args.rate),
                                ("s", args.set, 1.0)):
            if val is not None:
                lines.append(build_line(args.name, val, kind,
                                        args.tag, rate))
        if command_ms is not None:
            lines.append(build_line(
                args.name or "command.duration",
                round(command_ms, 3), "ms", args.tag))
        chan = grpclib.insecure_channel(args.proxy or args.hostport)
        send = chan.unary_unary(
            "/dogstatsd.DogstatsdGRPC/SendPacket",
            request_serializer=(
                dpb.DogstatsdPacket.SerializeToString),
            response_deserializer=dpb.Empty.FromString)
        send(dpb.DogstatsdPacket(packetBytes=b"\n".join(lines)),
             timeout=10)
        chan.close()
        return rc

    span = _build_span(args, samples, tags, start_ns, end_ns)
    if args.grpc:
        import grpc as grpclib

        from veneur_tpu_torch.protocol.gen import dogstatsd_grpc_pb2 as dpb
        from veneur_tpu_torch.protocol.gen import ssf_pb2
        chan = grpclib.insecure_channel(args.proxy or args.hostport)
        send = chan.unary_unary(
            "/ssf.SSFGRPC/SendSpan",
            request_serializer=ssf_pb2.SSFSpan.SerializeToString,
            response_deserializer=dpb.Empty.FromString)
        send(span, timeout=10)
        chan.close()
    else:
        sock.send(span.SerializeToString())
    return rc


def build_event_packet(args) -> bytes:
    """DogStatsD event wire (_e{...}; reference buildEventPacket,
    cmd/veneur-emit/main.go:844)."""
    # real newlines escape to literal \n sequences (the parser's
    # inverse, dogstatsd.py:251) and the header lengths describe the
    # UTF-8 BYTES as transmitted
    title = args.e_title.replace("\n", "\\n")
    text = args.e_text.replace("\n", "\\n")
    parts = [f"_e{{{len(title.encode())},{len(text.encode())}}}"
             f":{title}|{text}"]
    if args.e_time:
        parts.append(f"d:{_parse_when(args.e_time) // 1_000_000_000}")
    if args.e_hostname:
        parts.append(f"h:{args.e_hostname}")
    if args.e_aggr_key:
        parts.append(f"k:{args.e_aggr_key}")
    if args.e_priority and args.e_priority != "normal":
        parts.append(f"p:{args.e_priority}")
    if args.e_source_type:
        parts.append(f"s:{args.e_source_type}")
    if args.e_alert_type and args.e_alert_type != "info":
        parts.append(f"t:{args.e_alert_type}")
    tags = list(args.tag)
    if args.e_event_tags:
        tags += args.e_event_tags.split(",")
    if tags:
        parts.append("#" + ",".join(tags))
    return "|".join(parts).encode()


def build_sc_packet(args) -> bytes:
    """DogStatsD service-check wire (_sc|...; reference
    buildSCPacket, cmd/veneur-emit/main.go:909)."""
    parts = [f"_sc|{args.sc_name}|{args.sc_status}"]
    if args.sc_time:
        parts.append(f"d:{_parse_when(args.sc_time) // 1_000_000_000}")
    if args.sc_hostname:
        parts.append(f"h:{args.sc_hostname}")
    tags = list(args.tag)
    if args.sc_tags:
        tags += args.sc_tags.split(",")
    if tags:
        parts.append("#" + ",".join(tags))
    if args.sc_msg:
        parts.append("m:" + args.sc_msg.replace("\n", "\\n"))
    return "|".join(parts).encode()


def _parse_when(text: str) -> int:
    """Date/time flag -> unix nanoseconds: unix epoch seconds or an
    ISO-8601 string (the reference accepts dateparse's formats)."""
    try:
        return int(float(text) * 1e9)
    except ValueError:
        from datetime import datetime
        return int(datetime.fromisoformat(text).timestamp() * 1e9)


def main(argv=None) -> int:
    # allow_abbrev=False: Go's flag package (the reference CLI) has no
    # prefix matching, and abbreviation makes argparse reject a
    # -command child arg like ``-c`` as "ambiguous" before REMAINDER
    # can consume it
    ap = argparse.ArgumentParser(prog="veneur-emit",
                                 allow_abbrev=False)
    ap.add_argument("-hostport", required=True)
    ap.add_argument("-mode", default="metric",
                    choices=["metric", "event", "sc"],
                    help="metric (default), event or sc "
                         "(service check); event/sc are statsd-only")
    ap.add_argument("-debug", action="store_true")
    ap.add_argument("-name")
    ap.add_argument("-count", type=float)
    ap.add_argument("-gauge", type=float)
    ap.add_argument("-timing", type=float)
    ap.add_argument("-set")
    ap.add_argument("-tag", action="append", default=[])
    ap.add_argument("-rate", type=float, default=1.0)
    ap.add_argument("-command", nargs=argparse.REMAINDER,
                    help="run command, emit wall time as timer")
    ap.add_argument("-bench-count", type=int)
    ap.add_argument("-bench-names", type=int, default=1000)
    ap.add_argument("-bench-type", default="c")
    # SSF / gRPC modes (reference cmd/veneur-emit -ssf and gRPC flags)
    ap.add_argument("-ssf", action="store_true",
                    help="send as an SSF span with attached samples")
    ap.add_argument("-grpc", action="store_true",
                    help="send over gRPC (DogstatsdGRPC / SSFGRPC)")
    # -proxy (reference: authority override for proxied emission) —
    # used as the dial target for gRPC sends when set
    ap.add_argument("-proxy", default="")
    ap.add_argument("-span-service", "-span_service",
                    dest="span_service", default="veneur-emit")
    ap.add_argument("-span-name", "-span_name", dest="span_name",
                    default="")
    ap.add_argument("-span_starttime", dest="span_starttime",
                    default="")
    ap.add_argument("-span_endtime", dest="span_endtime", default="")
    ap.add_argument("-span_tags", dest="span_tags", default="")
    ap.add_argument("-trace-id", "-trace_id", dest="trace_id",
                    type=int, default=0)
    ap.add_argument("-parent-span-id", "-parent_span_id",
                    dest="parent_span_id", type=int, default=0)
    ap.add_argument("-indicator", action="store_true")
    ap.add_argument("-error", action="store_true")
    # event flags (reference e_* family)
    ap.add_argument("-e_title", default="")
    ap.add_argument("-e_text", default="")
    ap.add_argument("-e_time", default="")
    ap.add_argument("-e_hostname", default="")
    ap.add_argument("-e_aggr_key", default="")
    ap.add_argument("-e_priority", default="normal")
    ap.add_argument("-e_source_type", default="")
    ap.add_argument("-e_alert_type", default="info")
    ap.add_argument("-e_event_tags", default="")
    # service-check flags (reference sc_* family)
    ap.add_argument("-sc_name", default="")
    ap.add_argument("-sc_status", default="")
    ap.add_argument("-sc_time", default="")
    ap.add_argument("-sc_hostname", default="")
    ap.add_argument("-sc_tags", default="")
    ap.add_argument("-sc_msg", default="")
    # split the child command off BEFORE argparse sees it: even with
    # allow_abbrev=False, 3.10's argparse prefix-matches single-dash
    # options (bpo-39775), so a child arg like ``-c`` dies as
    # "ambiguous" before REMAINDER can claim it
    argv = list(sys.argv[1:] if argv is None else argv)
    command_tail: list[str] = []
    if "-command" in argv:
        i = argv.index("-command")
        command_tail = argv[i + 1:]
        argv = argv[:i]
    args = ap.parse_args(argv)
    if command_tail:
        args.command = command_tail

    if args.debug:
        import logging
        logging.basicConfig(level=logging.DEBUG)

    if args.mode in ("event", "sc"):
        # events/checks are statsd-wire only (the reference rejects
        # -ssf with these modes, main.go:215-219)
        if args.ssf or args.grpc:
            print(f"mode {args.mode} is unsupported with -ssf/-grpc",
                  file=sys.stderr)
            return 1
        if args.mode == "event" and not (args.e_title and
                                         args.e_text):
            print("event mode needs -e_title and -e_text",
                  file=sys.stderr)
            return 1
        if args.mode == "sc" and not (args.sc_name and
                                      args.sc_status != ""):
            print("sc mode needs -sc_name and -sc_status",
                  file=sys.stderr)
            return 1
        sock, datagram = _open(args.hostport)
        pkt = (build_event_packet(args) if args.mode == "event"
               else build_sc_packet(args))
        if args.debug:
            print(f"sending to {args.hostport}: {pkt!r}",
                  file=sys.stderr)
        _send(sock, datagram, pkt)
        return 0

    if args.ssf or args.grpc:
        return _emit_ssf_or_grpc(args)

    sock, datagram = _open(args.hostport)

    if args.bench_count:
        elapsed = run_bench(sock, datagram, args.bench_count,
                            args.bench_names, args.bench_type, args.tag)
        print(f"{args.bench_count} samples in {elapsed:.3f}s "
              f"({args.bench_count / elapsed:,.0f}/s)")
        return 0

    if args.command:
        t0 = time.perf_counter()
        rc = subprocess.call(args.command)
        ms = (time.perf_counter() - t0) * 1000.0
        _send(sock, datagram,
              build_line(args.name or "command.duration", round(ms, 3),
                         "ms", args.tag))
        return rc

    if args.name is None:
        print("need -name (or -command/-bench-count)", file=sys.stderr)
        return 1
    if args.count is not None:
        _send(sock, datagram, build_line(args.name, args.count, "c",
                                         args.tag, args.rate))
    if args.gauge is not None:
        _send(sock, datagram, build_line(args.name, args.gauge, "g",
                                         args.tag))
    if args.timing is not None:
        _send(sock, datagram, build_line(args.name, args.timing, "ms",
                                         args.tag, args.rate))
    if args.set is not None:
        _send(sock, datagram, build_line(args.name, args.set, "s",
                                         args.tag))
    return 0


if __name__ == "__main__":
    sys.exit(main())
