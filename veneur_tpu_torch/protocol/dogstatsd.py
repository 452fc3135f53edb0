"""DogStatsD wire-format parser: text datagrams -> parsed samples.

Implements the grammar the reference accepts (samplers/parser.go:298
``ParseMetric``, :431 ``ParseEvent``, :579 ``ParseServiceCheck``):

    metric:        name:value|type[|@rate][|#tag1:v,tag2]
    event:         _e{Tlen,Mlen}:title|text[|d:ts][|h:host][|k:key]
                   [|p:prio][|s:src][|t:alert][|#tags]
    service check: _sc|name|status[|d:ts][|h:host][|#tags][|m:message]

Types: c=counter, g=gauge, ms/h=timer/histogram (both aggregate through
the t-digest path), s=set, plus the SSF-only status type.  Magic scope
tags ``veneurlocalonly``/``veneurglobalonly`` are stripped from the tag
set and recorded as the sample scope (reference parser.go:397-407);
``veneursinkonly:<sink>`` tags are kept for sink routing
(samplers/samplers.go:110-127).

Each parsed metric carries a 32-bit fnv1a digest over
(name, type, joined sorted tags) — the shard/routing key, matching the
reference's key-identity semantics (parser.go:325-420, MetricKey
parser.go:73).

This is the correctness-reference implementation; the high-throughput
ingest path batches whole datagrams through the columnar parser
(protocol/columnar.py) and falls back to this one line-at-a-time on
malformed input.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from veneur_tpu_torch.utils.hashing import fnv1a_32

COUNTER = "counter"
GAUGE = "gauge"
TIMER = "timer"
HISTOGRAM = "histogram"
SET = "set"
STATUS = "status"

# DogStatsD type token -> internal metric type.  The reference matches
# on the first type byte (parser.go:331), treating DogStatsD
# distributions ('d') as histograms and accepting bare 'm' for 'ms'.
_TYPE_TOKENS = {
    b"c": COUNTER,
    b"g": GAUGE,
    b"m": TIMER,
    b"ms": TIMER,
    b"h": HISTOGRAM,
    b"d": HISTOGRAM,
    b"s": SET,
}

SCOPE_DEFAULT = ""
SCOPE_LOCAL = "local"
SCOPE_GLOBAL = "global"

_TAG_LOCAL = "veneurlocalonly"
_TAG_GLOBAL = "veneurglobalonly"


class ParseError(ValueError):
    pass


@dataclass(frozen=True)
class Sample:
    """One parsed metric sample (the reference's UDPMetric,
    samplers/parser.go:24)."""
    name: str
    type: str
    value: float | str
    tags: tuple[str, ...] = ()
    sample_rate: float = 1.0
    scope: str = SCOPE_DEFAULT
    digest: int = 0
    message: str = ""  # status checks carry their check message

    def key(self) -> tuple[str, str, str]:
        """(name, type, joined tags) — MetricKey identity
        (samplers/parser.go:73)."""
        return (self.name, self.type, ",".join(self.tags))


@dataclass(frozen=True)
class Event:
    """DogStatsD event (reference ParseEvent, samplers/parser.go:431)."""
    title: str
    text: str
    timestamp: int | None = None
    hostname: str = ""
    aggregation_key: str = ""
    priority: str = ""
    source_type: str = ""
    alert_type: str = ""
    tags: tuple[str, ...] = ()


@dataclass(frozen=True)
class ServiceCheck:
    """DogStatsD service check (reference ParseServiceCheck,
    samplers/parser.go:579).  Aggregates as a STATUS metric."""
    name: str
    status: int
    timestamp: int | None = None
    hostname: str = ""
    message: str = ""
    tags: tuple[str, ...] = ()


def compute_digest(name: str, mtype: str, tags: tuple[str, ...]) -> int:
    """32-bit routing digest over the metric identity — same identity
    triple as the reference's key hash (name, type, sorted tags;
    samplers/parser.go:325-420), one fnv1a pass over a delimited
    encoding of it."""
    return fnv1a_32(
        (name + "\x00" + mtype + "\x00" + ",".join(tags)).encode())


def _split_tags(raw: bytes) -> tuple[tuple[str, ...], str]:
    """Sort tags, extract scope magic tags."""
    scope = SCOPE_DEFAULT
    out = []
    for t in raw.split(b","):
        if not t:
            continue
        ts = t.decode("utf-8", "replace")
        # prefix match, as the reference does (parser.go:397-407) — the
        # documented "veneurglobalonly:true" form must be recognized
        if ts.startswith(_TAG_LOCAL):
            scope = SCOPE_LOCAL
        elif ts.startswith(_TAG_GLOBAL):
            scope = SCOPE_GLOBAL
        else:
            out.append(ts)
    return tuple(sorted(out)), scope


def parse_metric(line: bytes) -> Sample:
    """Parse one DogStatsD metric line (reference ParseMetric,
    samplers/parser.go:298)."""
    pipe_parts = line.split(b"|")
    if len(pipe_parts) < 2:
        raise ParseError(f"not a metric: {line!r}")
    head = pipe_parts[0]
    colon = head.find(b":")
    if colon <= 0:
        raise ParseError(f"missing name or value: {line!r}")
    name = head[:colon]
    rawval = head[colon + 1:]
    if not rawval:
        raise ParseError(f"empty value: {line!r}")

    type_token = pipe_parts[1]
    mtype = _TYPE_TOKENS.get(type_token)
    if mtype is None:
        raise ParseError(f"invalid type {type_token!r}: {line!r}")

    sample_rate = 1.0
    tags: tuple[str, ...] = ()
    scope = SCOPE_DEFAULT
    for section in pipe_parts[2:]:
        if section.startswith(b"@"):
            try:
                sample_rate = float(section[1:])
            except ValueError:
                raise ParseError(f"bad sample rate: {line!r}")
            if not (0.0 < sample_rate <= 1.0):
                raise ParseError(f"sample rate out of range: {line!r}")
        elif section.startswith(b"#"):
            tags, scope = _split_tags(section[1:])
        else:
            raise ParseError(f"unknown section {section!r}: {line!r}")

    value: float | str
    if mtype == SET:
        value = rawval.decode("utf-8", "replace")
    elif mtype == GAUGE and sample_rate != 1.0:
        raise ParseError(f"gauge cannot have sample rate: {line!r}")
    else:
        try:
            value = float(rawval)
        except ValueError:
            raise ParseError(f"invalid value {rawval!r}: {line!r}")
        # NaN/Inf are rejected as in the reference (parser.go value
        # checks) — one such sample would poison a whole row's
        # aggregates on device
        if value != value or value in (float("inf"), float("-inf")):
            raise ParseError(f"non-finite value: {line!r}")

    name_s = name.decode("utf-8", "replace")
    if not name_s:
        raise ParseError(f"empty metric name: {line!r}")
    digest = compute_digest(name_s, mtype, tags)
    return Sample(name=name_s, type=mtype, value=value, tags=tags,
                  sample_rate=sample_rate, scope=scope, digest=digest)


def _kv_sections(parts: list[bytes]):
    for p in parts:
        if len(p) >= 2 and p[1:2] == b":":
            yield p[:1], p[2:]
        elif p.startswith(b"#"):
            yield b"#", p[1:]
        else:
            raise ParseError(f"unknown section: {p!r}")


def _parse_ts(fields: dict[bytes, bytes], line: bytes) -> int | None:
    if b"d" not in fields:
        return None
    try:
        return int(fields[b"d"])
    except ValueError:
        raise ParseError(f"bad timestamp: {line!r}")


def parse_event(line: bytes) -> Event:
    """Parse a DogStatsD event (``_e{<title len>,<text len>}:...``)."""
    if not line.startswith(b"_e{"):
        raise ParseError(f"not an event: {line!r}")
    close = line.find(b"}:")
    if close < 0:
        raise ParseError(f"malformed event header: {line!r}")
    try:
        tlen_s, xlen_s = line[3:close].split(b",")
        tlen, xlen = int(tlen_s), int(xlen_s)
    except ValueError:
        raise ParseError(f"malformed event lengths: {line!r}")
    body = line[close + 2:]
    if len(body) < tlen + 1 + xlen:
        raise ParseError(f"event body too short: {line!r}")
    title = body[:tlen]
    if body[tlen:tlen + 1] != b"|":
        raise ParseError(f"bad event separator: {line!r}")
    text = body[tlen + 1:tlen + 1 + xlen]
    rest = body[tlen + 1 + xlen:]
    fields: dict[bytes, bytes] = {}
    tags: tuple[str, ...] = ()
    if rest:
        if not rest.startswith(b"|"):
            raise ParseError(f"bad event trailer: {line!r}")
        for k, v in _kv_sections(rest[1:].split(b"|")):
            if k == b"#":
                tags, _ = _split_tags(v)
            else:
                fields[k] = v
    ts = _parse_ts(fields, line)
    return Event(
        title=title.decode("utf-8", "replace").replace("\\n", "\n"),
        text=text.decode("utf-8", "replace").replace("\\n", "\n"),
        timestamp=ts,
        hostname=fields.get(b"h", b"").decode("utf-8", "replace"),
        aggregation_key=fields.get(b"k", b"").decode("utf-8", "replace"),
        priority=fields.get(b"p", b"").decode("utf-8", "replace"),
        source_type=fields.get(b"s", b"").decode("utf-8", "replace"),
        alert_type=fields.get(b"t", b"").decode("utf-8", "replace"),
        tags=tags)


def parse_service_check(line: bytes) -> ServiceCheck:
    """Parse a DogStatsD service check (``_sc|name|status|...``)."""
    parts = line.split(b"|")
    if len(parts) < 3 or parts[0] != b"_sc":
        raise ParseError(f"not a service check: {line!r}")
    name = parts[1].decode("utf-8", "replace")
    if not name:
        raise ParseError(f"empty service check name: {line!r}")
    try:
        status = int(parts[2])
    except ValueError:
        raise ParseError(f"bad status: {line!r}")
    if status not in (0, 1, 2, 3):
        raise ParseError(f"status out of range: {line!r}")
    fields: dict[bytes, bytes] = {}
    tags: tuple[str, ...] = ()
    for k, v in _kv_sections(parts[3:]):
        if k == b"#":
            tags, _ = _split_tags(v)
        else:
            fields[k] = v
    ts = _parse_ts(fields, line)
    return ServiceCheck(
        name=name, status=status, timestamp=ts,
        hostname=fields.get(b"h", b"").decode("utf-8", "replace"),
        message=fields.get(b"m", b"").decode("utf-8", "replace")
                      .replace("\\n", "\n"),
        tags=tags)


def parse_line(line: bytes):
    """Dispatch one datagram line -> Sample | Event | ServiceCheck
    (reference HandleMetricPacket, server.go:1103)."""
    if line.startswith(b"_e{"):
        return parse_event(line)
    if line.startswith(b"_sc|"):
        return parse_service_check(line)
    return parse_metric(line)
