"""veneur-prometheus equivalent: poll a Prometheus ``/metrics``
endpoint and re-emit the scrape as DogStatsD.

Port of ``veneur_tpu/cli/prometheus.py``; it speaks the same protocols
through the port's own protocol, trace and discovery modules.

The reference binary (cmd/veneur-prometheus/main.go) polls on an
interval, translates each Prometheus sample to statsd, and — because
Prometheus counters are cumulative while statsd counters are deltas —
keeps a cache of the previous scrape and emits count DIFFS
(cmd/veneur-prometheus/cache.go).  Monotonicity breaks (process
restart reset the counter) emit nothing for that cycle, like the
reference's negative-delta guard.  mTLS scrape support mirrors the
reference's -cert/-key/-cacert flags.

Translation rules:
  counter                      -> statsd count of (now - prev)
  gauge / untyped              -> statsd gauge
  histogram/summary _sum/_count and _bucket -> counts, diffed
  summary quantile samples     -> gauges (instantaneous)
Labels become ``k:v`` tags; ``-ignored-labels`` drops by label name,
``-added-labels`` appends fixed tags.
"""

from __future__ import annotations

import argparse
import logging
import re
import socket
import ssl
import sys
import time
import urllib.request

log = logging.getLogger("veneur_tpu_torch.prometheus")

_LINE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)(?:\s+\d+)?$")
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_ESCAPE = re.compile(r'\\(["n\\])')
_UNESCAPE_MAP = {'"': '"', "n": "\n", "\\": "\\"}


def _unescape(v: str) -> str:
    """Single-pass exposition-format unescape — sequential
    str.replace corrupts inputs like '\\\\new' (escaped backslash
    followed by a literal n) no matter the order."""
    return _ESCAPE.sub(lambda m: _UNESCAPE_MAP[m.group(1)], v)


def parse_exposition(text: str):
    """Prometheus text exposition -> [(name, labels dict, value,
    type)]; type comes from the preceding # TYPE comment (untyped when
    absent)."""
    types: dict[str, str] = {}
    out = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _LINE.match(line)
        if not m:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        name = m.group("name")
        labels = dict()
        if m.group("labels"):
            for lk, lv in _LABEL.findall(m.group("labels")):
                labels[lk] = _unescape(lv)
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in types:
                base = name[:-len(suffix)]
                break
        mtype = types.get(base, types.get(name, "untyped"))
        out.append((name, labels, value, mtype))
    return out


def _is_cumulative(name: str, mtype: str, labels: dict) -> bool:
    if mtype == "counter":
        return True
    if mtype in ("histogram", "summary"):
        # _bucket/_sum/_count series are cumulative; bare-name summary
        # quantile samples are instantaneous
        return (name.endswith(("_bucket", "_sum", "_count"))
                or "le" in labels)
    return False


def translate(samples, cache: dict, ignored_labels=(),
              added_tags=()) -> list[bytes]:
    """One scrape -> DogStatsD lines, diffing cumulative series
    against ``cache`` (mutated in place; the reference's cache.go)."""
    lines = []
    for name, labels, value, mtype in samples:
        # legitimately-escaped newlines/commas/pipes in label values
        # would corrupt the DogStatsD line protocol — flatten them
        tags = [f"{k}:{_sanitize(v)}"
                for k, v in sorted(labels.items())
                if k not in ignored_labels]
        tags.extend(added_tags)
        tagstr = ("|#" + ",".join(tags)) if tags else ""
        if _is_cumulative(name, mtype, labels):
            key = (name, tuple(sorted(labels.items())))
            prev = cache.get(key)
            cache[key] = value
            if prev is None or value < prev:
                continue  # first sight or counter reset: no delta
            delta = value - prev
            if delta == 0:
                continue
            lines.append(f"{name}:{_fmt(delta)}|c{tagstr}".encode())
        else:
            lines.append(f"{name}:{_fmt(value)}|g{tagstr}".encode())
    return lines


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(v)


def _sanitize(v: str) -> str:
    return (v.replace("\n", " ").replace(",", "_").replace("|", "_")
            .replace("#", "_"))


def scrape(url: str, cert=None, key=None, cacert=None,
           timeout=10.0) -> str:
    ctx = None
    if url.startswith("https"):
        ctx = ssl.create_default_context(cafile=cacert)
        if cert:
            ctx.load_cert_chain(cert, key)
    with urllib.request.urlopen(url, timeout=timeout,
                                context=ctx) as resp:
        return resp.read().decode("utf-8", "replace")


def main(argv=None) -> int:
    # add_help=False frees -h for the reference's metrics-host flag
    # (cmd/veneur-prometheus/main.go:13); --help still works
    ap = argparse.ArgumentParser(prog="veneur-prometheus",
                                 add_help=False)
    ap.add_argument("--help", action="help",
                    help="show this help message and exit")
    ap.add_argument("-host", "-h", dest="host",
                    default="http://localhost:9090/metrics",
                    help="prometheus metrics endpoint URL")
    ap.add_argument("-statsd-host", "-s", dest="statsd",
                    default="127.0.0.1:8126",
                    help="UDP statsd target host:port")
    ap.add_argument("-interval", "-i", default="10s")
    ap.add_argument("-prefix", "-p", default="",
                    help="prefix prepended VERBATIM to every metric "
                         "(include a trailing period, per the "
                         "reference)")
    ap.add_argument("-d", dest="debug", action="store_true",
                    help="debug logging")
    ap.add_argument("-socket", default="",
                    help="unix datagram socket path used as the "
                         "statsd transport instead of UDP")
    ap.add_argument("-ignored-labels", default="",
                    help="comma-separated label names to drop")
    ap.add_argument("-added-labels", default="",
                    help="comma-separated k:v tags to append")
    ap.add_argument("-cert", default=None)
    ap.add_argument("-key", default=None)
    ap.add_argument("-cacert", default=None)
    ap.add_argument("-once", action="store_true",
                    help="single scrape (for testing)")
    args = ap.parse_args(argv)
    if args.debug:
        logging.getLogger().setLevel(logging.DEBUG)

    iv = args.interval
    seconds = float(iv[:-1]) * {"s": 1, "m": 60, "h": 3600}.get(
        iv[-1], 1) if iv and iv[-1] in "smh" else float(iv)
    if args.socket:
        # unix datagram transport (-socket; the reference supports it
        # for proxy setups)
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        target = args.socket
    else:
        host, _, port = args.statsd.partition(":")
        target = (host, int(port or 8126))
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    ignored = tuple(x for x in args.ignored_labels.split(",") if x)
    added = tuple(x for x in args.added_labels.split(",") if x)
    cache: dict = {}

    while True:
        try:
            text = scrape(args.host, args.cert, args.key, args.cacert)
            out = translate(parse_exposition(text), cache,
                            ignored, added)
            for line in out:
                if args.prefix:
                    # verbatim: the reference's contract is that the
                    # prefix carries its own trailing period
                    line = args.prefix.encode() + line
                sock.sendto(line, target)
            log.info("scraped %s: %d metrics emitted", args.host,
                     len(out))
        except Exception:
            log.exception("scrape failed")
        if args.once:
            return 0
        time.sleep(seconds)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
