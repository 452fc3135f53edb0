"""Simple sinks (port of ``veneur_tpu/sinks/simple.py``):

- blackhole: discards everything (reference sinks/blackhole/
  blackhole.go:12; ``blackhole_sink``)
- debug: logs every flushed metric (reference sinks/debug;
  ``debug_flushed_metrics``)
- capture: holds flushed batches in memory (a server's extra sink in
  tests and embedding programs)
- localfile plugin: appends flush batches as TSV
  (reference plugins/localfile/localfile.go:32)
"""

from __future__ import annotations

import logging
import time

import numpy as np

from veneur_tpu_torch.core.metrics import InterMetric
from veneur_tpu_torch.sinks.base import SinkBase

log = logging.getLogger("veneur_tpu_torch.sinks")


class BlackholeSink(SinkBase):
    name = "blackhole"

    def flush(self, metrics: list[InterMetric]) -> None:
        pass

    def ingest(self, span) -> None:
        pass


class DebugSink(SinkBase):
    name = "debug"

    def flush(self, metrics: list[InterMetric]) -> None:
        for m in metrics:
            log.info("flushed metric %s=%s type=%s tags=%s", m.name,
                     m.value, m.type, ",".join(m.tags))

    def flush_other_samples(self, samples: list) -> None:
        for s in samples:
            log.info("flushed sample %r", s)


class CaptureSink(SinkBase):
    """Test sink: records everything (mirror of the reference's test
    capture sinks, server_test.go:134-170 fixture)."""
    name = "capture"

    def __init__(self):
        super().__init__()
        self.batches: list[list[InterMetric]] = []
        self.other: list = []
        self.spans: list = []

    def flush(self, metrics: list[InterMetric] | None = None) -> None:
        # doubles as a SpanSink, whose flush() takes no batch
        if metrics is not None:
            self.batches.append(list(metrics))

    def flush_other_samples(self, samples: list) -> None:
        self.other.extend(samples)

    def ingest(self, span) -> None:
        self.spans.append(span)

    @property
    def metrics(self) -> list[InterMetric]:
        return [m for b in self.batches for m in b]


def _tsv_rows(metrics: list[InterMetric], hostname: str) -> str:
    """Native TSV layout, inspired by the reference's CSV encoder
    fields (plugins/s3/csv.go): name, tags, type, hostname, raw
    timestamp, raw value, partition date.  Keeps raw values/types
    for operator readability; ``flush_file_format: reference``
    switches to the byte-exact reference schema below."""
    rows = []
    for m in metrics:
        dt = time.strftime("%Y-%m-%d", time.gmtime(m.timestamp))
        rows.append("\t".join([
            m.name, ",".join(m.tags), m.type, hostname,
            str(m.timestamp), repr(m.value), dt]))
    return "\n".join(rows) + ("\n" if rows else "")


# the reference renders Timestamp with Go layout "2006-01-02 03:04:05"
# (csv.go:15) — an HOUR-ONLY-12h quirk (03, no AM/PM) kept here for
# byte parity with the Redshift loaders built on it
_REDSHIFT_FMT = "%Y-%m-%d %I:%M:%S"
_PARTITION_FMT = "%Y%m%d"


def _fmt_value(v: float) -> str:
    """Shortest round-tripping positional decimal — Go's
    strconv.FormatFloat(v, 'f', -1, 64) (csv.go:82)."""
    return np.format_float_positional(float(v), trim="-")


def _tsv_rows_reference(metrics: list[InterMetric], hostname: str,
                        interval: float,
                        partition_ts: float | None = None) -> str:
    """Byte-exact reference TSV schema (plugins/s3/csv.go:51-89,
    golden rows csv_test.go): Name, {Tags}, MetricType, Hostname,
    Interval, Timestamp, Value, Partition — counters convert to
    per-second rates, only rates/gauges encode (the reference errors
    on other types; here they are skipped and counted in the log),
    and fields quote csv-style when they contain the delimiter."""
    import csv as _csv
    import io as _io

    buf = _io.StringIO()
    w = _csv.writer(buf, delimiter="\t", lineterminator="\n",
                    quoting=_csv.QUOTE_MINIMAL)
    part = time.strftime(
        _PARTITION_FMT,
        time.gmtime(partition_ts if partition_ts is not None
                    else time.time()))
    skipped = 0
    for m in metrics:
        if m.type == "counter":
            mtype, value = "rate", m.value / max(interval, 1e-9)
        elif m.type == "gauge":
            mtype, value = "gauge", m.value
        else:
            skipped += 1
            continue
        w.writerow([
            m.name, "{" + ",".join(m.tags) + "}", mtype, hostname,
            str(int(interval)),
            time.strftime(_REDSHIFT_FMT, time.gmtime(m.timestamp)),
            _fmt_value(value), part])
    if skipped:
        log.debug("reference tsv: skipped %d non-rate/gauge rows",
                  skipped)
    return buf.getvalue()


def encode_flush_rows(metrics: list[InterMetric], hostname: str,
                      fmt: str, interval: float) -> str:
    """Dispatch between the native layout and the reference-exact
    schema (``flush_file_format`` config key)."""
    if fmt == "reference":
        return _tsv_rows_reference(metrics, hostname, interval)
    return _tsv_rows(metrics, hostname)


class LocalFilePlugin:
    """Append each flush as TSV to one file (reference
    plugins/localfile; it shares the s3 plugin's CSV encoder, so
    ``fmt="reference"`` writes that exact schema here too)."""
    name = "localfile"

    def __init__(self, path: str, hostname: str = "",
                 fmt: str = "native", interval: float = 10.0):
        self.path = path
        self.hostname = hostname
        self.fmt = fmt
        self.interval = interval

    def flush(self, metrics: list[InterMetric],
              hostname: str = "") -> None:
        with open(self.path, "a") as f:
            f.write(encode_flush_rows(metrics,
                                      hostname or self.hostname,
                                      self.fmt, self.interval))


