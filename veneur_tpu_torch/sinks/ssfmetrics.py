"""ssfmetrics: the span -> metric extraction bridge.

The port's copy of ``veneur_tpu/sinks/ssfmetrics.py``; a span's
samples go to the server in one ``ingest_samples`` call, where the
reference calls ``ingest_parsed`` once per sample.

The reference wires this sink into the HOT span path
(sinks/ssfmetrics/metrics.go:30, constructed server.go:444-452): every
span's attached SSFSamples become ordinary metrics in the aggregation
tables, and indicator spans additionally synthesize SLI duration
timers (samplers/parser.go:129 ConvertIndicatorMetrics).
"""

from __future__ import annotations

import logging

from veneur_tpu_torch.protocol import dogstatsd as dsd, ssf_convert

log = logging.getLogger("veneur_tpu_torch.sinks")


class MetricExtractionSink:
    name = "ssfmetrics"

    def __init__(self, server, indicator_timer_name: str = "",
                 objective_timer_name: str = "",
                 uniqueness_rate: float = 0.01):
        self._server = server
        self.indicator_timer_name = indicator_timer_name
        self.objective_timer_name = objective_timer_name
        self.uniqueness_rate = uniqueness_rate
        self.submitted = 0         # spans processed
        self.metrics_generated = 0
        self.dropped = 0           # extracted but table-dropped

    def start(self) -> None:
        pass

    def ingest(self, span) -> None:
        samples, invalid = ssf_convert.convert_metrics(span)
        samples.extend(ssf_convert.convert_indicator_metrics(
            span, self.indicator_timer_name,
            self.objective_timer_name))
        # span-population uniqueness sketch, delivery-sampled
        # (reference metrics.go:128 ConvertSpanUniquenessMetrics at
        # a fixed 1% rate).  Self-trace spans (observe/tracer.py) are
        # exempt: their names are a small constant set, and the random
        # sampling would inject table rows mid-interval, making the
        # server's own metric counts nondeterministic.
        if span.tags.get("veneur.internal") != "true":
            samples.extend(
                ssf_convert.convert_span_uniqueness_metrics(
                    span, self.uniqueness_rate))
        if invalid:
            # counted into the pipeline itself like the reference's
            # self-reported ssf.error_total (metrics.go:92-106)
            self._server.bump("ssf_invalid_samples", invalid)
            samples.append(dsd.Sample(
                name="ssf.error_total", type=dsd.COUNTER,
                value=float(invalid),
                tags=("packet_type:ssf_metric",
                      "reason:invalid_metrics",
                      "step:extract_metrics")))
        self.submitted += 1
        # flushed-vs-dropped must track what the TABLE accepted, or the
        # metrics_flushed_total counter hides data loss in exactly the
        # overload window it exists for; the span's samples go in under
        # one hold of the server's lock
        processed, dropped, _shed = self._server.ingest_samples(
            samples, bump=True)
        self.dropped += dropped
        self.metrics_generated += processed - dropped

    def flush(self) -> None:
        pass
