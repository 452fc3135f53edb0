"""SSF sample/span -> internal metric conversion.

The port's copy of ``veneur_tpu/protocol/ssf_convert.py``.

The reference's ParseMetricSSF (samplers/parser.go:239), ConvertMetrics
(:103) and ConvertIndicatorMetrics (:129): SSF samples become the same
``dsd.Sample`` objects the DogStatsD path produces (SSF tags are a
string map -> sorted "k:v" tag tuple; the magic scope KEYS
``veneurlocalonly``/``veneurglobalonly`` set the scope and are
dropped), and indicator spans synthesize SLI duration timers.
"""

from __future__ import annotations

from veneur_tpu_torch.protocol import dogstatsd as dsd
from veneur_tpu_torch.protocol.gen import ssf_pb2
from veneur_tpu_torch.protocol.wire import valid_trace

_SSF_TYPE = {
    ssf_pb2.SSFSample.COUNTER: dsd.COUNTER,
    ssf_pb2.SSFSample.GAUGE: dsd.GAUGE,
    ssf_pb2.SSFSample.HISTOGRAM: dsd.HISTOGRAM,
    ssf_pb2.SSFSample.SET: dsd.SET,
    ssf_pb2.SSFSample.STATUS: dsd.STATUS,
}

_SSF_SCOPE = {
    ssf_pb2.SSFSample.DEFAULT: dsd.SCOPE_DEFAULT,
    ssf_pb2.SSFSample.LOCAL: dsd.SCOPE_LOCAL,
    ssf_pb2.SSFSample.GLOBAL: dsd.SCOPE_GLOBAL,
}


class InvalidSample(ValueError):
    pass


def parse_metric_ssf(m: ssf_pb2.SSFSample) -> dsd.Sample:
    """One SSFSample -> dsd.Sample (reference ParseMetricSSF,
    samplers/parser.go:239)."""
    mtype = _SSF_TYPE.get(m.metric)
    if mtype is None:
        raise InvalidSample(f"invalid SSF metric type {m.metric}")
    if not m.name:
        raise InvalidSample("SSF sample without name")
    scope = _SSF_SCOPE.get(m.scope, dsd.SCOPE_DEFAULT)
    tags = []
    for k, v in m.tags.items():
        # scope magic TAG KEYS, dropped from the tag set
        # (parser.go:277-285)
        if k == "veneurlocalonly":
            scope = dsd.SCOPE_LOCAL
            continue
        if k == "veneurglobalonly":
            scope = dsd.SCOPE_GLOBAL
            continue
        tags.append(f"{k}:{v}")
    tags = tuple(sorted(tags))
    rate = m.sample_rate if m.sample_rate > 0 else 1.0

    value: float | str
    message = ""
    if mtype == dsd.SET:
        value = m.message
    elif mtype == dsd.STATUS:
        value = float(m.status)
        message = m.message
    else:
        value = float(m.value)
    return dsd.Sample(name=m.name, type=mtype, value=value, tags=tags,
                      sample_rate=float(rate), scope=scope,
                      message=message)


def convert_metrics(span: ssf_pb2.SSFSpan
                    ) -> tuple[list[dsd.Sample], int]:
    """All parsable samples attached to a span; returns (samples,
    invalid_count) — valid ones survive a partial failure, as the
    reference's ConvertMetrics contract specifies."""
    out = []
    invalid = 0
    for m in span.metrics:
        try:
            out.append(parse_metric_ssf(m))
        except InvalidSample:
            invalid += 1
    return out, invalid


def convert_indicator_metrics(span: ssf_pb2.SSFSpan,
                              indicator_timer_name: str,
                              objective_timer_name: str
                              ) -> list[dsd.Sample]:
    """Indicator span -> SLI duration timers in nanoseconds
    (reference ConvertIndicatorMetrics, samplers/parser.go:129):
    the "indicator" timer tagged by service+error, the "objective"
    timer additionally tagged by span name (overridable with the
    ssf_objective span tag) and forced global."""
    if not span.indicator or not valid_trace(span):
        return []
    duration_ns = float(span.end_timestamp - span.start_timestamp)
    err = "true" if span.error else "false"
    out = []
    if indicator_timer_name:
        tags = tuple(sorted((f"service:{span.service}",
                             f"error:{err}")))
        out.append(dsd.Sample(name=indicator_timer_name,
                              type=dsd.TIMER, value=duration_ns,
                              tags=tags))
    if objective_timer_name:
        objective = span.tags.get("ssf_objective") or span.name
        tags = tuple(sorted((f"service:{span.service}",
                             f"objective:{objective}",
                             f"error:{err}")))
        out.append(dsd.Sample(name=objective_timer_name,
                              type=dsd.TIMER, value=duration_ns,
                              tags=tags, scope=dsd.SCOPE_GLOBAL))
    return out


def convert_span_uniqueness_metrics(span: ssf_pb2.SSFSpan,
                                    rate: float = 0.01,
                                    _random=None) -> list[dsd.Sample]:
    """Span-population uniqueness sketch (reference
    ConvertSpanUniquenessMetrics, samplers/parser.go:183-208): a Set
    sample ``ssf.names_unique`` counting unique span NAMES per
    service, tagged by indicator and root-ness, delivery-sampled at
    ``rate`` (reference ssf.RandomlySample, ssf/samples.go:128 — sets
    dedupe, so sampling thins delivery, not the count's meaning)."""
    if not span.service:
        return []
    import random as _rand
    roll = (_random if _random is not None else _rand.random)()
    if roll >= rate:
        return []
    is_root = span.id == span.trace_id
    tags = tuple(sorted((
        f"indicator:{'true' if span.indicator else 'false'}",
        f"service:{span.service}",
        f"root_span:{'true' if is_root else 'false'}")))
    return [dsd.Sample(name="ssf.names_unique", type=dsd.SET,
                       value=span.name.encode(), tags=tags)]
