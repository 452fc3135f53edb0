"""The port's configuration surface against the reference's.

The repo's ``example.yaml`` and ``example_host.yaml`` load strictly in
the port (every key they set is one the port runs).  Each key this
slice added takes the reference's default, its ``VENEUR_<KEY>``
environment override and its validation: a value the reference refuses
the port refuses with the same message, a value it accepts the port
accepts.  The sinks' keys (``tags_exclude``, ``tpu_sink_workers``,
every sink's settings and the reference's deprecated aliases) read as
the reference reads them.  The last keys to be ported
(``sentry_dsn``, ``tpu_mesh_shards`` and the ``tpu_collective_*``
keys) read as the reference reads them too: the port's ``Config``
holds every field of the reference's, its ``ProxyConfig`` every field
of the reference's proxy config, and nothing is refused.
"""

from __future__ import annotations

import os

import pytest

from veneur_tpu.core.config import Config as JConfig
from veneur_tpu.core.config import ProxyConfig as JProxyConfig
from veneur_tpu.core.config import read_config as jread_config
from veneur_tpu_torch.core.config import Config, ProxyConfig, read_config

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# key -> (an environment value, a value the reference refuses or None
# where it validates nothing)
NEW_KEYS = {
    "tags": ("env:prod,bare", None),
    "debug": ("true", None),
    "flush_watchdog_missed_flushes": ("5", None),
    "synchronize_with_interval": ("1", None),
    "ssf_listen_addresses": ("udp://127.0.0.1:8128", None),
    "http_quit": ("yes", None),
    "trace_max_length_bytes": ("65536", None),
    "read_buffer_size_bytes": ("4194304", None),
    "num_workers": ("8", None),
    "percentile_naming": ("reference", "truncate"),
    "quantile_interpolation": ("reference", "linear"),
    "omit_empty_hostname": ("on", None),
    "count_unique_timeseries": ("true", None),
    "indicator_span_timer_name": ("ssf.indicator_span", None),
    "objective_span_timer_name": ("ssf.objective_span", None),
    "span_channel_capacity": ("64", 0),
    "num_span_workers": ("3", 0),
    "debug_ingested_spans": ("1", None),
    "blackhole_sink": ("true", None),
    "debug_flushed_metrics": ("true", None),
    "tpu_warmup": ("true", None),
    "compile_cache_dir": ("/tmp/cache", None),
    "accelerator_probe_timeout": ("5s", None),
    "tpu_ingest_backend": ("recvmmsg", "io_uring"),
    "tpu_uring_buffers": ("4096", 1000),
    "http_address": ("einhorn@3", None),
    "tls_key": ("/etc/veneur/key.pem", None),
    "tls_certificate": ("/etc/veneur/cert.pem", None),
    "tls_authority_certificate": ("/etc/veneur/ca.pem", None),
    "forward_grpc_tls": ("true", None),
    "forward_grpc_tls_ca": ("/etc/veneur/ca.pem", None),
}


# the sinks' keys: key -> (an environment value, a value the reference
# refuses or None where it validates nothing); an environment value of
# None marks a key whose environment form the reference cannot take
SINK_KEYS = {
    "tags_exclude": ("host,env|datadog", None),
    "mutex_profile_fraction": ("5", None),
    "block_profile_rate": ("7", None),
    "tpu_sink_workers": ("0", None),
    "datadog_api_key": ("k", None),
    "datadog_api_hostname": ("http://127.0.0.1:1", None),
    "datadog_flush_max_per_body": ("100", None),
    "flush_max_per_body": ("50", None),
    "datadog_metric_name_prefix_drops": ("a.,b.", None),
    "datadog_exclude_tags_prefix_by_prefix_metric": (
        None, [{"tags": ["host"]}]),
    "datadog_span_buffer_size": ("64", None),
    "ssf_buffer_size": ("32", None),
    "prometheus_repeater_address": ("udp://127.0.0.1:9125", None),
    "prometheus_network_type": ("udp", None),
    "aws_s3_bucket": ("b", None),
    "aws_region": ("us-west-2", None),
    "aws_access_key_id": ("AK", None),
    "aws_secret_access_key": ("SK", None),
    "aws_s3_endpoint": ("http://127.0.0.1:1", None),
    "kafka_broker": ("127.0.0.1:9092", None),
    "kafka_metric_topic": ("m", None),
    "kafka_check_topic": ("c", None),
    "kafka_event_topic": ("e", None),
    "kafka_span_topic": ("s", None),
    "kafka_span_serialization_format": ("json", "avro"),
    "kafka_metric_buffer_bytes": ("1024", None),
    "kafka_metric_buffer_messages": ("10", None),
    "kafka_metric_buffer_frequency": ("1s", None),
    "kafka_span_buffer_bytes": ("2048", None),
    "kafka_span_buffer_mesages": ("20", None),
    "kafka_span_buffer_frequency": ("2s", None),
    "kafka_metric_require_acks": ("local", "most"),
    "kafka_span_require_acks": ("none", "some"),
    "kafka_partitioner": ("random", "roundrobin"),
    "kafka_retry_max": ("3", None),
    "kafka_span_sample_rate_percent": ("50", 0.0),
    "kafka_span_sample_tag": ("team", None),
    "datadog_trace_api_address": ("http://127.0.0.1:8126", None),
    "signalfx_api_key": ("t", None),
    "signalfx_endpoint_base": ("http://127.0.0.1:1", None),
    "signalfx_endpoint_api": ("http://127.0.0.1:2", None),
    "signalfx_flush_max_per_body": ("10", None),
    "signalfx_vary_key_by": ("team", None),
    "signalfx_per_tag_api_keys": ("infra:k1,web:k2", None),
    "signalfx_dynamic_per_tag_api_keys_enable": ("true", None),
    "signalfx_dynamic_per_tag_api_keys_refresh_period": ("1m", None),
    "signalfx_hostname_tag": ("hostname", None),
    "signalfx_metric_name_prefix_drops": ("x.", None),
    "signalfx_metric_tag_prefix_drops": ("secret", None),
    "splunk_hec_address": ("http://127.0.0.1:8088", None),
    "splunk_hec_token": ("tok", None),
    "splunk_span_sample_rate": ("10", None),
    "splunk_hec_batch_size": ("7", None),
    "splunk_hec_submission_workers": ("2", None),
    "splunk_hec_tls_validate_hostname": ("hec.example", None),
    "splunk_hec_send_timeout": ("3s", None),
    "splunk_hec_ingest_timeout": ("4s", None),
    "splunk_hec_max_connection_lifetime": ("60s", None),
    "splunk_hec_connection_lifetime_jitter": ("5s", None),
    "newrelic_insert_key": ("ik", None),
    "newrelic_account_id": ("42", None),
    "newrelic_region": ("eu", None),
    "newrelic_event_type": ("ev", None),
    "newrelic_service_check_event_type": ("chk", None),
    "newrelic_trace_observer_url": ("http://127.0.0.1:3", None),
    "newrelic_metric_endpoint": ("http://127.0.0.1:4", None),
    "newrelic_trace_endpoint": ("http://127.0.0.1:5", None),
    "newrelic_common_tags": ("env:p,team:t", None),
    "xray_address": ("127.0.0.1:2000", None),
    "xray_sample_percentage": ("25.0", None),
    "xray_annotation_tags": ("route,user", None),
    "lightstep_access_token": ("lt", None),
    "lightstep_collector_host": ("http://127.0.0.1:6", None),
    "lightstep_maximum_spans": ("10", None),
    "lightstep_num_clients": ("2", None),
    "lightstep_reconnect_period": ("1m", None),
    "trace_lightstep_access_token": ("old", None),
    "trace_lightstep_collector_host": ("http://127.0.0.1:7", None),
    "trace_lightstep_maximum_spans": ("11", None),
    "trace_lightstep_num_clients": ("3", None),
    "trace_lightstep_reconnect_period": ("2m", None),
    "falconer_address": ("127.0.0.1:3000", None),
}

# the keys the port still does not run: none
REFUSED = ()


def test_config_holds_every_reference_key_but_the_refused():
    from dataclasses import fields
    want = {f.name for f in fields(JConfig)}
    got = {f.name for f in fields(Config)}
    assert got <= want
    assert sorted(want - got) == sorted(REFUSED)
    assert len(got) == 182 and len(want) == 182
    pwant = {f.name for f in fields(JProxyConfig)}
    pgot = {f.name for f in fields(ProxyConfig)}
    assert pgot == pwant and len(pgot) == 31


@pytest.mark.parametrize("name", ["example.yaml", "example_host.yaml"])
def test_example_config_loads_strictly(name):
    path = os.path.join(ROOT, name)
    got = read_config(path)
    want = jread_config(path, strict=True)
    for key in list(NEW_KEYS) + list(SINK_KEYS):
        assert getattr(got, key) == getattr(want, key), key
    assert got.statsd_listen_addresses == want.statsd_listen_addresses
    assert got.ssf_listen_addresses == want.ssf_listen_addresses


@pytest.mark.parametrize("key", sorted(NEW_KEYS))
def test_new_key_default_override_and_validation(key):
    env_value, bad = NEW_KEYS[key]
    assert getattr(read_config(data={}, env={}), key) == \
        getattr(jread_config(data={}, env={}), key)
    env = {"VENEUR_" + key.upper(): env_value}
    got = getattr(read_config(data={}, env=env), key)
    assert got == getattr(jread_config(data={}, env=env), key)
    assert got != getattr(read_config(data={}, env={}), key)
    if bad is None:
        return
    with pytest.raises(ValueError) as want:
        jread_config(data={key: bad}, env={})
    with pytest.raises(ValueError) as got_err:
        read_config(data={key: bad}, env={})
    assert str(got_err.value) == str(want.value)


@pytest.mark.parametrize("key", sorted(SINK_KEYS))
def test_sink_key_default_override_and_validation(key):
    env_value, bad = SINK_KEYS[key]
    assert getattr(read_config(data={}, env={}), key) == \
        getattr(jread_config(data={}, env={}), key)
    if env_value is not None:
        env = {"VENEUR_" + key.upper(): env_value}
        got_cfg = read_config(data={}, env=env)
        want_cfg = jread_config(data={}, env=env)
        got = getattr(got_cfg, key)
        assert got == getattr(want_cfg, key)
        assert got != getattr(read_config(data={}, env={}), key)
        # an alias folds into its replacement alike
        for f in SINK_KEYS:
            assert getattr(got_cfg, f) == getattr(want_cfg, f), f
    if bad is None:
        return
    with pytest.raises(ValueError) as want:
        jread_config(data={key: bad}, env={})
    with pytest.raises(ValueError) as got_err:
        read_config(data={key: bad}, env={})
    assert str(got_err.value) == str(want.value)


# deprecated alias -> (its replacement, a value): the alias applies
# only while the replacement holds its default
ALIASES = {
    "flush_max_per_body": ("datadog_flush_max_per_body", 77),
    "ssf_buffer_size": ("datadog_span_buffer_size", 99),
    "trace_lightstep_access_token": ("lightstep_access_token", "old"),
    "trace_lightstep_collector_host": ("lightstep_collector_host",
                                       "http://127.0.0.1:9"),
    "trace_lightstep_maximum_spans": ("lightstep_maximum_spans", 12),
    "trace_lightstep_num_clients": ("lightstep_num_clients", 4),
    "trace_lightstep_reconnect_period": ("lightstep_reconnect_period",
                                         "9m"),
}


@pytest.mark.parametrize("alias", sorted(ALIASES))
def test_sink_alias_resolves_as_jax(alias):
    target, value = ALIASES[alias]
    got = read_config(data={alias: value}, env={})
    want = jread_config(data={alias: value}, env={})
    assert getattr(got, target) == getattr(want, target) == value
    # a replacement set explicitly wins over its alias
    explicit = getattr(JConfig(), target)
    explicit = (explicit + 1 if isinstance(explicit, int)
                else explicit + "x")
    data = {alias: value, target: explicit}
    assert getattr(read_config(data=data, env={}), target) == \
        getattr(jread_config(data=data, env={}), target) == explicit


@pytest.mark.parametrize("addr", ["tcp://127.0.0.1:8126",
                                  "unixgram:///tmp/statsd.sock",
                                  "unix:///tmp/statsd.sock"])
def test_stream_and_unix_statsd_addresses_accepted(addr):
    cfg = read_config(data={"statsd_listen_addresses": [addr]}, env={})
    assert cfg.statsd_listen_addresses == [addr]


@pytest.mark.parametrize("key,value", [
    ("statsd_listen_addresses", ["quic://127.0.0.1:8126"]),
    ("ssf_listen_addresses", ["tcp://127.0.0.1:8128"]),
])
def test_unsupported_listeners_refused(key, value):
    with pytest.raises(ValueError, match=key):
        read_config(data={key: value}, env={})


# the ingest edge's keys, once refused by name: each value reads as the
# reference reads it, and a bad value is refused by both with the same
# message (the TLS keys are not validated at read time by either: a key
# pair that cannot load fails the server's start, tests/test_torch_tls.py)
@pytest.mark.parametrize("key,value,bad", [
    ("http_address", "einhorn@0", None),
    ("tpu_ingest_backend", "uring", "epoll"),
    ("tpu_uring_buffers", 1024, 3),
    ("tls_key", "k.pem", None), ("tls_certificate", "c.pem", None),
    ("forward_grpc_tls", True, None),
])
def test_edge_keys_read_as_jax(key, value, bad):
    got = getattr(read_config(data={key: value}, env={}), key)
    assert got == getattr(jread_config(data={key: value}, env={}), key)
    assert got == value
    if bad is None:
        return
    with pytest.raises(ValueError) as want:
        jread_config(data={key: bad}, env={})
    with pytest.raises(ValueError) as got_err:
        read_config(data={key: bad}, env={})
    assert str(got_err.value) == str(want.value)


def test_einhorn_address_needs_a_listener_number():
    """``einhorn@`` with no number: the reference fails at start-up
    (``int('')``), the port at read time, by the key's name."""
    with pytest.raises(ValueError, match="http_address"):
        read_config(data={"http_address": "einhorn@"}, env={})


# once refused by name, now read as the reference reads them
@pytest.mark.parametrize("key,value", [
    ("datadog_api_key", "x"), ("tags_exclude", ["a", "b|datadog"]),
])
def test_sink_keys_read_as_jax(key, value):
    got = getattr(read_config(data={key: value}, env={}), key)
    assert got == getattr(jread_config(data={key: value}, env={}), key)
    assert got == value


# once refused by name, now read as the reference reads them: the
# value, the ``VENEUR_<KEY>`` override and the validation
@pytest.mark.parametrize("key,value", [
    ("sentry_dsn", "http://k@127.0.0.1:1/2"),
    ("tpu_mesh_shards", 4), ("tpu_collective_forward", "on"),
    ("tpu_collective_import", "off"), ("tpu_collective_peers", ""),
    ("tpu_collective_max_rows", 256),
    ("tpu_collective_key_bytes", 128),
])
def test_unported_keys_refused_by_name(key, value):
    assert key not in REFUSED
    got = getattr(read_config(data={key: value}, env={}), key)
    assert got == getattr(jread_config(data={key: value}, env={}),
                          key) == value
    assert getattr(read_config(data={}, env={}), key) == getattr(
        jread_config(data={}, env={}), key)
    env = {"VENEUR_" + key.upper(): str(value) or "x=1"}
    if key == "tpu_collective_peers":
        env.update({"VENEUR_TPU_SHARDED_GLOBAL": "1",
                    "VENEUR_FORWARD_USE_GRPC": "1"})
    assert getattr(read_config(data={}, env=env), key) == getattr(
        jread_config(data={}, env=env), key)


@pytest.mark.parametrize("data", [
    {"tpu_collective_import": "maybe"},
    {"tpu_collective_forward": "sometimes"},
    {"tpu_collective_peers": "a:1=1"},
    {"tpu_collective_peers": "a:1=1", "tpu_sharded_global": True},
    {"tpu_collective_peers": "a:1=x", "tpu_sharded_global": True,
     "forward_use_grpc": True},
    {"tpu_collective_peers": "a:1=1,a:1=2", "tpu_sharded_global": True,
     "forward_use_grpc": True},
    {"tpu_collective_max_rows": 0}, {"tpu_collective_key_bytes": -1},
])
def test_collective_keys_refused_as_jax(data):
    """A value the reference's validation refuses, the port refuses
    with the same message."""
    with pytest.raises(ValueError) as want:
        jread_config(data=data, env={})
    with pytest.raises(ValueError) as got:
        read_config(data=data, env={})
    assert str(got.value) == str(want.value)


# keys whose value must parse as an address, a list of numbers or a
# duration (both packages refuse another string, each in its own words)
_ENV_VALUES = {
    "grpc_listen_addresses": "tcp://127.0.0.1:1",
    "http_address": "127.0.0.1:1",
    "percentiles": "0.5,0.9",
    "ssf_listen_addresses": "udp://127.0.0.1:1",
    "statsd_listen_addresses": "udp://127.0.0.1:1",
    "tpu_flight_cooldown": "5s",
}


def _env_value(key: str, default) -> str:
    """A ``VENEUR_<KEY>`` string of a field's type."""
    if key in _ENV_VALUES:
        return _ENV_VALUES[key]
    if isinstance(default, bool):
        return "1"
    if isinstance(default, int):
        return "7"
    if isinstance(default, float):
        return "0.5"
    if isinstance(default, list):
        return "a,b"
    if isinstance(default, dict):
        return "k:v"
    return "x"


@pytest.mark.parametrize("key", sorted(f.name for f in
                                       __import__("dataclasses")
                                       .fields(JConfig)))
def test_every_key_takes_its_env_override_as_jax(key):
    """Every key takes its ``VENEUR_<KEY>`` override, as in the
    reference: the same value, or the same refusal."""
    env = {"VENEUR_" + key.upper(): _env_value(key,
                                               getattr(JConfig(), key))}
    try:
        want = getattr(jread_config(data={}, env=env), key)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            read_config(data={}, env=env)
        assert str(got.value) == str(e)
        return
    assert getattr(read_config(data={}, env=env), key) == want
