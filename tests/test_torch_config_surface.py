"""The port's configuration surface against the reference's.

The repo's ``example.yaml`` and ``example_host.yaml`` load strictly in
the port (every key they set is one the port runs).  Each key this
slice added takes the reference's default, its ``VENEUR_<KEY>``
environment override and its validation: a value the reference refuses
the port refuses with the same message, a value it accepts the port
accepts.  The keys the port still does not run stay refused by name.
"""

from __future__ import annotations

import os

import pytest

from veneur_tpu.core.config import read_config as jread_config
from veneur_tpu_torch.core.config import read_config

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
}


@pytest.mark.parametrize("name", ["example.yaml", "example_host.yaml"])
def test_example_config_loads_strictly(name):
    path = os.path.join(ROOT, name)
    got = read_config(path)
    want = jread_config(path, strict=True)
    for key in NEW_KEYS:
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


@pytest.mark.parametrize("addr", ["tcp://127.0.0.1:8126",
                                  "unixgram:///tmp/statsd.sock",
                                  "unix:///tmp/statsd.sock"])
def test_stream_and_unix_statsd_addresses_accepted(addr):
    cfg = read_config(data={"statsd_listen_addresses": [addr]}, env={})
    assert cfg.statsd_listen_addresses == [addr]


@pytest.mark.parametrize("key,value", [
    ("statsd_listen_addresses", ["quic://127.0.0.1:8126"]),
    ("ssf_listen_addresses", ["tcp://127.0.0.1:8128"]),
    ("http_address", "einhorn@0"),
])
def test_unsupported_listeners_refused(key, value):
    with pytest.raises(ValueError, match=key):
        read_config(data={key: value}, env={})


@pytest.mark.parametrize("key,value", [
    ("tpu_ingest_backend", "uring"), ("tpu_uring_buffers", 1024),
    ("tls_key", "k.pem"), ("tls_certificate", "c.pem"),
    ("forward_grpc_tls", True), ("datadog_api_key", "x"),
    ("sentry_dsn", "http://k@127.0.0.1:1/2"), ("tags_exclude", ["a"]),
    ("tpu_mesh_shards", 4), ("tpu_collective_forward", "on"),
])
def test_unported_keys_refused_by_name(key, value):
    jread_config(data={key: value}, env={})
    with pytest.raises(ValueError, match=key):
        read_config(data={key: value}, env={})
