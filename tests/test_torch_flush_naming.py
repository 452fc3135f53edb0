"""The flush's names and tags against the JAX flusher.

One JAX interval's planes and row metadata are carried into the port
(``convert.snapshot_from_numpy``), so both flushers read the same
snapshot.  Each case sets one of the flush keys this slice ported:
common ``tags``, ``percentile_naming`` (``precise`` and ``reference``,
at 0.5, 0.99 and 0.999, where the reference naming truncates 0.999 to
``99percentile``), ``quantile_interpolation`` (``interp`` and
``reference``), and an empty hostname kept by ``omit_empty_hostname``;
each runs through the columnar frame and the per-row emit, on a global
and on a local.  Names, tags, types and hostnames are equal; counters,
gauges, counts, min/max and set estimates bit for bit; sums, averages
and harmonic means to rtol 1e-6; percentiles and medians to rtol 2e-3 /
atol 1e-3 with each package's own readout.
"""

from __future__ import annotations

import socket

import numpy as np
import pytest

from veneur_tpu.core.config import read_config as jread_config
from veneur_tpu.core.flusher import Flusher as JFlusher
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.core.table import MetricTable as JTable
from veneur_tpu.core.table import TableConfig as JConfig
from veneur_tpu_torch import convert
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.flusher import Flusher, _percentile_suffix
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.protocol import dogstatsd as dsd

_SIZES = dict(counter_rows=64, gauge_rows=64, histo_rows=64, set_rows=16)
AGGS = ("max", "min", "sum", "avg", "count", "hmean", "median")
PCTS = (0.5, 0.99, 0.999)

CASES = {
    "tags": dict(tags=("env:prod", "veneurglobalonly", "team:core")),
    "naming_reference": dict(percentile_naming="reference"),
    "interp_reference": dict(quantile_interpolation="reference"),
    "both_reference": dict(percentile_naming="reference",
                           quantile_interpolation="reference",
                           tags=("dc:x",)),
    "empty_hostname": dict(hostname=""),
}


def _lines(seed: int = 11) -> list[bytes]:
    rng = np.random.default_rng(seed)
    lines = [b"hits:3|c", b"api:1|c|#route:a",
             b"g.hits:7|c|#veneurglobalonly", b"temp:9|g",
             b"g.temp:2|g|#veneurglobalonly",
             b"users:a|s", b"users:b|s", b"g.users:a|s|#veneurglobalonly",
             b"one:5|ms"]
    for v in rng.gamma(2.0, 30.0, 600):
        lines.append(f"lat:{v:.4f}|ms".encode())
        lines.append(f"lat:{v / 3:.4f}|ms|#route:b".encode())
    for v in rng.uniform(1, 50, 300):
        lines.append(f"g.lat:{v:.4f}|h|#veneurglobalonly".encode())
        lines.append(f"l.lat:{v:.4f}|ms|#veneurlocalonly".encode())
    return lines


def _snapshots():
    jt = JTable(JConfig(**_SIZES, host_set_plane_max_bytes=0))
    for ln in _lines():
        jt.ingest(dsd.parse_metric(ln))
    jsnap = jt.swap()
    state = {k: np.asarray(getattr(jsnap, k)) for k in convert.PLANES}
    for k in ("counter_meta", "gauge_meta", "histo_meta", "set_meta",
              "counter_touched", "gauge_touched", "histo_touched",
              "set_touched", "hll_host_plane", "hll_device_touched"):
        state[k] = getattr(jsnap, k)
    return jsnap, convert.snapshot_from_numpy(state, device="cpu")


def _by_key(metrics) -> dict:
    """(name, tags) -> the metrics under it, by value (the reference
    naming gives 0.99 and 0.999 one name)."""
    out: dict = {}
    for m in metrics:
        out.setdefault((m.name, m.tags), []).append(m)
    return {k: sorted(v, key=lambda m: m.value) for k, v in out.items()}


def _assert_same(got, want):
    g, w = _by_key(got), _by_key(want)
    assert g.keys() == w.keys(), (sorted(set(g) - set(w)),
                                  sorted(set(w) - set(g)))
    for key, wms in w.items():
        assert len(g[key]) == len(wms), key
        for gm, wm in zip(g[key], wms):
            assert (gm.type, gm.hostname, gm.timestamp) == \
                (wm.type, wm.hostname, wm.timestamp), key
            name = key[0]
            if name.endswith(("percentile", ".median")):
                np.testing.assert_allclose(gm.value, wm.value, rtol=2e-3,
                                           atol=1e-3, err_msg=str(key))
            elif name.endswith((".sum", ".avg", ".hmean")):
                np.testing.assert_allclose(gm.value, wm.value, rtol=1e-6,
                                           err_msg=str(key))
            else:
                assert gm.value == wm.value, key


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("columnar", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flush_keys_match_jax(case, columnar, is_local):
    jsnap, tsnap = _snapshots()
    kw = dict(is_local=is_local, percentiles=PCTS, aggregates=AGGS,
              hostname="h", columnar=columnar)
    kw.update(CASES[case])
    got = Flusher(device="cpu", **kw).flush(tsnap, now=42)
    want = JFlusher(**kw).flush(jsnap, now=42)
    assert got.metrics, "nothing flushed"
    _assert_same(got.metrics, want.metrics)
    assert got.tally == {k: v for k, v in want.tally.items()
                         if k in got.tally}
    tags = tuple(kw.get("tags", ()))
    assert all(m.tags[len(m.tags) - len(tags):] == tags
               for m in got.metrics)
    assert {m.hostname for m in got.metrics} == {kw["hostname"]}
    names = {m.name for m in got.metrics}
    if not is_local:
        if kw.get("percentile_naming") == "reference":
            assert "lat.99percentile" in names
            assert "lat.999percentile" not in names
        else:
            assert {"lat.99percentile", "lat.999percentile"} <= names


def test_reference_interpolation_differs_from_interp():
    """The two readouts are different functions: on the same snapshot
    they disagree somewhere, so the cases above test both."""
    _, tsnap = _snapshots()
    vals = []
    for method in ("interp", "reference"):
        res = Flusher(device="cpu", percentiles=PCTS, aggregates=AGGS,
                      quantile_interpolation=method).flush(tsnap, now=1)
        vals.append({(m.name, m.tags): m.value for m in res.metrics
                     if m.name.endswith("percentile")})
    assert vals[0].keys() == vals[1].keys()
    assert any(vals[0][k] != vals[1][k] for k in vals[0])


@pytest.mark.parametrize("naming", ["precise", "reference"])
@pytest.mark.parametrize("p", [0.5, 0.75, 0.99, 0.999, 0.9999, 0.1])
def test_percentile_suffix_matches_jax(p, naming):
    from veneur_tpu.core.flusher import _percentile_suffix as jsuffix
    assert _percentile_suffix(p, naming) == jsuffix(p, naming)


@pytest.mark.parametrize("omit", [False, True])
def test_server_hostname_and_flush_keys(omit):
    """A server with an empty ``hostname`` keeps it empty only with
    ``omit_empty_hostname``; its flusher takes the flush keys from the
    config, as the JAX server's does, and its flush carries them."""
    data = {"interval": "10s", "hostname": "", "omit_empty_hostname": omit,
            "tags": ["env:x"], "percentile_naming": "reference",
            "quantile_interpolation": "reference", "tpu_counter_rows": 16,
            "tpu_gauge_rows": 16, "tpu_histo_rows": 16, "tpu_set_rows": 4,
            "tpu_overload": False}
    t = Server(read_config(data=data), device="cpu")
    j = JServer(jread_config(data=data))
    try:
        for srv in (t, j):
            assert srv.flusher.hostname == ("" if omit
                                            else socket.gethostname())
            assert srv.flusher.common_tags == ("env:x",)
            assert srv.flusher.percentile_naming == "reference"
            assert srv.flusher.quantile_interpolation == "reference"
        flushed = []
        for srv in (t, j):
            srv.handle_packet(b"\n".join(b"x:%d|ms" % v
                                         for v in range(100)))
            flushed.append({(m.name, m.tags, m.hostname): m.value
                            for m in srv.flush_once().metrics
                            if not m.name.startswith("veneur.")})
        assert flushed[0].keys() == flushed[1].keys()
        assert ("x.99percentile", ("env:x",),
                t.flusher.hostname) in flushed[0]
    finally:
        t.shutdown()
        j.shutdown()
