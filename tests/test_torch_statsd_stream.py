"""TCP and unixgram DogStatsD listeners against the JAX server.

A port server on the CPU and a JAX server take the same lines over a
``tcp://`` listener (one connection, newline-delimited) and over a
``unixgram://`` socket (multi-line datagrams), with per-tenant
admission budgets active (token refill frozen at the burst, as
``tests/test_torch_overload.py`` runs them): the flushed user metrics
(counters, gauges, counts, min/max and sets bit for bit, percentiles
to rtol 2e-3 / atol 1e-3), the packet, sample, shed and per-protocol
counters and the sealed ledger record are equal.  A second server on a
unix socket path another holds is refused by its lock file, in either
package.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time

import numpy as np
import pytest

from veneur_tpu.core.config import read_config as jread_config
from veneur_tpu.core.server import Server as JServer
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.server import Server

_ROWS = {"tpu_counter_rows": 128, "tpu_gauge_rows": 128,
         "tpu_histo_rows": 128, "tpu_set_rows": 16}
_WAIT = 20.0


def _lines(seed: int) -> list[bytes]:
    """Counters, gauges, timers and sets across three tenants, scope
    tags, a service check and malformed lines."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(240):
        tenant = f"tenant:t{i % 3}"
        kind = i % 6
        if kind == 0:
            out.append(f"hits:{i % 5 + 1}|c|#{tenant}".encode())
        elif kind == 1:
            out.append(f"depth{i % 4}:{i}|g|#{tenant}".encode())
        elif kind in (2, 3):
            v = rng.gamma(2.0, 30.0)
            out.append(f"lat{i % 2}:{v:.4f}|ms|#{tenant}".encode())
        elif kind == 4:
            out.append(f"users:u{i % 17}|s|#{tenant}".encode())
        else:
            out.append(f"g.hits:{i}|c|#veneurglobalonly,{tenant}".encode())
    out[7] = b"not a metric line"
    out[50] = b"chk.stream:1|c|@0.5|#tenant:t1"
    out.append(b"_sc|stream.check|1|#tenant:t0")
    return out


def _pair(tmp: str, **kw):
    data = {"interval": "60s", "hostname": "h", **_ROWS,
            "tpu_overload_tenant_rate": 20.0,
            "tpu_overload_tenant_burst": 20.0, **kw}
    out = []
    for name, cls, read, dev in (("port", Server, read_config,
                                  {"device": "cpu"}),
                                 ("jax", JServer, jread_config, {})):
        path = os.path.join(tmp, f"{name}.sock")
        srv = cls(read(data=dict(data, statsd_listen_addresses=[
            "tcp://127.0.0.1:0", f"unixgram://{path}"])), **dev)
        # buckets hold exactly their burst: both admit the same samples
        srv.overload._refill = lambda: None
        srv.start()
        out.append((srv, path))
    return out


def _wait(pred, what):
    deadline = time.monotonic() + _WAIT
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def _user(metrics) -> dict:
    return {(m.name, m.tags): (m.value, m.type) for m in metrics
            if not m.name.startswith("veneur.")}


_COUNTERS = ("packets_received", "packet_errors", "metrics_processed",
             "metrics_dropped", "metrics_shed", "received_dogstatsd-tcp",
             "received_dogstatsd-unixgram")


@pytest.mark.parametrize("how", ["tcp", "unixgram"])
def test_stream_listeners_match_jax(how):
    lines = _lines(5)
    with tempfile.TemporaryDirectory() as tmp:
        pair = _pair(tmp)
        try:
            for srv, path in pair:
                if how == "tcp":
                    with socket.create_connection(
                            ("127.0.0.1", srv.statsd_ports[0])) as c:
                        c.sendall(b"\n".join(lines) + b"\n")
                    key, want = "received_dogstatsd-tcp", len(lines)
                else:
                    s = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
                    for k in range(0, len(lines), 20):
                        s.sendto(b"\n".join(lines[k:k + 20]), path)
                    s.close()
                    key, want = ("received_dogstatsd-unixgram",
                                 (len(lines) + 19) // 20)
                _wait(lambda: srv.stats.get(key, 0) == want,
                      f"{how}: every packet read")
            flushed = [srv.flush_once().metrics for srv, _ in pair]
            stats = [{k: srv.stats.get(k, 0) for k in _COUNTERS}
                     for srv, _ in pair]
            recs = [srv.ledger.records()[-1].to_dict() for srv, _ in pair]
        finally:
            for srv, _ in pair:
                srv.shutdown()
    assert stats[0] == stats[1]
    assert stats[0]["metrics_shed"] > 0 and stats[0]["packet_errors"] > 0
    for field in ("received", "shed", "balanced", "status", "dropped",
                  "parse_errors"):
        assert recs[0][field] == recs[1][field], field
    assert recs[0]["balanced"]
    got, want = (_user(m) for m in flushed)
    assert got.keys() == want.keys(), (sorted(set(got) - set(want)),
                                       sorted(set(want) - set(got)))
    assert ("stream.check", ("tenant:t0",)) in got
    for key, (w, wtype) in want.items():
        g, gtype = got[key]
        assert gtype == wtype, key
        if key[0].endswith("percentile"):
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-3,
                                       err_msg=str(key))
        else:
            assert g == w, key


@pytest.mark.parametrize("second", ["port", "jax"])
def test_socket_lock_refuses_a_second_server(second):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "statsd.sock")
        data = {"interval": "60s", **_ROWS,
                "statsd_listen_addresses": [f"unixgram://{path}"]}
        first = Server(read_config(data=data), device="cpu")
        first.start()
        other = (Server(read_config(data=data), device="cpu")
                 if second == "port" else JServer(jread_config(data=data)))
        try:
            with pytest.raises(RuntimeError, match="held by another"):
                other.start()
            # the holder still reads its socket
            s = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
            s.sendto(b"held:1|c", path)
            s.close()
            _wait(lambda: first.stats.get(
                "received_dogstatsd-unixgram", 0) == 1, "the holder's read")
        finally:
            other.shutdown()
            first.shutdown()
        # shutdown released the lock: a new server takes the path
        again = Server(read_config(data=data), device="cpu")
        again.start()
        again.shutdown()
        assert os.path.exists(path + ".lock")
