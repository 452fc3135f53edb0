"""TLS on the port's listeners and on its gRPC forward.

The cases of ``tests/test_tls.py`` against the port, with certificates
made once for the module by ``openssl`` (a CA, and a server and a
client pair it signed, each with the loopback SAN gRPC verifies): TLS
ingest on the TCP
statsd listener, a plaintext client refused and counted in
``tls_handshake_errors``, mutual TLS refusing a client without a
certificate and taking one with, an authority certificate without a key
pair refused as in the JAX server, inline PEM material, the gRPC
listener under TLS, and the gRPC forward (plain, sharded, and from the
proxy) dialing a TLS global.  The TLS chain's global flushes what the
same chain in plaintext flushes, and a JAX local reaches the port's TLS
global with the same material.
"""

from __future__ import annotations

import os
import shutil
import socket
import ssl
import stat
import subprocess
import time

import grpc
import pytest

from veneur_tpu.core.config import read_config as jread_config
from veneur_tpu.core.server import Server as JServer
from veneur_tpu_torch.core.config import ProxyConfig, read_config
from veneur_tpu_torch.core.proxy import ProxyServer
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.sinks.simple import CaptureSink
from tests.torch_fixtures import unsampled_span_uniqueness  # noqa: F401

pytestmark = pytest.mark.skipif(shutil.which("openssl") is None,
                                reason="openssl is not on the PATH")

_ROWS = {"tpu_counter_rows": 64, "tpu_gauge_rows": 64,
         "tpu_histo_rows": 64, "tpu_set_rows": 8}


def _openssl(*args):
    subprocess.run(["openssl", *args], check=True, capture_output=True)


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    d = tmp_path_factory.mktemp("certs")
    ca_key, ca_crt = str(d / "ca.key"), str(d / "ca.crt")
    _openssl("req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", ca_key, "-out", ca_crt, "-days", "1",
             "-subj", "/CN=test-ca")
    out = {"ca": ca_crt}
    for name in ("server", "client"):
        key, csr, crt = (str(d / f"{name}.{x}")
                         for x in ("key", "csr", "crt"))
        _openssl("req", "-newkey", "rsa:2048", "-nodes", "-keyout", key,
                 "-out", csr, "-subj", "/CN=127.0.0.1")
        ext = d / f"{name}.ext"
        ext.write_text("subjectAltName=IP:127.0.0.1,DNS:localhost\n")
        _openssl("x509", "-req", "-in", csr, "-CA", ca_crt, "-CAkey",
                 ca_key, "-CAcreateserial", "-out", crt, "-days", "1",
                 "-extfile", str(ext))
        out[f"{name}_key"], out[f"{name}_crt"] = key, crt
    return out


def _server(cfg: dict, cap=None) -> Server:
    srv = Server(read_config(data={"interval": "60s", "hostname": "h",
                                   **_ROWS, **cfg}, env={}),
                 device="cpu", extra_sinks=[cap] if cap else None)
    srv.start()
    return srv


def _tls_server(certs, mtls: bool, cap=None) -> Server:
    cfg = {"statsd_listen_addresses": ["tcp://127.0.0.1:0"],
           "tls_key": certs["server_key"],
           "tls_certificate": certs["server_crt"]}
    if mtls:
        cfg["tls_authority_certificate"] = certs["ca"]
    return _server(cfg, cap)


def _client_ctx(certs, with_cert: bool) -> ssl.SSLContext:
    ctx = ssl.create_default_context(cafile=certs["ca"])
    ctx.check_hostname = False
    if with_cert:
        ctx.load_cert_chain(certs["client_crt"], certs["client_key"])
    return ctx


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def test_tls_ingest(certs):
    cap = CaptureSink()
    srv = _tls_server(certs, mtls=False, cap=cap)
    try:
        raw = socket.create_connection(("127.0.0.1", srv.statsd_ports[0]))
        with _client_ctx(certs, False).wrap_socket(raw) as s:
            s.sendall(b"tls.hits:5|c\ntls.lat:2|ms\n")
        assert _wait(lambda: srv.stats["metrics_processed"] >= 2)
        srv.flush_once()
    finally:
        srv.shutdown()
    got = {m.name: m.value for m in cap.metrics}
    assert got["tls.hits"] == 5.0
    assert srv.stats.get("tls_handshake_errors", 0) == 0


def test_plaintext_client_rejected_by_tls_server(certs):
    srv = _tls_server(certs, mtls=False)
    try:
        with socket.create_connection(
                ("127.0.0.1", srv.statsd_ports[0])) as s:
            s.sendall(b"plain.hits:5|c\n")
        assert _wait(lambda: srv.stats.get("tls_handshake_errors", 0) >= 1)
        assert srv.stats["metrics_processed"] == 0
    finally:
        srv.shutdown()


def test_mtls_requires_client_cert(certs):
    cap = CaptureSink()
    srv = _tls_server(certs, mtls=True, cap=cap)
    try:
        raw = socket.create_connection(("127.0.0.1", srv.statsd_ports[0]))
        with pytest.raises((ssl.SSLError, ConnectionResetError)):
            with _client_ctx(certs, False).wrap_socket(raw) as s:
                s.sendall(b"x:1|c\n")
                s.recv(1)  # the server's alert surfaces here
        assert _wait(lambda: srv.stats.get("tls_handshake_errors", 0) == 1)
        raw = socket.create_connection(("127.0.0.1", srv.statsd_ports[0]))
        with _client_ctx(certs, True).wrap_socket(raw) as s:
            s.sendall(b"mtls.hits:2|c\n")
        assert _wait(lambda: srv.stats["metrics_processed"] >= 1)
        srv.flush_once()
    finally:
        srv.shutdown()
    assert srv.stats["metrics_processed"] == 1
    assert any(m.name == "mtls.hits" for m in cap.metrics)


def test_authority_without_key_is_config_error(certs):
    data = {"tls_authority_certificate": certs["ca"], **_ROWS}
    with pytest.raises(ValueError, match="tls_authority") as got:
        Server(read_config(data=data, env={}), device="cpu")
    with pytest.raises(ValueError) as want:
        JServer(jread_config(data=data, env={}))
    assert str(got.value) == str(want.value)


def test_inline_pem_material(certs):
    """Inline PEM (the reference's example.yaml style) loads as a file
    path does: the key is spilled to a 0600 temporary file."""
    pem = {k: open(certs[f"server_{k}"]).read() for k in ("key", "crt")}
    spilled = []
    real = ssl.SSLContext.load_cert_chain

    def spy(self, certfile, keyfile=None, password=None):
        spilled.append(keyfile)
        return real(self, certfile, keyfile, password)
    ssl.SSLContext.load_cert_chain = spy
    try:
        cap = CaptureSink()
        srv = _server({"statsd_listen_addresses": ["tcp://127.0.0.1:0"],
                       "tls_key": pem["key"], "tls_certificate": pem["crt"]},
                      cap)
    finally:
        ssl.SSLContext.load_cert_chain = real
    try:
        assert stat.S_IMODE(os.stat(spilled[0]).st_mode) == 0o600
        assert open(spilled[0]).read() == pem["key"]
        raw = socket.create_connection(("127.0.0.1", srv.statsd_ports[0]))
        with _client_ctx(certs, False).wrap_socket(raw) as s:
            s.sendall(b"inline.hits:1|c\n")
        assert _wait(lambda: srv.stats["metrics_processed"] >= 1)
    finally:
        srv.shutdown()


def _forward_rows():
    from veneur_tpu_torch.core.flusher import Flusher
    from veneur_tpu_torch.core.table import MetricTable, TableConfig
    from veneur_tpu_torch.protocol import dogstatsd as dsd
    src = MetricTable(TableConfig(histo_rows=8), device="cpu")
    src.ingest(dsd.Sample(name="tlsm", type=dsd.COUNTER, value=3.0,
                          scope=dsd.SCOPE_GLOBAL))
    return Flusher(is_local=True, device="cpu").flush(src.swap()).forward


def test_grpc_listener_serves_under_tls(certs):
    """The gRPC listener serves under the server's TLS material
    (reference networking.go:333-340): a TLS client's wire is imported,
    a plaintext client fails."""
    from veneur_tpu_torch.forward.grpc_forward import ForwardClient
    srv = _server({"grpc_listen_addresses": ["tcp://127.0.0.1:0"],
                   "tls_key": certs["server_key"],
                   "tls_certificate": certs["server_crt"]})
    try:
        rows = _forward_rows()
        with open(certs["ca"], "rb") as f:
            creds = grpc.ssl_channel_credentials(f.read())
        client = ForwardClient(f"127.0.0.1:{srv.grpc_ports[0]}",
                               credentials=creds)
        client.send(rows)
        client.close()
        assert _wait(lambda: srv.stats.get("imports_received", 0) >= 1)
        plain = ForwardClient(f"127.0.0.1:{srv.grpc_ports[0]}", timeout=2.0)
        with pytest.raises(grpc.RpcError):
            plain.send(rows)
        plain.close()
    finally:
        srv.shutdown()


def _lines() -> list[bytes]:
    out = [b"g.hits:%d|c|#veneurglobalonly" % (i % 5 + 1) for i in range(40)]
    out += [b"lat.%d:%d|ms" % (i % 4, i) for i in range(200)]
    out += [b"users:u%d|s" % (i % 23) for i in range(60)]
    return [b"\n".join(out[k:k + 50]) for k in range(0, len(out), 50)]


def _chain(certs, tls: bool, how: str) -> dict:
    """A local (or a JAX local) forwarding one interval over gRPC to a
    port global, over TLS with ``forward_grpc_tls_ca`` (and mutual TLS
    on the global) or in plaintext: the global's user metrics."""
    gcfg = {"grpc_listen_addresses": ["tcp://127.0.0.1:0"]}
    if tls:
        gcfg.update(tls_key=certs["server_key"],
                    tls_certificate=certs["server_crt"],
                    tls_authority_certificate=certs["ca"])
    cap = CaptureSink()
    glob = _server(gcfg, cap)
    try:
        addr = f"127.0.0.1:{glob.grpc_ports[0]}"
        lcfg = {"interval": "60s", "hostname": "h", **_ROWS,
                "forward_address": addr, "forward_use_grpc": True}
        if tls:
            lcfg.update(forward_grpc_tls_ca=certs["ca"],
                        tls_key=certs["client_key"],
                        tls_certificate=certs["client_crt"])
        if how == "sharded":
            lcfg["tpu_sharded_global"] = True
        if how == "jax":
            local = JServer(jread_config(data=lcfg, env={}))
        else:
            local = Server(read_config(data=lcfg, env={}), device="cpu")
        try:
            for packet in _lines():
                local.handle_packet(packet)
            local.flush_once()
            assert _wait(lambda: glob.stats.get("imports_received", 0) >= 1)
            assert local.stats.get("forward_errors", 0) == 0
        finally:
            local.shutdown()
        glob.flush_once()
    finally:
        glob.shutdown()
    return {(m.name, m.tags): m.value for m in cap.metrics
            if not m.name.startswith("veneur.")}


@pytest.mark.parametrize("how", ["plain", "sharded", "jax"])
def test_grpc_forward_dials_tls_global(certs, how):
    """A local with ``forward_grpc_tls_ca`` and a client pair reaches an
    mTLS global through the ordinary forward (``plain``), the sharded
    forward's destination worker (``sharded``), and from the JAX
    package (``jax``); the global flushes what the same chain flushes in
    plaintext, bit for bit."""
    got = _chain(certs, True, how)
    assert got == _chain(certs, False, how)
    assert got[("g.hits", ())] == sum(i % 5 + 1 for i in range(40))
    assert ("lat.0.99percentile", ()) in got


def test_forward_without_client_cert_refused_by_mtls_global(certs):
    """A local that pins the CA but has no client pair fails its
    forward to an mTLS global: counted, nothing imported."""
    glob = _server({"grpc_listen_addresses": ["tcp://127.0.0.1:0"],
                    "tls_key": certs["server_key"],
                    "tls_certificate": certs["server_crt"],
                    "tls_authority_certificate": certs["ca"]})
    try:
        local = Server(read_config(data={
            "interval": "60s", **_ROWS, "forward_use_grpc": True,
            "forward_address": f"127.0.0.1:{glob.grpc_ports[0]}",
            "forward_grpc_tls_ca": certs["ca"]}, env={}), device="cpu")
        local._forward_grpc_credentials()
        try:
            local.handle_packet(b"g.x:1|c|#veneurglobalonly")
            local.flush_once()
        finally:
            local.shutdown()
        assert local.stats["forward_errors"] >= 1
        assert glob.stats.get("imports_received", 0) == 0
    finally:
        glob.shutdown()


def test_proxy_dials_tls_global(certs):
    """The proxy's gRPC destinations over TLS: a local forwards through
    a port proxy with ``forward_grpc_tls_ca`` to a TLS global, and the
    global flushes the local's global counter."""
    cap = CaptureSink()
    glob = _server({"grpc_listen_addresses": ["tcp://127.0.0.1:0"],
                    "tls_key": certs["server_key"],
                    "tls_certificate": certs["server_crt"]}, cap)
    px = ProxyServer(ProxyConfig(
        grpc_address="127.0.0.1:0", forward_grpc_tls_ca=certs["ca"],
        forward_address=f"127.0.0.1:{glob.grpc_ports[0]}"))
    px.start()
    try:
        local = Server(read_config(data={
            "interval": "60s", **_ROWS, "forward_use_grpc": True,
            "forward_address": f"127.0.0.1:{px.grpc_port}"}, env={}),
            device="cpu")
        try:
            local.handle_packet(b"px.hits:4|c|#veneurglobalonly")
            local.flush_once()
        finally:
            local.shutdown()
        assert _wait(lambda: glob.stats.get("imports_received", 0) >= 1)
        glob.flush_once()
    finally:
        px.shutdown()
        glob.shutdown()
    assert px.stats.get("forward_errors", 0) == 0
    assert {m.name: m.value for m in cap.metrics}["px.hits"] == 4.0
