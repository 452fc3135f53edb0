"""CPU parity of the port's service discovery against the JAX package.

``ConsulDiscoverer`` against a local fake Consul (plain HTTP) and
``KubernetesDiscoverer`` against a local fake API server (HTTPS with a
self-signed certificate made by ``openssl`` for 127.0.0.1), each also
run through the JAX package's discoverer on the same answers;
``DestinationRing``'s keep-last-good refresh (a failed poll, a counted
empty answer), its pending-change records and stats, and
``StaticDiscoverer``.

Tolerance: none — destination lists, rings and counts are compared
exactly.
"""

from __future__ import annotations

import http.server
import json
import subprocess
import threading

import pytest

from veneur_tpu.forward import discovery as jdisc
from veneur_tpu_torch.forward import discovery


class _Fake:
    """A local HTTP(S) server answering GETs from a script: each entry
    is (status, JSON-able body); the last entry repeats."""

    def __init__(self, script, tls_files=None):
        self.script = list(script)
        self.requests = []
        fake = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                fake.requests.append(
                    (self.path, self.headers.get("Authorization")))
                status, body = (fake.script.pop(0)
                                if len(fake.script) > 1 else fake.script[0])
                out = json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.httpd.daemon_threads = True
        if tls_files is not None:
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(*tls_files)
            self.httpd.socket = ctx.wrap_socket(self.httpd.socket,
                                                server_side=True)
        self.port = self.httpd.server_port
        self._t = threading.Thread(target=self.httpd.serve_forever,
                                   daemon=True)
        self._t.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._t.join(timeout=5.0)


def _consul(*entries):
    return [{"Node": {"Address": node},
             "Service": {"Address": svc, "Port": port}}
            for node, svc, port in entries]


CONSUL_SCRIPT = (
    (200, _consul(("10.0.0.1", "", 8128), ("10.0.0.2", "10.1.1.2", 8200),
                  ("10.0.0.3", "", 0))),
    (500, {"error": "consul down"}),
    (200, []),
    (200, _consul(("10.0.0.2", "10.1.1.2", 8200),
                  ("10.0.0.4", "", 8128))),
    (200, _consul(("10.0.0.4", "", 8128), ("10.0.0.2", "10.1.1.2", 8200))),
)


def _run_ring(mod, url):
    ring = mod.DestinationRing(mod.ConsulDiscoverer(url), "veneur-global")
    trace = []
    for _ in CONSUL_SCRIPT:
        changed = ring.refresh()
        change = ring.take_change()
        if change is not None:
            epoch, added, removed, prev = change
            change = (epoch, added, removed, prev.members)
        trace.append((changed, ring.ring.members, change,
                      ring.get("some.key|counter|"), ring.stats()))
    return trace


def test_consul_ring_keep_last_good_matches_jax():
    """A ring refreshed from a fake Consul: the first answer seeds it
    (an entry without a port is skipped), a 500 and an empty answer
    keep the last good membership and are counted by reason, a changed
    answer swaps it and leaves a pending change, the same set in
    another order is no change.  Both packages give the same trace."""
    got, want = [], []
    for mod, out in ((discovery, got), (jdisc, want)):
        fake = _Fake(CONSUL_SCRIPT)
        try:
            out.extend(_run_ring(mod, f"http://127.0.0.1:{fake.port}/"))
        finally:
            fake.close()
        assert all("/v1/health/service/veneur-global?passing=true" in p
                   for p, _ in fake.requests)
    assert got == want
    last = got[-1][-1]
    assert last["members"] == ["10.0.0.4:8128", "10.1.1.2:8200"]
    assert last["refresh_errors"] == {"error": 1, "empty": 1}
    assert last["refresh_failures"] == 2 and last["epoch"] == 2
    assert got[0][0] and not got[1][0] and not got[2][0]
    assert got[1][1] == got[2][1] == ("10.0.0.1:8128", "10.1.1.2:8200")
    assert got[3][2][1:3] == (["10.0.0.4:8128"], ["10.0.0.1:8128"])
    assert got[4][2] is None


def test_ring_apply_merges_a_burst_of_changes_as_jax():
    """Two swaps before one take: the change record carries the net adds
    and removes against the oldest pre-swap ring, in both packages."""
    out = []
    for mod in (discovery, jdisc):
        ring = mod.DestinationRing(mod.StaticDiscoverer(["a:1"]), "static")
        assert ring.refresh()
        ring.take_change()
        assert ring.apply(["a:1", "b:1"]) and ring.apply(["b:1", "c:1"])
        assert not ring.apply(["c:1", "b:1"])
        epoch, added, removed, prev = ring.take_change()
        out.append((epoch, added, removed, prev.members,
                    ring.take_change(), ring.snapshot().members))
    assert out[0] == out[1] == (
        3, ["b:1", "c:1"], ["a:1"], ("a:1",), None, ("b:1", "c:1"))


@pytest.fixture
def tls_files(tmp_path):
    crt, key = tmp_path / "ca.crt", tmp_path / "key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(crt), "-days", "1",
         "-subj", "/CN=127.0.0.1", "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True, timeout=60)
    return str(crt), str(key)


def _pods(*pods):
    return {"items": [
        {"status": {"podIP": ip, "conditions": [
            {"type": "Ready", "status": "True" if ready else "False"}]}}
        for ip, ready in pods]}


def test_kubernetes_discoverer_matches_jax(tmp_path, tls_files,
                                          monkeypatch):
    """The in-cluster pod lister against a fake API server over HTTPS:
    the service account's token is sent as a bearer, the namespace
    comes from its file, only ready pods with an IP are listed; a 403
    raises and a ring keeps its last good membership.  Out of cluster
    the discoverer refuses to start.  Both packages agree."""
    sa = tmp_path / "sa"
    sa.mkdir()
    (sa / "token").write_text("tok123\n")
    (sa / "namespace").write_text("metrics\n")
    (sa / "ca.crt").write_text(open(tls_files[0]).read())
    script = ((200, _pods(("10.2.0.1", True), ("10.2.0.2", False),
                          ("", True), ("10.2.0.3", True))),
              (403, {"kind": "Status"}),
              (200, _pods(("10.2.0.3", True))))
    out = []
    for mod in (discovery, jdisc):
        monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
        with pytest.raises(RuntimeError, match="not running"):
            mod.KubernetesDiscoverer()
        fake = _Fake(script, tls_files=tls_files)
        try:
            monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "127.0.0.1")
            monkeypatch.setenv("KUBERNETES_SERVICE_PORT", str(fake.port))
            monkeypatch.setattr(mod.KubernetesDiscoverer, "SA", str(sa))
            disc = mod.KubernetesDiscoverer(label_selector="app=g",
                                            pod_port="8129")
            ring = mod.DestinationRing(disc, "k8s")
            trace = [(ring.refresh(), ring.ring.members) for _ in script]
            trace.append(ring.stats())
        finally:
            fake.close()
        assert fake.requests[0] == (
            "/api/v1/namespaces/metrics/pods?labelSelector=app=g",
            "Bearer tok123")
        out.append(trace)
    assert out[0] == out[1]
    assert out[0][0] == (True, ("10.2.0.1:8129", "10.2.0.3:8129"))
    assert out[0][1] == (False, ("10.2.0.1:8129", "10.2.0.3:8129"))
    assert out[0][2] == (True, ("10.2.0.3:8129",))
    assert out[0][3]["refresh_errors"] == {"error": 1}


def test_static_discoverer_matches_jax():
    for mod in (discovery, jdisc):
        d = mod.StaticDiscoverer(["b:1", "a:1"])
        got = d.get_destinations_for_service("x")
        got.append("mutated")
        assert d.get_destinations_for_service("x") == ["b:1", "a:1"]
