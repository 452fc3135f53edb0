"""Service discovery for the proxy's destination ring.

Port of ``veneur_tpu/forward/discovery.py``.

The reference's Discoverer interface (discoverer.go:3) with its two
implementations — Consul health polling (consul.go:14) and Kubernetes
pod listing (kubernetes.go:14) — plus the static list used when a
fixed ``forward_address`` is configured.  Refresh semantics follow
proxy.go:491-521 RefreshDestinations: poll every interval, swap the
ring on success, and KEEP THE LAST GOOD destination set when a poll
errors or returns empty.
"""

from __future__ import annotations

import json
import logging
import ssl
import threading
import urllib.request
from typing import Protocol

from veneur_tpu_torch.forward.ring import ConsistentRing

log = logging.getLogger("veneur_tpu_torch.discovery")


class Discoverer(Protocol):
    def get_destinations_for_service(self, service: str) -> list[str]:
        """Current destination addresses; raises on lookup failure."""


class StaticDiscoverer:
    """Fixed destination list (the no-discovery deployment)."""

    def __init__(self, destinations: list[str]):
        self._destinations = list(destinations)

    def get_destinations_for_service(self, service: str) -> list[str]:
        return list(self._destinations)


class ConsulDiscoverer:
    """Poll Consul's health API for passing instances
    (reference consul.go:31 GetDestinationsForService:
    GET /v1/health/service/<name>?passing)."""

    def __init__(self, base_url: str = "http://127.0.0.1:8500",
                 opener=None):
        self.base_url = base_url.rstrip("/")
        # opener injection = the reference's custom-RoundTripper test
        # seam (consul_discovery_test.go:14)
        self._open = opener or urllib.request.urlopen

    def get_destinations_for_service(self, service: str) -> list[str]:
        url = (f"{self.base_url}/v1/health/service/{service}"
               f"?passing=true")
        with self._open(url, timeout=10.0) as resp:
            entries = json.loads(resp.read())
        out = []
        for e in entries:
            svc = e.get("Service", {})
            node = e.get("Node", {})
            host = svc.get("Address") or node.get("Address")
            port = svc.get("Port")
            if host and port:
                out.append(f"{host}:{port}")
        return out


class KubernetesDiscoverer:
    """List ready pod IPs for a labeled service via the in-cluster API
    (reference kubernetes.go:14: in-cluster config + pod watch).  Uses
    the mounted service-account token; raises out-of-cluster."""

    SA = "/var/run/secrets/kubernetes.io/serviceaccount"

    def __init__(self, namespace: str | None = None,
                 label_selector: str = "app=veneur-global",
                 pod_port: str = "8128"):
        import os
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise RuntimeError("not running in a Kubernetes cluster")
        self.base = f"https://{host}:{port}"
        with open(f"{self.SA}/token") as f:
            self._token = f.read().strip()
        if namespace is None:
            with open(f"{self.SA}/namespace") as f:
                namespace = f.read().strip()
        self.namespace = namespace
        self.label_selector = label_selector
        self.pod_port = pod_port
        self._ctx = ssl.create_default_context(
            cafile=f"{self.SA}/ca.crt")

    def get_destinations_for_service(self, service: str) -> list[str]:
        url = (f"{self.base}/api/v1/namespaces/{self.namespace}/pods"
               f"?labelSelector={self.label_selector}")
        req = urllib.request.Request(
            url, headers={"Authorization": f"Bearer {self._token}"})
        with urllib.request.urlopen(req, timeout=10.0,
                                    context=self._ctx) as resp:
            pods = json.loads(resp.read())
        out = []
        for pod in pods.get("items", []):
            status = pod.get("status", {})
            ip = status.get("podIP")
            ready = any(
                c.get("type") == "Ready" and c.get("status") == "True"
                for c in status.get("conditions", []))
            if ip and ready:
                out.append(f"{ip}:{self.pod_port}")
        return out


class DestinationRing:
    """Discovery-refreshed consistent ring with keep-last-good
    semantics (proxy.go:491-521).

    Failures degrade gracefully: a poll that errors or returns empty
    KEEPS the last-known-good membership and counts a reason-tagged
    refresh error (``refresh_errors``: ``error`` = the discoverer
    raised, ``empty`` = it answered with no destinations) — surfaced
    as ``veneur.discovery.refresh_errors_total`` so a flapping Consul
    is an alert, not an interval loss.

    Membership swaps leave a pending-change record (``take_change``)
    carrying the previous ring, so a live consumer (the sharded
    forwarder) can retire workers for departed members and credit
    moved-arc traffic against the pre-swap ownership.
    """

    def __init__(self, discoverer: Discoverer, service: str):
        self.discoverer = discoverer
        self.service = service
        self.ring = ConsistentRing()
        self._lock = threading.Lock()
        self.epoch = 0  # bumped on every membership swap
        self.refreshes = 0
        self.refresh_failures = 0
        self.refresh_errors: dict[str, int] = {}
        self.last_error: str | None = None
        # (epoch, added, removed, prev_ring) accumulated across swaps
        # since the last take_change — the oldest prev_ring survives a
        # burst of swaps so moved-arc diffs span the whole burst
        self._change: tuple | None = None

    def _count_error(self, reason: str, detail: str) -> None:
        self.refresh_failures += 1
        self.refresh_errors[reason] = (
            self.refresh_errors.get(reason, 0) + 1)
        self.last_error = f"{reason}: {detail}"

    def refresh(self) -> bool:
        """Poll once; returns True if the ring was updated."""
        try:
            dests = self.discoverer.get_destinations_for_service(
                self.service)
        except Exception as e:
            self._count_error("error", str(e))
            log.warning("discovery refresh failed (keeping %d "
                        "destinations): %s", len(self.ring), e)
            return False
        if not dests:
            # empty responses keep the last good set (proxy.go:505-515)
            self._count_error("empty", "no destinations")
            log.warning("discovery returned no destinations; keeping "
                        "%d", len(self.ring))
            return False
        self.apply(dests)
        self.refreshes += 1
        return True

    def apply(self, dests) -> bool:
        """Swap in an explicit membership (discovery result, a drain
        handoff, or a chaos injection); returns True when membership
        actually changed."""
        with self._lock:
            new_members = tuple(sorted(set(dests)))
            if new_members == self.ring.members:
                return False
            prev = self.ring
            self.ring = ConsistentRing(new_members)
            self.epoch += 1
            added = sorted(set(new_members) - set(prev.members))
            removed = sorted(set(prev.members) - set(new_members))
            if self._change is None:
                self._change = (self.epoch, added, removed, prev)
            else:
                _, a0, r0, prev0 = self._change
                # merge: net adds/removes since the oldest un-taken
                # swap, diffed against that swap's pre-ring
                a = sorted((set(a0) | set(added)) - set(removed))
                r = sorted((set(r0) | set(removed)) - set(added))
                self._change = (self.epoch, a, r, prev0)
            return True

    def take_change(self) -> tuple | None:
        """Pop the pending membership change as (epoch, added,
        removed, prev_ring); None when membership is unchanged since
        the last take."""
        with self._lock:
            change, self._change = self._change, None
            return change

    def stats(self) -> dict:
        with self._lock:
            members = list(self.ring.members)
        return {
            "service": self.service,
            "members": members,
            "epoch": self.epoch,
            "refreshes": self.refreshes,
            "refresh_failures": self.refresh_failures,
            "refresh_errors": dict(self.refresh_errors),
            "last_error": self.last_error,
        }

    def get(self, key: str) -> str:
        with self._lock:
            return self.ring.get(key)

    def snapshot(self) -> ConsistentRing:
        """The current ring object, read atomically.

        ``ConsistentRing`` is immutable after a refresh swap (refresh
        builds a fresh ring rather than mutating in place), so the
        columnar router can hash/assign a whole batch against one
        membership epoch without holding the lock.
        """
        with self._lock:
            return self.ring
