"""Listener address resolution: udp:// tcp:// unix:// URLs.

Reference protocol/addr.go:18 ``ResolveAddr``: listener addresses are
URL-style with the scheme choosing the socket family.
"""

from __future__ import annotations

from urllib.parse import urlparse


def parse_addr(addr: str) -> tuple[str, str, int, str]:
    """-> (scheme, host, port, path).  path is set for unix sockets.
    ``einhorn@N`` adopts inherited file descriptor N from an einhorn
    socket manager (reference README 'Einhorn Usage': goji/bind's
    einhorn handling for http_address)."""
    if addr.startswith("einhorn@"):
        return "einhorn", "", int(addr.split("@", 1)[1]), ""
    u = urlparse(addr)
    if u.scheme in ("udp", "tcp"):
        if u.port is None and ":" not in (u.netloc or ""):
            raise ValueError(f"missing port in {addr!r}")
        return u.scheme, u.hostname or "127.0.0.1", u.port or 0, ""
    if u.scheme in ("unix", "unixgram"):
        return "unix", "", 0, u.path or u.netloc
    raise ValueError(f"unsupported address scheme in {addr!r}")
