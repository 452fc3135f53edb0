"""Einhorn-style listener fd handoff (SOCK_CLOAKED).

The reference rides rolling restarts by letting einhorn own the
listening sockets: the master binds once and every worker generation
adopts the same fds, so the kernel receive queue — and every datagram
parked in it — survives a worker death (reference veneur docs on
einhorn, proxy_srv bind-or-adopt).  This module is that contract for
this port (a copy of ``veneur_tpu/ops/fdpass.py``):

- ``VENEUR_TPU_SOCK_CLOAKED`` carries ``name=fd`` pairs into a
  replacement process (the fds themselves ride ``pass_fds`` /
  fork-inherit).  Names identify the listener slot so a replacement
  with a different config shape fails loudly instead of reading the
  wrong socket: ``statsd.udp.{addr_index}.{reader_index}`` for the
  DogStatsD UDP reader shards and ``http`` for the debug/import
  listener.
- ``send_sockets``/``recv_sockets`` move the same mapping between two
  live processes over an AF_UNIX socket via SCM_RIGHTS, for masters
  that hand fds to an already-running replacement instead of
  exec-inheriting them.

The gRPC listener is NOT cloaked: grpcio cannot adopt an existing
listening fd, so rolling restarts cover that port with SO_REUSEPORT
rebinding (grpc's default on Linux) — the UDP datagram path, where a
dropped packet is silent loss, is the one that needs true adoption.
"""

from __future__ import annotations

import json
import os
import socket

ENV_VAR = "VENEUR_TPU_SOCK_CLOAKED"


def encode_cloak(fds: dict[str, int]) -> str:
    """``{"statsd.udp.0.0": 7, "http": 9}`` -> ``statsd.udp.0.0=7,http=9``.

    Names must not contain ``=`` or ``,`` (the slot-name grammar above
    never does); fds must be non-negative ints.
    """
    parts = []
    for name, fd in fds.items():
        if "=" in name or "," in name or not name:
            raise ValueError(f"bad cloak slot name {name!r}")
        if int(fd) < 0:
            raise ValueError(f"bad cloak fd {fd!r} for {name!r}")
        parts.append(f"{name}={int(fd)}")
    return ",".join(parts)


def parse_cloak(value: str | None = None) -> dict[str, int]:
    """Decode the cloak mapping; reads ``VENEUR_TPU_SOCK_CLOAKED``
    when ``value`` is None.  Malformed entries are skipped (fail-open:
    a bad cloak degrades to a cold start, never a crash — the adopting
    server falls back to binding fresh sockets for missing slots)."""
    if value is None:
        value = os.environ.get(ENV_VAR, "")
    out: dict[str, int] = {}
    for part in (value or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, fd = part.rpartition("=")
        if not sep or not name:
            continue
        try:
            fdno = int(fd)
        except ValueError:
            continue
        if fdno >= 0:
            out[name] = fdno
    return out


def adopt_socket(fd: int) -> socket.socket:
    """Wrap an inherited listener fd as a socket object.

    ``socket.socket(fileno=...)`` auto-detects family/type/proto from
    the fd on Linux, so one adopter covers UDP readers and TCP
    listeners alike.  The returned socket OWNS the fd (closing it
    closes the kernel socket), matching a freshly-bound one.
    """
    sock = socket.socket(fileno=fd)
    # inherited fds may carry O_NONBLOCK/CLOEXEC state from the old
    # process; normalize to the blocking-with-timeout regime the
    # reader loops expect (callers set their own timeouts)
    sock.setblocking(True)
    return sock


def socket_cloak(sockets: dict[str, socket.socket]) -> str:
    """Convenience: encode a name->socket mapping by fileno, for a
    master building a replacement's environment (pair with
    ``subprocess(..., pass_fds=[s.fileno() for s in ...])``)."""
    return encode_cloak({n: s.fileno() for n, s in sockets.items()})


# ----------------------------------------------------------------------
# SCM_RIGHTS transfer between live processes

_MAX_FDS = 64


def send_sockets(conn: socket.socket, fds: dict[str, int]) -> None:
    """Ship named fds to a peer over a connected AF_UNIX socket.
    Order-preserving: the name list travels as a JSON payload next to
    the SCM_RIGHTS ancillary array, so the receiver re-pairs them
    positionally."""
    names = list(fds.keys())
    payload = json.dumps(names).encode()
    socket.send_fds(conn, [payload], [fds[n] for n in names])


def recv_sockets(conn: socket.socket) -> dict[str, int]:
    """Receive the mapping shipped by ``send_sockets``.  The returned
    fds are live in THIS process (the kernel duplicated them); the
    caller owns closing or adopting them."""
    payload, fds, _flags, _addr = socket.recv_fds(conn, 1 << 16,
                                                  _MAX_FDS)
    names = json.loads(payload.decode())
    if len(names) != len(fds):
        # partial ancillary delivery — close what arrived rather than
        # leak kernel sockets into a confused mapping
        for fd in fds:
            os.close(fd)
        raise OSError(f"fd handoff truncated: {len(names)} names, "
                      f"{len(fds)} fds")
    return dict(zip(names, fds))
