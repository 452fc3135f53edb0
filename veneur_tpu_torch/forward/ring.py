"""Consistent-hash ring for proxy and sharded-forward routing.

Port of ``veneur_tpu/forward/ring.py``.  The reference proxy assigns
every forwarded metric to one global veneur by consistent-hashing its
MetricKey over the destination ring (proxy.go:587,
proxysrv/server.go:273, via stathat.com/c/consistent).  The property
that matters is stability: adding/removing one destination remaps only
~1/N of keys, and the same key always lands on the same destination
while membership is unchanged.  The hash is the repo's
fnv1a-64+fmix64 (both ends of the wire are ours), the same as the JAX
package's, so the two packages place every key on the same member.

``get`` is the scalar oracle; ``assign``/``hash_keys`` are the
vectorized batch equivalents the columnar routes run — bit-identical
destination per key by construction (same hash, and
``np.searchsorted(side="right")`` on the sorted vnode array is exactly
``bisect.bisect`` with the same wrap-to-0).
"""

from __future__ import annotations

import bisect
import ctypes

import numpy as np

from veneur_tpu_torch import native
from veneur_tpu_torch.utils.hashing import _fmix64, fnv1a_64_int

REPLICAS = 120  # vnodes per member: keeps load spread within ~10%


def _h(data: str) -> int:
    return _fmix64(fnv1a_64_int(data.encode()))


def hash_keys(keys: list[bytes]) -> np.ndarray:
    """Vectorized ``_h`` over already-encoded keys -> uint64[n], through
    the native ``vtpu_hash_members`` (the same fnv1a64+fmix64 stream,
    at any key length)."""
    n = len(keys)
    if n == 0:
        return np.empty(0, dtype=np.uint64)
    lib = native.load()
    buf = np.frombuffer(b"".join(keys) or b"\0", dtype=np.uint8)
    lens = np.fromiter((len(k) for k in keys), dtype=np.int64, count=n)
    offs = np.zeros(n, dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    out = np.empty(n, dtype=np.uint64)
    lib.vtpu_hash_members(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return out


class ConsistentRing:
    def __init__(self, members: list[str] | None = None,
                 replicas: int = REPLICAS):
        self.replicas = replicas
        self._points: list[int] = []
        self._owners: list[str] = []
        self._members: tuple[str, ...] = ()
        self._points_arr = np.empty(0, dtype=np.uint64)
        self._owner_idx = np.empty(0, dtype=np.int32)
        if members:
            self.set_members(members)

    def set_members(self, members: list[str]) -> None:
        uniq = sorted(set(members))
        pairs = []
        for mi, m in enumerate(uniq):
            for i in range(self.replicas):
                pairs.append((_h(f"{i}:{m}"), mi))
        pairs.sort()
        self._points = [p for p, _ in pairs]
        self._owners = [uniq[mi] for _, mi in pairs]
        self._members = tuple(uniq)
        self._points_arr = np.asarray(self._points, dtype=np.uint64)
        self._owner_idx = np.fromiter(
            (mi for _, mi in pairs), dtype=np.int32, count=len(pairs))

    @property
    def members(self) -> tuple[str, ...]:
        return self._members

    def __len__(self) -> int:
        return len(self._members)

    def get(self, key: str) -> str:
        """Destination owning ``key``; raises LookupError when empty."""
        if not self._points:
            raise LookupError("empty ring")
        i = bisect.bisect(self._points, _h(key))
        if i == len(self._points):
            i = 0
        return self._owners[i]

    def assign(self, hashes: np.ndarray) -> np.ndarray:
        """Member index (into ``members``) per key hash -> int32[n].

        ``hashes`` is the uint64 output of ``hash_keys`` (or the native
        proxy key hasher).  Raises LookupError when empty, as ``get``
        does.
        """
        if not self._points:
            raise LookupError("empty ring")
        idx = np.searchsorted(self._points_arr, hashes, side="right")
        idx[idx == len(self._points_arr)] = 0
        return self._owner_idx[idx]
