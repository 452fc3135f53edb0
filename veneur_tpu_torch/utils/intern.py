"""Vectorized open-addressing hash index: u64 identity hash -> i32 row.

The per-sample dict lookup in the slow ingest path is the Python-side
analogue of the reference's per-worker ``map[MetricKey]`` (worker.go:60)
— fine at thousands/sec, fatal at millions.  This table answers a whole
column of key hashes in a handful of numpy passes: linear probing where
every probe round resolves all still-unresolved keys at once.  Misses
fall back to the caller's slow path exactly once per novel key.

Values are i32: row ids >= 0, or DROPPED (-2) marking keys whose class
table is full so later samples are counted as dropped without re-taking
the slow path.  MISSING (-1) means "not present".
"""

from __future__ import annotations

import numpy as np

MISSING = np.int32(-1)
DROPPED = np.int32(-2)

_EMPTY = np.uint64(0)
# key 0 is remapped to this arbitrary odd constant so the empty-slot
# sentinel stays unambiguous (one-in-2^64 keys pay one extra probe)
_ZERO_ALIAS = np.uint64(0x9E3779B97F4A7C15)


class HashIndex:
    def __init__(self, capacity: int = 1 << 16):
        cap = 1
        while cap < capacity:
            cap *= 2
        self.cap = cap
        self.mask = np.uint64(cap - 1)
        self.keys = np.zeros(cap, np.uint64)
        self.vals = np.full(cap, MISSING, np.int32)
        self.count = 0

    @staticmethod
    def _canon(keys: np.ndarray) -> np.ndarray:
        return np.where(keys == _EMPTY, _ZERO_ALIAS, keys)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """i32[N] of values; MISSING where the key is absent."""
        keys = self._canon(np.ascontiguousarray(keys, np.uint64))
        n = len(keys)
        out = np.full(n, MISSING, np.int32)
        if n == 0 or self.count == 0:
            return out
        idx = keys & self.mask
        active = np.arange(n)
        akeys = keys
        # load factor is kept < 0.6, so probe chains are short; the cap
        # bound only guards against adversarial clustering
        for _ in range(64):
            slot_k = self.keys[idx]
            hit = slot_k == akeys
            if hit.any():
                out[active[hit]] = self.vals[idx[hit]]
            unresolved = (~hit) & (slot_k != _EMPTY)
            if not unresolved.any():
                return out
            active = active[unresolved]
            akeys = akeys[unresolved]
            idx = (idx[unresolved] + np.uint64(1)) & self.mask
        # pathological chain: finish scalar
        for j, k in zip(active, akeys):
            out[j] = self._lookup_one(k)
        return out

    def _lookup_one(self, key: np.uint64) -> np.int32:
        i = key & self.mask
        while True:
            k = self.keys[i]
            if k == key:
                return self.vals[i]
            if k == _EMPTY:
                return MISSING
            i = (i + np.uint64(1)) & self.mask

    def insert(self, key: int, val: int) -> None:
        """Scalar insert/overwrite (miss path only — rare)."""
        if self.count >= (self.cap * 3) // 5:
            self._grow()
        k = self._canon(np.asarray([key], np.uint64))[0]
        i = k & self.mask
        while True:
            cur = self.keys[i]
            if cur == _EMPTY:
                self.keys[i] = k
                self.vals[i] = val
                self.count += 1
                return
            if cur == k:
                self.vals[i] = val
                return
            i = (i + np.uint64(1)) & self.mask

    def _grow(self) -> None:
        old_k, old_v = self.keys, self.vals
        self.cap *= 2
        self.mask = np.uint64(self.cap - 1)
        self.keys = np.zeros(self.cap, np.uint64)
        self.vals = np.full(self.cap, MISSING, np.int32)
        self.count = 0
        live = old_k != _EMPTY
        for k, v in zip(old_k[live], old_v[live]):
            # keys stored are already canonicalized
            i = k & self.mask
            while self.keys[i] != _EMPTY:
                i = (i + np.uint64(1)) & self.mask
            self.keys[i] = k
            self.vals[i] = v
            self.count += 1

    def clear(self) -> None:
        self.keys[:] = _EMPTY
        self.vals[:] = MISSING
        self.count = 0
