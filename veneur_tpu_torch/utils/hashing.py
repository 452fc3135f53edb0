"""Host-side hashing: vectorized 64-bit member hashing for HLL sets and
fnv1a-32 metric-key digests.

The reference hashes set members with metrohash seeded 1337
(vendor/github.com/axiomhq/hyperloglog/utils.go ``hashFunc``) and metric
keys with fnv1a-32 over name+type+sorted-tags (samplers/parser.go:325-420).
We keep fnv1a-32 for the key digest (it determines shard routing and is
part of the observable contract) but use our own vectorized 64-bit hash
for HLL members — only its statistical quality matters, not its identity.

The member hash is FNV-1a-64 over the bytes followed by a murmur3 fmix64
finalizer for avalanche; it is computed column-wise over a padded byte
matrix so a million members hash in a handful of numpy passes.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

FNV1A_32_OFFSET = np.uint32(2166136261)
FNV1A_32_PRIME = np.uint32(16777619)
FNV1A_64_OFFSET = np.uint64(14695981039346656037)
FNV1A_64_PRIME = np.uint64(1099511628211)

# HLL precision: 2^14 registers (reference worker.go:247).  This is THE
# authoritative constant — veneur_tpu_torch.ops.hll imports it so the host
# hash split and the device register-plane width can never diverge.
HLL_P = 14


def fnv1a_32(data: bytes) -> int:
    """Scalar fnv1a-32, used for MetricKey digests (shard routing parity
    with reference samplers/parser.go:325)."""
    h = int(FNV1A_32_OFFSET)
    prime = int(FNV1A_32_PRIME)
    for b in data:
        h = ((h ^ b) * prime) & 0xFFFFFFFF
    return h


def pack_bytes_matrix(members: Sequence[bytes],
                      max_len: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """Pack variable-length byte strings into (matrix u8[N, L], lens
    i64[N]) for column-wise hashing, without a per-member Python loop:
    one join + a vectorized scatter by (row, column) index.  Members
    longer than max_len are pre-compressed (rare path only) by hashing
    their tail into 8 suffix bytes."""
    n = len(members)
    lens = np.fromiter((len(m) for m in members), dtype=np.int64, count=n)
    longest = int(lens.max(initial=0))
    if longest > max_len:
        members = [
            m if len(m) <= max_len
            else m[:max_len - 8] + fnv1a_64_scalar(m[max_len - 8:])
            for m in members
        ]
        lens = np.fromiter((len(m) for m in members), dtype=np.int64,
                           count=n)
        longest = int(lens.max(initial=0))
    mat = np.zeros((n, max(longest, 1)), dtype=np.uint8)
    total = int(lens.sum())
    if total:
        buf = np.frombuffer(b"".join(members), dtype=np.uint8)
        rows = np.repeat(np.arange(n, dtype=np.int64), lens)
        offsets = np.concatenate(([0], np.cumsum(lens)[:-1]))
        cols = np.arange(total, dtype=np.int64) - np.repeat(offsets, lens)
        mat[rows, cols] = buf
    return mat, lens


def fnv1a_64_int(data: bytes) -> int:
    """Scalar fnv1a-64 (the single authoritative byte loop — ring
    placement, key identity and member hashing all build on it)."""
    h = int(FNV1A_64_OFFSET)
    prime = int(FNV1A_64_PRIME)
    for b in data:
        h = ((h ^ b) * prime) & 0xFFFFFFFFFFFFFFFF
    return h


def fnv1a_64_scalar(data: bytes) -> bytes:
    return fnv1a_64_int(data).to_bytes(8, "little")


def _fmix64(h: int) -> int:
    """murmur3 fmix64 finalizer (scalar; mirrors the vectorized one in
    hash64 and the native parser's fmix64 bit-for-bit)."""
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 33
    return h


def _fold64(payload: bytes) -> int:
    """FNV-style fold of 8 little-endian bytes per multiply (8x fewer
    dependent multiplies than byte-serial FNV), zero-padded tail,
    length mixed in so padding can't collide.  No finalizer — callers
    combine folds and fmix64 once at the end."""
    h = int(FNV1A_64_OFFSET)
    prime = int(FNV1A_64_PRIME)
    mask = 0xFFFFFFFFFFFFFFFF
    for i in range(0, len(payload), 8):
        chunk = int.from_bytes(payload[i:i + 8], "little")
        h = ((h ^ chunk) * prime) & mask
    return h ^ len(payload)


# odd constants decorrelating the type/scope contributions from tag
# sums (golden-ratio and murmur-style multipliers; must match
# dsd_parse.cpp)
_KEY_TYPE_MULT = 0x9E3779B97F4A7C15
_KEY_SCOPE_MULT = 0xC2B2AE3D27D4EB4F
_MASK64 = 0xFFFFFFFFFFFFFFFF


def key_hash64(name: str, type_code: int, tags: Sequence[str],
               scope_code: int) -> int:
    """64-bit series-identity hash over (name, type, tag multiset,
    scope) — MUST stay bit-identical to the native parser's key hash
    (vtpu_parse_batch in the reference package's native parser) so slow-path
    row allocations and fast-path lookups agree.

    Scheme: fmix64( fold64(name) ^ fmix64(type*C1 ^ scope*C2 + SUM of
    fmix64(fold64(tag))) ).  Summing per-tag avalanche hashes makes
    tag ORDER irrelevant without sorting — the commutative-multiset
    equivalent of the reference's sorted-tag MetricKey
    (samplers/parser.go:393) — and the native parser accumulates the
    sum inline during its single tag scan with no assembly buffer
    (the sort + payload-assembly + final-hash stage was half its
    per-line cost)."""
    tagsum = 0
    for t in tags:
        tagsum = (tagsum + _fmix64(_fold64(t.encode()))) & _MASK64
    tail = ((type_code * _KEY_TYPE_MULT) ^
            (scope_code * _KEY_SCOPE_MULT)) + tagsum
    return _fmix64(_fold64(name.encode()) ^ _fmix64(tail & _MASK64))


def hash64(members: Sequence[bytes]) -> np.ndarray:
    """Vectorized 64-bit hash of a batch of byte strings -> u64[N]."""
    if len(members) == 0:
        return np.zeros(0, dtype=np.uint64)
    mat, lens = pack_bytes_matrix(members)
    with np.errstate(over="ignore"):
        h = np.full(mat.shape[0], FNV1A_64_OFFSET, dtype=np.uint64)
        for j in range(mat.shape[1]):
            col = mat[:, j].astype(np.uint64)
            active = j < lens
            mixed = (h ^ col) * FNV1A_64_PRIME
            h = np.where(active, mixed, h)
        # murmur3 fmix64 finalizer for avalanche quality
        h ^= h >> np.uint64(33)
        h *= np.uint64(0xFF51AFD7ED558CCD)
        h ^= h >> np.uint64(33)
        h *= np.uint64(0xC4CEB9FE1A85EC53)
        h ^= h >> np.uint64(33)
    return h


def _floor_log2_u64(x: np.ndarray) -> np.ndarray:
    """Exact floor(log2(x)) for x>0 via shift cascade (float log2 is
    inexact near 2^53)."""
    x = x.copy()
    r = np.zeros(x.shape, dtype=np.uint64)
    for s in (32, 16, 8, 4, 2, 1):
        s64 = np.uint64(s)
        y = x >> s64
        m = y != 0
        x = np.where(m, y, x)
        r = np.where(m, r + s64, r)
    return r


def hll_position(hashes: np.ndarray,
                 p: int = HLL_P) -> tuple[np.ndarray, np.ndarray]:
    """Split u64 hashes into (register index i32[N], rank i32[N]) exactly
    as the reference's getPosVal (hyperloglog/utils.go): index = top p
    bits, rank = leading-zero count of the remaining bits (with a stop
    bit at position p-1) plus one."""
    p64 = np.uint64(p)
    idx = (hashes >> (np.uint64(64) - p64)).astype(np.int32)
    with np.errstate(over="ignore"):
        w = (hashes << p64) | (np.uint64(1) << (p64 - np.uint64(1)))
    clz = np.uint64(63) - _floor_log2_u64(w)
    rank = (clz + np.uint64(1)).astype(np.int32)
    return idx, rank


def hash_members(members: Sequence[bytes],
                 p: int = HLL_P) -> tuple[np.ndarray, np.ndarray]:
    """bytes batch -> (register index, rank) ready for device scatter."""
    return hll_position(hash64(members), p)
