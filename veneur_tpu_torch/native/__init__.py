"""The port's native (C++) host library: parse, ingest, the recvmmsg
drain and the io_uring ring (``uring.py``), rank, planes, the
reference-schema /import value decode, the gRPC MetricList decode and
the HLL sketch classify and fold of its set items.

``dsd_parse.cpp`` beside this file is the port's own copy of the entries
it runs from the reference package's native parser.  ``load()`` compiles
it with the system g++ into the package's ``_build/`` directory on first
use (the library's name carries a hash of the source and the flags, so
an edited source rebuilds), loads it with ctypes and declares every
entry's argument and result types.  A failed build raises with the
compiler's output: the table and the server have no pure-Python ingest
to fall back to.

The numpy functions at the end (``rank_plain``, ``dense_plane_plain``,
``hll_plane_plain``, ``tier_split_plain``) are the plain versions the
tests hold the C entries against; nothing on the ingest path calls them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

from veneur_tpu_torch.observe.devicecost import REGISTRY

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "dsd_parse.cpp"
BUILD_DIR = _DIR.parent / "_build"
# -mtune (not -march): tuned for the build host but ISA-portable
FLAGS = ("-O3", "-mtune=native", "-shared", "-fPIC", "-std=c++17")

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()

u8p = ctypes.POINTER(ctypes.c_uint8)
i32p = ctypes.POINTER(ctypes.c_int32)
i64p = ctypes.POINTER(ctypes.c_int64)
u64p = ctypes.POINTER(ctypes.c_uint64)
f32p = ctypes.POINTER(ctypes.c_float)
f64p = ctypes.POINTER(ctypes.c_double)


def library_path() -> Path:
    tag = hashlib.sha1(SOURCE.read_bytes() +
                       " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libdsd_parse-{tag}.so"


def build() -> Path:
    """Compile the library (once per source revision) and return its
    path.  Raises RuntimeError with g++'s output if the build fails."""
    out = library_path()
    if out.exists():
        REGISTRY.add_cache_hit()
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.monotonic_ns()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native library build failed: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"native library build failed "
                           f"({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: racing processes both succeed
    REGISTRY.add_compile(time.monotonic_ns() - t0)
    return out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare argument and result types for every entry the port
    calls (the reference's signatures)."""
    i64, i32, vp = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p
    lib.vtpu_parse_batch.restype = i64
    lib.vtpu_parse_batch.argtypes = [
        u8p, i64, u64p, u8p, f64p, u64p, f32p, u8p, i64p, i32p, i64]
    lib.vtpu_hash_members.restype = None
    lib.vtpu_hash_members.argtypes = [u8p, i64p, i64p, i64, u64p]
    lib.vtpu_recv_drain.restype = i64
    lib.vtpu_recv_drain.argtypes = [i32, u8p, i64, i32, i32, i32p, i32p]
    lib.vtpu_index_new.restype = vp
    lib.vtpu_index_new.argtypes = [i64]
    lib.vtpu_index_free.restype = None
    lib.vtpu_index_free.argtypes = [vp]
    lib.vtpu_index_clear.restype = None
    lib.vtpu_index_clear.argtypes = [vp]
    lib.vtpu_index_insert.restype = None
    lib.vtpu_index_insert.argtypes = [vp, ctypes.c_uint64, i32]
    lib.vtpu_index_count.restype = i64
    lib.vtpu_index_count.argtypes = [vp]
    lib.vtpu_index_readers.restype = i64
    lib.vtpu_index_readers.argtypes = [vp]
    lib.vtpu_index_lookup.restype = None
    lib.vtpu_index_lookup.argtypes = [vp, u64p, i64, i32p]
    lib.vtpu_ingest.restype = None
    lib.vtpu_ingest.argtypes = [
        vp, u64p, u8p, f64p, u64p, f32p, i64, i64p, i64, i64,
        f64p, u8p, f32p, u8p, u8p,
        i32p, f32p, f32p, u8p,
        i32p, i32p, u8p,
        i64p, i64p]
    lib.vtpu_parse_ingest.restype = None
    lib.vtpu_parse_ingest.argtypes = [
        u8p, i64, vp, i64,
        f64p, u8p, f32p, u8p, u8p,
        i32p, f32p, f32p, u8p,
        i32p, i32p, u8p,
        u64p, u8p, f64p, u64p, f32p, i64p, i32p,
        i64p, i32p, u8p,
        i64p]
    # io_uring multishot ring ingest (stubs where the headers lack
    # io_uring: probe returns -ENOSYS, new fails; same symbols)
    lib.vtpu_uring_probe.restype = i64
    lib.vtpu_uring_probe.argtypes = []
    lib.vtpu_uring_new.restype = vp
    lib.vtpu_uring_new.argtypes = [i32, i32, i32, u8p, i64p]
    lib.vtpu_uring_free.restype = None
    lib.vtpu_uring_free.argtypes = [vp]
    lib.vtpu_uring_stats.restype = None
    lib.vtpu_uring_stats.argtypes = [vp, i64p]
    lib.vtpu_uring_drain.restype = i64
    lib.vtpu_uring_drain.argtypes = [
        vp, u8p, i64, i32, i32, i32, i32, i32p, i32p, i32p]
    lib.vtpu_uring_parse_ingest.restype = i64
    lib.vtpu_uring_parse_ingest.argtypes = [
        vp, i32, i32, i32, i32, i32, vp, i64,
        f64p, u8p, f32p, u8p, u8p,
        i32p, f32p, f32p, u8p,
        i32p, i32p, u8p,
        u64p, u8p, f64p, u64p, f32p, i64p, i32p,
        i64p, i32p, u8p,
        i64p, i32p]
    lib.vtpu_uring_pending_copy.restype = i64
    lib.vtpu_uring_pending_copy.argtypes = [vp, u8p, i64]
    lib.vtpu_uring_release.restype = i64
    lib.vtpu_uring_release.argtypes = [vp]
    lib.vtpu_rank.restype = None
    lib.vtpu_rank.argtypes = [i32p, i64, i32, i32p, i32p]
    lib.vtpu_dense_plane.restype = i64
    lib.vtpu_dense_plane.argtypes = [
        i32p, f32p, f32p, i64, i32, i32,
        f32p, f32p, i32p, i32p, f32p, f32p, f64p]
    lib.vtpu_hll_plane.restype = None
    lib.vtpu_hll_plane.argtypes = [i32p, i32p, i64, i32, i32, u8p]
    lib.vtpu_sb_gather_i32.restype = None
    lib.vtpu_sb_gather_i32.argtypes = [
        ctypes.POINTER(i32p), i64p, i32, i32p, i64, i32]
    lib.vtpu_hll_plane_stats.restype = None
    lib.vtpu_hll_plane_stats.argtypes = [
        i32p, i32p, i64, i32, i32, u8p, f64p, i32p]
    lib.vtpu_tier_split.restype = i64
    lib.vtpu_tier_split.argtypes = [i32p, i64, u8p, i32p, i32p, i32p]
    lib.vtpu_gob_decode.restype = i64
    lib.vtpu_gob_decode.argtypes = [
        u8p, i64, i64,
        i64p, i64p, u8p,
        i64,
        f64p, f64p,
        i64p, i32p,
        f32p, f32p,
        u8p,
        i64p]
    lib.vtpu_metriclist_decode.restype = i64
    lib.vtpu_metriclist_decode.argtypes = [
        u8p, i64, i64, i64, i64,
        i64p, i32p,
        u8p, i32p, i32p, f64p,
        f64p,
        i64p, i32p,
        f32p, f32p,
        i64p, i32p,
        i64p, i32p,
        i64p, i32p,
        i64p]
    lib.vtpu_metriclist_keyhash.restype = None
    lib.vtpu_metriclist_keyhash.argtypes = [
        u8p, i64,
        i64p, i32p,
        u8p, i32p, i32p,
        i64p, i32p,
        i64p, i32p,
        u64p]
    lib.vtpu_hll_classify.restype = i64
    lib.vtpu_hll_classify.argtypes = [
        u8p, i64, i64, u8p, i64p, i32p, u8p, i64p, i32p, i32p, i64]
    lib.vtpu_hll_fold.restype = i64
    lib.vtpu_hll_fold.argtypes = [
        u8p, i64p, u8p, i64p, i32p, i32p, i64p, i64p, i64, u8p, i64]
    lib.vtpu_metriclist_spans.restype = i64
    lib.vtpu_metriclist_spans.argtypes = [
        u8p, i64, i64, i64p, i64p, i64p]
    lib.vtpu_proxy_keyhash.restype = None
    lib.vtpu_proxy_keyhash.argtypes = [
        u8p, i64,
        i64p, i32p,
        i32p,
        i64p, i32p,
        i64p, i32p,
        u64p, u8p]
    return lib


def load() -> ctypes.CDLL:
    """The bound library, building it on first use.  Raises if the
    build or the load fails; never returns None."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(build())))
    return _lib


def ptr(a: np.ndarray, ctype):
    """A ctypes pointer to a C-contiguous array's data (raises on any
    other layout: native code walks the buffer flat)."""
    if not a.flags.c_contiguous:
        raise ValueError("native entries take C-contiguous arrays")
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _arr(a, dtype) -> np.ndarray:
    return np.ascontiguousarray(a, dtype)


def _empty_stats(num_rows: int) -> np.ndarray:
    """f64 (weight, min, max, sum, rsum) accumulators, identity-filled
    (min +F32_MAX, max -F32_MAX) as vtpu_dense_plane expects."""
    stats = np.zeros((num_rows, 5), np.float64)
    stats[:, 1] = np.finfo(np.float32).max
    stats[:, 2] = -np.finfo(np.float32).max
    return stats


# ---- typed wrappers over the per-array entries -----------------------

def rank(rows, num_rows: int) -> tuple[np.ndarray, int]:
    """Within-row occurrence rank of each sample and the largest per-row
    count (vtpu_rank; rows outside [0, num_rows) get rank 0)."""
    rows = _arr(rows, np.int32)
    counts = np.zeros(num_rows, np.int32)
    out = np.empty(len(rows), np.int32)
    load().vtpu_rank(ptr(rows, ctypes.c_int32), len(rows), num_rows,
                     ptr(counts, ctypes.c_int32), ptr(out, ctypes.c_int32))
    return out, int(counts.max(initial=0))


def dense_plane(rows, vals, wts, num_rows: int, width: int):
    """Host-densified value plane (vtpu_dense_plane): samples land at
    their within-row arrival rank; past ``width`` they spill.  ``wts``
    None = unit weights (no weight plane).  Returns (plane_v, plane_w or
    None, counts, (spill rows, vals, wts or None), f64 stats[R, 5])
    where stats columns are (weight, min, max, sum, rsum) over every
    sample, spilled ones included."""
    rows = _arr(rows, np.int32)
    vals = _arr(vals, np.float32)
    n = len(rows)
    plane_v = np.zeros((num_rows, width), np.float32)
    counts = np.zeros(num_rows, np.int32)
    stats = _empty_stats(num_rows)
    ov_rows = np.empty(n, np.int32)
    ov_vals = np.empty(n, np.float32)
    if wts is None:
        plane_w = ov_wts = None
        wts_p = plane_w_p = ov_wts_p = None
    else:
        wts = _arr(wts, np.float32)
        plane_w = np.zeros((num_rows, width), np.float32)
        ov_wts = np.empty(n, np.float32)
        wts_p = ptr(wts, ctypes.c_float)
        plane_w_p = ptr(plane_w, ctypes.c_float)
        ov_wts_p = ptr(ov_wts, ctypes.c_float)
    spill = load().vtpu_dense_plane(
        ptr(rows, ctypes.c_int32), ptr(vals, ctypes.c_float), wts_p, n,
        num_rows, width, ptr(plane_v, ctypes.c_float), plane_w_p,
        ptr(counts, ctypes.c_int32), ptr(ov_rows, ctypes.c_int32),
        ptr(ov_vals, ctypes.c_float), ov_wts_p,
        ptr(stats, ctypes.c_double))
    # copies: the spill arrays are n-sized scratch
    ov = (ov_rows[:spill].copy(), ov_vals[:spill].copy(),
          None if ov_wts is None else ov_wts[:spill].copy())
    return plane_v, plane_w, counts, ov, stats


def hll_plane(rows, packed, plane: np.ndarray) -> None:
    """Byte-max fold of packed (idx << 6 | rank) positions into a
    zeroed-or-partial u8[R, m] register plane, in place (vtpu_hll_plane;
    out-of-range rows and indices are skipped)."""
    rows = _arr(rows, np.int32)
    packed = _arr(packed, np.int32)
    load().vtpu_hll_plane(ptr(rows, ctypes.c_int32),
                          ptr(packed, ctypes.c_int32), len(rows),
                          plane.shape[0], plane.shape[1],
                          ptr(plane, ctypes.c_uint8))


def hll_plane_stats(rows, packed, plane: np.ndarray, inv_sum: np.ndarray,
                    ez: np.ndarray) -> None:
    """hll_plane that also keeps each row's LogLog-Beta statistics
    (ez = zero-register count, inv_sum = sum 2^-reg) up to date, in
    place (vtpu_hll_plane_stats)."""
    rows = _arr(rows, np.int32)
    packed = _arr(packed, np.int32)
    if inv_sum.dtype != np.float64 or ez.dtype != np.int32:
        raise ValueError("inv_sum must be f64 and ez i32")
    load().vtpu_hll_plane_stats(
        ptr(rows, ctypes.c_int32), ptr(packed, ctypes.c_int32), len(rows),
        plane.shape[0], plane.shape[1], ptr(plane, ctypes.c_uint8),
        ptr(inv_sum, ctypes.c_double), ptr(ez, ctypes.c_int32))


def sb_gather_i32(parts, dst: np.ndarray, fill: int) -> None:
    """Concatenate int32 ``parts`` into ``dst`` and fill its tail with
    ``fill`` (vtpu_sb_gather_i32; parts past ``dst`` are cut)."""
    parts = [_arr(p, np.int32) for p in parts]
    k = len(parts)
    ptrs = (i32p * k)(*(ptr(p, ctypes.c_int32) for p in parts))
    lens = (ctypes.c_int64 * k)(*(len(p) for p in parts))
    if dst.dtype != np.int32:
        raise ValueError("dst must be int32")
    load().vtpu_sb_gather_i32(ptrs, lens, k, ptr(dst, ctypes.c_int32),
                              len(dst), fill)


def tier_split(rows, tier: np.ndarray, slot: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stable partition of a batch's row ids by tier bit
    (vtpu_tier_split): (wide positions, their pool slots, compact
    positions), positions indexing into the batch."""
    rows = _arr(rows, np.int32)
    n = len(rows)
    if tier.dtype != np.uint8 or slot.dtype != np.int32:
        raise ValueError("tier must be u8 and slot i32")
    out_idx = np.empty(n, np.int32)
    out_rows = np.empty(n, np.int32)
    nw = int(load().vtpu_tier_split(
        ptr(rows, ctypes.c_int32), n, ptr(tier, ctypes.c_uint8),
        ptr(slot, ctypes.c_int32), ptr(out_idx, ctypes.c_int32),
        ptr(out_rows, ctypes.c_int32)))
    return out_idx[:nw], out_rows[:nw], out_idx[nw:]


# HLL sketch forms of a wire's items (vtpu_hll_classify)
HLL_SKIP, HLL_DENSE, HLL_SPARSE, HLL_CODEC = 0, 1, 2, 3
_HLL_M = 1 << 14


class Sketches(NamedTuple):
    """One wire's classified HLL sketches: each item's byte offset
    ``off`` into the wire and form ``status`` (``HLL_*``), and the
    sparse sketches' ``(register << 8) | rank`` pairs at
    ``pairs[pair_start:pair_start + pair_cnt]``."""
    off: np.ndarray
    status: np.ndarray
    pair_start: np.ndarray
    pair_cnt: np.ndarray
    pairs: np.ndarray


def hll_classify(buf: np.ndarray, kind, off, length) -> Sketches:
    """Classify the set items' (``kind`` 4) sketch bytes
    ``buf[off:off + length]``: ``HLL_DENSE`` and ``HLL_SPARSE`` where
    ``forward.hll_codec.decode`` would accept the sketch, the sparse
    ones decoded to pairs; ``HLL_CODEC`` for the rest
    (vtpu_hll_classify, one more call when the pairs outgrow the
    first guess)."""
    kind = _arr(kind, np.uint8)
    off = _arr(off, np.int64)
    length = _arr(length, np.int32)
    n = len(kind)
    status = np.empty(n, np.uint8)
    pair_start = np.empty(n, np.int64)
    pair_cnt = np.empty(n, np.int32)
    pairs = np.empty(0, np.int32)
    lib = load()
    while True:
        need = int(lib.vtpu_hll_classify(
            ptr(buf, ctypes.c_uint8), len(buf), n,
            ptr(kind, ctypes.c_uint8), ptr(off, ctypes.c_int64),
            ptr(length, ctypes.c_int32), ptr(status, ctypes.c_uint8),
            ptr(pair_start, ctypes.c_int64), ptr(pair_cnt, ctypes.c_int32),
            ptr(pairs, ctypes.c_int32), len(pairs)))
        if need <= len(pairs):
            return Sketches(off, status, pair_start, pair_cnt, pairs)
        pairs = np.empty(need, np.int32)


def hll_fold(buf: np.ndarray, sk: Sketches, items, dest,
             plane: np.ndarray) -> int:
    """Byte-max the classified sketches of ``items`` into rows ``dest``
    of a u8[R, 16384] register plane, in place, in order (vtpu_hll_fold;
    items the codec must see and rows outside the plane are skipped).
    Returns the sketches folded."""
    items = _arr(items, np.int64)
    dest = _arr(dest, np.int64)
    if plane.dtype != np.uint8 or plane.ndim != 2 or \
            plane.shape[1] != _HLL_M:
        raise ValueError(f"bad register plane {plane.dtype} {plane.shape}")
    if len(items) != len(dest):
        raise ValueError("items and dest differ in length")
    if len(items) and (items.min() < 0 or items.max() >= len(sk.status)):
        raise ValueError("item index outside the wire")
    return int(load().vtpu_hll_fold(
        ptr(buf, ctypes.c_uint8), ptr(sk.off, ctypes.c_int64),
        ptr(sk.status, ctypes.c_uint8), ptr(sk.pair_start, ctypes.c_int64),
        ptr(sk.pair_cnt, ctypes.c_int32), ptr(sk.pairs, ctypes.c_int32),
        ptr(items, ctypes.c_int64), ptr(dest, ctypes.c_int64), len(items),
        ptr(plane, ctypes.c_uint8), plane.shape[0]))


# ---- plain versions (tests only) ------------------------------------

def rank_plain(rows, num_rows: int) -> tuple[np.ndarray, int]:
    rows = _arr(rows, np.int32)
    live = (rows >= 0) & (rows < num_rows)
    out = np.zeros(len(rows), np.int32)
    r = rows[live]
    order = np.argsort(r, kind="stable")
    srt = r[order]
    first = np.ones(len(r), bool)
    first[1:] = srt[1:] != srt[:-1]
    start = np.maximum.accumulate(np.where(first, np.arange(len(r)), 0))
    rk = np.empty(len(r), np.int32)
    rk[order] = np.arange(len(r)) - start
    out[live] = rk
    return out, int(np.bincount(r, minlength=1).max(initial=0))


def dense_plane_plain(rows, vals, wts, num_rows: int, width: int):
    rows = _arr(rows, np.int32)
    vals = _arr(vals, np.float32)
    unit = wts is None
    w = np.ones(len(rows), np.float32) if unit else _arr(wts, np.float32)
    live = (rows >= 0) & (rows < num_rows)
    rows, vals, w = rows[live], vals[live], w[live]
    rk, _ = rank_plain(rows, num_rows)
    keep = rk < width
    plane_v = np.zeros((num_rows, width), np.float32)
    plane_v[rows[keep], rk[keep]] = vals[keep]
    plane_w = None
    if not unit:
        plane_w = np.zeros((num_rows, width), np.float32)
        plane_w[rows[keep], rk[keep]] = w[keep]
    counts = np.minimum(np.bincount(rows, minlength=num_rows),
                        width).astype(np.int32)
    stats = _empty_stats(num_rows)
    for i in range(len(rows)):  # sequential f64 sums, as the C loop
        r, v, wi = rows[i], vals[i], w[i]
        st = stats[r]
        st[0] += wi
        st[1] = min(st[1], v)
        st[2] = max(st[2], v)
        st[3] += float(v) * float(wi)
        if v != 0:
            st[4] += float(wi) / float(v)
    ov = (rows[~keep], vals[~keep], None if unit else w[~keep])
    return plane_v, plane_w, counts, ov, stats


def hll_plane_plain(rows, packed, plane: np.ndarray) -> None:
    rows = _arr(rows, np.int32)
    packed = _arr(packed, np.int32)
    idx = packed >> 6
    rk = (packed & 0x3F).astype(np.uint8)
    live = ((rows >= 0) & (rows < plane.shape[0]) & (idx >= 0) &
            (idx < plane.shape[1]))
    np.maximum.at(plane, (rows[live], idx[live]), rk[live])


def tier_split_plain(rows, tier: np.ndarray, slot: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    rows = _arr(rows, np.int32)
    mask = tier[rows] != 0
    wide_pos = np.nonzero(mask)[0].astype(np.int32)
    return (wide_pos, slot[rows[wide_pos]].astype(np.int32),
            np.nonzero(~mask)[0].astype(np.int32))
