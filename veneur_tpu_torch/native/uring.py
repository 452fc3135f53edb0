"""io_uring multishot ring ingest: the reader tier above the recvmmsg
drain (the port's copy of the reference's ``native/uring.py``).

One :class:`UringReader` per SO_REUSEPORT reader socket: a registered
ring with a kernel-provided buffer pool and a single multishot
``IORING_OP_RECV`` that keeps completing into pool buffers with no
per-packet syscall.  Datagrams are parsed IN PLACE in the
numpy-owned arena by ``vtpu_uring_parse_ingest`` (zero-copy: the
buffer the kernel wrote is the buffer the parser reads); the buffers
backing any miss/slow-path lines stay held out of the pool until
:meth:`UringReader.release`, after the table commit that referenced
them.

Everything degrades: :func:`probe` answers whether THIS
kernel/process can run the multishot provided-buffer receive
(``-errno`` names the refusing rung), and a ring that dies at runtime
(seccomp, resource limits) surfaces ``-errno`` from every call so the
server can drop the reader to the recvmmsg tier without losing it.
All of it is host code: the ring feeds the same staging as the
recvmmsg tier, and the device step after it is unchanged.
"""

from __future__ import annotations

import ctypes
import errno as _errno
import os
import threading

import numpy as np

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)

_probe_lock = threading.Lock()
_probe_cache: dict[int, int] = {}  # id(lib) -> result

#: stats() slot names, in vtpu_uring_stats layout order
STAT_FIELDS = (
    "buf_count", "buf_len", "kernel_bufs", "held_bufs",
    "completions", "oversize", "enobufs", "rearms", "batches",
    "armed", "dead_errno", "cq_backlog",
)


def probe(lib) -> int:
    """0 when the kernel grants multishot provided-buffer receive,
    else ``-errno`` from the first refusing rung (ENOSYS: no
    io_uring; EPERM: seccomp/sysctl; EINVAL: pre-5.19/6.0 kernel;
    ENOMEM/EPERM on registration: RLIMIT_MEMLOCK).  Cached per
    library handle — the answer cannot change within a process."""
    if lib is None:
        return -_errno.ENOSYS
    key = id(lib)
    with _probe_lock:
        r = _probe_cache.get(key)
        if r is None:
            r = int(lib.vtpu_uring_probe())
            _probe_cache[key] = r
        return r


def probe_reason(err: int) -> str:
    """Short reason tag for the fallback counter / log line."""
    e = -err
    if e == _errno.ENOSYS:
        return "enosys"
    if e == _errno.EPERM or e == _errno.EACCES:
        return "eperm"
    if e == _errno.ENOMEM:
        return "enomem"
    if e == _errno.EINVAL or e == _errno.EOPNOTSUPP:
        return "einval"
    return "error"


class UringError(OSError):
    """A ring call failed with ``-errno`` (ring dead or unbuildable);
    carries the fallback reason tag."""

    def __init__(self, err: int, where: str):
        e = -err if err < 0 else err
        super().__init__(e, "%s: %s" % (where, os.strerror(e)))
        self.reason = probe_reason(-e)


class UringReader:
    """One reader thread's ring over an already-bound UDP socket.

    The arena (``buf_count * buf_len`` bytes, numpy-owned) is where
    the kernel lands datagrams and where the fused parse reads them;
    :attr:`arena` is sliceable by the arena-relative offsets the
    parse pass reports for miss/slow lines.  NOT thread-safe — one
    ring, one reader thread, matching the server's reader layout.
    """

    def __init__(self, lib, sock_fd: int, buf_count: int,
                 buf_len: int):
        if buf_count & (buf_count - 1):
            raise ValueError("buf_count must be a power of two")
        self._lib = lib
        self.buf_count = buf_count
        self.buf_len = buf_len
        self.arena = np.zeros(buf_count * buf_len, np.uint8)
        self.io_out = np.zeros(4, np.int32)
        self._stats = np.zeros(32, np.int64)
        err = ctypes.c_int64(0)
        self.handle = lib.vtpu_uring_new(
            sock_fd, buf_count, buf_len,
            self.arena.ctypes.data_as(_u8p), ctypes.byref(err))
        if not self.handle:
            raise UringError(-int(err.value), "io_uring setup")

    def close(self) -> None:
        h, self.handle = self.handle, None
        if h:
            self._lib.vtpu_uring_free(h)

    def __del__(self):  # best-effort: munmap + fd on GC
        try:
            self.close()
        except Exception:
            pass

    def drain(self, out: np.ndarray, max_msgs: int, max_len: int,
              wait_ms: int, wait_batch: int = 1
              ) -> tuple[int, int, int, int]:
        """Copy-out drain with the vtpu_recv_drain output contract
        (newline-joined datagrams in ``out``).  ``wait_batch`` > 1
        lets completions pool kernel-side before waking (multishot
        batching).  Returns (bytes, n_msgs, n_oversize, n_enobufs);
        raises UringError when the ring is dead."""
        n = ctypes.c_int32(0)
        nov = ctypes.c_int32(0)
        neb = ctypes.c_int32(0)
        w = self._lib.vtpu_uring_drain(
            self.handle, out.ctypes.data_as(_u8p), out.nbytes,
            max_msgs, max_len, wait_ms, wait_batch, ctypes.byref(n),
            ctypes.byref(nov), ctypes.byref(neb))
        if w < 0:
            raise UringError(int(w), "io_uring drain")
        return int(w), int(n.value), int(nov.value), int(neb.value)

    def pending_copy(self) -> bytes:
        """The held datagrams as one newline-joined bytes object (the
        reindex-epoch replay path)."""
        cap = 65536
        while True:
            out = np.empty(cap, np.uint8)
            w = int(self._lib.vtpu_uring_pending_copy(
                self.handle, out.ctypes.data_as(_u8p), cap))
            if w >= 0:
                return out[:w].tobytes()
            cap = -w

    def release(self) -> None:
        """Return held buffers to the pool and re-arm; call after the
        commit that referenced the arena.  Raises UringError if the
        re-arm found the ring dead."""
        r = int(self._lib.vtpu_uring_release(self.handle))
        if r < 0:
            raise UringError(r, "io_uring re-arm")

    def stats(self) -> dict:
        """Counter snapshot for /debug/vars (see STAT_FIELDS), plus
        the completion-batch histogram."""
        self._lib.vtpu_uring_stats(
            self.handle, self._stats.ctypes.data_as(_i64p))
        s = self._stats
        out = {k: int(s[i]) for i, k in enumerate(STAT_FIELDS)}
        out["batch_hist"] = [int(v) for v in s[12:22]]
        return out
