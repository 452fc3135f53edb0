"""Fused t-digest cluster merge: the CUDA kernel and its plain version.

Port of the Pallas TPU kernel ``veneur_tpu/ops/pallas_merge.py``
(``_build(...).kernel``, entered via ``merge_planes``).  State planes
f32[R, C] plus an incoming batch f32[R, K] merge into f32[R, C], packed
and sorted by mean; the cluster semantics are those of
``tdigest._merge_impl`` (sort by mean with empty slots keyed +inf,
``q_left`` from the cumulative weight, ``floor(k(q) - k(0))`` cluster
ids clipped to the capacity, weighted per-cluster means).

- ``cluster_merge`` is the wrapper every merge goes through.  For a
  CUDA tensor it launches the hand-written kernel
  (``csrc/cluster_merge.cu``, built with nvcc for sm_90a on first use
  and loaded with ctypes) or raises; for a CPU tensor it runs
  ``cluster_merge_plain``.  There is no fallback from one to the other.
- ``cluster_merge_plain`` is the reference's scatter path in PyTorch:
  the CPU tests hold it against JAX, and the card holds the kernel
  against it.

Both flush f32 subnormals to a zero of their sign as they read the
four planes and as they write the two results, as the reference's merge
does under XLA (a subnormal weight is no weight).

``launches`` counts kernel launches (not plain-version calls), so a run
can show that its merges went through the kernel; ``occupancy`` reports
the kernel's launch shape on the current card.  Every merge notes the
bytes it moves (``merge_bytes``) to the device-cost registry, the
estimate of the step that ran it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import subprocess
import threading
import time
from pathlib import Path

import torch

from veneur_tpu_torch.observe.devicecost import REGISTRY
from veneur_tpu_torch.ops.segment import ftz

MAX_WIDTH = 2048    # pow2 sort width bound, as the TPU kernel's
_EPS = 1e-30

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "cluster_merge.cu"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

launches = 0

_lib = None
_lib_lock = threading.Lock()


def merge_bytes(rows: int, cap: int, k: int) -> int:
    """Bytes one merge must move: read both f32 planes and the batch,
    write both planes (the bound formula of ``chip_smoke.py``)."""
    return 2 * rows * (cap + k) * 4 + 2 * rows * cap * 4


def _pow2_at_least(w: int) -> int:
    n = 8
    while n < w:
        n <<= 1
    return n


def supported(cap: int, batch_width: int) -> bool:
    """Whether the kernel handles this (state, batch) shape."""
    return _pow2_at_least(cap + batch_width) <= MAX_WIDTH


def max_batch_slots(cap: int) -> int:
    """Largest incoming-batch width that keeps a merge against a
    ``cap``-slot state inside the kernel's bound (the table caps its
    merge chunk width to it)."""
    return MAX_WIDTH - cap


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    return "nvcc"


def build(verbose: bool = False) -> Path:
    """Compile the kernel into ``_build/`` (once per source revision;
    the library's name carries a hash of the source) and return the
    library's path.  Raises if nvcc fails."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha1(src + " ".join(ARCH_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libcluster_merge-{tag}.so"
    if out.exists():
        REGISTRY.add_cache_hit()
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.monotonic_ns()
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", str(tmp), str(SOURCE)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    if verbose and res.stderr:
        print(res.stderr.strip())
    os.replace(tmp, out)
    REGISTRY.add_compile(time.monotonic_ns() - t0)
    return out


def bind(path) -> ctypes.CDLL:
    """Load a library built from the kernel's source and declare its C
    entries' argument types."""
    lib = ctypes.CDLL(str(path))
    p = ctypes.c_void_p
    f = ctypes.c_float
    i = ctypes.c_int
    ll = ctypes.c_longlong
    fn = lib.cluster_merge_launch
    fn.argtypes = [p, p, ll, p, p, ll, p, p, i, i, i, i, f, f, f, f, f, p]
    fn.restype = i
    occ = lib.cluster_merge_occupancy
    occ.argtypes = [i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
    occ.restype = i
    return lib


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(build())
    return _lib


def occupancy(cap: int, batch_width: int) -> dict:
    """The kernel's launch shape at (cap, batch width) on the current
    card: threads and dynamic shared memory per row, and how many rows
    (CTAs) one SM holds at once."""
    threads = ctypes.c_int()
    smem = ctypes.c_int()
    per_sm = _load().cluster_merge_occupancy(
        cap, batch_width, ctypes.byref(threads), ctypes.byref(smem))
    if per_sm < 0:
        raise RuntimeError("cluster_merge occupancy query failed")
    return {"threads": threads.value, "smem_bytes": smem.value,
            "rows_per_sm": per_sm}


def _k_scale(q: torch.Tensor, delta: float, tail_coeff: float,
             tail_q0: float, tail_qmin: float) -> torch.Tensor:
    """asin body + clamped upper-tail log term (tdigest._k_scale)."""
    body = (delta / (2.0 * math.pi)) * torch.asin(
        torch.clamp(2.0 * q - 1.0, -1.0, 1.0))
    if tail_coeff <= 0.0:
        return body
    tail = tail_coeff * torch.log(
        tail_q0 / torch.clamp(1.0 - q, min=tail_qmin))
    return body + torch.clamp(tail, min=0.0)


@functools.lru_cache(maxsize=16)
def _kernel_constants(delta: float, tail_coeff: float, tail_q0: float,
                      tail_qmin: float) -> tuple[float, float]:
    """The k-scale's f32 multiplier and k(0), as the kernel takes them
    (computed once per scale: the merge is called on the hot path)."""
    scale = float(torch.tensor(delta / (2.0 * math.pi),
                               dtype=torch.float32))
    k0 = float(_k_scale(torch.zeros((), dtype=torch.float32), delta,
                        tail_coeff, tail_q0, tail_qmin))
    return scale, k0


def cluster_merge_plain(means: torch.Tensor, weights: torch.Tensor,
                        new_means: torch.Tensor,
                        new_weights: torch.Tensor, *, delta: float,
                        tail_coeff: float, tail_q0: float,
                        tail_qmin: float
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's scatter merge in PyTorch, on any device."""
    num_rows, cap = means.shape
    m = ftz(torch.cat([means, new_means], dim=1))
    w = ftz(torch.cat([weights, new_weights], dim=1))
    key = torch.where(w > 0, m, torch.full_like(m, math.inf))
    _, order = torch.sort(key, dim=1, stable=True)
    m = m.gather(1, order)
    w = w.gather(1, order)

    total = w.sum(dim=1, keepdim=True)
    cum = w.cumsum(dim=1)
    q_left = (cum - w) / total.clamp(min=_EPS)
    k0 = _k_scale(torch.zeros((), dtype=torch.float32, device=m.device),
                  delta, tail_coeff, tail_q0, tail_qmin)
    k = _k_scale(q_left, delta, tail_coeff, tail_q0, tail_qmin) - k0
    cluster = torch.floor(k).to(torch.int64).clamp(0, cap - 1)

    rows = torch.arange(num_rows, dtype=torch.int64,
                        device=m.device)[:, None]
    flat = (rows * cap + cluster).reshape(-1)
    out_w = torch.zeros(num_rows * cap, dtype=torch.float32,
                        device=m.device).index_add_(
        0, flat, w.reshape(-1)).view(num_rows, cap)
    out_wm = torch.zeros(num_rows * cap, dtype=torch.float32,
                         device=m.device).index_add_(
        0, flat, (w * m).reshape(-1)).view(num_rows, cap)
    out_m = torch.where(out_w > 0, out_wm / out_w.clamp(min=_EPS),
                        torch.zeros_like(out_w))

    # re-pack: occupied slots contiguous and mean-sorted
    pack_key = torch.where(out_w > 0, out_m,
                           torch.full_like(out_m, math.inf))
    _, order = torch.sort(pack_key, dim=1, stable=True)
    return ftz(out_m.gather(1, order)), ftz(out_w.gather(1, order))


def _check(name: str, t: torch.Tensor, rows: int, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] != rows:
        raise ValueError(f"{name} has shape {tuple(t.shape)}")
    if t.shape[1] and t.stride(1) != 1:
        raise ValueError(f"{name} rows must be contiguous")


def cluster_merge(means: torch.Tensor, weights: torch.Tensor,
                  new_means: torch.Tensor, new_weights: torch.Tensor, *,
                  delta: float, tail_coeff: float, tail_q0: float,
                  tail_qmin: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge f32[R, K] incoming centroids into f32[R, C] digests.

    CPU tensors take the plain version.  CUDA tensors launch the
    kernel on the current stream; a shape beyond the kernel's 2048
    width bound raises ValueError, a failed build or launch raises
    RuntimeError."""
    kw = dict(delta=delta, tail_coeff=tail_coeff, tail_q0=tail_q0,
              tail_qmin=tail_qmin)
    dev = means.device
    REGISTRY.note_kernel_bytes(merge_bytes(
        means.shape[0], means.shape[1], new_means.shape[1]))
    if dev.type == "cpu":
        return cluster_merge_plain(means, weights, new_means,
                                   new_weights, **kw)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    num_rows, cap = means.shape
    k_in = new_means.shape[1]
    for name, t, width in (("means", means, cap),
                           ("weights", weights, cap),
                           ("new_means", new_means, k_in),
                           ("new_weights", new_weights, k_in)):
        _check(name, t, num_rows, dev)
        if t.shape[1] != width:
            raise ValueError(f"{name} has width {t.shape[1]}, "
                             f"expected {width}")
    if means.stride() != weights.stride() or \
            new_means.stride() != new_weights.stride():
        raise ValueError("means and weights must share strides")
    n = _pow2_at_least(cap + k_in)
    if n > MAX_WIDTH:
        raise ValueError(f"merge width {cap}+{k_in} exceeds the "
                         f"kernel's {MAX_WIDTH} bound")
    lib = _load()
    out_m = torch.empty((num_rows, cap), dtype=torch.float32, device=dev)
    out_w = torch.empty((num_rows, cap), dtype=torch.float32, device=dev)
    scale, k0 = _kernel_constants(**kw)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cluster_merge_launch(
            means.data_ptr(), weights.data_ptr(),
            means.stride(0) if num_rows else cap,
            new_means.data_ptr(), new_weights.data_ptr(),
            new_means.stride(0) if num_rows else k_in,
            out_m.data_ptr(), out_w.data_ptr(),
            num_rows, cap, k_in, n, scale, k0, float(tail_coeff),
            float(tail_q0), float(tail_qmin), stream)
    if rc != 0:
        raise RuntimeError(f"cluster_merge launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out_m, out_w
