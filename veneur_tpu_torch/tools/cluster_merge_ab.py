"""Time variants of the cluster merge kernel against each other on one
NVIDIA GPU.

    python3 -m veneur_tpu_torch.tools.cluster_merge_ab [--rows 16384]

Run from the root of a checkout (it takes phase 2's inputs and timing
from ``chip_smoke.py`` there).  Each variant is a copy of
``csrc/cluster_merge.cu`` changed by this script and built beside the
kernel's own library (``_build/``), with the same C entry:

- ``kernel``: the source as it is;
- ``persistent``: a grid of as many CTAs as fit on the card at once,
  each walking rows ``blockIdx.x, +gridDim.x, ...`` and copying the next
  row into a second shared-memory buffer (``cp.async``) while it merges
  the current one;
- ``composite_sort``: every unsorted row sorted by (key, column)
  composites, also where its live weights are all equal;
- ``fast_math``: q by a reciprocal and the tail's log by ``__logf``;
- ``no_flush``: without the f32 subnormal flush on load and store (the
  kernel before it), to time what the flush costs;
- ``stop_survey`` ... ``stop_ids``: the kernel cut short after one phase
  (loads and survey, sort, merge, cluster ids), writing zeros, so that
  the differences between them give each phase's time.

For batch widths K = 512, 256 and 616 at C = 616 (the inputs of
``chip_smoke.py`` phase 2), it prints one JSON line per variant and
round: the median ms of one launch (CUDA events around back-to-back
launches), and in the first round how many rows differ from the
kernel's bit for bit and, per quantile of 0.1, 0.5, 0.9 and 0.99, the
largest excess over phase 2's tolerance against the plain version
(rtol 2e-3 / atol 1e-3; <= 0 passes).  Variants run in
turns (kernel, persistent, ..., kernel, persistent, ...), twice.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from veneur_tpu_torch.ops import cluster_merge as cm
from veneur_tpu_torch.ops import tdigest

_PERSISTENT = r'''
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 8) cluster_merge_persistent(
    const float* __restrict__ means, const float* __restrict__ weights,
    long long ld_state, const float* __restrict__ new_means,
    const float* __restrict__ new_weights, long long ld_batch,
    float* __restrict__ out_m, float* __restrict__ out_w, int rows,
    int cap, int k_in, int wa, int wm, float scale, float k0,
    float tail_coeff, float tail_q0, float tail_qmin) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Scratch sc;
  const int cp = (cap + 3) & ~3;
  float* mkey = smem + 4 * wa;
  long long row = blockIdx.x;
  int b = 0;
  if (row < rows) {
    copy_row_async(means + row * ld_state, weights + row * ld_state, cap,
                   smem, smem + wa);
    copy_row_async(new_means + row * ld_batch, new_weights + row * ld_batch,
                   k_in, smem + cp, smem + wa + cp);
  }
  cp_async_commit();
  for (; row < rows; row += gridDim.x) {
    const long long next = row + gridDim.x;
    float* nb = smem + (b ^ 1) * 2 * wa;
    if (next < rows) {
      copy_row_async(means + next * ld_state, weights + next * ld_state,
                     cap, nb, nb + wa);
      copy_row_async(new_means + next * ld_batch,
                     new_weights + next * ld_batch, k_in, nb + cp,
                     nb + wa + cp);
    }
    cp_async_commit();
    init_stat(sc.stat);
    cp_async_wait_prev();
    __syncthreads();
    float* cb = smem + b * 2 * wa;
    merge_row(cb, cb + wa, cb + cp, cb + wa + cp, mkey, mkey + wm, sc,
              out_m + row * cap, out_w + row * cap, cap, k_in, scale, k0,
              tail_coeff, tail_q0, tail_qmin);
    __syncthreads();
    b ^= 1;
  }
}
'''

_PERSISTENT_LAUNCH = r'''
  const size_t psmem = (size_t)(4 * l.wa + 2 * l.wm) * sizeof(float);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(cluster_merge_persistent,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       (int)cudaSharedmemCarveoutMaxShared);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, cluster_merge_persistent, kThreads, psmem);
  const int grid = rows < sms * per_sm ? rows : sms * per_sm;
  cluster_merge_persistent<<<grid, kThreads, psmem,
                             (cudaStream_t)stream>>>(
      means, weights, ld_state, new_means, new_weights, ld_batch, out_m,
      out_w, rows, cap, k_in, l.wa, l.wm, scale, k0, tail_coeff, tail_q0,
      tail_qmin);
'''

# where each phase-cut variant returns: the line it is put before
_STOPS = {
    "stop_survey": "  // sort only what is not already packed and sorted",
    "stop_sort": "  // merge by rank; live elements",
    "stop_merge": "  // each thread owns `per` consecutive merged positions",
    "stop_ids": "  // one output slot per run of equal ids",
}


def _replace(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"variant anchor not found once: {old!r}")
    return src.replace(old, new)


_EDITS = {
    "composite_sort": [("  if (st.wmin == st.wmax) {", "  if (false) {")],
    "fast_math": [
        ("    const float q = (cum - w) / denom;",
         "    const float q = (cum - w) * (1.f / denom);"),
        ("tail_coeff * logf(tail_q0 / fmaxf(1.f - q, tail_qmin));",
         "tail_coeff * (logf(tail_q0) - __logf(fmaxf(1.f - q, tail_qmin)));"),
    ],
    "no_flush": [
        ("  flush_row(sm, sw, cap);\n  flush_row(bm, bw, k_in);\n"
         "  __syncthreads();\n", ""),
        ("    om[s] = ftz(mean);\n    ow[s] = ftz(s_w);",
         "    om[s] = mean;\n    ow[s] = s_w;"),
    ],
}


def variant_source(name: str) -> str:
    src = cm.SOURCE.read_text()
    if name == "kernel":
        return src
    if name in _EDITS:
        for old, new in _EDITS[name]:
            src = _replace(src, old, new)
        return src
    if name == "persistent":
        src = _replace(src, "// Shared-memory layout of one row:",
                       _PERSISTENT + "\n// Shared-memory layout of one row:")
        start = src.index("  cluster_merge_kernel<<<")
        end = src.index("  return (int)cudaGetLastError();", start)
        return src[:start] + _PERSISTENT_LAUNCH + src[end:]
    if name in _STOPS:
        anchor = _STOPS[name]
        return _replace(src, anchor, "  zero_row(om, ow, cap);\n"
                        "  return;\n" + anchor)
    raise KeyError(name)


def build(name: str):
    """Compile one variant into _build/ and load it (ctypes), with the
    argument types of the kernel's own library."""
    src = cm.BUILD_DIR / f"cluster_merge_ab_{name}.cu"
    cm.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(variant_source(name))
    out = src.with_suffix(".so")
    cmd = [cm._nvcc(), *cm.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", str(out), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr[-3000:]}")
    return cm.bind(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=16384)
    ap.add_argument("--variants", default=",".join(
        ["kernel", "persistent", *_EDITS, *_STOPS]))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cluster_merge_ab: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke  # the phase 2 inputs and timing, from the root
    names = args.variants.split(",")
    libs = {n: build(n) for n in names}
    cap = tdigest.DEFAULT_CAPACITY
    kw = dict(delta=tdigest._SCALE_MULT * 100.0,
              tail_coeff=tdigest._TAIL_MULT * 100.0,
              tail_q0=tdigest._TAIL_Q0, tail_qmin=tdigest._TAIL_QMIN)
    rng = np.random.default_rng(7)
    cases = {k: [torch.from_numpy(x).cuda()
                 for x in chip_smoke.random_case(rng, args.rows, cap, k)]
             for k in (512, 256, 616)}
    qs = torch.tensor([0.1, 0.5, 0.9, 0.99], device="cuda")
    plain = {k: tdigest.quantile(*cm.cluster_merge_plain(*a, **kw), qs)
             for k, a in cases.items()}
    saved = cm._lib
    first = {}
    try:
        for rnd in range(2):
            for name in names:
                cm._lib = libs[name]
                line = {"variant": name, "round": rnd, "rows": args.rows,
                        "cap": cap}
                for k, a in cases.items():
                    if rnd == 0:
                        om, ow = cm.cluster_merge(*a, **kw)
                        if name == names[0]:
                            first[k] = (om, ow)
                        fm, fw = first[k]
                        diff = ((om != fm) | (ow != fw)).any(1)
                        line[f"k{k}_rows_differing"] = int(diff.sum())
                        qp = plain[k]
                        excess = ((tdigest.quantile(om, ow, qs) - qp).abs()
                                  - (1e-3 + 2e-3 * qp.abs())).amax(0)
                        line[f"k{k}_q_excess"] = excess.tolist()
                    line[f"k{k}_ms"] = chip_smoke.cuda_ms(
                        lambda: cm.cluster_merge(*a, **kw))
                print(json.dumps(line), flush=True)
    finally:
        cm._lib = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
