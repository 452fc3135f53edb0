// Fused t-digest cluster merge for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in veneur_tpu/ops/pallas_merge.py
// (_build(...).kernel, entered via merge_planes): state planes
// f32[R, C] plus an incoming batch f32[R, K] merge into f32[R, C],
// packed and sorted by mean.  Per row:
//
//   key = mean, empty slots (weight 0) keyed +inf
//   block bitonic sort of (key, weight)
//   inclusive prefix sum of weight -> q = (cum - w) / total
//   k = delta/(2 pi) asin(2q - 1) + max(tail, 0) - k(0)
//   cluster = clip(floor(k), 0, C - 1)
//   per cluster: sum w, sum w*m; mean = sum wm / sum w
//   occupied clusters compacted to slots 0..k-1, zeros after
//
// Design.  One CTA per row, n/2 threads (n = pow2 >= C + K, <= 2048),
// the row in shared memory as key[n], w[n], cluster[n] (24 KiB at
// n = 2048).  The state row and the batch row are read straight from
// their own tensors (row strides are arguments), so nothing is
// concatenated in device memory.  After the sort, cluster ids never
// decrease along the row, so every cluster is one contiguous run: the
// thread owning a run's first element sums it in sorted order (the
// order of the reference's scatter-add) — no atomics, deterministic.
// A block max-scan over the ids makes that monotonicity exact even
// where the f32 block scan's summation order could move q back by an
// ulp at a thread boundary.  Runs come out in increasing cluster id,
// which is increasing mean, so a block count of run starts gives each
// run its output slot directly: the TPU kernel's second bitonic pass
// and its MXU one-hot segment sums have no counterpart here.  (A run's
// mean is clamped to its own [first, last] key: f32 rounding of
// sum(w m) / sum(w) can otherwise land an ulp past a neighbour's.)
//
// Bound.  The merge is memory-bound: it must read 2 R (C + K) f32 and
// write 2 R C f32.  At R = 16384, C = 616, K = 512 that is ~228 MB,
// ~68 us at 3.35 TB/s on an H100 SXM.  This first version re-sorts
// every row in shared memory (66 bitonic stages at n = 2048) although
// the state row arrives sorted, and runs far above that bound; PERF.md
// has its measured time.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxWidth = 2048;
constexpr float kEps = 1e-30f;

struct AddF {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct AddI {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct MaxI {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// Block-wide exclusive scan of one value per thread.  blockDim.x is a
// multiple of 32 and at most 1024.  Writes the block total to *total.
template <typename T, typename Op>
__device__ T block_exclusive_scan(T v, Op op, T identity, T* warp_buf,
                                  T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = op(y, x);
  }
  T excl = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) excl = identity;
  if (lane == 31) warp_buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T s = lane < nwarps ? warp_buf[lane] : identity;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      T y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s = op(y, s);
    }
    warp_buf[lane] = s;
  }
  __syncthreads();
  const T warp_prefix = warp == 0 ? identity : warp_buf[warp - 1];
  *total = warp_buf[nwarps - 1];
  __syncthreads();  // warp_buf is reused by the next scan
  return warp == 0 ? excl : op(warp_prefix, excl);
}

__global__ void __launch_bounds__(1024) cluster_merge_kernel(
    const float* __restrict__ means, const float* __restrict__ weights,
    long long ld_state, const float* __restrict__ new_means,
    const float* __restrict__ new_weights, long long ld_batch,
    float* __restrict__ out_m, float* __restrict__ out_w, int cap,
    int k_in, int n, float scale, float k0, float tail_coeff,
    float tail_q0, float tail_qmin) {
  __shared__ float key[kMaxWidth];
  __shared__ float wt[kMaxWidth];
  __shared__ int cl[kMaxWidth];
  __shared__ float fbuf[32];
  __shared__ int ibuf[32];

  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const float* sm = means + row * ld_state;
  const float* sw = weights + row * ld_state;
  const float* bm = new_means + row * ld_batch;
  const float* bw = new_weights + row * ld_batch;
  float* om = out_m + row * cap;
  float* ow = out_w + row * cap;

  // 1. load state + batch, pad to n with weight 0 / key +inf
  for (int i = tid; i < n; i += nthreads) {
    float m = 0.f, w = 0.f;
    if (i < cap) {
      m = sm[i];
      w = sw[i];
    } else if (i < cap + k_in) {
      m = bm[i - cap];
      w = bw[i - cap];
    }
    key[i] = w > 0.f ? m : INFINITY;
    wt[i] = w;
  }
  __syncthreads();

  // 2. ascending bitonic sort of key, weights co-moving; ties never
  //    swap (equal keys may land in either order: same readout)
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < (n >> 1); p += nthreads) {
        const int lo = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int hi = lo | j;
        const float a = key[lo];
        const float b = key[hi];
        const bool asc = (lo & k) == 0;
        if (asc ? (a > b) : (a < b)) {
          key[lo] = b;
          key[hi] = a;
          const float t = wt[lo];
          wt[lo] = wt[hi];
          wt[hi] = t;
        }
      }
      __syncthreads();
    }
  }

  // each thread owns `per` consecutive sorted positions
  const int per = (n + nthreads - 1) / nthreads;  // 1 or 2
  const int base = tid * per;

  // 3. inclusive prefix sum of weight; live count (weight > 0 sorts
  //    before every empty slot, so live = positions [0, nlive))
  float local = 0.f;
  int live_local = 0;
  for (int e = 0; e < per; ++e) {
    const int i = base + e;
    if (i < n) {
      local += wt[i];
      live_local += wt[i] > 0.f;
    }
  }
  float total;
  const float prefix = block_exclusive_scan(local, AddF(), 0.f, fbuf,
                                            &total);
  int nlive;
  block_exclusive_scan(live_local, AddI(), 0, ibuf, &nlive);

  // 4. k-scale cluster id per position, made monotone by a max-scan
  const float denom = fmaxf(total, kEps);
  int ids[2] = {0, 0};
  int run_max = 0;
  float cum = prefix;
  for (int e = 0; e < per; ++e) {
    const int i = base + e;
    if (i >= n) break;
    const float w = wt[i];
    cum += w;
    const float q = (cum - w) / denom;
    float kv = scale * asinf(fminf(fmaxf(2.f * q - 1.f, -1.f), 1.f));
    if (tail_coeff > 0.f) {
      const float t =
          tail_coeff * logf(tail_q0 / fmaxf(1.f - q, tail_qmin));
      kv += fmaxf(t, 0.f);
    }
    kv -= k0;
    int c = (int)floorf(kv);
    c = c < 0 ? 0 : (c > cap - 1 ? cap - 1 : c);
    run_max = c > run_max ? c : run_max;
    ids[e] = run_max;
  }
  int unused;
  const int id_prefix = block_exclusive_scan(run_max, MaxI(), 0, ibuf,
                                             &unused);
  for (int e = 0; e < per; ++e) {
    const int i = base + e;
    if (i < n) cl[i] = ids[e] > id_prefix ? ids[e] : id_prefix;
  }
  __syncthreads();

  // 5. one output slot per run of equal cluster ids among live
  //    positions: slot = number of runs before it
  int starts = 0;
  for (int e = 0; e < per; ++e) {
    const int i = base + e;
    if (i < nlive && (i == 0 || cl[i] != cl[i - 1])) ++starts;
  }
  int nruns;
  int slot = block_exclusive_scan(starts, AddI(), 0, ibuf, &nruns);
  for (int e = 0; e < per; ++e) {
    const int i = base + e;
    if (i < nlive && (i == 0 || cl[i] != cl[i - 1])) {
      const int c = cl[i];
      float s_w = 0.f, s_wm = 0.f;
      int j = i;
      for (; j < nlive && cl[j] == c; ++j) {
        const float w = wt[j];
        s_w += w;
        s_wm += w * key[j];
      }
      // the mean lies in [first, last] of its run; clamping away the
      // f32 rounding that can step outside keeps slot means sorted
      const float mean = fminf(fmaxf(s_wm / fmaxf(s_w, kEps), key[i]),
                               key[j - 1]);
      ow[slot] = s_w;
      om[slot] = mean;
      ++slot;
    }
  }
  for (int s = nruns + tid; s < cap; s += nthreads) {
    ow[s] = 0.f;
    om[s] = 0.f;
  }
}

}  // namespace

// Launch one merge on `stream`.  Returns cudaGetLastError() (0 = ok).
extern "C" int cluster_merge_launch(
    const float* means, const float* weights, long long ld_state,
    const float* new_means, const float* new_weights, long long ld_batch,
    float* out_m, float* out_w, int rows, int cap, int k_in, int n,
    float scale, float k0, float tail_coeff, float tail_q0,
    float tail_qmin, void* stream) {
  if (n > kMaxWidth || n < cap + k_in || (n & (n - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  const int threads = n / 2 < 32 ? 32 : n / 2;
  cluster_merge_kernel<<<rows, threads, 0, (cudaStream_t)stream>>>(
      means, weights, ld_state, new_means, new_weights, ld_batch, out_m,
      out_w, cap, k_in, n, scale, k0, tail_coeff, tail_q0, tail_qmin);
  return (int)cudaGetLastError();
}
