// Fused t-digest cluster merge for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in veneur_tpu/ops/pallas_merge.py
// (_build(...).kernel, entered via merge_planes): state planes
// f32[R, C] plus an incoming batch f32[R, K] merge into f32[R, C],
// packed and sorted by mean.  Per row:
//
//   f32 subnormals read or written flush to a zero of their sign
//   key = mean, empty slots (weight 0) keyed +inf
//   stable sort of cat(state, batch) by key
//   inclusive prefix sum of weight -> q = (cum - w) / total
//   k = delta/(2 pi) asin(2q - 1) + max(tail, 0) - k(0)
//   cluster = clip(floor(k), 0, C - 1)
//   per cluster: sum w, sum w*m; mean = sum wm / sum w
//   occupied clusters compacted to slots 0..k-1, zeros after
//
// Bound.  The merge is bound by bytes: it must read 2 R (C + K) f32 and
// write 2 R C f32, ~228 MB at R = 16384, C = 616, K = 512, which is
// 0.068 ms at 3.35 TB/s on an H100 SXM.  The sort and the k-scale are
// a few hundred operations per slot, far below the f32 rate; what keeps
// the kernel above the bound is instruction issue and barriers.
//
// Design.  One CTA of 128 threads per row, the row in dynamic shared
// memory (~18 KB at C + K = 1128), at most 64 registers a thread, so
// eight rows are resident on an SM and hide each other's latency.
//
// - Loads: cp.async copies the whole row into shared memory at once,
//   16 bytes at a time where the row pointers allow, 4 otherwise.  A
//   pass flushes subnormals to zero in place (one barrier); one more
//   pass then counts each row's live slots, its highest live column and
//   the spread of its live weights, and checks that keys never decrease
//   along it (a warp reduction and one barrier).  A row with no weight
//   anywhere writes zeros and exits.
// - Sorting only what is unsorted: the state row is normally this
//   kernel's own output, packed and exactly mean-sorted, so it passes
//   the check; so does a digest union's batch.  On the ingest paths the
//   batch (raw samples) fails it and is sorted in registers by a bitonic
//   network over pow2(highest live column + 1) keys: strides inside a
//   thread are register swaps, inside a warp shuffles, and only the
//   strides across the four warps (three) go through shared memory,
//   instead of a full re-sort's 66 barriers.  Where all live weights of
//   the row are equal (unit samples), equal keys are interchangeable and
//   the network sorts bare f32 keys with min / max; otherwise it sorts
//   64-bit composites (order-preserving key bits, original column), so
//   that ties keep arrival order as the reference's stable sort does.
// - The two sorted runs merge by rank: state element i goes to
//   i + (batch keys < key_i), batch element j to j + (state keys <=
//   key_j), both binary searches in shared memory.  Ties put the state
//   first, which is the stable sort of cat(state, batch).  Only live
//   elements are placed and scanned.
// - The tail: an f32 block scan of the weights gives q; the k-scale
//   gives cluster ids, made monotone by a block max-scan (the block
//   scan's summation order can move q back by an ulp at a thread
//   boundary).  Each cluster is then one contiguous run; a block count
//   of run starts gives each run its output slot, and thread s sums run
//   s in sorted order (no atomics, deterministic) and writes slot s, so
//   the stores are coalesced.  Each run's mean is clamped to its
//   [first, last] key so that f32 rounding of sum(w m) / sum(w) cannot
//   step past a neighbour's mean.  Every block scan takes one barrier.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWidth = 2048;
constexpr float kEps = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

struct AddF {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct AddI {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct MaxI {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// Block-wide exclusive scan of one value per thread; *total gets the
// block total.  One barrier: every warp combines the kWarps warp totals
// itself, so each call site needs its own `warp_buf`.
template <typename T, typename Op>
__device__ T block_exclusive_scan(T v, Op op, T identity, T* warp_buf,
                                  T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = op(y, x);
  }
  T excl = __shfl_up_sync(kFull, x, 1);
  if (lane == 0) excl = identity;
  if (lane == 31) warp_buf[warp] = x;
  __syncthreads();
  T before = identity;
  T all = identity;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const T s = warp_buf[w];
    if (w < warp) before = op(before, s);
    all = op(all, s);
  }
  *total = all;
  return op(before, excl);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// f32 -> u32 with the same order; -0 counts as +0, +inf above all
// finite keys.
__device__ __forceinline__ uint32_t order_bits(float f) {
  uint32_t b = __float_as_uint(f);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// A subnormal as a zero of its sign: the reference's merge runs under
// XLA, which flushes them on every f32 load and store (the build keeps
// nvcc's default -ftz=false, so this is the only place they flush).
__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < FLT_MIN ? copysignf(0.f, x) : x;
}

// Flush one row's means and weights in shared memory in place.
__device__ void flush_row(float* m, float* w, int width) {
  for (int i = threadIdx.x; i < width; i += kThreads) {
    m[i] = ftz(m[i]);
    w[i] = ftz(w[i]);
  }
}

__device__ __forceinline__ float key_of(const float* m, const float* w,
                                        int i) {
  return w[i] > 0.f ? m[i] : INFINITY;
}

// Start copying one row (means m, weights w) into shared dm / dw
// (16-byte aligned): 16-byte copies where the row allows, 4-byte ones
// otherwise.  Nothing waits here.
__device__ void copy_row_async(const float* m, const float* w, int width,
                               float* dm, float* dw) {
  const int tid = threadIdx.x;
  int done = 0;
  if (aligned16(m) && aligned16(w)) {
    const int n4 = width >> 2;
    for (int v = tid; v < n4; v += kThreads) {
      cp_async16(dm + 4 * v, m + 4 * v);
      cp_async16(dw + 4 * v, w + 4 * v);
    }
    done = n4 << 2;
  }
  for (int i = done + tid; i < width; i += kThreads) {
    cp_async4(dm + i, m + i);
    cp_async4(dw + i, w + i);
  }
}

// What one pass over a row in shared memory finds.
struct RowStat {
  int live;      // slots with weight > 0
  int top;       // highest live column + 1
  int unsorted;  // whether the keys ever decrease along the row
  int wmin;      // least and greatest live weight, as f32 bits (order-
  int wmax;      // preserving for positive floats)
};

__device__ void init_stat(RowStat* st) {
  if (threadIdx.x < 2) {
    st[threadIdx.x] = RowStat{0, 0, 0, 0x7fffffff, 0};
  }
}

__device__ void survey_row(const float* m, const float* w, int width,
                           RowStat* st) {
  int cnt = 0, hi = 0, bad = 0, wmin = 0x7fffffff, wmax = 0;
  for (int i = threadIdx.x; i < width; i += kThreads) {
    const float wi = w[i];
    const float k = wi > 0.f ? m[i] : INFINITY;
    if (wi > 0.f) {
      ++cnt;
      hi = i + 1;
      wmin = min(wmin, __float_as_int(wi));
      wmax = max(wmax, __float_as_int(wi));
    }
    if (i > 0 && key_of(m, w, i - 1) > k) bad = 1;
  }
  cnt = __reduce_add_sync(kFull, cnt);
  hi = __reduce_max_sync(kFull, hi);
  bad = __reduce_or_sync(kFull, bad);
  wmin = __reduce_min_sync(kFull, wmin);
  wmax = __reduce_max_sync(kFull, wmax);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&st->live, cnt);
    atomicMax(&st->top, hi);
    atomicOr(&st->unsorted, bad);
    atomicMin(&st->wmin, wmin);
    atomicMax(&st->wmax, wmax);
  }
}

__device__ __forceinline__ unsigned long long pick(unsigned long long a,
                                                   unsigned long long b,
                                                   bool keep_min) {
  return keep_min ? (a < b ? a : b) : (a > b ? a : b);
}

// Stable ascending sort of key/wt[0, width) in place, where every live
// slot lies in [0, top) and N = kThreads * E >= top.  Thread t holds
// composites g = t * E + e in registers.  Ends with a barrier.
template <int E>
__device__ void sort_segment(float* key, float* wt, int width, int top,
                             unsigned long long* xbuf) {
  constexpr int N = kThreads * E;
  constexpr int kLogN = E == 1 ? 7 : E == 2 ? 8 : E == 4 ? 9
                        : E == 8 ? 10 : 11;
  static_assert((1 << kLogN) == N, "E must be a power of two <= 16");
  const int t = threadIdx.x;
  unsigned long long v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int g = t * E + e;
    const float k = g < top ? key_of(key, wt, g) : INFINITY;
    v[e] = (static_cast<unsigned long long>(order_bits(k)) << 32) |
           static_cast<unsigned>(g);
  }
#pragma unroll
  for (int lk = 1; lk <= kLogN; ++lk) {
    const int k = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (j < E) {  // both partners in this thread
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if ((e & j) == 0) {
            const bool asc = ((t * E + e) & k) == 0;
            const unsigned long long a = v[e];
            const unsigned long long b = v[e | j];
            if ((a > b) == asc) {
              v[e] = b;
              v[e | j] = a;
            }
          }
        }
      } else if (j < 32 * E) {  // partner thread in this warp
        const int lanes = j / E;
        const bool lower = (t & lanes) == 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const unsigned long long o = __shfl_xor_sync(kFull, v[e], lanes);
          const bool asc = ((t * E + e) & k) == 0;
          v[e] = pick(v[e], o, lower == asc);
        }
      } else {  // partner thread in another warp: through shared memory
        const int pt = t ^ (j / E);
        const bool lower = (t & (j / E)) == 0;
#pragma unroll
        for (int e = 0; e < E; ++e) xbuf[t * E + e] = v[e];
        __syncthreads();
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const bool asc = ((t * E + e) & k) == 0;
          v[e] = pick(v[e], xbuf[pt * E + e], lower == asc);
        }
        __syncthreads();
      }
    }
  }
  float w[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int src = static_cast<int>(v[e] & 0xffffffffu);
    w[e] = src < width ? wt[src] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int g = t * E + e;
    if (g < width) {
      key[g] = from_order_bits(static_cast<uint32_t>(v[e] >> 32));
      wt[g] = w[e];
    }
  }
  __syncthreads();
}

// The same network on bare f32 keys, for a row whose live slots all
// weigh `w0`: equal keys then carry equal weights, so any order among
// them is the stable sort's, and min / max replace the composites.
template <int E>
__device__ void sort_keys(float* key, float* wt, int width, int top,
                          int live, float w0, float* xbuf) {
  constexpr int kLogN = E == 1 ? 7 : E == 2 ? 8 : E == 4 ? 9
                        : E == 8 ? 10 : 11;
  static_assert((1 << kLogN) == kThreads * E, "E: power of two <= 16");
  const int t = threadIdx.x;
  float v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int g = t * E + e;
    v[e] = g < top ? key_of(key, wt, g) : INFINITY;
  }
#pragma unroll
  for (int lk = 1; lk <= kLogN; ++lk) {
    const int k = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (j < E) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if ((e & j) == 0) {
            const bool asc = ((t * E + e) & k) == 0;
            const float lo = fminf(v[e], v[e | j]);
            const float hi = fmaxf(v[e], v[e | j]);
            v[e] = asc ? lo : hi;
            v[e | j] = asc ? hi : lo;
          }
        }
      } else if (j < 32 * E) {
        const int lanes = j / E;
        const bool lower = (t & lanes) == 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float o = __shfl_xor_sync(kFull, v[e], lanes);
          const bool asc = ((t * E + e) & k) == 0;
          v[e] = lower == asc ? fminf(v[e], o) : fmaxf(v[e], o);
        }
      } else {
        const int pt = t ^ (j / E);
        const bool lower = (t & (j / E)) == 0;
#pragma unroll
        for (int e = 0; e < E; ++e) xbuf[t * E + e] = v[e];
        __syncthreads();
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const bool asc = ((t * E + e) & k) == 0;
          const float o = xbuf[pt * E + e];
          v[e] = lower == asc ? fminf(v[e], o) : fmaxf(v[e], o);
        }
        __syncthreads();
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int g = t * E + e;
    if (g < width) {
      key[g] = v[e];
      wt[g] = g < live ? w0 : 0.f;
    }
  }
  __syncthreads();
}

// Sort a row that failed the check, by bare keys where its live
// weights are all equal, else by (key, column) composites.
__device__ void sort_row(float* key, float* wt, int width,
                         const RowStat& st, void* xbuf) {
  float* fx = static_cast<float*>(xbuf);
  unsigned long long* cx = static_cast<unsigned long long*>(xbuf);
  const int top = st.top;
  if (st.wmin == st.wmax) {
    const float w0 = __int_as_float(st.wmin);
    if (top <= kThreads) {
      sort_keys<1>(key, wt, width, top, st.live, w0, fx);
    } else if (top <= 2 * kThreads) {
      sort_keys<2>(key, wt, width, top, st.live, w0, fx);
    } else if (top <= 4 * kThreads) {
      sort_keys<4>(key, wt, width, top, st.live, w0, fx);
    } else if (top <= 8 * kThreads) {
      sort_keys<8>(key, wt, width, top, st.live, w0, fx);
    } else {
      sort_keys<16>(key, wt, width, top, st.live, w0, fx);
    }
  } else if (top <= kThreads) {
    sort_segment<1>(key, wt, width, top, cx);
  } else if (top <= 2 * kThreads) {
    sort_segment<2>(key, wt, width, top, cx);
  } else if (top <= 4 * kThreads) {
    sort_segment<4>(key, wt, width, top, cx);
  } else if (top <= 8 * kThreads) {
    sort_segment<8>(key, wt, width, top, cx);
  } else {
    sort_segment<16>(key, wt, width, top, cx);
  }
}

// Zero both output rows.
__device__ void zero_row(float* om, float* ow, int cap) {
  int done = 0;
  if ((cap & 3) == 0 && aligned16(om) && aligned16(ow)) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int v = threadIdx.x; v < (cap >> 2); v += kThreads) {
      reinterpret_cast<float4*>(om)[v] = z;
      reinterpret_cast<float4*>(ow)[v] = z;
    }
    done = cap;
  }
  for (int s = done + threadIdx.x; s < cap; s += kThreads) {
    om[s] = 0.f;
    ow[s] = 0.f;
  }
}

// The merge of one row whose state (sm, sw) and batch (bm, bw) lie in
// shared memory, as they arrived; results go to om / ow.  mkey / mw
// hold the merged row.  A row that fails the sortedness check is sorted
// in place (empty slots then hold +inf); the sort's exchange buffer
// borrows the merged arrays, and the cluster ids borrow sm once the
// merge has read it.  The caller has run init_stat and waited for the
// row's copies, then synchronised the block.
struct Scratch {
  float wsum[kWarps];  // one buffer per block scan
  int idmax[kWarps];
  int runs[kWarps];
  RowStat stat[2];     // state, batch
};

__device__ void merge_row(float* sm, float* sw, float* bm, float* bw,
                          float* mkey, float* mw, Scratch& sc, float* om,
                          float* ow, int cap, int k_in, float scale,
                          float k0, float tail_coeff, float tail_q0,
                          float tail_qmin) {
  const int tid = threadIdx.x;
  const RowStat& ss = sc.stat[0];
  const RowStat& bs = sc.stat[1];
  int* cl = reinterpret_cast<int*>(sm);
  flush_row(sm, sw, cap);
  flush_row(bm, bw, k_in);
  __syncthreads();
  survey_row(sm, sw, cap, &sc.stat[0]);
  survey_row(bm, bw, k_in, &sc.stat[1]);
  __syncthreads();
  const int ls = ss.live;
  const int lb = bs.live;
  if (ls + lb == 0) {  // no weight anywhere: the plain version's zeros
    zero_row(om, ow, cap);
    return;
  }

  // sort only what is not already packed and sorted
  if (ss.unsorted) sort_row(sm, sw, cap, ss, mkey);
  if (bs.unsorted) sort_row(bm, bw, k_in, bs, mkey);

  // merge by rank; live elements are [0, ls) and [0, lb), keyed by
  // their means
  for (int i = tid; i < ls; i += kThreads) {
    const float k = sm[i];
    int lo = 0, hi = lb;  // batch keys < k
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (bm[mid] < k) lo = mid + 1; else hi = mid;
    }
    mkey[i + lo] = k;
    mw[i + lo] = sw[i];
  }
  for (int j = tid; j < lb; j += kThreads) {
    const float k = bm[j];
    int lo = 0, hi = ls;  // state keys <= k
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sm[mid] <= k) lo = mid + 1; else hi = mid;
    }
    mkey[j + lo] = k;
    mw[j + lo] = bw[j];
  }
  __syncthreads();

  // each thread owns `per` consecutive merged positions
  const int live = ls + lb;
  const int per = (live + kThreads - 1) / kThreads;
  const int base = tid * per;
  const int end = min(base + per, live);

  float local = 0.f;
  for (int i = base; i < end; ++i) local += mw[i];
  float total;
  const float prefix = block_exclusive_scan(local, AddF(), 0.f, sc.wsum,
                                            &total);

  // k-scale cluster id per position, made monotone by a max-scan
  const float denom = fmaxf(total, kEps);
  int run_max = 0;
  float cum = prefix;
  for (int i = base; i < end; ++i) {
    const float w = mw[i];
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
    cl[i] = run_max;
  }
  int unused;
  const int id_prefix = block_exclusive_scan(run_max, MaxI(), 0,
                                             sc.idmax, &unused);
  // id_prefix is the id of position base - 1, so run starts are found
  // from this thread's own ids
  int starts = 0;
  int prev = base == 0 ? -1 : id_prefix;
  for (int i = base; i < end; ++i) {
    const int c = cl[i] > id_prefix ? cl[i] : id_prefix;
    cl[i] = c;
    starts += c != prev;
    prev = c;
  }

  // one output slot per run of equal ids, in order: slot = runs before
  // it.  Run starts go to `first` (over sw, free since the merge), then
  // thread s sums run s and writes slot s, so stores are coalesced.
  int nruns;
  int slot = block_exclusive_scan(starts, AddI(), 0, sc.runs, &nruns);
  int* first = reinterpret_cast<int*>(sw);
  prev = base == 0 ? -1 : id_prefix;
  for (int i = base; i < end; ++i) {
    if (cl[i] != prev) first[slot++] = i;
    prev = cl[i];
  }
  __syncthreads();
  for (int s = tid; s < cap; s += kThreads) {
    float s_w = 0.f, mean = 0.f;
    if (s < nruns) {
      const int a = first[s];
      const int b = s + 1 < nruns ? first[s + 1] : live;
      float s_wm = 0.f;
      for (int j = a; j < b; ++j) {
        const float w = mw[j];
        s_w += w;
        s_wm += w * mkey[j];
      }
      // the mean lies in [first, last] of its run; clamping away the
      // f32 rounding that can step outside keeps slot means sorted
      mean = fminf(fmaxf(s_wm / fmaxf(s_w, kEps), mkey[a]), mkey[b - 1]);
    }
    om[s] = ftz(mean);
    ow[s] = ftz(s_w);
  }
}


// Dynamic shared memory, in floats: sm / bm, sw / bw, the row as it
// arrives (wa each: state at 0, batch at cp = cap rounded up to 4),
// then mkey[wm], mw[wm] for the merged row.
__global__ void __launch_bounds__(kThreads, 8) cluster_merge_kernel(
    const float* __restrict__ means, const float* __restrict__ weights,
    long long ld_state, const float* __restrict__ new_means,
    const float* __restrict__ new_weights, long long ld_batch,
    float* __restrict__ out_m, float* __restrict__ out_w, int cap,
    int k_in, int wa, int wm, float scale, float k0, float tail_coeff,
    float tail_q0, float tail_qmin) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Scratch sc;
  const int cp = (cap + 3) & ~3;
  float* sm = smem;
  float* sw = smem + wa;
  const long long row = blockIdx.x;

  copy_row_async(means + row * ld_state, weights + row * ld_state, cap,
                 sm, sw);
  copy_row_async(new_means + row * ld_batch, new_weights + row * ld_batch,
                 k_in, sm + cp, sw + cp);
  init_stat(sc.stat);
  cp_async_wait_all();
  __syncthreads();
  merge_row(sm, sw, sm + cp, sw + cp, smem + 2 * wa, smem + 2 * wa + wm,
            sc, out_m + row * cap, out_w + row * cap, cap, k_in, scale,
            k0, tail_coeff, tail_q0, tail_qmin);
}

// Shared-memory layout of one row: wa floats for each of the row's
// means and weights (state, then batch from cap rounded up to 4), wm
// for each of the merged means and weights (also the sort's exchange
// buffer, so at least the widest sort).
struct Layout {
  int wa, wm;
  size_t bytes() const { return (size_t)(2 * wa + 2 * wm) * sizeof(float); }
};

Layout layout(int cap, int k_in) {
  Layout l;
  l.wa = (((cap + 3) & ~3) + k_in + 3) & ~3;
  int sort_n = kThreads;
  while (sort_n < cap || sort_n < k_in) sort_n <<= 1;
  l.wm = l.wa > sort_n ? l.wa : sort_n;
  return l;
}

// Let the SM give shared memory its largest share, so that registers
// and not the carveout bound the resident rows.
cudaError_t prefer_shared() {
  static const cudaError_t rc = cudaFuncSetAttribute(
      cluster_merge_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  return rc;
}

}  // namespace

// Launch one merge on `stream`.  `n` is the caller's power-of-two bound
// on cap + k_in (at most 2048).  Returns cudaGetLastError() (0 = ok).
extern "C" int cluster_merge_launch(
    const float* means, const float* weights, long long ld_state,
    const float* new_means, const float* new_weights, long long ld_batch,
    float* out_m, float* out_w, int rows, int cap, int k_in, int n,
    float scale, float k0, float tail_coeff, float tail_q0,
    float tail_qmin, void* stream) {
  if (n > kMaxWidth || n < cap + k_in || (n & (n - 1)) != 0 || cap < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  if (const cudaError_t rc = prefer_shared()) return (int)rc;
  const Layout l = layout(cap, k_in);
  cluster_merge_kernel<<<rows, kThreads, l.bytes(),
                         (cudaStream_t)stream>>>(
      means, weights, ld_state, new_means, new_weights, ld_batch, out_m,
      out_w, cap, k_in, l.wa, l.wm, scale, k0, tail_coeff, tail_q0,
      tail_qmin);
  return (int)cudaGetLastError();
}

// Rows (CTAs) resident on one SM at this shape, and the CTA's threads
// and dynamic shared memory, for the record; -1 on error.
extern "C" int cluster_merge_occupancy(int cap, int k_in, int* threads,
                                       int* smem_bytes) {
  const Layout l = layout(cap, k_in);
  int per_sm = 0;
  if (prefer_shared() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, cluster_merge_kernel, kThreads, l.bytes()) !=
          cudaSuccess) {
    return -1;
  }
  *threads = kThreads;
  *smem_bytes = (int)l.bytes();
  return per_sm;
}
