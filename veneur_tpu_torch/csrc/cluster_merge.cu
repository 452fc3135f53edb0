// Fused t-digest cluster merge for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in veneur_tpu/ops/pallas_merge.py
// (_build(...).kernel, entered via merge_planes): state planes
// f32[R, C] plus an incoming batch f32[R, K] merge into f32[R, C],
// packed and sorted by mean.  Per row:
//
//   f32 subnormals read or written flush to a zero of their sign
//   key = mean (a NaN mean read as +inf), empty slots (weight 0) keyed
//   +inf
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
// Nothing in the design needs C + K inside the reference's 2048-lane
// bound: a wider row takes more shared memory (16 bytes a lane, ~37 KB
// at compression 300's C + K = 1824 + 512), up to the card's per-CTA
// opt-in limit (~227 KB on an H100, C + K near 12,000), which
// cluster_merge_max_dyn reports; a row past it takes the spill route.
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
//   the check.  On the ingest paths the batch (raw samples) fails it and
//   is sorted in registers by a bitonic network over pow2(highest live
//   column + 1) keys: strides inside a thread are register swaps, inside
//   a warp shuffles, and only the strides across the four warps (three)
//   go through shared memory, instead of a full re-sort's 66 barriers.
//   Where all live weights of the row are equal (unit samples), equal
//   keys are interchangeable and the network sorts bare f32 keys with
//   min / max; otherwise it sorts 64-bit composites (order-preserving
//   key bits, original column), so that ties keep arrival order as the
//   reference's stable sort does.
// - Sorted runs, merged by rank.  A segment wider than the register sort
//   (16 x 128 keys: a mesh flush merge or a collective fold's union, whose
//   batch is S packed, mean-sorted digests side by side, or a state past
//   the reference's 2048-lane bound) is rarely random: a packed digest
//   keys its live slots in order and its empty slots +inf, so S digests
//   side by side show S non-decreasing runs, each with its live slots
//   first.  The survey counts the descents (in key bits, the composite
//   order), and a segment of at most kMaxRuns runs (the wrapper's limit)
//   with no live key at or above +inf is merged instead of sorted
//   (merge_runs): the runs' starts are collected and ordered, each run's
//   live prefix found by a binary search and gathered as key bits, and the
//   runs merge pairwise, ceil(log2 runs) rounds, ties to the lower-column
//   run, live slots only, between the merged arrays and the segment.  A
//   round is a merge path: each thread owns a stretch of the output, finds
//   where it starts in the pair's two inputs by one binary search, and
//   merges from there in order (a binary search a slot is latency-bound).
//   A stable merge of runs taken in
//   column order is the stable sort by (key bits, column): the live slots
//   come out in the long sort's order, with its key bits (-0 as +0).  Past
//   kMaxRuns (raw samples, an unsorted wide state) a segment past the
//   register sort runs the bitonic network on composites in shared memory,
//   one barrier per step (sort_long).
// - The two sorted segments merge by rank: state element i goes to
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
//
// Rounding.  The library is built with -fmad=false: no multiply and add
// is contracted into one fused operation, so the k-scale, the scans and
// the cluster sums round as the plain version's separate operations do,
// and every instance of the merge body below gives one row the same
// bits.  nvcc contracts the same source differently in each instance
// otherwise, and a cluster boundary an ulp decides then falls on either
// side in the odd row.
//
// The spill route.  A row wider than one CTA's opt-in shared memory
// (past C + K near 12,000 on an H100: a mesh flush merge of 20 or more
// shards, a collective import fold over 20 or more places, compression
// past ~2,000) is mostly empty slots: a 24-shard flush merge's row holds
// 15,400 slots of which ~3,700 are live (its digests at most half full),
// and a live slot costs 16 bytes on chip (key and weight as it arrives
// and merged).  Two passes.  cluster_merge_spill_kernel is a grid of
// kSpillCtasPerSm CTAs of 128 threads an SM, each looping over rows with
// a fixed share of the SM's shared memory.  A row streams in from global
// memory once (stream_segment: float4 loads, eight in flight a thread,
// subnormals flushed, the survey taken, the live slots compacted stably
// into shared memory by one block scan a 2048-column tile), and where
// its live union fits and holds no odd key (+inf; -0 among equal
// weights: where compaction could part from the uncompacted row's bits)
// the same merge body runs on it in shared memory.  Compaction keeps the
// live slots' order, so the sorted union, and every output bit, are the
// uncompacted row's.  A row that does not fit (or holds an odd key) goes
// on a list, and cluster_merge_spill_rows_kernel, eight CTAs an SM to
// hide its round trips, copies each listed row whole to a global scratch
// slice of its CTA and merges it there as the wide route merges in
// shared memory: each exchange goes through __syncthreads(), which
// orders the block's global writes as it does its shared ones; the
// register sorts exchange through a tile in shared memory, runs merge
// between the slice's arrays, and a long sort keeps its steps of stride
// under kRegSort on that tile (sort_long_tiled).  Its bound is the wide
// route's bytes.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRegSort = 16 * kThreads;  // widest register sort
constexpr int kMaxRuns = 64;             // most sorted runs a merge takes
constexpr int kSpillCtasPerSm = 2;       // spill CTAs sharing an SM
constexpr int kStreamU = 4;              // float4s a thread loads a tile
constexpr int kStreamTile = kStreamU * 4 * kThreads;  // columns a tile
constexpr float kEps = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kInfBits = 0xff800000u;  // order_bits(+inf)

struct AddF {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct AddI {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct AddU64 {
  __device__ unsigned long long operator()(unsigned long long a,
                                           unsigned long long b) const {
    return a + b;
  }
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

// A mean as the merge keys it: flushed, and NaN read as +inf, so that
// every comparison of two keys is consistent (a NaN compares false both
// ways, and the merge by rank then places two slots on one output slot
// and reads one never written).
__device__ __forceinline__ float flush_mean(float x) {
  return isnan(x) ? INFINITY : ftz(x);
}

// Flush one row's means and weights in shared memory in place.
__device__ void flush_row(float* m, float* w, int width) {
  for (int i = threadIdx.x; i < width; i += kThreads) {
    m[i] = flush_mean(m[i]);
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

// What one pass over a row segment finds.
constexpr int kUnsorted = 1;  // its keys decrease somewhere (f32 compare)
constexpr int kHigh = 2;      // a live key at or above +inf in key bits
constexpr int kWide = 4;      // wider than the register sort: descents
                              // counted, its runs may merge by rank
constexpr int kOdd = 8;       // (spill stream) a live +inf key
constexpr int kNegZero = 16;  // (spill stream) a live -0 key

struct RowStat {
  int live;      // slots with weight > 0
  int top;       // highest live column + 1
  int flags;     // kUnsorted | kHigh | kWide | kOdd | kNegZero
  int wmin;      // least and greatest live weight, as f32 bits (order-
  int wmax;      // preserving for positive floats)
  int descents;  // key-bit descents (segments past the register sort)
};

__device__ void init_stat(RowStat* st) {
  if (threadIdx.x < 2) {
    st[threadIdx.x] = RowStat{0, 0, 0, 0x7fffffff, 0, 0};
  }
}

// Survey a segment in shared (or the spill route's global) memory.  Only
// a segment past the register sort counts its key-bit descents and
// looks for keys at or above +inf: nothing else reads them.
__device__ void survey_row(const float* m, const float* w, int width,
                           RowStat* st) {
  const bool runs = width > kRegSort;
  int cnt = 0, hi = 0, flags = 0, wmin = 0x7fffffff, wmax = 0, desc = 0;
  for (int i = threadIdx.x; i < width; i += kThreads) {
    const float wi = w[i];
    const float k = wi > 0.f ? m[i] : INFINITY;
    if (wi > 0.f) {
      ++cnt;
      hi = i + 1;
      wmin = min(wmin, __float_as_int(wi));
      wmax = max(wmax, __float_as_int(wi));
    }
    if (i > 0 && key_of(m, w, i - 1) > k) flags |= kUnsorted;
    if (runs) {
      const uint32_t b = order_bits(k);
      flags |= kWide;
      if (i > 0 && order_bits(key_of(m, w, i - 1)) > b) ++desc;
      if (wi > 0.f && b >= kInfBits) flags |= kHigh;
    }
  }
  cnt = __reduce_add_sync(kFull, cnt);
  hi = __reduce_max_sync(kFull, hi);
  flags = __reduce_or_sync(kFull, flags);
  wmin = __reduce_min_sync(kFull, wmin);
  wmax = __reduce_max_sync(kFull, wmax);
  if (runs) desc = __reduce_add_sync(kFull, desc);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&st->live, cnt);
    atomicMax(&st->top, hi);
    atomicOr(&st->flags, flags);
    atomicMin(&st->wmin, wmin);
    atomicMax(&st->wmax, wmax);
    if (runs) atomicAdd(&st->descents, desc);
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

// A slot's sort composite: order-preserving key bits, then its column.
__device__ __forceinline__ unsigned long long composite(const float* key,
                                                        const float* wt,
                                                        int top, int g) {
  const float k = g < top ? key_of(key, wt, g) : INFINITY;
  return (static_cast<unsigned long long>(order_bits(k)) << 32) |
         static_cast<unsigned>(g);
}

// One step (stage k, stride j) of the bitonic network over xbuf[0, n),
// then a barrier.  `base` is xbuf[0]'s column in the whole segment (a
// tile's offset), which sets each pair's direction.
__device__ __forceinline__ void bitonic_step(unsigned long long* xbuf,
                                             int n, int base, int k,
                                             int j) {
  for (int i = threadIdx.x; i < (n >> 1); i += kThreads) {
    const int a = ((i & ~(j - 1)) << 1) | (i & (j - 1));  // bit j clear
    const unsigned long long x = xbuf[a];
    const unsigned long long y = xbuf[a | j];
    if ((x > y) == (((base + a) & k) == 0)) {
      xbuf[a] = y;
      xbuf[a | j] = x;
    }
  }
  __syncthreads();
}

// The end of a long sort: the weight's bits replace each sorted
// composite's column, then keys and weights go back in place.
__device__ void finish_long(float* key, float* wt, int width,
                            unsigned long long* xbuf);

// Stable ascending sort of key/wt[0, width) in place for a segment
// past the register network (top > kRegSort): the same bitonic network
// on (key bits, column) composites in shared memory (xbuf holds N =
// pow2(top) of them), one barrier per step.  Ends with a barrier.
__device__ void sort_long(float* key, float* wt, int width, int top,
                          unsigned long long* xbuf) {
  int n = kRegSort;
  while (n < top) n <<= 1;
  for (int g = threadIdx.x; g < n; g += kThreads) {
    xbuf[g] = composite(key, wt, top, g);
  }
  __syncthreads();
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) bitonic_step(xbuf, n, 0, k, j);
  }
  finish_long(key, wt, width, xbuf);
}

// sort_long for the spill route's rows in global memory: the same
// network, but each run of steps with strides under kRegSort runs on
// one tile of kRegSort composites in shared memory (loaded, stepped,
// stored back), so a stage of the network touches global memory once
// per stride of kRegSort or more, plus once for its tile pass.  The
// network and so the sorted composites are sort_long's.
__device__ void sort_long_tiled(float* key, float* wt, int width, int top,
                                unsigned long long* xbuf,
                                unsigned long long* tile) {
  constexpr int T = kRegSort;
  int n = T;
  while (n < top) n <<= 1;
  for (int b = 0; b < n; b += T) {  // stages 2..T inside each tile
    for (int l = threadIdx.x; l < T; l += kThreads) {
      tile[l] = composite(key, wt, top, b + l);
    }
    __syncthreads();
    for (int k = 2; k <= T; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) bitonic_step(tile, T, b, k, j);
    }
    for (int l = threadIdx.x; l < T; l += kThreads) xbuf[b + l] = tile[l];
    __syncthreads();
  }
  for (int k = 2 * T; k <= n; k <<= 1) {
    for (int j = k >> 1; j >= T; j >>= 1) bitonic_step(xbuf, n, 0, k, j);
    for (int b = 0; b < n; b += T) {
      for (int l = threadIdx.x; l < T; l += kThreads) tile[l] = xbuf[b + l];
      __syncthreads();
      for (int j = T >> 1; j > 0; j >>= 1) bitonic_step(tile, T, b, k, j);
      for (int l = threadIdx.x; l < T; l += kThreads) xbuf[b + l] = tile[l];
      __syncthreads();
    }
  }
  finish_long(key, wt, width, xbuf);
}

__device__ void finish_long(float* key, float* wt, int width,
                            unsigned long long* xbuf) {
  // the weight's bits replace the column, then both go back in place
  for (int g = threadIdx.x; g < width; g += kThreads) {
    const unsigned long long v = xbuf[g];
    const int src = static_cast<int>(v & 0xffffffffu);
    const float w = src < width ? wt[src] : 0.f;
    xbuf[g] = (v & 0xffffffff00000000ull) | __float_as_uint(w);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < width; g += kThreads) {
    key[g] = from_order_bits(static_cast<uint32_t>(xbuf[g] >> 32));
    wt[g] = __uint_as_float(static_cast<uint32_t>(xbuf[g]));
  }
  __syncthreads();
}

// The runs of one segment: how many, where each starts, and where each
// one's live slots begin in the merged order (off[n] = all of them).
struct RunMeta {
  int n;
  int start[kMaxRuns];
  int off[kMaxRuns + 1];
  int scan[kWarps];
};
constexpr int kMetaFloats = static_cast<int>(sizeof(RunMeta) / sizeof(float));

// The run holding merged position i: the r with off[r] <= i < off[r+1]
// (empty runs skipped).
__device__ __forceinline__ int run_of(const int* off, int n, int i) {
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= i) lo = mid; else hi = mid;
  }
  return lo;
}

// Stable sort of key/wt[0, top) by merging its sorted runs (the caller
// checked: at most kMaxRuns runs, no live key at or above +inf, so each
// run's live slots are its prefix).  The live slots end in key/wt[0,
// live) in the order sort_long gives them, keys through order bits.
// The runs' live prefixes are first gathered into xk / xw (`live` slots
// each) as key bits; then each round merges pairs of groups of 2^t runs
// between xk / xw and the segment's prefix by merge path: thread t owns
// `per` consecutive output positions, finds where they start in the
// pair's two inputs by one binary search on its diagonal, and merges
// sequentially from there, taking the left (lower-column) input on a
// tie.  Ends with a barrier.
__device__ void merge_runs(float* key, float* wt, int top, float* xk,
                           float* xw, RunMeta* rm) {
  const int tid = threadIdx.x;
  if (tid == 0) rm->n = 0;
  __syncthreads();
  // run starts: column 0 and every descent in key bits
  for (int i = tid; i < top; i += kThreads) {
    if (i == 0 || order_bits(key_of(key, wt, i - 1)) >
                      order_bits(key_of(key, wt, i))) {
      const int s = atomicAdd(&rm->n, 1);
      if (s < kMaxRuns) rm->start[s] = i;
    }
  }
  __syncthreads();
  const int n = min(rm->n, kMaxRuns);
  // order the starts: each one's rank among them
  int mine = 0, rank = 0;
  if (tid < n) {
    mine = rm->start[tid];
    for (int j = 0; j < n; ++j) rank += rm->start[j] < mine;
  }
  __syncthreads();
  if (tid < n) rm->start[rank] = mine;
  __syncthreads();
  // each run's live prefix, by a binary search for its first empty slot
  int cnt = 0;
  if (tid < n) {
    const int lo = rm->start[tid];
    int a = lo, b = tid + 1 < n ? rm->start[tid + 1] : top;
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (wt[mid] > 0.f) a = mid + 1; else b = mid;
    }
    cnt = a - lo;
  }
  int total;
  const int off = block_exclusive_scan(cnt, AddI(), 0, rm->scan, &total);
  if (tid < n) rm->off[tid] = off;
  if (tid == 0) rm->off[n] = total;
  __syncthreads();
  uint32_t* xb = reinterpret_cast<uint32_t*>(xk);
  uint32_t* kb = reinterpret_cast<uint32_t*>(key);
  for (int r = 0; r < n; ++r) {  // gather the live prefixes, as key bits
    const int s = rm->start[r];
    const int o = rm->off[r];
    const int len = rm->off[r + 1] - o;
    for (int j = tid; j < len; j += kThreads) {
      xb[o + j] = order_bits(key[s + j]);
      xw[o + j] = wt[s + j];
    }
  }
  __syncthreads();
  int rounds = 0;
  while ((1 << rounds) < n) ++rounds;
  const int per = (total + kThreads - 1) / kThreads;
  const int pend = min((tid + 1) * per, total);
  for (int t = 0; t < rounds; ++t) {
    const bool to_key = (t & 1) == 0;  // x -> segment, segment -> x
    const bool last = t == rounds - 1;
    const uint32_t* sb = to_key ? xb : kb;
    const float* sw = to_key ? xw : wt;
    uint32_t* db = to_key ? kb : xb;
    float* dw = to_key ? wt : xw;
    const int g = 1 << t;
    int p = tid * per;
    while (p < pend) {
      // the pair of groups holding output position p: A = [a0, a1),
      // B = [a1, b1), merged into [a0, b1)
      const int q0 = (run_of(rm->off, n, p) >> (t + 1)) << (t + 1);
      const int a0 = rm->off[q0];
      const int a1 = rm->off[min(q0 + g, n)];
      const int b1 = rm->off[min(q0 + 2 * g, n)];
      const int la = a1 - a0;
      const int lb = b1 - a1;
      const int d = p - a0;
      // i = A's slots among the pair's first d outputs: the least i
      // whose A[i] comes after B[d - i - 1]
      int lo = max(0, d - lb), hi = min(d, la);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (sb[a1 + d - mid - 1] < sb[a0 + mid]) hi = mid; else lo = mid + 1;
      }
      int i = lo, j = d - lo;
      uint32_t ha = i < la ? sb[a0 + i] : 0u;
      uint32_t hb = j < lb ? sb[a1 + j] : 0u;
      const int stop = min(pend, b1);
      for (; p < stop; ++p) {
        uint32_t k;
        float w;
        if (j >= lb || (i < la && ha <= hb)) {
          k = ha;
          w = sw[a0 + i];
          if (++i < la) ha = sb[a0 + i];
        } else {
          k = hb;
          w = sw[a1 + j];
          if (++j < lb) hb = sb[a1 + j];
        }
        if (last && to_key) {
          key[p] = from_order_bits(k);
        } else {
          db[p] = k;
        }
        dw[p] = w;
      }
    }
    __syncthreads();
  }
  if ((rounds & 1) == 0) {  // the merged slots are in x
    for (int i = tid; i < total; i += kThreads) {
      key[i] = from_order_bits(xb[i]);
      wt[i] = xw[i];
    }
    __syncthreads();
  }
}

// Sort a segment that failed the check: merge its runs where it is
// wider than the register sort and has at most `max_runs` of them (and
// the buffers hold its live slots), else by bare keys where its live
// weights are all equal, else by (key, column) composites.  On the spill route's global rows (kGlobal) mkey lies in
// global memory: the register sorts exchange through the shared `tile`
// instead, and a long segment takes sort_long_tiled.
template <bool kGlobal>
__device__ void sort_row(float* key, float* wt, int width,
                         const RowStat& st, float* mkey, float* mw,
                         int x_cap, RunMeta* rm, unsigned long long* tile,
                         int max_runs) {
  void* xbuf = mkey;
  void* ex = kGlobal ? static_cast<void*>(tile) : xbuf;
  float* fx = static_cast<float*>(ex);
  unsigned long long* cx = static_cast<unsigned long long*>(ex);
  const int top = st.top;
  if ((st.flags & kWide) && st.descents < max_runs &&
      !(st.flags & kHigh) && st.live <= x_cap) {
    merge_runs(key, wt, top, mkey, mw, rm);
  } else if (top > kRegSort) {
    if (kGlobal) {
      sort_long_tiled(key, wt, width, top,
                      static_cast<unsigned long long*>(xbuf), tile);
    } else {
      sort_long(key, wt, width, top, cx);
    }
  } else if (st.wmin == st.wmax) {
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

// The merge of one row, surveyed: state (sm, sw; ws slots) and batch
// (bm, bw; wb slots) lie flushed in shared memory (on the spill route's
// global rows, kGlobal: in the CTA's global scratch); sc.stat holds
// their surveys; results go to om / ow (cap slots).  mkey / mw hold the
// merged row.  A segment that fails the sortedness check is sorted in
// place (empty slots then hold +inf); the sort's buffers borrow the
// merged arrays (x_cap slots each; rm holds a runs merge's runs; the
// global rows' register sorts take the shared `tile`), and the cluster
// ids borrow sm once the merge has read it.
struct Scratch {
  float wsum[kWarps];  // one buffer per block scan
  int idmax[kWarps];
  int runs[kWarps];
  RowStat stat[2];     // state, batch
};

template <bool kGlobal>
__device__ void merge_body(float* sm, float* sw, int ws, float* bm,
                           float* bw, int wb, float* mkey, float* mw,
                           int x_cap, Scratch& sc, RunMeta* rm,
                           unsigned long long* tile, float* om, float* ow,
                           int cap, int max_runs, float scale, float k0,
                           float tail_coeff, float tail_q0,
                           float tail_qmin) {
  const int tid = threadIdx.x;
  const RowStat& ss = sc.stat[0];
  const RowStat& bs = sc.stat[1];
  int* cl = reinterpret_cast<int*>(sm);
  const int ls = ss.live;
  const int lb = bs.live;
  if (ls + lb == 0) {  // no weight anywhere: the plain version's zeros
    zero_row(om, ow, cap);
    return;
  }

  // sort only what is not already packed and sorted
  if (ss.flags & kUnsorted) {
    sort_row<kGlobal>(sm, sw, ws, ss, mkey, mw, x_cap, rm, tile, max_runs);
  }
  if (bs.flags & kUnsorted) {
    sort_row<kGlobal>(bm, bw, wb, bs, mkey, mw, x_cap, rm, tile, max_runs);
  }

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

// The merge of one row whose state (sm, sw) and batch (bm, bw) lie in
// shared memory (kGlobal: in the CTA's global scratch) as they arrived:
// flushed in place, surveyed, then merge_body.  The caller has run
// init_stat and waited for the row's copies, then synchronised the
// block.
template <bool kGlobal>
__device__ void merge_row(float* sm, float* sw, float* bm, float* bw,
                          float* mkey, float* mw, int x_cap, Scratch& sc,
                          RunMeta* rm, unsigned long long* tile, float* om,
                          float* ow, int cap, int k_in, int max_runs,
                          float scale, float k0, float tail_coeff,
                          float tail_q0, float tail_qmin) {
  flush_row(sm, sw, cap);
  flush_row(bm, bw, k_in);
  __syncthreads();
  survey_row(sm, sw, cap, &sc.stat[0]);
  survey_row(bm, bw, k_in, &sc.stat[1]);
  __syncthreads();
  merge_body<kGlobal>(sm, sw, cap, bm, bw, k_in, mkey, mw, x_cap, sc, rm,
                      tile, om, ow, cap, max_runs, scale, k0, tail_coeff,
                      tail_q0, tail_qmin);
}


// Dynamic shared memory, in floats: sm / bm, sw / bw, the row as it
// arrives (wa each: state at 0, batch at cp = cap rounded up to 4),
// then mkey[wm], mw[wm] for the merged row; a runs merge keeps its runs
// in mkey's last kMetaFloats floats.
__global__ void __launch_bounds__(kThreads, 8) cluster_merge_kernel(
    const float* __restrict__ means, const float* __restrict__ weights,
    long long ld_state, const float* __restrict__ new_means,
    const float* __restrict__ new_weights, long long ld_batch,
    float* __restrict__ out_m, float* __restrict__ out_w, int cap,
    int k_in, int wa, int wm, int max_runs, float scale, float k0,
    float tail_coeff, float tail_q0, float tail_qmin) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Scratch sc;
  const int cp = (cap + 3) & ~3;
  float* sm = smem;
  float* sw = smem + wa;
  float* mkey = smem + 2 * wa;
  float* mw = mkey + wm;
  const long long row = blockIdx.x;

  copy_row_async(means + row * ld_state, weights + row * ld_state, cap,
                 sm, sw);
  copy_row_async(new_means + row * ld_batch, new_weights + row * ld_batch,
                 k_in, sm + cp, sw + cp);
  init_stat(sc.stat);
  cp_async_wait_all();
  __syncthreads();
  merge_row<false>(sm, sw, sm + cp, sw + cp, mkey, mw, wm - kMetaFloats,
                   sc, reinterpret_cast<RunMeta*>(mw - kMetaFloats),
                   nullptr, out_m + row * cap, out_w + row * cap, cap,
                   k_in, max_runs, scale, k0, tail_coeff, tail_q0,
                   tail_qmin);
}

// Copy one row into the CTA's global scratch: float4 where both sides
// allow, floats otherwise.
__device__ void copy_row_plain(const float* m, const float* w, int width,
                               float* dm, float* dw) {
  const int tid = threadIdx.x;
  int done = 0;
  if (aligned16(m) && aligned16(w) && aligned16(dm) && aligned16(dw)) {
    const int n4 = width >> 2;
    for (int v = tid; v < n4; v += kThreads) {
      reinterpret_cast<float4*>(dm)[v] =
          reinterpret_cast<const float4*>(m)[v];
      reinterpret_cast<float4*>(dw)[v] =
          reinterpret_cast<const float4*>(w)[v];
    }
    done = n4 << 2;
  }
  for (int i = done + tid; i < width; i += kThreads) {
    dm[i] = m[i];
    dw[i] = w[i];
  }
}

// Four columns from col on (0 past width): one float4 each where `vec`
// says the row allows it.
__device__ __forceinline__ void load4(const float* m, const float* w,
                                      int col, int width, bool vec,
                                      float* mv, float* wv) {
  if (vec && col + 3 < width) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(m + col));
    const float4 b = __ldg(reinterpret_cast<const float4*>(w + col));
    mv[0] = a.x; mv[1] = a.y; mv[2] = a.z; mv[3] = a.w;
    wv[0] = b.x; wv[1] = b.y; wv[2] = b.z; wv[3] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = col + e < width;
      mv[e] = in ? __ldg(m + col + e) : 0.f;
      wv[e] = in ? __ldg(w + col + e) : 0.f;
    }
  }
}

// What a live key (flushed) tells the on-chip spill path: +inf (kOdd)
// and -0 (kNegZero) are keys where a compacted row's sorts could part
// from the wide route's bits.
__device__ __forceinline__ int odd_flags(float m) {
  return (m == INFINITY ? kOdd : 0) |
         (__float_as_uint(m) == 0x80000000u ? kNegZero : 0);
}

// Stream one segment of a row (means m, weights w; `width` columns) from
// global memory: flush subnormals, survey it into *st (descents in key
// bits, live-weight spread, kOdd and kNegZero; the caller sets live,
// top and the sort flags) and compact its live slots, stably, into
// shared dk / dw while they fit `room`.  Each tile of kStreamTile
// columns is four quarters of 512, one float4 a thread each (a warp's
// loads coalesced), all loaded before one block scan of the quarters'
// live counts (12 bits each) and the tile's descents (bits 48-63) places
// them.  Returns the live count; sets *fail, and stops reading, where
// more live slots than `room` arrive, or more than a long sort can take
// on chip (`sort_room`) once the segment has too many runs to merge.
__device__ int stream_segment(const float* __restrict__ m,
                              const float* __restrict__ w, int width,
                              bool vec, float* dk, float* dw, int room,
                              int sort_room, int max_runs, RowStat* st,
                              unsigned long long* scan, int& tiles,
                              int& fail) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  int running = 0, descents = 0, wmin = 0x7fffffff, wmax = 0, flags = 0;
  for (int c0 = 0; c0 < width && !fail; c0 += kStreamTile) {
    float mv[kStreamU][4], wv[kStreamU][4];
    float pm[kStreamU], pw[kStreamU];  // lane 0: the column before
#pragma unroll
    for (int u = 0; u < kStreamU; ++u) {
      const int col = c0 + u * 4 * kThreads + 4 * tid;
      load4(m, w, col, width, vec, mv[u], wv[u]);
      pm[u] = 0.f;
      pw[u] = 0.f;
      if (lane == 0 && col > 0 && col - 1 < width) {
        pm[u] = __ldg(m + col - 1);
        pw[u] = __ldg(w + col - 1);
      }
    }
    unsigned long long packed = 0;
    int desc = 0;
#pragma unroll
    for (int u = 0; u < kStreamU; ++u) {
      const int col = c0 + u * 4 * kThreads + 4 * tid;
      uint32_t b[4];
      int cnt = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mv[u][e] = flush_mean(mv[u][e]);
        wv[u][e] = ftz(wv[u][e]);
        const bool live = col + e < width && wv[u][e] > 0.f;
        b[e] = order_bits(live ? mv[u][e] : INFINITY);
        if (live) {
          ++cnt;
          flags |= odd_flags(mv[u][e]);
          wmin = min(wmin, __float_as_int(wv[u][e]));
          wmax = max(wmax, __float_as_int(wv[u][e]));
        }
      }
      uint32_t prev = __shfl_up_sync(kFull, b[3], 1);
      if (lane == 0) {
        const float pwf = ftz(pw[u]);
        prev = order_bits(pwf > 0.f ? flush_mean(pm[u]) : INFINITY);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = col + e;
        if (c > 0 && c < width && prev > b[e]) ++desc;
        prev = b[e];
      }
      packed += static_cast<unsigned long long>(cnt) << (12 * u);
    }
    packed += static_cast<unsigned long long>(desc) << 48;
    unsigned long long tot;
    const unsigned long long ex = block_exclusive_scan(
        packed, AddU64(), 0ull, scan + (tiles & 1) * kWarps, &tot);
    ++tiles;
    int base = running;
#pragma unroll
    for (int u = 0; u < kStreamU; ++u) {
      const int col = c0 + u * 4 * kThreads + 4 * tid;
      int rank = base + static_cast<int>((ex >> (12 * u)) & 0xfff);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (col + e < width && wv[u][e] > 0.f) {
          if (rank < room) {
            dk[rank] = mv[u][e];
            dw[rank] = wv[u][e];
          }
          ++rank;
        }
      }
      base += static_cast<int>((tot >> (12 * u)) & 0xfff);
    }
    running = base;
    descents += static_cast<int>(tot >> 48);
    if (running > room ||
        (width > kRegSort && descents >= max_runs && running > sort_room)) {
      fail = 1;
    }
  }
  wmin = __reduce_min_sync(kFull, wmin);
  wmax = __reduce_max_sync(kFull, wmax);
  flags = __reduce_or_sync(kFull, flags);
  if (tid == 0) st->descents = descents;
  if (lane == 0) {
    atomicMin(&st->wmin, wmin);
    atomicMax(&st->wmax, wmax);
    atomicOr(&st->flags, flags);
  }
  return running;
}

// Whether a streamed segment of `live` slots (`width` as it arrived)
// merges on chip with the wide route's bits, and inside the shared
// buffers (room slots each for keys, weights, mkey and mw).  A +inf
// key (tied with the empty slots), or a -0 key among equal weights
// (where the bare-key sort keeps zeros' signs as they lie), leaves the
// row to the global path.
// No sort, a register sort or a runs merge fits; a long sort needs its
// pow2 composites in mkey and mw.
__device__ __forceinline__ bool merges_on_chip(const RowStat& st, int live,
                                               int width, int room,
                                               int max_runs) {
  if ((st.flags & kOdd) ||
      ((st.flags & kNegZero) && st.wmin == st.wmax)) {
    return false;
  }
  if (st.descents == 0 || live <= kRegSort ||
      (width > kRegSort && st.descents < max_runs)) {
    return true;
  }
  int n = kRegSort;
  while (n < live) n <<= 1;
  return n <= room;
}

// The spill route, first pass: the grid's CTAs loop over rows.  Dynamic
// shared memory: keys, weights, mkey and mw of `room` floats each (a
// row's compacted live slots).  A row that does not merge on chip is
// left to the second pass: its index goes to deferred[*count].
__global__ void __launch_bounds__(kThreads, kSpillCtasPerSm)
cluster_merge_spill_kernel(
    const float* __restrict__ means, const float* __restrict__ weights,
    long long ld_state, const float* __restrict__ new_means,
    const float* __restrict__ new_weights, long long ld_batch,
    float* __restrict__ out_m, float* __restrict__ out_w, int rows,
    int cap, int k_in, int room, int max_runs, int* deferred, int* count,
    float scale, float k0, float tail_coeff, float tail_q0,
    float tail_qmin) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Scratch sc;
  __shared__ RunMeta rm;
  __shared__ unsigned long long scan[2 * kWarps];
  float* keys = smem;
  float* wts = smem + room;
  float* mkey = smem + 2 * room;
  float* mw = smem + 3 * room;
  const bool vs = aligned16(means) && aligned16(weights) &&
                  (ld_state & 3) == 0;
  const bool vb = aligned16(new_means) && aligned16(new_weights) &&
                  (ld_batch & 3) == 0;
  int sort_room = kRegSort;  // the widest long sort mkey and mw hold
  while (2 * sort_room <= room) sort_room <<= 1;
  int tiles = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    init_stat(sc.stat);
    __syncthreads();
    int fail = 0;
    const int ls = stream_segment(means + row * ld_state,
                                  weights + row * ld_state, cap, vs, keys,
                                  wts, room, sort_room, max_runs,
                                  &sc.stat[0], scan, tiles, fail);
    const int lb = fail ? 0
                        : stream_segment(new_means + row * ld_batch,
                                         new_weights + row * ld_batch,
                                         k_in, vb, keys + ls, wts + ls,
                                         room - ls, sort_room, max_runs,
                                         &sc.stat[1], scan, tiles, fail);
    __syncthreads();
    const bool on_chip =
        !fail && merges_on_chip(sc.stat[0], ls, cap, room, max_runs) &&
        merges_on_chip(sc.stat[1], lb, k_in, room, max_runs);
    __syncthreads();  // every thread has read the stats
    if (on_chip) {
      if (threadIdx.x < 2) {
        RowStat& st = sc.stat[threadIdx.x];
        st.live = st.top = threadIdx.x ? lb : ls;
        st.flags = (st.descents > 0 ? kUnsorted : 0) |
                   ((threadIdx.x ? k_in : cap) > kRegSort ? kWide : 0);
      }
      __syncthreads();
      merge_body<false>(keys, wts, ls, keys + ls, wts + ls, lb, mkey, mw,
                        room, sc, &rm, nullptr, out_m + row * cap,
                        out_w + row * cap, cap, max_runs, scale, k0,
                        tail_coeff, tail_q0, tail_qmin);
    } else if (threadIdx.x == 0) {
      deferred[atomicAdd(count, 1)] = static_cast<int>(row);
    }
    __syncthreads();  // the next row reuses shared memory
  }
}

// The spill route, second pass: the rows the first left, each copied
// whole to the CTA's slice of the global scratch (scratch[b *
// ld_scratch, ...), laid out as the wide route's shared memory,
// layout()) and merged there; the register sorts and a long sort's
// short strides exchange through a shared tile.  Many CTAs an SM, to
// hide the slice's round trips.
__global__ void __launch_bounds__(kThreads, 8) cluster_merge_spill_rows_kernel(
    const float* __restrict__ means, const float* __restrict__ weights,
    long long ld_state, const float* __restrict__ new_means,
    const float* __restrict__ new_weights, long long ld_batch,
    float* __restrict__ out_m, float* __restrict__ out_w,
    const int* __restrict__ deferred, const int* __restrict__ count,
    int cap, int k_in, int wa, int wm, float* scratch,
    long long ld_scratch, int max_runs, float scale, float k0,
    float tail_coeff, float tail_q0, float tail_qmin) {
  __shared__ __align__(16) unsigned long long tile[kRegSort];
  __shared__ Scratch sc;
  __shared__ RunMeta rm;
  const int cp = (cap + 3) & ~3;
  float* sm = scratch + blockIdx.x * ld_scratch;
  float* sw = sm + wa;
  const int n = *count;
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const long long row = deferred[i];
    copy_row_plain(means + row * ld_state, weights + row * ld_state, cap,
                   sm, sw);
    copy_row_plain(new_means + row * ld_batch,
                   new_weights + row * ld_batch, k_in, sm + cp, sw + cp);
    init_stat(sc.stat);
    __syncthreads();
    merge_row<true>(sm, sw, sm + cp, sw + cp, sm + 2 * wa,
                    sm + 2 * wa + wm, wm, sc, &rm, tile, out_m + row * cap,
                    out_w + row * cap, cap, k_in, max_runs, scale, k0,
                    tail_coeff, tail_q0, tail_qmin);
    __syncthreads();  // the next row reuses the slice and sc
  }
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
// and not the carveout bound the resident rows, and let a CTA take up to
// the card's opt-in limit of dynamic shared memory (a wide row).
// *max_dyn gets that limit.
cudaError_t setup_shared(int* max_dyn) {
  static int limit = 0;
  static const cudaError_t rc = [] {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    cudaError_t e = cudaGetDevice(&dev);
    if (!e) e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (!e) e = cudaFuncGetAttributes(&fa, cluster_merge_kernel);
    if (!e) limit = optin - (int)fa.sharedSizeBytes;
    if (!e) e = cudaFuncSetAttribute(
        cluster_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        limit);
    if (!e) e = cudaFuncSetAttribute(
        cluster_merge_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  *max_dyn = limit;
  return rc;
}

// The spill kernel's dynamic shared memory: an SM's share for one of
// kSpillCtasPerSm CTAs, less the per-CTA reserve and its static shared
// memory, as `room` live slots of 16 bytes (a multiple of 4).
cudaError_t setup_spill(int* room) {
  static int slots = 0;
  static const cudaError_t rc = [] {
    int dev = 0, per_sm = 0, optin = 0, reserved = 0;
    cudaFuncAttributes fa;
    cudaError_t e = cudaGetDevice(&dev);
    if (!e) e = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (!e) e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (!e) e = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
    if (!e) e = cudaFuncGetAttributes(&fa, cluster_merge_spill_kernel);
    if (e) return e;
    int bytes = per_sm / kSpillCtasPerSm - reserved;
    bytes = (bytes < optin ? bytes : optin) - (int)fa.sharedSizeBytes;
    slots = (bytes / 16) & ~3;
    if (slots * 4 < 2 * kRegSort) return cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(cluster_merge_spill_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             slots * 16);
    if (!e) e = cudaFuncSetAttribute(
        cluster_merge_spill_kernel,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  *room = slots;
  return rc;
}

// CTAs of the spill route's first pass resident on one SM, and the
// card's SMs.
cudaError_t spill_residency(int* per_sm, int* sms) {
  int dev = 0, room = 0;
  cudaError_t e = setup_spill(&room);
  if (!e) e = cudaGetDevice(&dev);
  if (!e) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                     dev);
  if (!e) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, cluster_merge_spill_kernel, kThreads, (size_t)room * 16);
  return e;
}

// The same for its second pass (static shared memory only).
cudaError_t spill_rows_residency(int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (!e) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                     dev);
  if (!e) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, cluster_merge_spill_rows_kernel, kThreads, 0);
  return e;
}

}  // namespace

// The dynamic shared memory one CTA may take on the current card (the
// wide route's limit: the opt-in limit less the kernel's static shared
// memory), -1 on error.
extern "C" int cluster_merge_max_dyn() {
  int max_dyn = 0;
  if (setup_shared(&max_dyn) != cudaSuccess) return -1;
  return max_dyn;
}

// Live slots a spill-route row may hold on chip (its CTA's shared
// memory / 16 bytes), -1 on error.
extern "C" int cluster_merge_spill_room() {
  int room = 0;
  if (setup_spill(&room) != cudaSuccess) return -1;
  return room;
}

// The spill route's second-pass grid for `rows` rows: every CTA of it
// the card holds at once, at most one a row; -1 on error.  The caller
// allocates that many scratch slices of layout(cap, k_in).bytes().
extern "C" int cluster_merge_spill_grid(int rows) {
  int per_sm = 0, sms = 0;
  if (spill_rows_residency(&per_sm, &sms) != cudaSuccess || per_sm < 1) {
    return -1;
  }
  const long long all = (long long)per_sm * sms;
  return (int)(rows < all ? (rows > 0 ? rows : 1) : all);
}

// Launch one merge on the spill route on `stream`: the first pass over
// every row (kSpillCtasPerSm CTAs an SM), then the second over the rows
// it left, `grid` CTAs (from cluster_merge_spill_grid), each on its own
// slice of `scratch`, at least layout(cap, k_in).bytes() a slice,
// `ld_scratch` floats apart.  `deferred` holds `rows` ints and `count`
// one, 0 at the launch: it ends with the rows merged in global memory.
// `max_runs` (0..kMaxRuns) is the most sorted runs a segment merges
// instead of sorting (0: always the long sort).  Returns
// cudaGetLastError() (0 = ok).
extern "C" int cluster_merge_launch_spill(
    const float* means, const float* weights, long long ld_state,
    const float* new_means, const float* new_weights, long long ld_batch,
    float* out_m, float* out_w, int rows, int cap, int k_in, int n,
    float* scratch, int grid, long long ld_scratch, int* deferred,
    int* count, int max_runs, float scale, float k0, float tail_coeff,
    float tail_q0, float tail_qmin, void* stream) {
  const Layout l = layout(cap, k_in);
  if (n < cap + k_in || (n & (n - 1)) != 0 || cap < 1 || grid < 1 ||
      ld_scratch < (long long)(2 * l.wa + 2 * l.wm) ||
      (ld_scratch & 3) != 0 || max_runs < 0 || max_runs > kMaxRuns) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  int room = 0, per_sm = 0, sms = 0;
  if (const cudaError_t rc = spill_residency(&per_sm, &sms)) return (int)rc;
  if (const cudaError_t rc = setup_spill(&room)) return (int)rc;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const long long all = (long long)per_sm * sms;
  const int first = (int)(rows < all ? rows : all);
  cluster_merge_spill_kernel<<<first, kThreads, (size_t)room * 16,
                               (cudaStream_t)stream>>>(
      means, weights, ld_state, new_means, new_weights, ld_batch, out_m,
      out_w, rows, cap, k_in, room, max_runs, deferred, count, scale, k0,
      tail_coeff, tail_q0, tail_qmin);
  if (const cudaError_t rc = cudaGetLastError()) return (int)rc;
  cluster_merge_spill_rows_kernel<<<grid, kThreads, 0,
                                    (cudaStream_t)stream>>>(
      means, weights, ld_state, new_means, new_weights, ld_batch, out_m,
      out_w, deferred, count, cap, k_in, l.wa, l.wm, scratch, ld_scratch,
      max_runs, scale, k0, tail_coeff, tail_q0, tail_qmin);
  return (int)cudaGetLastError();
}

// Launch one merge on `stream` with the row in shared memory (the
// kernel and wide routes).  `n` is the caller's power-of-two bound on
// cap + k_in; `max_runs` as for cluster_merge_launch_spill.  Returns
// cudaGetLastError() (0 = ok); a row too wide for shared memory
// (layout().bytes() over cluster_merge_max_dyn) is
// cudaErrorInvalidValue: it takes cluster_merge_launch_spill.
extern "C" int cluster_merge_launch(
    const float* means, const float* weights, long long ld_state,
    const float* new_means, const float* new_weights, long long ld_batch,
    float* out_m, float* out_w, int rows, int cap, int k_in, int n,
    int max_runs, float scale, float k0, float tail_coeff, float tail_q0,
    float tail_qmin, void* stream) {
  if (n < cap + k_in || (n & (n - 1)) != 0 || cap < 1 || max_runs < 0 ||
      max_runs > kMaxRuns) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  int max_dyn = 0;
  if (const cudaError_t rc = setup_shared(&max_dyn)) return (int)rc;
  const Layout l = layout(cap, k_in);
  if (l.bytes() > (size_t)max_dyn) return (int)cudaErrorInvalidValue;
  cluster_merge_kernel<<<rows, kThreads, l.bytes(),
                         (cudaStream_t)stream>>>(
      means, weights, ld_state, new_means, new_weights, ld_batch, out_m,
      out_w, cap, k_in, l.wa, l.wm, max_runs, scale, k0, tail_coeff,
      tail_q0, tail_qmin);
  return (int)cudaGetLastError();
}

// Rows (CTAs) resident on one SM at this shape, and the CTA's threads
// and the row's bytes (layout(): dynamic shared memory on the kernel's
// own routes, a global scratch slice on the spill route, whose CTAs
// these then are), for the record; -1 on error.
extern "C" int cluster_merge_occupancy(int cap, int k_in, int* threads,
                                       int* smem_bytes) {
  const Layout l = layout(cap, k_in);
  int per_sm = 0, max_dyn = 0, sms = 0;
  if (setup_shared(&max_dyn) != cudaSuccess) return -1;
  const cudaError_t e =
      l.bytes() <= (size_t)max_dyn
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, cluster_merge_kernel, kThreads, l.bytes())
          : spill_residency(&per_sm, &sms);
  if (e != cudaSuccess) return -1;
  *threads = kThreads;
  *smem_bytes = (int)l.bytes();
  return per_sm;
}
