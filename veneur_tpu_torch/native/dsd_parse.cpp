// Columnar DogStatsD batch parser and fused ingest: the host side of
// the port's ingest path, for one reader or several (reader shards
// probe the identity index without a lock).
//
// A copy of the reference package's veneur_tpu/native/dsd_parse.cpp,
// cut to the entries the port runs: the batch parser
// (vtpu_parse_batch), the recvmmsg drain (vtpu_recv_drain), the
// io_uring multishot ring with its in-place fused parse (vtpu_uring_*,
// -ENOSYS stubs where the headers lack io_uring), the member
// hasher, the identity index (vtpu_index_*), the column combiner
// (vtpu_ingest), the fused parse + probe + combine pass
// (vtpu_parse_ingest), the within-row rank, the host-densified value
// plane (vtpu_dense_plane), the HLL register folds (vtpu_hll_plane,
// vtpu_hll_plane_stats), the superbatch segment gather, the tier
// partition of the adaptive sketch tiers (vtpu_tier_split), the batched
// gob value decode of the reference-schema /import wire
// (vtpu_gob_decode), and the gRPC MetricList wire walker with its
// per-item import-identity hash (vtpu_metriclist_decode,
// vtpu_metriclist_keyhash).  Everything
// kept is byte for byte the reference's, so identity hashes stay
// bit-identical to utils/hashing.key_hash64 and member hashes to
// utils/hashing.hash64.  The port's own addition is the gRPC import's
// HLL sketch classify and fold (vtpu_hll_classify, vtpu_hll_fold).
//
// Role: the hot loop of the reference's ingest
// (server.go:1240 ReadMetricSocket -> samplers/parser.go:298
// ParseMetric), re-imagined as a batch transform: one contiguous buffer
// of newline-separated metric lines in, struct-of-arrays out
// (identity hash, type, value, weight, scope, name/line offsets), or,
// fused, straight into the table's dense staging.  Only never-seen
// series (and events/service checks/errors) take the per-line Python
// slow path.
//
// Identity hash: fold64 over the name, combined with the type code,
// the scope and a commutative sum of per-tag hashes, finalized with
// murmur3 fmix64 (see the constants below).
//
// Build: g++ -O3 -mtune=native -shared -fPIC -std=c++17 (see
// veneur_tpu_torch/native/__init__.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <vector>

#ifdef __linux__
#include <sys/socket.h>
#include <sys/syscall.h>
#include <sys/mman.h>
#include <netinet/in.h>
#include <unistd.h>
#include <errno.h>
#if defined(__NR_io_uring_setup)
#include <linux/io_uring.h>
#define VTPU_HAVE_URING 1
#endif
#endif

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

// ---- stage-1 delimiter index ---------------------------------------
// One vectorized sweep classifies the whole buffer into four bitmask
// planes (newline, colon, pipe, comma), 64 positions per word; field
// extraction then walks bits with tzcnt instead of calling memchr per
// field.  At DogStatsD line lengths (~20-60 bytes) memchr's fixed
// per-call setup dominates — five calls per line was ~40% of the
// per-line budget — while the bulk sweep costs ~0.3 cycles/byte once.

struct DelimMasks {
  const uint64_t* nl;
  const uint64_t* colon;
  const uint64_t* pipe;
  const uint64_t* comma;
  int64_t nwords;
};

thread_local std::vector<uint64_t> g_mask_scratch;

void build_masks_scalar(const uint8_t* buf, int64_t len, uint64_t* nl,
                        uint64_t* colon, uint64_t* pipe,
                        uint64_t* comma, int64_t from) {
  for (int64_t i = from; i < len; i++) {
    uint64_t bit = 1ULL << (i & 63);
    switch (buf[i]) {
      case '\n': nl[i >> 6] |= bit; break;
      case ':': colon[i >> 6] |= bit; break;
      case '|': pipe[i >> 6] |= bit; break;
      case ',': comma[i >> 6] |= bit; break;
      default: break;
    }
  }
}

#if defined(__x86_64__)
__attribute__((target("avx512bw")))
void build_masks_avx512(const uint8_t* buf, int64_t len, uint64_t* nl,
                        uint64_t* colon, uint64_t* pipe,
                        uint64_t* comma) {
  const __m512i vnl = _mm512_set1_epi8('\n');
  const __m512i vco = _mm512_set1_epi8(':');
  const __m512i vpi = _mm512_set1_epi8('|');
  const __m512i vcm = _mm512_set1_epi8(',');
  int64_t full = len & ~63LL;
  for (int64_t i = 0; i < full; i += 64) {
    __m512i a = _mm512_loadu_si512((const void*)(buf + i));
    int64_t w = i >> 6;
    nl[w] = _mm512_cmpeq_epi8_mask(a, vnl);
    colon[w] = _mm512_cmpeq_epi8_mask(a, vco);
    pipe[w] = _mm512_cmpeq_epi8_mask(a, vpi);
    comma[w] = _mm512_cmpeq_epi8_mask(a, vcm);
  }
  if (full < len)
    build_masks_scalar(buf, len, nl, colon, pipe, comma, full);
}

__attribute__((target("avx2")))
void build_masks_avx2(const uint8_t* buf, int64_t len, uint64_t* nl,
                      uint64_t* colon, uint64_t* pipe,
                      uint64_t* comma) {
  const __m256i vnl = _mm256_set1_epi8('\n');
  const __m256i vco = _mm256_set1_epi8(':');
  const __m256i vpi = _mm256_set1_epi8('|');
  const __m256i vcm = _mm256_set1_epi8(',');
  int64_t full = len & ~63LL;
  for (int64_t i = 0; i < full; i += 64) {
    __m256i a = _mm256_loadu_si256((const __m256i*)(buf + i));
    __m256i b = _mm256_loadu_si256((const __m256i*)(buf + i + 32));
    int64_t w = i >> 6;
    nl[w] = (uint32_t)_mm256_movemask_epi8(
                _mm256_cmpeq_epi8(a, vnl)) |
            ((uint64_t)(uint32_t)_mm256_movemask_epi8(
                 _mm256_cmpeq_epi8(b, vnl))
             << 32);
    colon[w] = (uint32_t)_mm256_movemask_epi8(
                   _mm256_cmpeq_epi8(a, vco)) |
               ((uint64_t)(uint32_t)_mm256_movemask_epi8(
                    _mm256_cmpeq_epi8(b, vco))
                << 32);
    pipe[w] = (uint32_t)_mm256_movemask_epi8(
                  _mm256_cmpeq_epi8(a, vpi)) |
              ((uint64_t)(uint32_t)_mm256_movemask_epi8(
                   _mm256_cmpeq_epi8(b, vpi))
               << 32);
    comma[w] = (uint32_t)_mm256_movemask_epi8(
                   _mm256_cmpeq_epi8(a, vcm)) |
               ((uint64_t)(uint32_t)_mm256_movemask_epi8(
                    _mm256_cmpeq_epi8(b, vcm))
                << 32);
  }
  if (full < len)
    build_masks_scalar(buf, len, nl, colon, pipe, comma, full);
}
#endif

DelimMasks build_masks(const uint8_t* buf, int64_t len) {
  int64_t nwords = (len + 63) >> 6;
  // a pathological batch would otherwise pin its scratch high-water
  // mark per reader thread forever (~len/2 bytes)
  constexpr size_t kShrinkAt = (64u << 20) / 8;
  if (g_mask_scratch.capacity() > kShrinkAt &&
      (size_t)(4 * nwords) <= kShrinkAt / 4) {
    g_mask_scratch.shrink_to_fit();
  }
  g_mask_scratch.resize((size_t)(4 * nwords));
  uint64_t* nl = g_mask_scratch.data();
  uint64_t* colon = nl + nwords;
  uint64_t* pipe = colon + nwords;
  uint64_t* comma = pipe + nwords;
  bool simd = false;
#if defined(__x86_64__)
  simd = __builtin_cpu_supports("avx2") != 0;
#endif
  if (simd) {
    // the sweeps '='-assign every FULL word; only the word the
    // scalar tail lands in needs pre-zeroing (full-plane zeroing
    // re-wrote ~len/2 bytes the sweep was about to overwrite)
    if (len & 63) {
      nl[nwords - 1] = 0;
      colon[nwords - 1] = 0;
      pipe[nwords - 1] = 0;
      comma[nwords - 1] = 0;
    }
#if defined(__x86_64__)
    if (__builtin_cpu_supports("avx512bw")) {
      build_masks_avx512(buf, len, nl, colon, pipe, comma);
    } else {
      build_masks_avx2(buf, len, nl, colon, pipe, comma);
    }
#endif
  } else {
    memset(g_mask_scratch.data(), 0,
           (size_t)(4 * nwords) * sizeof(uint64_t));
    build_masks_scalar(buf, len, nl, colon, pipe, comma, 0);
  }
  return DelimMasks{nl, colon, pipe, comma, nwords};
}

// first set bit in [from, limit); -1 if none
inline int64_t next_bit(const uint64_t* m, int64_t from,
                        int64_t limit) {
  if (from >= limit) return -1;
  int64_t w = from >> 6;
  int64_t wlast = (limit - 1) >> 6;
  uint64_t cur = m[w] & (~0ULL << (from & 63));
  while (!cur) {
    if (++w > wlast) return -1;
    cur = m[w];
  }
  int64_t pos = (w << 6) + __builtin_ctzll(cur);
  return pos < limit ? pos : -1;
}

constexpr uint64_t kFnvOffset = 14695981039346656037ULL;
constexpr uint64_t kFnvPrime = 1099511628211ULL;

inline uint64_t fnv1a64(uint64_t h, const uint8_t* p, int64_t n) {
  for (int64_t i = 0; i < n; i++) h = (h ^ p[i]) * kFnvPrime;
  return h;
}

inline uint64_t fmix64(uint64_t h) {
  h ^= h >> 33;
  h *= 0xFF51AFD7ED558CCDULL;
  h ^= h >> 33;
  h *= 0xC4CEB9FE1A85EC53ULL;
  h ^= h >> 33;
  return h;
}

// FNV-style fold of 8 little-endian bytes per multiply (the
// byte-serial loop's 3-cycle dependent multiply per byte dominated
// parse time), tail zero-padded, length mixed in so padding can't
// collide.  No finalizer — the identity hash combines folds and
// fmix64s at the end.  MUST stay bit-identical to _fold64 in
// veneur_tpu/utils/hashing.py.
inline uint64_t fold64(const uint8_t* p, size_t n) {
  uint64_t h = kFnvOffset;
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t c;
    memcpy(&c, p + i, 8);
    h = (h ^ c) * kFnvPrime;
  }
  if (i < n) {
    uint64_t c = 0;
    memcpy(&c, p + i, n - i);
    h = (h ^ c) * kFnvPrime;
  }
  return h ^ (uint64_t)n;
}

// Series-identity hash constants (must match utils/hashing.py):
// key = fmix64( fold64(name) ^ fmix64(type*C1 ^ scope*C2 + tagsum) )
// where tagsum = sum of fmix64(fold64(tag)) — commutative, so tag
// ORDER is irrelevant without any sort or assembly buffer.
constexpr uint64_t kKeyTypeMult = 0x9E3779B97F4A7C15ULL;
constexpr uint64_t kKeyScopeMult = 0xC2B2AE3D27D4EB4FULL;

// Fast float parse over a byte slice.  Handles [+-]digits[.digits] with
// an exact digit accumulator; falls back to strtod for exponents and
// other rarities.  Returns false on malformed.
bool parse_value(const uint8_t* p, int64_t n, double* out) {
  if (n <= 0 || n > 64) return false;
  if (n == 1) {  // ":1|c" style single-digit values dominate counters
    const unsigned d = (unsigned)p[0] - '0';
    if (d > 9) return false;
    *out = (double)d;
    return true;
  }
  int64_t i = 0;
  bool neg = false;
  if (p[0] == '-') { neg = true; i = 1; }
  else if (p[0] == '+') { i = 1; }
  if (i >= n) return false;
  uint64_t ipart = 0;
  int idig = 0;
  while (i < n && p[i] >= '0' && p[i] <= '9') {
    if (idig < 18) { ipart = ipart * 10 + (p[i] - '0'); idig++; }
    else goto slow;  // precision overflow: use strtod
    i++;
  }
  if (i == n) {
    if (idig == 0) return false;
    *out = neg ? -(double)ipart : (double)ipart;
    return true;
  }
  if (p[i] == '.') {
    i++;
    {
      uint64_t fpart = 0;
      int fdig = 0;
      while (i < n && p[i] >= '0' && p[i] <= '9') {
        if (fdig < 18) { fpart = fpart * 10 + (p[i] - '0'); fdig++; }
        i++;
      }
      if (i != n || (idig == 0 && fdig == 0)) {
        if (i < n) goto slow;
        return false;
      }
      static const double kPow10[19] = {
          1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10,
          1e11, 1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18};
      double v = (double)ipart + (double)fpart / kPow10[fdig];
      *out = neg ? -v : v;
      return true;
    }
  }
slow: {
    char tmp[65];
    memcpy(tmp, p, n);
    tmp[n] = 0;
    char* end = nullptr;
    double v = strtod(tmp, &end);
    if (end != tmp + n) return false;
    if (!std::isfinite(v)) return false;
    *out = v;
    return true;
  }
}

// ---- io_uring multishot ring ingest --------------------------------
// The kernel-efficient rung above recvmmsg (ROADMAP item 1): one
// registered ring per reader socket, a kernel-provided buffer pool the
// NIC path fills on its own, and a multishot IORING_OP_RECV that keeps
// completing into pool buffers with ZERO per-packet (and, steady
// state, zero per-batch) syscalls.  Userspace walks the completion
// queue and hands each datagram to the fused parse pass IN PLACE —
// the buffer the kernel wrote is the buffer the parser reads; the
// recvmmsg tier's join/copy round disappears.
//
// The system uapi header in the build image predates buffer rings and
// multishot receive (both runtime features of this kernel), so the
// few constants and the two structs involved are defined locally, the
// way liburing itself carries them.  Everything degrades at runtime:
// io_uring_setup ENOSYS/EPERM, PBUF_RING EINVAL on an old kernel, or
// a multishot arm rejected with EINVAL all surface as a dead handle
// and the caller falls back to the recvmmsg tier.
#ifdef VTPU_HAVE_URING

#ifndef IORING_RECV_MULTISHOT
#define IORING_RECV_MULTISHOT (1U << 1)
#endif
#ifndef IORING_REGISTER_PBUF_RING
#define IORING_REGISTER_PBUF_RING 22
#define IORING_UNREGISTER_PBUF_RING 23
#endif
#ifndef IORING_CQE_BUFFER_SHIFT
#define IORING_CQE_BUFFER_SHIFT 16
#endif
#ifndef IORING_OFF_SQ_RING
#define IORING_OFF_SQ_RING 0ULL
#define IORING_OFF_CQ_RING 0x8000000ULL
#define IORING_OFF_SQES 0x10000000ULL
#endif

// local twins of io_uring_buf / io_uring_buf_reg (absent from the old
// header); the ring's shared tail overlays byte 14 of entry 0
struct VtpuIoBuf {
  __u64 addr;
  __u32 len;
  __u16 bid;
  __u16 resv;
};
struct VtpuBufReg {
  __u64 ring_addr;
  __u32 ring_entries;
  __u16 bgid;
  __u16 pad;
  __u64 resv[3];
};
struct VtpuGeteventsArg {
  __u64 sigmask;
  __u32 sigmask_sz;
  __u32 pad;
  __u64 ts;
};
struct VtpuKtimespec {
  int64_t tv_sec;
  long long tv_nsec;
};

inline int sys_uring_setup(unsigned entries, struct io_uring_params* p) {
  return (int)syscall(__NR_io_uring_setup, entries, p);
}
inline int sys_uring_enter(int fd, unsigned to_submit,
                           unsigned min_complete, unsigned flags,
                           const void* arg, size_t argsz) {
  return (int)syscall(__NR_io_uring_enter, fd, to_submit,
                      min_complete, flags, arg, argsz);
}
inline int sys_uring_register(int fd, unsigned op, void* arg,
                              unsigned nr) {
  return (int)syscall(__NR_io_uring_register, fd, op, arg, nr);
}

// completion-batch histogram: power-of-two buckets 1,2,4,...,>=512
constexpr int kUringHistBuckets = 10;

struct VtpuUring {
  int ring_fd = -1;
  int sock_fd = -1;
  // SQ/CQ mappings
  void* sq_mem = nullptr;
  size_t sq_sz = 0;
  void* cq_mem = nullptr;   // == sq_mem under FEAT_SINGLE_MMAP
  size_t cq_sz = 0;
  struct io_uring_sqe* sqes = nullptr;
  size_t sqes_sz = 0;
  unsigned* sq_head = nullptr;
  unsigned* sq_tail = nullptr;
  unsigned sq_mask = 0;
  unsigned* sq_array = nullptr;
  unsigned* cq_head = nullptr;
  unsigned* cq_tail = nullptr;
  unsigned cq_mask = 0;
  struct io_uring_cqe* cqes = nullptr;
  // provided-buffer ring (kernel 5.19+), page-aligned mmap
  void* buf_ring = nullptr;
  size_t buf_ring_sz = 0;
  uint16_t buf_tail = 0;       // local shadow of the shared tail
  uint8_t* arena = nullptr;    // caller-owned: buf_count * buf_len
  int32_t buf_count = 0;       // power of two
  int32_t buf_len = 0;
  uint16_t bgid = 0;
  bool armed = false;
  int dead_errno = 0;          // nonzero: backend unusable at runtime
  // buffers consumed by the zero-copy parse pass, HELD out of the
  // pool until vtpu_uring_release (miss/slow lines point into them)
  std::vector<int32_t> held_bid;
  std::vector<int32_t> held_len;
  // counters for /debug/vars
  int64_t completions = 0;
  int64_t oversize = 0;
  int64_t enobufs = 0;
  int64_t rearms = 0;
  int64_t batches = 0;
  int64_t returned = 0;        // buffers handed to the kernel (cumul)
  int64_t consumed = 0;        // buffers taken back via CQEs (cumul)
  int64_t hist[kUringHistBuckets] = {0};
};

inline void uring_buf_store_tail(VtpuUring* u) {
  __atomic_store_n((uint16_t*)((char*)u->buf_ring + 14),
                   u->buf_tail, __ATOMIC_RELEASE);
}

// return one buffer to the provided-buffer ring (tail publish is the
// caller's, so a recycle sweep pays one release store)
inline void uring_buf_recycle(VtpuUring* u, int32_t bid) {
  VtpuIoBuf* e = (VtpuIoBuf*)u->buf_ring
      + (u->buf_tail & (uint16_t)(u->buf_count - 1));
  e->addr = (uint64_t)(uintptr_t)(u->arena
                                  + (int64_t)bid * u->buf_len);
  e->len = (uint32_t)u->buf_len;
  e->bid = (uint16_t)bid;
  u->buf_tail++;
  u->returned++;
}

// arm (or re-arm) the multishot receive; returns 0 or -errno.  One
// SQE outlives many completions — this runs only at startup and
// after a terminal CQE (ENOBUFS, error, or kernel-side cancel).
inline int uring_arm(VtpuUring* u) {
  if (u->dead_errno) return -u->dead_errno;
  unsigned tail = *u->sq_tail;
  unsigned idx = tail & u->sq_mask;
  struct io_uring_sqe* sqe = &u->sqes[idx];
  memset(sqe, 0, sizeof(*sqe));
  sqe->opcode = IORING_OP_RECV;
  sqe->fd = u->sock_fd;
  sqe->flags = IOSQE_BUFFER_SELECT;
  sqe->ioprio = IORING_RECV_MULTISHOT;
  sqe->buf_group = u->bgid;
  sqe->user_data = 1;
  u->sq_array[idx] = idx;
  __atomic_store_n(u->sq_tail, tail + 1, __ATOMIC_RELEASE);
  int r = sys_uring_enter(u->ring_fd, 1, 0, 0, nullptr, 0);
  if (r < 0) return -errno;
  u->armed = true;
  u->rearms++;
  return 0;
}

// block until >= min_batch CQEs are pending or wait_ms elapses; 0 =
// something pending, -ETIME = nothing pending, other negative =
// enter error.  min_batch > 1 is the multishot payoff on a loaded
// host: completions accumulate KERNEL-SIDE (no syscall, no wakeup)
// while the sender keeps the CPU, then one walk drains the batch —
// recvmmsg can only approximate that by burning a syscall per poll.
// A partial batch at timeout is returned, never discarded.
inline int uring_wait(VtpuUring* u, int32_t wait_ms,
                      int32_t min_batch) {
  if (min_batch < 1) min_batch = 1;
  unsigned head = *u->cq_head;
  unsigned avail =
      __atomic_load_n(u->cq_tail, __ATOMIC_ACQUIRE) - head;
  // anything already pending is processed NOW, even below
  // min_batch: under load the CQ accumulates naturally while the
  // previous batch parses (that IS the batching), and a pending CQE
  // may be a multishot termination our armed flag hasn't seen yet —
  // batch-waiting on a dead multishot would sleep the full timeout
  // while the socket queue overflows.  Only an EMPTY CQ (where the
  // armed flag is provably current) may wait for a batch.
  if (avail != 0) return 0;
  // an unarmed ring posts no new completions: re-arm if buffers are
  // free, otherwise report empty so the caller releases held ones.
  if (!u->armed) {
    if (u->dead_errno == 0 && u->returned - u->consumed > 0) {
      int r = uring_arm(u);
      if (r < 0) u->dead_errno = -r;
    }
    if (!u->armed) return -ETIME;
  }
  if (wait_ms <= 0) return -ETIME;
  VtpuKtimespec ts;
  ts.tv_sec = wait_ms / 1000;
  ts.tv_nsec = (long long)(wait_ms % 1000) * 1000000LL;
  VtpuGeteventsArg arg;
  memset(&arg, 0, sizeof(arg));
  arg.ts = (uint64_t)(uintptr_t)&ts;
  int r = sys_uring_enter(u->ring_fd, 0, (unsigned)min_batch,
                          IORING_ENTER_GETEVENTS | IORING_ENTER_EXT_ARG,
                          &arg, sizeof(arg));
  if (r < 0) {
    int e = errno;
    if (e != ETIME && e != EINTR) return -e;
  }
  // timeout with a partial batch still returns it
  if (__atomic_load_n(u->cq_tail, __ATOMIC_ACQUIRE) != head) return 0;
  return -ETIME;
}

inline void uring_note_batch(VtpuUring* u, int64_t n) {
  if (n <= 0) return;
  u->batches++;
  int b = 0;
  while ((1LL << b) < n && b < kUringHistBuckets - 1) b++;
  u->hist[b]++;
}

void uring_destroy(VtpuUring* u) {
  if (u == nullptr) return;
  if (u->ring_fd >= 0) {
    if (u->buf_ring != nullptr) {
      VtpuBufReg reg;
      memset(&reg, 0, sizeof(reg));
      reg.bgid = u->bgid;
      sys_uring_register(u->ring_fd, IORING_UNREGISTER_PBUF_RING,
                         &reg, 1);
    }
    close(u->ring_fd);
  }
  if (u->buf_ring != nullptr) munmap(u->buf_ring, u->buf_ring_sz);
  if (u->sqes != nullptr) munmap(u->sqes, u->sqes_sz);
  if (u->cq_mem != nullptr && u->cq_mem != u->sq_mem)
    munmap(u->cq_mem, u->cq_sz);
  if (u->sq_mem != nullptr) munmap(u->sq_mem, u->sq_sz);
  delete u;
}

#endif  // VTPU_HAVE_URING

}  // namespace

extern "C" {

// Type codes shared with protocol/columnar.py
enum : uint8_t {
  T_COUNTER = 0, T_GAUGE = 1, T_TIMER = 2, T_HISTOGRAM = 3, T_SET = 4,
  T_EVENT = 250, T_SERVICE_CHECK = 251, T_ERROR = 255,
};

// Parse newline-separated DogStatsD lines from buf[0:len].
// All output arrays must have capacity >= the number of lines.
// Returns the number of lines written, or, when capacity runs out
// mid-buffer, -(total nonempty lines in buf) so the caller can grow
// its scratch and retry — counting lines up front cost more than the
// parse itself (bytes.count on a 75MB batch was ~60ms; the rare
// retry is free in steady state because reader batches are bounded).
// Per-line grammar core shared by the column writer
// (vtpu_parse_batch) and the fused parse+combine pass
// (vtpu_parse_ingest).  Returns the line's type code; for metric
// codes (<= T_SET) every LineParse field is valid, for
// event/service-check/error codes only tc is.
struct LineParse {
  uint8_t tc;
  uint8_t scope;
  float weight;
  double value;     // non-set metrics
  uint64_t member;  // sets
  uint64_t key;
};

inline uint8_t parse_line_general(const uint8_t* buf, int64_t start,
                                  int64_t eol, const DelimMasks& dm,
                                  LineParse* o) {
  const uint8_t* line = buf + start;
  const int64_t n = eol - start;

  // events / service checks -> slow path
  if (n >= 3 && line[0] == '_') {
    if (line[1] == 'e' && line[2] == '{') return T_EVENT;
    if (n >= 4 && line[1] == 's' && line[2] == 'c' &&
        line[3] == '|') return T_SERVICE_CHECK;
  }

  // name:value|type[|@rate][|#tags] — all field positions come
  // from the stage-1 masks (absolute buffer offsets)
  const int64_t ca = next_bit(dm.colon, start, eol);
  if (ca < 0 || ca == start) return T_ERROR;
  // a '|' before the colon means the first pipe-section has no
  // name:value pair — the reference splits on '|' FIRST and rejects
  // such lines (samplers/parser.go:307), so must we
  if (next_bit(dm.pipe, start, ca) >= 0) return T_ERROR;
  const int64_t pa = next_bit(dm.pipe, ca + 1, eol);
  if (pa < 0 || pa == ca + 1) return T_ERROR;
  int64_t te = next_bit(dm.pipe, pa + 1, eol);
  if (te < 0) te = eol;
  int64_t tlen = te - (pa + 1);
  uint8_t tc;
  uint8_t t0 = tlen >= 1 ? buf[pa + 1] : 0;
  if (tlen == 1) {
    switch (t0) {
      case 'c': tc = T_COUNTER; break;
      case 'g': tc = T_GAUGE; break;
      case 'm': tc = T_TIMER; break;
      case 'h': tc = T_HISTOGRAM; break;
      case 'd': tc = T_HISTOGRAM; break;
      case 's': tc = T_SET; break;
      default: return T_ERROR;
    }
  } else if (tlen == 2 && t0 == 'm' && buf[pa + 2] == 's') {
    tc = T_TIMER;
  } else {
    return T_ERROR;
  }

  // optional sections.  Tags accumulate into a commutative identity
  // sum as they are scanned — no tag array, no sort, no assembly
  // (that stage was half the per-line cost of the payload-hash
  // design), and no tag-count cap.
  double rate = 1.0;
  uint64_t tagsum = 0;
  uint8_t sc = 0;
  int64_t sec = te;
  while (sec < eol) {
    // sec points at '|'
    int64_t s0 = sec + 1;
    if (s0 >= eol) return T_ERROR;
    int64_t s1 = next_bit(dm.pipe, s0, eol);
    if (s1 < 0) s1 = eol;
    if (buf[s0] == '@') {
      if (!parse_value(buf + s0 + 1, s1 - s0 - 1, &rate) ||
          !(rate > 0.0 && rate <= 1.0)) {
        return T_ERROR;
      }
    } else if (buf[s0] == '#') {
      // a later '#' section REPLACES tags and scope (the reference
      // overwrites tags per section; last one wins)
      tagsum = 0;
      sc = 0;
      int64_t t = s0 + 1;
      while (t <= s1) {
        int64_t e = next_bit(dm.comma, t, s1);
        if (e < 0) e = s1;
        int64_t L = e - t;
        if (L > 0) {
          // scope magic tags: prefix match as the reference does
          // (parser.go:397-407); first-byte guard keeps the memcmp
          // off the per-tag hot path
          if (buf[t] == 'v' && L >= 15 &&
              memcmp(buf + t, "veneurlocalonly", 15) == 0) {
            sc = 1;
          } else if (buf[t] == 'v' && L >= 16 &&
                     memcmp(buf + t, "veneurglobalonly", 16) == 0) {
            sc = 2;
          } else {
            tagsum += fmix64(fold64(buf + t, (size_t)L));
          }
        }
        t = e + 1;
      }
    } else {
      return T_ERROR;
    }
    sec = s1;
  }
  if (tc == T_GAUGE && rate != 1.0) return T_ERROR;

  int64_t vlen = pa - (ca + 1);
  if (tc == T_SET) {
    o->member = fmix64(fnv1a64(kFnvOffset, buf + ca + 1, vlen));
  } else {
    double v;
    if (!parse_value(buf + ca + 1, vlen, &v) ||
        !std::isfinite(v)) {
      return T_ERROR;
    }
    o->value = v;
  }
  o->weight = (float)(1.0 / rate);
  o->scope = sc;
  o->key = fmix64(
      fold64(buf + start, (size_t)(ca - start)) ^
      fmix64((((uint64_t)tc * kKeyTypeMult) ^
              ((uint64_t)sc * kKeyScopeMult)) + tagsum));
  o->tc = tc;
  return tc;
}

// ---- short-line fast path -------------------------------------------
// Lines of <= 64 bytes (virtually all DogStatsD traffic) fit in ONE
// 64-bit line-relative delimiter mask per plane: two funnel-shifted
// word loads replace every next_bit call, and all field navigation is
// register bit arithmetic (ctz + clear-lowest).  The general path
// above stays the single source of truth for longer lines; the fuzz
// agreement tests pin the two paths (and the pure-Python parser) to
// identical outputs.

inline uint64_t mask_below(int64_t x) {
  return x >= 64 ? ~0ULL : ((1ULL << x) - 1);
}

// bits of plane m for line-relative positions [0, n), n <= 64
inline uint64_t rel_mask(const uint64_t* m, int64_t nwords,
                         int64_t start, int64_t n) {
  const int64_t w = start >> 6;
  const int s = (int)(start & 63);
  uint64_t lo = m[w] >> s;
  // w+1 >= nwords only when every position it would contribute lies
  // past the buffer (and so past this line) — safe to skip
  if (s && w + 1 < nwords) lo |= m[w + 1] << (64 - s);
  return lo & mask_below(n);
}

inline uint8_t parse_line_fast(const uint8_t* buf, int64_t start,
                               int64_t n, const DelimMasks& dm,
                               LineParse* o) {
  const uint8_t* line = buf + start;

  // events / service checks -> slow path
  if (n >= 3 && line[0] == '_') {
    if (line[1] == 'e' && line[2] == '{') return T_EVENT;
    if (n >= 4 && line[1] == 's' && line[2] == 'c' &&
        line[3] == '|') return T_SERVICE_CHECK;
  }

  uint64_t mc = rel_mask(dm.colon, dm.nwords, start, n);
  uint64_t mp = rel_mask(dm.pipe, dm.nwords, start, n);
  if (!mc) return T_ERROR;
  const int64_t ca = __builtin_ctzll(mc);
  if (ca == 0) return T_ERROR;
  if (!mp) return T_ERROR;
  const int64_t pa = __builtin_ctzll(mp);
  // a '|' before the colon means the first pipe-section has no
  // name:value pair — reject as the reference does (parser.go:307)
  if (pa < ca) return T_ERROR;
  if (pa == ca + 1) return T_ERROR;
  mp &= mp - 1;
  const int64_t te = mp ? __builtin_ctzll(mp) : n;
  const int64_t tlen = te - (pa + 1);
  uint8_t tc;
  const uint8_t t0 = tlen >= 1 ? line[pa + 1] : 0;
  if (tlen == 1) {
    switch (t0) {
      case 'c': tc = T_COUNTER; break;
      case 'g': tc = T_GAUGE; break;
      case 'm': tc = T_TIMER; break;
      case 'h': tc = T_HISTOGRAM; break;
      case 'd': tc = T_HISTOGRAM; break;
      case 's': tc = T_SET; break;
      default: return T_ERROR;
    }
  } else if (tlen == 2 && t0 == 'm' && line[pa + 2] == 's') {
    tc = T_TIMER;
  } else {
    return T_ERROR;
  }

  double rate = 1.0;
  uint64_t tagsum = 0;
  uint8_t sc = 0;
  int64_t sec = te;
  while (sec < n) {
    // sec points at '|'; its bit is mp's lowest — pop it
    const int64_t s0 = sec + 1;
    if (s0 >= n) return T_ERROR;
    mp &= mp - 1;
    const int64_t s1 = mp ? __builtin_ctzll(mp) : n;
    if (line[s0] == '@') {
      if (!parse_value(line + s0 + 1, s1 - s0 - 1, &rate) ||
          !(rate > 0.0 && rate <= 1.0)) {
        return T_ERROR;
      }
    } else if (line[s0] == '#') {
      // a later '#' section REPLACES tags and scope (last one wins)
      tagsum = 0;
      sc = 0;
      uint64_t mt = rel_mask(dm.comma, dm.nwords, start, n) &
                    mask_below(s1) & ~mask_below(s0 + 1);
      int64_t t = s0 + 1;
      while (t <= s1) {
        const int64_t e = mt ? __builtin_ctzll(mt) : s1;
        mt &= mt - 1;
        const int64_t L = e - t;
        if (L > 0) {
          // scope magic tags: prefix match as the reference does
          // (parser.go:397-407)
          if (line[t] == 'v' && L >= 15 &&
              memcmp(line + t, "veneurlocalonly", 15) == 0) {
            sc = 1;
          } else if (line[t] == 'v' && L >= 16 &&
                     memcmp(line + t, "veneurglobalonly", 16) == 0) {
            sc = 2;
          } else {
            tagsum += fmix64(fold64(line + t, (size_t)L));
          }
        }
        t = e + 1;
      }
    } else {
      return T_ERROR;
    }
    sec = s1;
  }
  if (tc == T_GAUGE && rate != 1.0) return T_ERROR;

  const int64_t vlen = pa - (ca + 1);
  if (tc == T_SET) {
    o->member = fmix64(fnv1a64(kFnvOffset, line + ca + 1, vlen));
  } else {
    double v;
    if (!parse_value(line + ca + 1, vlen, &v) ||
        !std::isfinite(v)) {
      return T_ERROR;
    }
    o->value = v;
  }
  o->weight = (float)(1.0 / rate);
  o->scope = sc;
  o->key = fmix64(
      fold64(line, (size_t)ca) ^
      fmix64((((uint64_t)tc * kKeyTypeMult) ^
              ((uint64_t)sc * kKeyScopeMult)) + tagsum));
  o->tc = tc;
  return tc;
}

inline uint8_t parse_line_core(const uint8_t* buf, int64_t start,
                               int64_t eol, const DelimMasks& dm,
                               LineParse* o) {
  const int64_t n = eol - start;
  if (n <= 64) return parse_line_fast(buf, start, n, dm, o);
  return parse_line_general(buf, start, eol, dm, o);
}

int64_t vtpu_parse_batch(
    const uint8_t* buf, int64_t len,
    uint64_t* key_hash, uint8_t* type_code, double* value,
    uint64_t* member_hash, float* weight, uint8_t* scope,
    int64_t* line_off, int32_t* line_len, int64_t max_lines) {
  DelimMasks dm = build_masks(buf, len);
  int64_t out = 0;
  int64_t pos = 0;
  while (pos < len) {
    int64_t nlp = next_bit(dm.nl, pos, len);
    const int64_t eol = nlp < 0 ? len : nlp;
    int64_t n = eol - pos;
    int64_t start = pos;
    pos = eol + 1;
    if (n == 0) continue;
    if (out >= max_lines) {
      // scratch too small: finish counting nonempty lines and signal
      int64_t total = out + 1;
      while (pos < len) {
        int64_t nl2 = next_bit(dm.nl, pos, len);
        const int64_t eol2 = nl2 < 0 ? len : nl2;
        if (eol2 > pos) total++;
        pos = eol2 + 1;
      }
      return -total;
    }

    line_off[out] = start;
    line_len[out] = (int32_t)n;
    // the other columns are NOT pre-zeroed: every consumer masks by
    // type_code first (value unused for sets, member_hash unused for
    // non-sets, all of them unused for error/event lines), and
    // key_hash/weight/scope are unconditionally assigned on the
    // metric success path below — 5 scattered stores per line saved
    LineParse lp;
    uint8_t tc = parse_line_core(buf, start, eol, dm, &lp);
    type_code[out] = tc;
    if (tc <= T_SET) {
      if (tc == T_SET) member_hash[out] = lp.member;
      else value[out] = lp.value;
      weight[out] = lp.weight;
      scope[out] = lp.scope;
      key_hash[out] = lp.key;
    }
    out++;
  }
  return out;
}

// Non-blocking bulk datagram drain: one recvmmsg syscall pulls up to
// max_msgs datagrams straight into ``out`` (iovecs at a fixed
// max_len+1 stride), then an in-place forward compaction joins them
// with newlines for the columnar parser.  Replaces the per-packet
// recv loop whose ~1-2us/packet of syscall + bytes-object overhead
// capped a reader near 500k packets/s.  Returns bytes written (0 =
// nothing pending); *n_msgs gets the datagram count.  The caller's
// BLOCKING first read stays in Python for shutdown responsiveness.
int64_t vtpu_recv_drain(int32_t fd, uint8_t* out, int64_t out_cap,
                        int32_t max_msgs, int32_t max_len,
                        int32_t* n_msgs, int32_t* n_oversize) {
#ifndef __linux__
  // recvmmsg is Linux-only; elsewhere the caller's blocking loop
  // handles every packet (the rest of the library still builds)
  (void)fd; (void)out; (void)out_cap; (void)max_msgs; (void)max_len;
  *n_msgs = 0;
  *n_oversize = 0;
  return 0;
#else
  constexpr int kMax = 512;
  if (max_msgs > kMax) max_msgs = kMax;
  const int64_t stride = (int64_t)max_len + 1;
  if ((int64_t)max_msgs * stride > out_cap) {
    max_msgs = (int32_t)(out_cap / stride);
  }
  *n_msgs = 0;
  *n_oversize = 0;
  if (max_msgs <= 0) return 0;
  struct mmsghdr hdrs[kMax];
  struct iovec iovs[kMax];
  memset(hdrs, 0, sizeof(struct mmsghdr) * (size_t)max_msgs);
  for (int i = 0; i < max_msgs; i++) {
    iovs[i].iov_base = out + (int64_t)i * stride;
    iovs[i].iov_len = (size_t)max_len;
    hdrs[i].msg_hdr.msg_iov = &iovs[i];
    hdrs[i].msg_hdr.msg_iovlen = 1;
  }
  int got = recvmmsg(fd, hdrs, (unsigned)max_msgs, MSG_DONTWAIT,
                     nullptr);
  if (got <= 0) return 0;  // EAGAIN/err: blocking loop handles it
  // forward compaction: write_ptr never passes a source start because
  // sum(len_j + 1) <= i * stride.  Datagrams past max_len arrive
  // MSG_TRUNC-flagged and are REJECTED whole (the reference drops
  // oversize packets, server.go:1254; a truncated tail line could
  // otherwise parse as a valid wrong value).
  int64_t w = 0;
  int kept = 0;
  for (int i = 0; i < got; i++) {
    if (hdrs[i].msg_hdr.msg_flags & MSG_TRUNC) {
      (*n_oversize)++;
      continue;
    }
    const int64_t len = hdrs[i].msg_len;
    if (len == 0) continue;
    memmove(out + w, out + (int64_t)i * stride, (size_t)len);
    w += len;
    out[w++] = '\n';
    kept++;
  }
  *n_msgs = kept;
  return w;
#endif  // __linux__
}

// Vectorized member hasher for HLL set values arriving via the slow
// path — must match hash64 in utils/hashing.py.
void vtpu_hash_members(const uint8_t* buf, const int64_t* offs,
                       const int64_t* lens, int64_t n, uint64_t* out) {
  for (int64_t i = 0; i < n; i++) {
    out[i] = fmix64(fnv1a64(kFnvOffset, buf + offs[i], lens[i]));
  }
}

// ---------------------------------------------------------------------
// Identity index: open-addressing u64 key -> i32 row, the native twin
// of utils/intern.HashIndex (same sentinels: -1 missing, -2 dropped;
// key 0 aliased so the empty-slot sentinel stays unambiguous).  Owned
// by C++ so the per-batch lookup+combine below runs without crossing
// back into Python per probe round.
//
// Concurrency contract (the multi-reader fused path): PROBES are
// lock-free and may run from any number of reader threads with no
// lock held; MUTATIONS (insert/clear) are serialized by the caller
// (the Python table lock).  The slot array lives in an immutable-
// capacity inner table published through an atomic pointer: growth
// and clear build a fresh inner table and swap the pointer (RCU), so
// a concurrent prober keeps walking a complete, self-consistent old
// table and at worst misses a brand-new key — which lands it on the
// miss path, where resolution under the lock is idempotent.  Retired
// tables are reclaimed only at quiescent instants (the probe
// refcount reads zero inside a mutation, which the lock serializes).
// Slot publication orders val before key (release/acquire) so a
// prober that sees a key always sees its row.

struct VtpuTab {
  uint64_t* keys;
  int32_t* vals;
  int64_t cap;  // power of two
};

struct VtpuIndex {
  std::atomic<VtpuTab*> tab;
  int64_t count;                 // writer-only (caller-serialized)
  std::atomic<int64_t> readers;  // lock-free probe passes in flight
  std::vector<VtpuTab*> retired;
};

static constexpr uint64_t kZeroAlias = 0x9E3779B97F4A7C15ULL;

static inline uint64_t canon_key(uint64_t k) {
  return k ? k : kZeroAlias;
}

static VtpuTab* tab_alloc(int64_t cap) {
  VtpuTab* tb = new VtpuTab;
  tb->cap = cap;
  tb->keys = (uint64_t*)calloc((size_t)cap, 8);
  tb->vals = (int32_t*)malloc((size_t)cap * 4);
  for (int64_t i = 0; i < cap; i++) tb->vals[i] = -1;
  return tb;
}

static void tab_free(VtpuTab* tb) {
  free(tb->keys);
  free(tb->vals);
  delete tb;
}

static inline int32_t tab_get(const VtpuTab* tb, uint64_t key) {
  key = canon_key(key);
  uint64_t mask = (uint64_t)tb->cap - 1;
  uint64_t i = key & mask;
  for (;;) {
    uint64_t k = __atomic_load_n(&tb->keys[i], __ATOMIC_ACQUIRE);
    if (k == key)
      return __atomic_load_n(&tb->vals[i], __ATOMIC_RELAXED);
    if (k == 0) return -1;
    i = (i + 1) & mask;
  }
}

// Pin the current inner table for a whole probe pass.  seq_cst pairs
// with the seq_cst readers check in index_sweep: the refcount bump
// can't be reordered after the pointer load, so a table this pass
// can observe is never one a sweep may free.
static inline const VtpuTab* index_enter(VtpuIndex* t) {
  t->readers.fetch_add(1, std::memory_order_seq_cst);
  return t->tab.load(std::memory_order_seq_cst);
}

static inline void index_exit(VtpuIndex* t) {
  t->readers.fetch_sub(1, std::memory_order_release);
}

// Free retired tables once no probe pass is in flight.  Runs only on
// the caller-serialized mutation path, after the new table pointer is
// published: readers == 0 here means nobody can still hold a retired
// pointer, and later entrants load the new table.
static void index_sweep(VtpuIndex* t) {
  if (!t->retired.empty() &&
      t->readers.load(std::memory_order_seq_cst) == 0) {
    for (VtpuTab* tb : t->retired) tab_free(tb);
    t->retired.clear();
  }
}

static void tab_put(VtpuTab* tb, uint64_t key, int32_t val,
                    int64_t* count) {
  key = canon_key(key);
  uint64_t mask = (uint64_t)tb->cap - 1;
  uint64_t i = key & mask;
  for (;;) {
    uint64_t k = tb->keys[i];  // single writer: plain load is exact
    if (k == 0) {
      __atomic_store_n(&tb->vals[i], val, __ATOMIC_RELAXED);
      __atomic_store_n(&tb->keys[i], key, __ATOMIC_RELEASE);
      if (count) (*count)++;
      return;
    }
    if (k == key) {
      __atomic_store_n(&tb->vals[i], val, __ATOMIC_RELEASE);
      return;
    }
    i = (i + 1) & mask;
  }
}

static void index_grow(VtpuIndex* t) {
  VtpuTab* old = t->tab.load(std::memory_order_relaxed);
  VtpuTab* nt = tab_alloc(old->cap * 2);
  for (int64_t i = 0; i < old->cap; i++) {
    if (old->keys[i]) tab_put(nt, old->keys[i], old->vals[i], nullptr);
  }
  t->tab.store(nt, std::memory_order_seq_cst);
  t->retired.push_back(old);
  index_sweep(t);
}

static void index_put(VtpuIndex* t, uint64_t key, int32_t val) {
  VtpuTab* tb = t->tab.load(std::memory_order_relaxed);
  if (t->count * 5 >= tb->cap * 3) {
    index_grow(t);
    tb = t->tab.load(std::memory_order_relaxed);
  }
  tab_put(tb, key, val, &t->count);
}

void* vtpu_index_new(int64_t capacity) {
  int64_t cap = 1024;
  while (cap < capacity) cap <<= 1;
  VtpuIndex* t = new VtpuIndex;
  t->tab.store(tab_alloc(cap), std::memory_order_relaxed);
  t->count = 0;
  t->readers.store(0, std::memory_order_relaxed);
  return t;
}

void vtpu_index_free(void* p) {
  VtpuIndex* t = (VtpuIndex*)p;
  for (VtpuTab* tb : t->retired) tab_free(tb);
  tab_free(t->tab.load(std::memory_order_relaxed));
  delete t;
}

void vtpu_index_clear(void* p) {
  VtpuIndex* t = (VtpuIndex*)p;
  VtpuTab* old = t->tab.load(std::memory_order_relaxed);
  t->tab.store(tab_alloc(old->cap), std::memory_order_seq_cst);
  t->retired.push_back(old);
  t->count = 0;
  index_sweep(t);
}

void vtpu_index_insert(void* p, uint64_t key, int32_t val) {
  VtpuIndex* t = (VtpuIndex*)p;
  index_put(t, key, val);
  index_sweep(t);  // opportunistic reclaim of retired tables
}

int64_t vtpu_index_count(void* p) { return ((VtpuIndex*)p)->count; }

// Probe passes in flight right now — observability for the
// multi-reader concurrency tests, not part of the ingest contract.
int64_t vtpu_index_readers(void* p) {
  return ((VtpuIndex*)p)->readers.load(std::memory_order_relaxed);
}

void vtpu_index_lookup(void* p, const uint64_t* keys, int64_t n,
                       int32_t* out) {
  VtpuIndex* t = (VtpuIndex*)p;
  const VtpuTab* tb = index_enter(t);
  for (int64_t i = 0; i < n; i++) out[i] = tab_get(tb, keys[i]);
  index_exit(t);
}

// ---------------------------------------------------------------------
// One-pass ingest: for every parsed metric line, probe the identity
// index and combine straight into per-class staging — dense
// accumulation for counters (associative add) and gauges (last-write),
// append columns for histos (the digest needs the raw distribution)
// and sets (packed HLL position).  This is the whole of
// MetricTable.ingest_columns' numpy pass pipeline in one cache-friendly
// loop; the Python side only resolves never-seen keys (slow parse +
// row allocation) and re-runs the ingest over the recorded miss lines.
//
// meta in/out layout: [0]=histo append cursor, [1]=set append cursor,
// [2]=miss count (out only), [3]=processed (metric lines with a
// resolved key, incl. dropped), [4]=counter hits, [5]=gauge hits,
// [6..10]=dropped per type code 0..4.
// One resolved metric sample into the dense/staged outputs — shared
// by the column combiner (vtpu_ingest) and the fused pass
// (vtpu_parse_ingest) so the two ingest paths cannot desync.
inline void combine_line(uint8_t tc, int32_t row, double val,
                         uint64_t member, float wt, int64_t hll_p,
                         double* counter_dense, uint8_t* counter_touch,
                         float* gauge_dense, uint8_t* gauge_mask,
                         uint8_t* gauge_touch,
                         int32_t* histo_rows, float* histo_vals,
                         float* histo_wts, uint8_t* histo_touch,
                         int32_t* set_rows, int32_t* set_pos,
                         uint8_t* set_touch,
                         int64_t* hn, int64_t* sn, int64_t* cn,
                         int64_t* gn) {
  switch (tc) {
    case T_COUNTER:
      counter_dense[row] += val * (double)wt;
      counter_touch[row] = 1;
      (*cn)++;
      break;
    case T_GAUGE:
      gauge_dense[row] = (float)val;
      gauge_mask[row] = 1;  // staging dirty mask (cleared per step)
      gauge_touch[row] = 1;  // interval-scoped flush-emission mark
      (*gn)++;
      break;
    case T_TIMER:
    case T_HISTOGRAM:
      histo_rows[*hn] = row;
      histo_vals[*hn] = (float)val;
      histo_wts[*hn] = wt;
      histo_touch[row] = 1;
      (*hn)++;
      break;
    case T_SET: {
      // bit split parameterized by hll_p so utils/hashing.HLL_P
      // stays the single source of truth
      const uint32_t ridx = (uint32_t)(member >> (64 - hll_p));
      const uint64_t w = (member << hll_p) | (1ULL << (hll_p - 1));
      const int rank = __builtin_clzll(w) + 1;
      set_rows[*sn] = row;
      set_pos[*sn] = (int32_t)((ridx << 6) | (uint32_t)rank);
      set_touch[row] = 1;
      (*sn)++;
      break;
    }
  }
}

void vtpu_ingest(
    void* tblp, const uint64_t* keys, const uint8_t* types,
    const double* vals, const uint64_t* members, const float* wts,
    int64_t n, const int64_t* subset, int64_t subset_n, int64_t hll_p,
    double* counter_dense, uint8_t* counter_touch,
    float* gauge_dense, uint8_t* gauge_mask, uint8_t* gauge_touch,
    int32_t* histo_rows, float* histo_vals, float* histo_wts,
    uint8_t* histo_touch,
    int32_t* set_rows, int32_t* set_pos, uint8_t* set_touch,
    int64_t* miss_idx, int64_t* meta) {
  VtpuIndex* t = (VtpuIndex*)tblp;
  // one inner table pinned for the whole pass: a concurrent grow
  // retires (never frees, while we're counted in) the old table, and
  // any key inserted after the pin simply misses here and resolves
  // idempotently under the caller's lock
  const VtpuTab* tb = index_enter(t);
  int64_t hn = meta[0], sn = meta[1], mn = 0;
  int64_t processed = 0, cn = 0, gn = 0;
  const int64_t total = subset_n >= 0 ? subset_n : n;
  const uint64_t pmask = (uint64_t)tb->cap - 1;
  for (int64_t j = 0; j < total; j++) {
    // probe prefetch ~16 lines ahead: at 100k+ cardinality the index
    // is DRAM-resident and the probe stall dominated this loop
    const int64_t ja = j + 16;
    if (ja < total) {
      const int64_t ia = subset_n >= 0 ? subset[ja] : ja;
      // keys[] is uninitialized scratch for non-metric lines (see the
      // parser's definedness contract) — filter before reading
      if (types[ia] <= T_SET) {
        const uint64_t slot = canon_key(keys[ia]) & pmask;
        __builtin_prefetch(&tb->keys[slot]);
        __builtin_prefetch(&tb->vals[slot]);
      }
    }
    const int64_t i = subset_n >= 0 ? subset[j] : j;
    const uint8_t tc = types[i];
    if (tc > T_SET) continue;
    const int32_t row = tab_get(tb, keys[i]);
    if (row == -1) {
      miss_idx[mn++] = i;
      continue;
    }
    processed++;
    if (row < 0) {  // DROPPED (-2): class table full
      meta[6 + tc]++;
      continue;
    }
    combine_line(tc, row, vals[i], members[i], wts[i], hll_p,
                 counter_dense, counter_touch, gauge_dense,
                 gauge_mask, gauge_touch, histo_rows, histo_vals,
                 histo_wts, histo_touch, set_rows, set_pos,
                 set_touch, &hn, &sn, &cn, &gn);
  }
  meta[0] = hn;
  meta[1] = sn;
  meta[2] = mn;
  meta[3] += processed;
  meta[4] += cn;
  meta[5] += gn;
  index_exit(t);
}

// Fused parse + probe + combine: one pass from raw newline-separated
// bytes to dense/staged table state, no column materialization.  The
// split design (vtpu_parse_batch -> vtpu_ingest) writes then re-reads
// ~22 bytes of columns per line — measurable at 35M lines/s — and
// exists so multi-reader servers can parse OUTSIDE the table lock;
// single-reader pipelines (num_readers == 1, and the bench harness)
// take this fused path instead.  Misses spill to compact columns
// (python resolves identities, then replays them through vtpu_ingest
// with the same staging/meta); event/service-check/error lines spill
// to (off, len, kind) for the per-line slow path.
// Cursors threaded through parse_ingest_chunk (append positions and
// per-pass tallies).
struct FusedCursors {
  int64_t hn, sn, mn, on, processed, cn, gn;
  int64_t lines;  // nonempty lines seen
};

// One chunk's worth of the fused line loop: parse newline-separated
// lines from buf[0:len], probing/combining into the shard scratch.
// ``base`` is added to every recorded miss/slow offset (0 here: the
// offsets are relative to the one buffer).
static void parse_ingest_chunk(
    const uint8_t* buf, int64_t len, int64_t base,
    const VtpuTab* tb, int64_t hll_p,
    double* counter_dense, uint8_t* counter_touch,
    float* gauge_dense, uint8_t* gauge_mask, uint8_t* gauge_touch,
    int32_t* histo_rows, float* histo_vals, float* histo_wts,
    uint8_t* histo_touch,
    int32_t* set_rows, int32_t* set_pos, uint8_t* set_touch,
    uint64_t* m_keys, uint8_t* m_types, double* m_vals,
    uint64_t* m_members, float* m_wts,
    int64_t* m_off, int32_t* m_len,
    int64_t* o_off, int32_t* o_len, uint8_t* o_kind,
    int64_t* meta, FusedCursors* cur) {
  DelimMasks dm = build_masks(buf, len);
  int64_t hn = cur->hn, sn = cur->sn, mn = cur->mn, on = cur->on;
  int64_t processed = cur->processed, cn = cur->cn, gn = cur->gn;
  // no probe prefetch here, unlike vtpu_ingest: the next line's key
  // doesn't exist until the next line is parsed; the parse compute
  // between probes provides the latency hiding instead
  int64_t pos = 0;
  while (pos < len) {
    int64_t nlp = next_bit(dm.nl, pos, len);
    const int64_t eol = nlp < 0 ? len : nlp;
    int64_t n = eol - pos;
    int64_t start = pos;
    pos = eol + 1;
    if (n == 0) continue;
    cur->lines++;
    LineParse lp{};
    uint8_t tc = parse_line_core(buf, start, eol, dm, &lp);
    if (tc > T_SET) {
      o_off[on] = base + start;
      o_len[on] = (int32_t)n;
      o_kind[on] = tc;
      on++;
      continue;
    }
    const int32_t row = tab_get(tb, lp.key);
    if (row == -1) {
      m_keys[mn] = lp.key;
      m_types[mn] = tc;
      m_vals[mn] = lp.value;
      m_members[mn] = lp.member;
      m_wts[mn] = lp.weight;
      m_off[mn] = base + start;
      m_len[mn] = (int32_t)n;
      mn++;
      continue;
    }
    processed++;
    if (row < 0) {  // DROPPED (-2): class table full
      meta[6 + tc]++;
      continue;
    }
    combine_line(tc, row, lp.value, lp.member, lp.weight, hll_p,
                 counter_dense, counter_touch, gauge_dense,
                 gauge_mask, gauge_touch, histo_rows, histo_vals,
                 histo_wts, histo_touch, set_rows, set_pos,
                 set_touch, &hn, &sn, &cn, &gn);
  }
  cur->hn = hn;
  cur->sn = sn;
  cur->mn = mn;
  cur->on = on;
  cur->processed = processed;
  cur->cn = cn;
  cur->gn = gn;
}

void vtpu_parse_ingest(
    const uint8_t* buf, int64_t len, void* tblp, int64_t hll_p,
    double* counter_dense, uint8_t* counter_touch,
    float* gauge_dense, uint8_t* gauge_mask, uint8_t* gauge_touch,
    int32_t* histo_rows, float* histo_vals, float* histo_wts,
    uint8_t* histo_touch,
    int32_t* set_rows, int32_t* set_pos, uint8_t* set_touch,
    uint64_t* m_keys, uint8_t* m_types, double* m_vals,
    uint64_t* m_members, float* m_wts,
    int64_t* m_off, int32_t* m_len,
    int64_t* o_off, int32_t* o_len, uint8_t* o_kind,
    int64_t* meta) {
  VtpuIndex* t = (VtpuIndex*)tblp;
  const VtpuTab* tb = index_enter(t);  // see vtpu_ingest's pin note
  FusedCursors cur{meta[0], meta[1], 0, 0, 0, 0, 0};
  parse_ingest_chunk(buf, len, 0, tb, hll_p,
                     counter_dense, counter_touch, gauge_dense,
                     gauge_mask, gauge_touch, histo_rows, histo_vals,
                     histo_wts, histo_touch, set_rows, set_pos,
                     set_touch, m_keys, m_types, m_vals, m_members,
                     m_wts, m_off, m_len, o_off, o_len, o_kind,
                     meta, &cur);
  meta[0] = cur.hn;
  meta[1] = cur.sn;
  meta[2] = cur.mn;
  meta[3] += cur.processed;
  meta[4] += cur.cn;
  meta[5] += cur.gn;
  meta[11] = cur.on;
  index_exit(t);
}

// Within-row occurrence rank: rank[i] = number of earlier samples with
// the same row id.  One O(n) pass with a per-row counter — replaces
// the device-side argsort in the t-digest densify (a 1M-element
// bitonic sort costs ~0.6s on the device; this pass is ~5ms on host).
// counts must be zeroed, length n_rows; out-of-range rows get rank 0.
void vtpu_rank(const int32_t* rows, int64_t n, int32_t n_rows,
               int32_t* counts, int32_t* rank) {
  for (int64_t i = 0; i < n; i++) {
    int32_t r = rows[i];
    if (r < 0 || r >= n_rows) {
      rank[i] = 0;
      continue;
    }
    rank[i] = counts[r]++;
  }
}

// Densify a histo sample batch directly into a host (n_rows, width)
// value plane (plus optional weight plane), one O(n) counting pass.
// The device then receives the PLANE (R*width*4 bytes) instead of
// 12 bytes/sample — on a narrow host<->device link the plane is the
// smaller transfer whenever the batch is dense — and skips the
// scatter: occupancy is derivable from counts.  Samples beyond
// ``width`` for a row spill to the ov_* arrays for a follow-up call.
// plane_v/plane_w and counts must be zeroed by the caller; returns
// the spill count.  Out-of-range rows are dropped (counted upstream).
//
// out_stats (nullable): f64[n_rows, 5] per-row batch aggregates
// (weight, min, max, sum, reciprocal-sum — the Histo sampler's local
// stats, reference samplers/samplers.go:484-494) accumulated here in
// full f32 precision over EVERY sample of the batch (including ones
// that spill), so the value plane itself may then ship at reduced
// precision without corrupting the emitted min/max/sum.  Caller
// pre-fills columns: weight/sum/rsum 0, min +F32_MAX, max -F32_MAX.
int64_t vtpu_dense_plane(const int32_t* rows, const float* vals,
                         const float* wts,  // null => unit weights
                         int64_t n, int32_t n_rows, int32_t width,
                         float* plane_v, float* plane_w,  // w nullable
                         int32_t* counts,
                         int32_t* ov_rows, float* ov_vals,
                         float* ov_wts, double* out_stats) {
  int64_t spill = 0;
  for (int64_t i = 0; i < n; i++) {
    int32_t r = rows[i];
    if (r < 0 || r >= n_rows) continue;
    const float v = vals[i];
    const float w = wts ? wts[i] : 1.0f;
    if (out_stats) {
      // f64 accumulators: sequential f32 sums drift ~eps*running_sum
      // per add on hot rows (and an f32 count saturates at 2^24)
      double* st = out_stats + (int64_t)r * 5;
      st[0] += w;
      if (v < st[1]) st[1] = v;
      if (v > st[2]) st[2] = v;
      st[3] += (double)v * w;
      if (v != 0.0f) st[4] += (double)w / v;
    }
    int32_t c = counts[r];
    if (c >= width) {
      ov_rows[spill] = r;
      ov_vals[spill] = v;
      if (wts) ov_wts[spill] = w;
      spill++;
      continue;
    }
    plane_v[(int64_t)r * width + c] = v;
    if (wts) plane_w[(int64_t)r * width + c] = w;
    counts[r] = c + 1;
  }
  return spill;
}

// Fold packed HLL member positions ((reg_idx << 6) | rank) into a
// host (n_rows, m) register plane with byte-max — the whole
// interval's set traffic then ships as ONE m-byte plane per row
// instead of 8 bytes per member, and the device union is an
// elementwise max instead of a scatter.  plane must be zeroed.
void vtpu_hll_plane(const int32_t* rows, const int32_t* packed,
                    int64_t n, int32_t n_rows, int32_t m,
                    uint8_t* plane) {
  for (int64_t i = 0; i < n; i++) {
    int32_t r = rows[i];
    if (r < 0 || r >= n_rows) continue;
    int32_t idx = packed[i] >> 6;
    uint8_t rank = (uint8_t)(packed[i] & 0x3F);
    if (idx < 0 || idx >= m) continue;
    uint8_t* p = plane + (int64_t)r * m + idx;
    if (*p < rank) *p = rank;
  }
}

// Superbatch segment gather: concatenate k staged part arrays
// directly into one int32 buffer segment and sentinel-fill the
// bucket-padded tail.  The parse path stages one packed-position
// part per ingested batch, so a reader-sharded interval carries
// hundreds of parts; emitting them straight into the superbatch
// segment replaces a numpy concatenate + pad copy pair per class.
void vtpu_sb_gather_i32(const int32_t* const* parts,
                        const int64_t* lens, int32_t k,
                        int32_t* dst, int64_t cap, int32_t fill) {
  int64_t o = 0;
  for (int32_t i = 0; i < k; i++) {
    int64_t len = lens[i];
    if (len > cap - o) len = cap - o;
    if (len > 0) {
      std::memcpy(dst + o, parts[i], (size_t)len * sizeof(int32_t));
      o += len;
    }
  }
  for (; o < cap; o++) dst[o] = fill;
}

// vtpu_hll_plane plus incremental per-row LogLog-Beta sufficient
// statistics: ez[r] counts zero registers, inv_sum[r] tracks
// sum_j 2^-reg_j.  Maintaining them at fold time makes the flush
// estimate O(rows) instead of re-scanning rows*m register bytes —
// the full-plane numpy rescan was the single largest phase of the
// set-heavy interval (65ms of a 110ms budget at 1M members/interval).
// Callers must initialise ez[r] = m and inv_sum[r] = m (all-zero
// row) alongside the zeroed plane.  exp2(-k) for k <= 63 is exact in
// f64, so the running sum matches a fresh rescan to accumulation
// rounding (~1e-12 relative), far inside the estimator's 0.8% s.e.
void vtpu_hll_plane_stats(const int32_t* rows, const int32_t* packed,
                          int64_t n, int32_t n_rows, int32_t m,
                          uint8_t* plane, double* inv_sum,
                          int32_t* ez) {
  double lut[64];
  for (int k = 0; k < 64; k++) lut[k] = std::pow(2.0, -k);
  for (int64_t i = 0; i < n; i++) {
    int32_t r = rows[i];
    if (r < 0 || r >= n_rows) continue;
    int32_t idx = packed[i] >> 6;
    uint8_t rank = (uint8_t)(packed[i] & 0x3F);
    if (idx < 0 || idx >= m) continue;
    uint8_t* p = plane + (int64_t)r * m + idx;
    uint8_t old = *p;
    if (old < rank) {
      *p = rank;
      inv_sum[r] += lut[rank] - lut[old];
      if (old == 0) ez[r]--;
    }
  }
}

// ---------------------------------------------------------------------
// adaptive sketch tiers (core/tiers.py): single-pass stable partition
// of a batch's row ids by per-row tier bit.  The first n_wide outputs
// are wide-tier samples with out_rows = slot[row] (pool-slot space),
// the rest compact-tier samples with out_rows = row (table-row space);
// out_idx carries each one's batch position.  Returns n_wide.
int64_t vtpu_tier_split(const int32_t* rows, int64_t n,
                        const uint8_t* tier, const int32_t* slot,
                        int32_t* out_idx, int32_t* out_rows) {
  int64_t w = 0;
  for (int64_t i = 0; i < n; i++)
    if (tier[rows[i]]) {
      out_idx[w] = (int32_t)i;
      out_rows[w] = slot[rows[i]];
      w++;
    }
  int64_t c = w;
  for (int64_t i = 0; i < n; i++)
    if (!tier[rows[i]]) {
      out_idx[c] = (int32_t)i;
      out_rows[c] = rows[i];
      c++;
    }
  return w;
}


// ---------------------------------------------------------------------
// Batched gob/binary value decode for the reference HTTP /import wire
// (forward/gob_codec.py).  One call turns a whole import body's opaque
// value payloads into flat columns: counter (LE int64), gauge
// (LE float64) and the MergingDigest gob stream (centroid slice +
// compression/min/max/reciprocalSum messages, fail-open when the
// trailing float messages are absent — merging_digest.go:434).
//
// Per-item isolation: a malformed value sets err[i]=1 and decoding
// continues (the caller drops-and-counts per item, exactly like the
// Python codec's exception path).  Centroid capacity overflow keeps
// COUNTING without writing and returns -2 with the exact need in
// out_needed[0], so one retry always fits.  Returns the number of
// centroids written.

namespace {

// gob unsigned int: one byte if < 128, else 256-n then n BE bytes.
// Bounded by ``limit`` the way the Python _read_uint is bounded by the
// whole buffer (the per-message end is enforced by the message jump,
// not per-read).
inline bool gob_uint(const uint8_t* b, int64_t limit, int64_t* pos,
                     uint64_t* out) {
  if (*pos >= limit) return false;
  uint8_t c = b[(*pos)++];
  if (c < 0x80) { *out = c; return true; }
  int n = 256 - c;
  if (n > 8 || *pos + n > limit) return false;
  uint64_t v = 0;
  for (int i = 0; i < n; i++) v = (v << 8) | b[(*pos)++];
  *out = v;
  return true;
}

// gob float64: the IEEE754 bits byte-reversed, carried as an unsigned
// int (Python: unpack("<d", u.to_bytes(8, "big"))).
inline bool gob_float(const uint8_t* b, int64_t limit, int64_t* pos,
                      double* out) {
  uint64_t u;
  if (!gob_uint(b, limit, pos, &u)) return false;
  uint64_t bits = __builtin_bswap64(u);
  memcpy(out, &bits, 8);
  return true;
}

// Decode one MergingDigest gob stream.  Mirrors
// gob_codec.decode_digest message for message; centroids are COUNTED
// always and written only while *nc < cap (the caller turns the
// overflow into a -2 grow-retry).  Returns false on malformed.
inline bool gob_digest(const uint8_t* b, int64_t n,
                       double* ds /* [4] min,max,rsum,comp */,
                       int64_t cap, float* means, float* weights,
                       int64_t* nc, int64_t* counted, bool* over) {
  int64_t pos = 0;
  bool got_slice = false;
  int n_floats = 0;
  double floats[4] = {0, 0, 0, 0};
  while (pos < n) {
    uint64_t msg_len;
    if (!gob_uint(b, n, &pos, &msg_len)) return false;
    if (msg_len > (uint64_t)(n - pos)) return false;
    const int64_t end = pos + (int64_t)msg_len;
    uint64_t tid_u;
    int64_t p = pos;
    if (!gob_uint(b, n, &p, &tid_u)) return false;
    const int64_t tid = (int64_t)(tid_u >> 1) ^ -(int64_t)(tid_u & 1);
    if (tid < 0) { pos = end; continue; }  // typedef: fixed prologue
    if (p >= end || b[p] != 0) return false;  // top-level delta byte
    p++;
    if (!got_slice) {
      if (tid < 64) return false;  // expected the centroid slice
      uint64_t count;
      if (!gob_uint(b, n, &p, &count)) return false;
      if (count > (1u << 20)) return false;
      for (uint64_t i = 0; i < count; i++) {
        double mean = 0.0, weight = 0.0;
        int64_t field = -1;
        for (;;) {
          uint64_t delta;
          if (!gob_uint(b, n, &p, &delta)) return false;
          if (delta == 0) break;
          field += (int64_t)delta;
          if (field == 0) {
            if (!gob_float(b, n, &p, &mean)) return false;
          } else if (field == 1) {
            if (!gob_float(b, n, &p, &weight)) return false;
          } else if (field == 2) {  // Samples []float64 (debug mode)
            uint64_t ns;
            if (!gob_uint(b, n, &p, &ns)) return false;
            double tmp;
            for (uint64_t j = 0; j < ns; j++)
              if (!gob_float(b, n, &p, &tmp)) return false;
          } else {
            return false;  // unknown centroid field
          }
        }
        if (*nc < cap) {
          means[*nc] = (float)mean;
          weights[*nc] = (float)weight;
          (*nc)++;
        } else {
          *over = true;
        }
        (*counted)++;
      }
      got_slice = true;
    } else {
      double v;
      if (!gob_float(b, n, &p, &v)) return false;
      if (n_floats < 4) floats[n_floats] = v;
      n_floats++;
    }
    pos = end;
  }
  if (!got_slice) return false;
  // encode order: compression, min, max, reciprocalSum; older streams
  // fail open (missing min/max read ±inf like the reference decoder)
  const double comp = n_floats > 0 ? floats[0] : 100.0;
  const double vmin = n_floats > 1 ? floats[1] : HUGE_VAL;
  const double vmax = n_floats > 2 ? floats[2] : -HUGE_VAL;
  const double rsum = n_floats > 3 ? floats[3] : 0.0;
  ds[0] = vmin; ds[1] = vmax; ds[2] = rsum; ds[3] = comp;
  return true;
}

}  // namespace

int64_t vtpu_gob_decode(
    const uint8_t* buf, int64_t buf_len, int64_t n_items,
    const int64_t* off, const int64_t* vlen,
    const uint8_t* kind,  // 1 counter, 2 gauge, 3 digest
    int64_t cap_cents,
    double* scalar,       // [n] counter/gauge value
    double* dstats,       // [n, 4]: min, max, rsum, compression
    int64_t* cent_start, int32_t* cent_cnt,
    float* means, float* weights,
    uint8_t* err,         // [n]: 0 ok, 1 malformed
    int64_t* out_needed /* [1]: total centroids */) {
  int64_t nc = 0, counted = 0;
  bool over = false;
  for (int64_t i = 0; i < n_items; i++) {
    scalar[i] = 0.0;
    double* ds = dstats + i * 4;
    ds[0] = 0.0; ds[1] = 0.0; ds[2] = 0.0; ds[3] = 0.0;
    cent_start[i] = nc;
    cent_cnt[i] = 0;
    err[i] = 1;
    const int64_t o = off[i], l = vlen[i];
    if (o < 0 || l < 0 || o + l > buf_len) continue;
    const uint8_t* v = buf + o;
    switch (kind[i]) {
      case 1: {  // counter: LE int64 (samplers.go:162 Counter.Export)
        if (l != 8) break;
        int64_t iv;
        memcpy(&iv, v, 8);
        scalar[i] = (double)iv;
        err[i] = 0;
        break;
      }
      case 2: {  // gauge: LE float64
        if (l != 8) break;
        memcpy(scalar + i, v, 8);
        err[i] = 0;
        break;
      }
      case 3: {  // histogram/timer: MergingDigest gob stream
        const int64_t before = nc, counted_before = counted;
        if (gob_digest(v, l, ds, cap_cents, means, weights, &nc,
                       &counted, &over)) {
          cent_cnt[i] = (int32_t)(counted - counted_before);
          err[i] = 0;
        } else {
          nc = before;  // discard the partial item's centroids
          counted = counted_before;
        }
        break;
      }
      default:
        break;  // unknown kind: malformed
    }
  }
  out_needed[0] = counted;
  return over ? -2 : nc;
}

// forwardrpc.MetricList wire walker (the global tier's decode hot
// path: importsrv/server.go:102 SendMetrics).  Parses the serialized
// proto DIRECTLY — field numbers per forward/protos/{forward,metric,
// tdigest}.proto are the Go-fleet compatibility contract — and emits
// columnar output, so Python touches one slice per metric instead of
// one object per centroid (a fleet interval carries ~millions of
// centroids; upb-object traversal was ~60% of the import cost).

namespace {

// Returns false on truncation/overflow; advances *pos.
inline bool read_varint(const uint8_t* buf, int64_t n, int64_t* pos,
                        uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  while (*pos < n && shift < 64) {
    uint8_t b = buf[(*pos)++];
    v |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) { *out = v; return true; }
    shift += 7;
  }
  return false;
}

// Skip one field of the given wire type; false on malformed.
inline bool skip_field(const uint8_t* buf, int64_t n, int64_t* pos,
                       uint32_t wt) {
  uint64_t tmp;
  switch (wt) {
    case 0: return read_varint(buf, n, pos, &tmp);
    case 1: if (*pos + 8 > n) return false; *pos += 8; return true;
    case 2:
      if (!read_varint(buf, n, pos, &tmp)) return false;
      if (tmp > (uint64_t)(n - *pos)) return false;
      *pos += (int64_t)tmp;
      return true;
    case 5: if (*pos + 4 > n) return false; *pos += 4; return true;
    default: return false;  // groups (3/4) never appear in proto3
  }
}

inline double read_f64(const uint8_t* p) {
  double v;
  memcpy(&v, p, 8);
  return v;
}

}  // namespace

// Decode one serialized MetricList into columns.  Capacities are the
// caller's buffer sizes; on overflow the walker keeps COUNTING (not
// writing) and returns the negated totals via the out_needed triple so
// one retry always fits.  Returns the metric count, or -1 malformed,
// or -2 when a capacity was exceeded (see out_needed).
//
// Per-metric columns: name_off/name_len (into buf), mtype/scope (proto
// enums), kind (0 none, 1 counter, 2 gauge, 3 histogram, 4 set),
// scalar (counter/gauge value), digest stats f64[4] (min, max, rsum,
// compression), cent_start/cent_cnt (into means/weights),
// tag_start/tag_cnt (into tag_off/tag_len), hll_off/hll_len.
int64_t vtpu_metriclist_decode(
    const uint8_t* buf, int64_t n,
    int64_t cap_metrics, int64_t cap_cents, int64_t cap_tags,
    int64_t* name_off, int32_t* name_len,
    uint8_t* kind, int32_t* mtype, int32_t* scope, double* scalar,
    double* dstats,  // [cap_metrics, 4]: min, max, rsum, compression
    int64_t* cent_start, int32_t* cent_cnt,
    float* means, float* weights,
    int64_t* tag_start, int32_t* tag_cnt,
    int64_t* tag_off, int32_t* tag_len,
    int64_t* hll_off, int32_t* hll_len,
    int64_t* out_needed /* [3]: metrics, cents, tags */) {
  int64_t nm = 0, nc = 0, nt = 0;  // running totals (counted always)
  int64_t pos = 0;
  bool over = false;
  while (pos < n) {
    uint64_t tag;
    if (!read_varint(buf, n, &pos, &tag)) return -1;
    if ((tag >> 3) != 1 || (tag & 7) != 2) {  // not metrics field
      if (!skip_field(buf, n, &pos, (uint32_t)(tag & 7))) return -1;
      continue;
    }
    uint64_t mlen;
    if (!read_varint(buf, n, &pos, &mlen)) return -1;
    if (mlen > (uint64_t)(n - pos)) return -1;
    const int64_t mend = pos + (int64_t)mlen;
    const bool write_m = !over && nm < cap_metrics;
    if (write_m) {
      name_off[nm] = 0; name_len[nm] = 0;
      kind[nm] = 0; mtype[nm] = 0; scope[nm] = 0; scalar[nm] = 0.0;
      double* ds = dstats + nm * 4;
      ds[0] = 0.0; ds[1] = 0.0; ds[2] = 0.0; ds[3] = 0.0;
      cent_start[nm] = nc; cent_cnt[nm] = 0;
      tag_start[nm] = nt; tag_cnt[nm] = 0;
      hll_off[nm] = 0; hll_len[nm] = 0;
    } else {
      over = true;
    }
    // walk Metric fields
    while (pos < mend) {
      uint64_t ftag;
      if (!read_varint(buf, mend, &pos, &ftag)) return -1;
      const uint32_t fn = (uint32_t)(ftag >> 3);
      const uint32_t wt = (uint32_t)(ftag & 7);
      uint64_t len, uv;
      switch (fn) {
        case 1:  // name
          if (wt != 2) goto skip;
          if (!read_varint(buf, mend, &pos, &len)) return -1;
          if (len > (uint64_t)(mend - pos)) return -1;
          if (write_m) {
            name_off[nm] = pos;
            name_len[nm] = (int32_t)len;
          }
          pos += (int64_t)len;
          break;
        case 2:  // tags (repeated string)
          if (wt != 2) goto skip;
          if (!read_varint(buf, mend, &pos, &len)) return -1;
          if (len > (uint64_t)(mend - pos)) return -1;
          if (!over && nt < cap_tags) {
            tag_off[nt] = pos;
            tag_len[nt] = (int32_t)len;
            if (write_m) tag_cnt[nm]++;
          } else {
            over = true;
          }
          nt++;
          pos += (int64_t)len;
          break;
        case 3:  // type enum
          if (wt != 0) goto skip;
          if (!read_varint(buf, mend, &pos, &uv)) return -1;
          if (write_m) mtype[nm] = (int32_t)uv;
          break;
        case 9:  // scope enum
          if (wt != 0) goto skip;
          if (!read_varint(buf, mend, &pos, &uv)) return -1;
          if (write_m) scope[nm] = (int32_t)uv;
          break;
        case 5: {  // counter { int64 value = 1 }
          if (wt != 2) goto skip;
          if (!read_varint(buf, mend, &pos, &len)) return -1;
          if (len > (uint64_t)(mend - pos)) return -1;
          const int64_t vend = pos + (int64_t)len;
          if (write_m) kind[nm] = 1;
          while (pos < vend) {
            uint64_t vtag;
            if (!read_varint(buf, vend, &pos, &vtag)) return -1;
            if ((vtag >> 3) == 1 && (vtag & 7) == 0) {
              if (!read_varint(buf, vend, &pos, &uv)) return -1;
              if (write_m) scalar[nm] = (double)(int64_t)uv;
            } else if (!skip_field(buf, vend, &pos,
                                   (uint32_t)(vtag & 7))) {
              return -1;
            }
          }
          break;
        }
        case 6: {  // gauge { double value = 1 }
          if (wt != 2) goto skip;
          if (!read_varint(buf, mend, &pos, &len)) return -1;
          if (len > (uint64_t)(mend - pos)) return -1;
          const int64_t vend = pos + (int64_t)len;
          if (write_m) kind[nm] = 2;
          while (pos < vend) {
            uint64_t vtag;
            if (!read_varint(buf, vend, &pos, &vtag)) return -1;
            if ((vtag >> 3) == 1 && (vtag & 7) == 1) {
              if (pos + 8 > vend) return -1;
              if (write_m) scalar[nm] = read_f64(buf + pos);
              pos += 8;
            } else if (!skip_field(buf, vend, &pos,
                                   (uint32_t)(vtag & 7))) {
              return -1;
            }
          }
          break;
        }
        case 8: {  // set { bytes hyper_log_log = 1 }
          if (wt != 2) goto skip;
          if (!read_varint(buf, mend, &pos, &len)) return -1;
          if (len > (uint64_t)(mend - pos)) return -1;
          const int64_t vend = pos + (int64_t)len;
          if (write_m) kind[nm] = 4;
          while (pos < vend) {
            uint64_t vtag;
            if (!read_varint(buf, vend, &pos, &vtag)) return -1;
            if ((vtag >> 3) == 1 && (vtag & 7) == 2) {
              uint64_t blen;
              if (!read_varint(buf, vend, &pos, &blen)) return -1;
              if (blen > (uint64_t)(vend - pos)) return -1;
              if (write_m) {
                hll_off[nm] = pos;
                hll_len[nm] = (int32_t)blen;
              }
              pos += (int64_t)blen;
            } else if (!skip_field(buf, vend, &pos,
                                   (uint32_t)(vtag & 7))) {
              return -1;
            }
          }
          break;
        }
        case 7: {  // histogram { MergingDigestData t_digest = 1 }
          if (wt != 2) goto skip;
          if (!read_varint(buf, mend, &pos, &len)) return -1;
          if (len > (uint64_t)(mend - pos)) return -1;
          const int64_t vend = pos + (int64_t)len;
          if (write_m) kind[nm] = 3;
          while (pos < vend) {
            uint64_t vtag;
            if (!read_varint(buf, vend, &pos, &vtag)) return -1;
            if ((vtag >> 3) == 1 && (vtag & 7) == 2) {
              // MergingDigestData
              uint64_t dlen;
              if (!read_varint(buf, vend, &pos, &dlen)) return -1;
              if (dlen > (uint64_t)(vend - pos)) return -1;
              const int64_t dend = pos + (int64_t)dlen;
              while (pos < dend) {
                uint64_t dtag;
                if (!read_varint(buf, dend, &pos, &dtag)) return -1;
                const uint32_t dfn = (uint32_t)(dtag >> 3);
                const uint32_t dwt = (uint32_t)(dtag & 7);
                if (dfn == 1 && dwt == 2) {  // Centroid
                  uint64_t clen;
                  if (!read_varint(buf, dend, &pos, &clen)) return -1;
                  if (clen > (uint64_t)(dend - pos)) return -1;
                  const int64_t cend = pos + (int64_t)clen;
                  double mean = 0.0, w = 0.0;
                  while (pos < cend) {
                    uint64_t ctag;
                    if (!read_varint(buf, cend, &pos, &ctag)) return -1;
                    const uint32_t cfn = (uint32_t)(ctag >> 3);
                    const uint32_t cwt = (uint32_t)(ctag & 7);
                    if (cfn == 1 && cwt == 1) {
                      if (pos + 8 > cend) return -1;
                      mean = read_f64(buf + pos);
                      pos += 8;
                    } else if (cfn == 2 && cwt == 1) {
                      if (pos + 8 > cend) return -1;
                      w = read_f64(buf + pos);
                      pos += 8;
                    } else if (!skip_field(buf, cend, &pos, cwt)) {
                      return -1;  // debug samples field etc.
                    }
                  }
                  if (!over && nc < cap_cents) {
                    means[nc] = (float)mean;
                    weights[nc] = (float)w;
                    if (write_m) cent_cnt[nm]++;
                  } else {
                    over = true;
                  }
                  nc++;
                } else if (dfn >= 2 && dfn <= 5 && dwt == 1) {
                  if (pos + 8 > dend) return -1;
                  if (write_m) {
                    double* ds = dstats + nm * 4;
                    const double v = read_f64(buf + pos);
                    if (dfn == 3) ds[0] = v;        // min
                    else if (dfn == 4) ds[1] = v;   // max
                    else if (dfn == 5) ds[2] = v;   // reciprocalSum
                    else ds[3] = v;                 // compression
                  }
                  pos += 8;
                } else if (!skip_field(buf, dend, &pos, dwt)) {
                  return -1;
                }
              }
            } else if (!skip_field(buf, vend, &pos,
                                   (uint32_t)(vtag & 7))) {
              return -1;
            }
          }
          break;
        }
        default:
        skip:
          if (!skip_field(buf, mend, &pos, wt)) return -1;
      }
    }
    if (pos != mend) return -1;
    nm++;
  }
  out_needed[0] = nm;
  out_needed[1] = nc;
  out_needed[2] = nt;
  return over ? -2 : nm;
}

// Import-identity hash per decoded MetricList item: an opaque cache
// key over (name bytes, kind, proto mtype, proto scope, tag bytes)
// for forward/grpc_forward.py's steady-state row cache —
// repeated-interval imports resolve rows without decoding a single
// string.  Same fold64/fmix64 building blocks as the series-identity
// hash, commutative over tags; the constant offsets only need to be
// deterministic (this hash never leaves the process and never mixes
// with the DogStatsD key space — kind is mixed with a distinct
// multiplier to keep the spaces disjoint).
void vtpu_metriclist_keyhash(
    const uint8_t* buf, int64_t nm,
    const int64_t* name_off, const int32_t* name_len,
    const uint8_t* kind, const int32_t* mtype, const int32_t* scope,
    const int64_t* tag_start, const int32_t* tag_cnt,
    const int64_t* tag_off, const int32_t* tag_len,
    uint64_t* out_hash) {
  constexpr uint64_t kImportKindMult = 0xD6E8FEB86659FD93ULL;
  for (int64_t i = 0; i < nm; i++) {
    uint64_t tagsum = 0;
    const int64_t ts = tag_start[i];
    for (int32_t j = 0; j < tag_cnt[i]; j++) {
      tagsum += fmix64(fold64(buf + tag_off[ts + j],
                              (size_t)tag_len[ts + j]));
    }
    const uint64_t meta =
        ((uint64_t)kind[i] * kImportKindMult) ^
        ((uint64_t)(uint32_t)mtype[i] * kKeyTypeMult) ^
        ((uint64_t)(uint32_t)scope[i] * kKeyScopeMult);
    out_hash[i] = fmix64(
        fold64(buf + name_off[i], (size_t)name_len[i]) ^
        fmix64(meta + tagsum));
  }
}


// Top-level record spans of a serialized MetricList: one (offset,
// length) per `metrics` entry, INCLUDING the field tag + varint
// length prefix, so a destination's re-encoded body is simply the
// concatenation of its records' byte slices (proto wire concatenation
// of repeated-field records is a valid message).  Non-metrics fields
// are skipped (MetricList has none today).  Returns the record count,
// -1 malformed, -2 capacity exceeded (out_needed holds the need).
int64_t vtpu_metriclist_spans(const uint8_t* buf, int64_t n,
                              int64_t cap, int64_t* rec_off,
                              int64_t* rec_len, int64_t* out_needed) {
  int64_t nm = 0, pos = 0;
  while (pos < n) {
    const int64_t start = pos;
    uint64_t tag;
    if (!read_varint(buf, n, &pos, &tag)) return -1;
    if ((tag >> 3) != 1 || (tag & 7) != 2) {
      if (!skip_field(buf, n, &pos, (uint32_t)(tag & 7))) return -1;
      continue;
    }
    uint64_t mlen;
    if (!read_varint(buf, n, &pos, &mlen)) return -1;
    if (mlen > (uint64_t)(n - pos)) return -1;
    pos += (int64_t)mlen;
    if (nm < cap) {
      rec_off[nm] = start;
      rec_len[nm] = pos - start;
    }
    nm++;
  }
  out_needed[0] = nm;
  return nm <= cap ? nm : -2;
}

// Proxy route-key hash: fmix64(fnv1a64("<name>|<typename>|<tags
// joined by ','>")) streamed straight off the wire columns — the
// EXACT bytes ProxyServer._pb_key assembles, so the vectorized
// searchsorted router stays bit-parity with ConsistentRing.get on
// the key string (ring._h) without materializing any key.  Metrics
// whose type enum has no name (outside 0..4) set need_py=1 and the
// caller hashes their str(enum) key in Python (the oracle's
// fallback spelling).
void vtpu_proxy_keyhash(const uint8_t* buf, int64_t nm,
                        const int64_t* name_off,
                        const int32_t* name_len,
                        const int32_t* mtype,
                        const int64_t* tag_start,
                        const int32_t* tag_cnt,
                        const int64_t* tag_off,
                        const int32_t* tag_len,
                        uint64_t* out_hash, uint8_t* need_py) {
  static const char* kTypeNames[5] = {"counter", "gauge", "histogram",
                                      "set", "timer"};
  static const int64_t kTypeLens[5] = {7, 5, 9, 3, 5};
  const uint8_t pipe = '|', comma = ',';
  for (int64_t i = 0; i < nm; i++) {
    const int32_t t = mtype[i];
    if (t < 0 || t > 4) {
      need_py[i] = 1;
      out_hash[i] = 0;
      continue;
    }
    need_py[i] = 0;
    uint64_t h = fnv1a64(kFnvOffset, buf + name_off[i], name_len[i]);
    h = (h ^ pipe) * kFnvPrime;
    h = fnv1a64(h, (const uint8_t*)kTypeNames[t], kTypeLens[t]);
    h = (h ^ pipe) * kFnvPrime;
    const int64_t ts = tag_start[i];
    for (int32_t j = 0; j < tag_cnt[i]; j++) {
      if (j) h = (h ^ comma) * kFnvPrime;
      h = fnv1a64(h, buf + tag_off[ts + j], tag_len[ts + j]);
    }
    out_hash[i] = fmix64(h);
  }
}

// ---- HLL sketches of a MetricList wire ------------------------------
// The gRPC import folds a wire's axiomhq/hyperloglog sketches
// (SetValue.hyper_log_log, forward/hll_codec.py is the oracle) into the
// table's host import plane in two calls: vtpu_hll_classify outside the
// ingest lock names each set item's form and decodes sparse sketches
// into (register, rank) pairs; vtpu_hll_fold under it byte-maxes every
// accepted sketch into its plane row.  A sketch the classifier refuses
// is left to the codec, so a malformed one never reaches the plane.
//
//   [version][p][b][sparse?]
//   dense:  [m/2 be32][m/2 bytes: even register in the high nibble,
//           register = nibble + b mod 256]
//   sparse: [tmpset_n be32][tmpset be32...][list_count be32]
//           [list_last be32][varbytes_n be32][varbytes: little 7-bit
//           varint deltas of the sorted encoded hashes]

static constexpr int32_t kHllP = 14;
static constexpr int32_t kHllM = 1 << kHllP;
static constexpr int32_t kHllPP = 25;
enum : uint8_t { kHllSkip = 0, kHllDense = 1, kHllSparse = 2,
                 kHllCodec = 3 };

static inline uint32_t load_be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

// An encoded sparse hash as a (register << 8 | rank) pair
// (sparse.go:25 decodeHash at p = 14, pp = 25); false for the zero
// hash word the codec refuses.
static inline bool hll_sparse_pair(uint32_t k, int32_t* out) {
  uint32_t idx, rank;
  if (k & 1) {
    rank = ((k >> 1) & 0x3F) + kHllPP - kHllP;
    idx = (k >> (32 - kHllP)) & (kHllM - 1);
  } else {
    idx = (k >> (kHllPP - kHllP + 1)) & (kHllM - 1);
    const uint32_t w = k << (32 - kHllPP + kHllP - 1);
    if (w == 0) return false;
    rank = (uint32_t)__builtin_clz(w) + 1;
  }
  *out = (int32_t)((idx << 8) | rank);
  return true;
}

// One sparse sketch's pairs into pairs[np..] while they fit under cap;
// returns the pair count, or -1 where the codec would raise.
static int64_t hll_sparse_decode(const uint8_t* d, int64_t len,
                                 int32_t* pairs, int64_t np,
                                 int64_t cap) {
  if (len < 8) return -1;
  const int64_t tn = load_be32(d + 4);
  const int64_t end = 8 + 4 * tn;
  if (len < end + 12) return -1;
  const int64_t count = load_be32(d + end);
  const int64_t vb_n = load_be32(d + end + 8);
  if (len - (end + 12) < vb_n) return -1;
  int64_t got = 0;
  int32_t pr;
  for (int64_t j = 0; j < tn; j++, got++) {
    if (!hll_sparse_pair(load_be32(d + 8 + 4 * j), &pr)) return -1;
    if (np + got < cap) pairs[np + got] = pr;
  }
  const uint8_t* vb = d + end + 12;
  uint32_t last = 0;
  int64_t i = 0;
  for (int64_t c = 0; c < count; c++, got++) {
    uint32_t x = 0;
    int shift = 0;
    for (;;) {
      if (i >= vb_n) return -1;
      const uint8_t byte = vb[i++];
      // bits past 32 vanish in the codec's sum mod 2^32
      if (shift < 32) {
        x |= (uint32_t)(byte & 0x7F) << shift;
        shift += 7;
      }
      if (!(byte & 0x80)) break;
    }
    last += x;
    if (!hll_sparse_pair(last, &pr)) return -1;
    if (np + got < cap) pairs[np + got] = pr;
  }
  return got;
}

// Classify each set item (kind 4) of a decoded wire: status kHllDense
// (p = 14, size m/2, whole), kHllSparse (flag 1, tmpset and list decode
// whole, no zero hash word) with its pairs at pair_start/pair_cnt, or
// kHllCodec; other kinds kHllSkip.  Pairs are written while they fit
// under pairs_cap; returns the pairs needed, so a call whose return
// passes pairs_cap is repeated with room for them.
int64_t vtpu_hll_classify(const uint8_t* buf, int64_t n, int64_t nm,
                          const uint8_t* kind, const int64_t* hll_off,
                          const int32_t* hll_len, uint8_t* status,
                          int64_t* pair_start, int32_t* pair_cnt,
                          int32_t* pairs, int64_t pairs_cap) {
  int64_t np = 0;
  for (int64_t i = 0; i < nm; i++) {
    pair_start[i] = np;
    pair_cnt[i] = 0;
    if (kind[i] != 4) {
      status[i] = kHllSkip;
      continue;
    }
    const int64_t off = hll_off[i], len = hll_len[i];
    status[i] = kHllCodec;
    if (off < 0 || len < 4 || len > n - off) continue;
    const uint8_t* d = buf + off;
    if (d[1] != kHllP) continue;
    if (d[3] == 1) {
      const int64_t got = hll_sparse_decode(d, len, pairs, np, pairs_cap);
      if (got < 0) continue;
      status[i] = kHllSparse;
      pair_cnt[i] = (int32_t)got;
      np += got;
    } else if (len >= 8 + kHllM / 2 && load_be32(d + 4) == kHllM / 2) {
      status[i] = kHllDense;
    }
  }
  return np;
}

// One dense sketch's registers byte-maxed into a plane row.
static void hll_fold_dense(const uint8_t* packed, uint8_t b,
                           uint8_t* row) {
  int32_t q = 0;
#if defined(__x86_64__)
  const __m128i lo_mask = _mm_set1_epi8(0x0F);
  const __m128i base = _mm_set1_epi8((char)b);
  for (; q + 16 <= kHllM / 2; q += 16) {
    const __m128i x =
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(packed + q));
    const __m128i hi = _mm_add_epi8(
        _mm_and_si128(_mm_srli_epi16(x, 4), lo_mask), base);
    const __m128i lo = _mm_add_epi8(_mm_and_si128(x, lo_mask), base);
    __m128i* dst = reinterpret_cast<__m128i*>(row + 2 * q);
    _mm_storeu_si128(dst, _mm_max_epu8(_mm_loadu_si128(dst),
                                       _mm_unpacklo_epi8(hi, lo)));
    _mm_storeu_si128(dst + 1, _mm_max_epu8(_mm_loadu_si128(dst + 1),
                                           _mm_unpackhi_epi8(hi, lo)));
  }
#endif
  for (; q < kHllM / 2; q++) {
    const uint8_t hi = (uint8_t)((packed[q] >> 4) + b);
    const uint8_t lo = (uint8_t)((packed[q] & 0x0F) + b);
    if (row[2 * q] < hi) row[2 * q] = hi;
    if (row[2 * q + 1] < lo) row[2 * q + 1] = lo;
  }
}

// Fold the classified sketches of items[0..k) into plane rows
// dest[0..k) of an (n_rows, m) u8 plane by byte max, in order; items
// not classified dense or sparse and rows outside the plane are
// skipped.  Returns the sketches folded.
int64_t vtpu_hll_fold(const uint8_t* buf, const int64_t* hll_off,
                      const uint8_t* status, const int64_t* pair_start,
                      const int32_t* pair_cnt, const int32_t* pairs,
                      const int64_t* items, const int64_t* dest,
                      int64_t k, uint8_t* plane, int64_t n_rows) {
  int64_t folded = 0;
  for (int64_t j = 0; j < k; j++) {
    const int64_t i = items[j], r = dest[j];
    if (r < 0 || r >= n_rows) continue;
    uint8_t* row = plane + r * kHllM;
    if (status[i] == kHllDense) {
      const uint8_t* d = buf + hll_off[i];
      hll_fold_dense(d + 8, d[2], row);
    } else if (status[i] == kHllSparse) {
      const int32_t* p = pairs + pair_start[i];
      for (int32_t q = 0; q < pair_cnt[i]; q++) {
        const uint8_t rank = (uint8_t)(p[q] & 0xFF);
        uint8_t* reg = row + (p[q] >> 8);
        if (*reg < rank) *reg = rank;
      }
    } else {
      continue;
    }
    folded++;
  }
  return folded;
}

// ---- io_uring ingest exports ---------------------------------------
// The rung above vtpu_recv_drain (ROADMAP item 1): a per-reader ring
// with a kernel-registered provided-buffer pool and one multishot
// IORING_OP_RECV that keeps completing with no per-packet syscall.
// Two consumption modes share the ring:
//   vtpu_uring_drain        copy-out, same contract as vtpu_recv_drain
//                           (admission-control paths that need a
//                           contiguous Python buffer)
//   vtpu_uring_parse_ingest zero-copy: datagrams are parsed IN PLACE
//                           in the caller-owned arena; consumed
//                           buffers are HELD out of the pool until
//                           vtpu_uring_release so miss/slow offsets
//                           into the arena stay valid through commit.
// All symbols export on every platform; without kernel support probe
// returns -ENOSYS and new fails, so the Python side needs no dlsym
// guards — only a return-code check.

#ifdef VTPU_HAVE_URING

static VtpuUring* vtpu_uring_create(int sock_fd, int32_t buf_count,
                                    int32_t buf_len, uint8_t* arena,
                                    int* err) {
  *err = 0;
  if (buf_count < 2 || buf_count > 32768 ||
      (buf_count & (buf_count - 1)) != 0 || buf_len < 64 ||
      arena == nullptr) {
    *err = EINVAL;
    return nullptr;
  }
  VtpuUring* u = new VtpuUring();
  u->sock_fd = sock_fd;
  u->arena = arena;
  u->buf_count = buf_count;
  u->buf_len = buf_len;
  u->bgid = 7;  // arbitrary nonzero group id, one ring per socket
  struct io_uring_params p;
  memset(&p, 0, sizeof(p));
  p.flags = IORING_SETUP_CQSIZE | IORING_SETUP_CLAMP;
  // CQ must absorb a full pool of completions between walks
  p.cq_entries = (unsigned)buf_count * 2;
  u->ring_fd = sys_uring_setup(8, &p);
  if (u->ring_fd < 0) {
    *err = errno;
    uring_destroy(u);
    return nullptr;
  }
  // uring_wait needs EXT_ARG timed getevents (5.11+); a kernel new
  // enough for multishot+PBUF_RING always has it, but check anyway
  if (!(p.features & IORING_FEAT_EXT_ARG)) {
    *err = EOPNOTSUPP;
    uring_destroy(u);
    return nullptr;
  }
  size_t sq_sz = p.sq_off.array + p.sq_entries * sizeof(unsigned);
  size_t cq_sz = p.cq_off.cqes
      + p.cq_entries * sizeof(struct io_uring_cqe);
  const bool single = (p.features & IORING_FEAT_SINGLE_MMAP) != 0;
  if (single) sq_sz = cq_sz = sq_sz > cq_sz ? sq_sz : cq_sz;
  u->sq_sz = sq_sz;
  u->sq_mem = mmap(nullptr, sq_sz, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_POPULATE, u->ring_fd,
                   IORING_OFF_SQ_RING);
  if (u->sq_mem == MAP_FAILED) {
    *err = errno;
    u->sq_mem = nullptr;
    uring_destroy(u);
    return nullptr;
  }
  u->cq_sz = cq_sz;
  if (single) {
    u->cq_mem = u->sq_mem;
  } else {
    u->cq_mem = mmap(nullptr, cq_sz, PROT_READ | PROT_WRITE,
                     MAP_SHARED | MAP_POPULATE, u->ring_fd,
                     IORING_OFF_CQ_RING);
    if (u->cq_mem == MAP_FAILED) {
      *err = errno;
      u->cq_mem = nullptr;
      uring_destroy(u);
      return nullptr;
    }
  }
  u->sqes_sz = p.sq_entries * sizeof(struct io_uring_sqe);
  u->sqes = (struct io_uring_sqe*)mmap(
      nullptr, u->sqes_sz, PROT_READ | PROT_WRITE,
      MAP_SHARED | MAP_POPULATE, u->ring_fd, IORING_OFF_SQES);
  if (u->sqes == MAP_FAILED) {
    *err = errno;
    u->sqes = nullptr;
    uring_destroy(u);
    return nullptr;
  }
  char* sqm = (char*)u->sq_mem;
  u->sq_head = (unsigned*)(sqm + p.sq_off.head);
  u->sq_tail = (unsigned*)(sqm + p.sq_off.tail);
  u->sq_mask = *(unsigned*)(sqm + p.sq_off.ring_mask);
  u->sq_array = (unsigned*)(sqm + p.sq_off.array);
  char* cqm = (char*)u->cq_mem;
  u->cq_head = (unsigned*)(cqm + p.cq_off.head);
  u->cq_tail = (unsigned*)(cqm + p.cq_off.tail);
  u->cq_mask = *(unsigned*)(cqm + p.cq_off.ring_mask);
  u->cqes = (struct io_uring_cqe*)(cqm + p.cq_off.cqes);
  // provided-buffer ring: page-aligned shared entries the kernel
  // reads on its own; registration is where RLIMIT_MEMLOCK or an
  // old kernel (EINVAL) says no
  u->buf_ring_sz = (size_t)buf_count * sizeof(VtpuIoBuf);
  const size_t page = 4096;
  u->buf_ring_sz = (u->buf_ring_sz + page - 1) & ~(page - 1);
  u->buf_ring = mmap(nullptr, u->buf_ring_sz, PROT_READ | PROT_WRITE,
                     MAP_ANONYMOUS | MAP_PRIVATE, -1, 0);
  if (u->buf_ring == MAP_FAILED) {
    *err = errno;
    u->buf_ring = nullptr;
    uring_destroy(u);
    return nullptr;
  }
  VtpuBufReg reg;
  memset(&reg, 0, sizeof(reg));
  reg.ring_addr = (uint64_t)(uintptr_t)u->buf_ring;
  reg.ring_entries = (uint32_t)buf_count;
  reg.bgid = u->bgid;
  if (sys_uring_register(u->ring_fd, IORING_REGISTER_PBUF_RING,
                         &reg, 1) < 0) {
    *err = errno;
    munmap(u->buf_ring, u->buf_ring_sz);
    u->buf_ring = nullptr;  // destroy must not UNREGISTER
    uring_destroy(u);
    return nullptr;
  }
  for (int32_t bid = 0; bid < buf_count; bid++) {
    uring_buf_recycle(u, bid);
  }
  uring_buf_store_tail(u);
  int r = uring_arm(u);
  if (r < 0) {
    *err = -r;
    uring_destroy(u);
    return nullptr;
  }
  // an unsupported multishot arm (pre-6.0 kernel) fails synchronously:
  // the error CQE is posted during submit, so peek right here.  A
  // positive-res CQE (data already queued on an adopted socket) is
  // left in place for the first walk.
  unsigned head = *u->cq_head;
  if (__atomic_load_n(u->cq_tail, __ATOMIC_ACQUIRE) != head) {
    struct io_uring_cqe* cqe = &u->cqes[head & u->cq_mask];
    if (cqe->res < 0 && cqe->res != -ENOBUFS) {
      *err = -cqe->res;
      uring_destroy(u);
      return nullptr;
    }
  }
  return u;
}

// Walk pending CQEs.  Per datagram the ``keep`` callback gets
// (bid, res) and returns true to HOLD the buffer (zero-copy path) or
// false to have it recycled immediately.  Stops after max_msgs kept
// datagrams or when ``room`` (callback-managed) says stop — room is
// checked BEFORE consuming a CQE so unconsumed completions survive to
// the next call.  Updates counters, recycles, republishes the buffer
// tail once, and re-arms when safe.  Returns kept count.
// (extern "C++" block: templates cannot carry C linkage; this helper
// is internal and never exported.)
extern "C++" {
template <typename KeepFn, typename RoomFn>
int64_t uring_walk(VtpuUring* u, int32_t max_msgs,
                          int32_t max_len, int32_t* n_oversize,
                          int32_t* n_enobufs, KeepFn keep,
                          RoomFn room) {
  unsigned head = *u->cq_head;
  int64_t kept = 0;
  int32_t recycled = 0;
  while (kept < max_msgs) {
    if (__atomic_load_n(u->cq_tail, __ATOMIC_ACQUIRE) == head) break;
    struct io_uring_cqe* cqe = &u->cqes[head & u->cq_mask];
    const bool has_buf = (cqe->flags & IORING_CQE_F_BUFFER) != 0;
    const int32_t res = cqe->res;
    // hide the arena's page-per-datagram stride: pull the NEXT
    // completion's buffer toward the cache while this one parses
    if (__atomic_load_n(u->cq_tail, __ATOMIC_RELAXED) != head + 1) {
      struct io_uring_cqe* nc = &u->cqes[(head + 1) & u->cq_mask];
      if (nc->flags & IORING_CQE_F_BUFFER)
        __builtin_prefetch(
            u->arena +
            (int64_t)(nc->flags >> IORING_CQE_BUFFER_SHIFT) *
                u->buf_len);
    }
    if (has_buf && res > 0 && res <= max_len && !room(res)) {
      break;  // leave this CQE for the next call
    }
    head++;
    u->completions++;
    if (!(cqe->flags & IORING_CQE_F_MORE)) u->armed = false;
    if (res < 0) {
      if (res == -ENOBUFS) {
        u->enobufs++;
        (*n_enobufs)++;
      } else {
        // terminal receive error: mark the backend dead so the
        // caller drops to the recvmmsg tier instead of spinning
        u->dead_errno = -res;
      }
      continue;
    }
    if (!has_buf) continue;  // zero-res completion without a buffer
    const int32_t bid = (int32_t)(cqe->flags >> IORING_CQE_BUFFER_SHIFT);
    u->consumed++;
    if (res > max_len) {
      // datagram filled past the caller's max length: the kernel
      // clipped it to buf_len, so parsing it would yield a silently
      // truncated final line — reject the whole packet, like the
      // recvmmsg tier does with MSG_TRUNC
      u->oversize++;
      (*n_oversize)++;
      uring_buf_recycle(u, bid);
      recycled++;
      continue;
    }
    if (res == 0) {
      uring_buf_recycle(u, bid);
      recycled++;
      continue;
    }
    kept++;
    if (!keep(bid, res)) {
      uring_buf_recycle(u, bid);
      recycled++;
    }
  }
  __atomic_store_n(u->cq_head, head, __ATOMIC_RELEASE);
  if (recycled > 0) uring_buf_store_tail(u);
  // re-arm only when the kernel has buffers to land the next packet
  // in; with the whole pool held, vtpu_uring_release re-arms instead
  // (re-arming into an empty pool would just manufacture ENOBUFS)
  if (!u->armed && u->dead_errno == 0 &&
      u->returned - u->consumed > 0) {
    int r = uring_arm(u);
    if (r < 0) u->dead_errno = -r;
  }
  uring_note_batch(u, kept);
  return kept;
}
}  // extern "C++"

// Startup probe: can this kernel/process actually run the multishot
// provided-buffer receive?  Builds a real (tiny) ring on a throwaway
// socket and tears it down.  0 = yes; -errno says which rung refused
// (ENOSYS io_uring, EPERM seccomp, EINVAL pre-PBUF_RING/multishot,
// ENOMEM/EPERM RLIMIT_MEMLOCK on registration).
int64_t vtpu_uring_probe(void) {
  int sfd = socket(AF_INET, SOCK_DGRAM, 0);
  if (sfd < 0) return -(int64_t)errno;
  struct sockaddr_in addr;
  memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  if (bind(sfd, (struct sockaddr*)&addr, sizeof(addr)) < 0) {
    int e = errno;
    close(sfd);
    return -(int64_t)e;
  }
  const int32_t kBufs = 8, kLen = 2048;
  uint8_t* arena = (uint8_t*)malloc((size_t)kBufs * kLen);
  if (arena == nullptr) {
    close(sfd);
    return -(int64_t)ENOMEM;
  }
  int err = 0;
  VtpuUring* u = vtpu_uring_create(sfd, kBufs, kLen, arena, &err);
  if (u != nullptr) uring_destroy(u);
  free(arena);
  close(sfd);
  return u != nullptr ? 0 : -(int64_t)err;
}

// Build a ring over an existing bound socket.  ``arena`` is CALLER
// OWNED (a numpy array on the Python side, so held datagram regions
// are sliceable with zero copies) and must stay alive until
// vtpu_uring_free.  Returns a handle, or NULL with *err_out = errno.
void* vtpu_uring_new(int32_t sock_fd, int32_t buf_count,
                     int32_t buf_len, uint8_t* arena,
                     int64_t* err_out) {
  int err = 0;
  VtpuUring* u = vtpu_uring_create(sock_fd, buf_count, buf_len,
                                   arena, &err);
  *err_out = (int64_t)err;
  return (void*)u;
}

void vtpu_uring_free(void* h) {
  uring_destroy((VtpuUring*)h);
}

// Snapshot for /debug/vars.  out must hold >= 32 int64s:
//  [0] buf_count  [1] buf_len  [2] pool buffers the kernel holds
//  [3] buffers held by the zero-copy parse  [4] completions
//  [5] oversize   [6] enobufs  [7] rearms   [8] batches
//  [9] armed      [10] dead_errno  [11] cq backlog
//  [12..21] completion-batch histogram (1,2,4,...,>=512)
void vtpu_uring_stats(void* h, int64_t* out) {
  VtpuUring* u = (VtpuUring*)h;
  memset(out, 0, 32 * sizeof(int64_t));
  if (u == nullptr) return;
  out[0] = u->buf_count;
  out[1] = u->buf_len;
  out[2] = u->returned - u->consumed;
  out[3] = (int64_t)u->held_bid.size();
  out[4] = u->completions;
  out[5] = u->oversize;
  out[6] = u->enobufs;
  out[7] = u->rearms;
  out[8] = u->batches;
  out[9] = u->armed ? 1 : 0;
  out[10] = u->dead_errno;
  out[11] = (int64_t)(__atomic_load_n(u->cq_tail, __ATOMIC_ACQUIRE)
                      - *u->cq_head);
  for (int i = 0; i < kUringHistBuckets; i++) out[12 + i] = u->hist[i];
}

// Copy-out drain: same output contract as vtpu_recv_drain (newline
// join, MSG_TRUNC-equivalent whole-packet rejection), but fed from
// the ring.  Blocks up to wait_ms for the first completion.  Used by
// paths that need a contiguous Python-owned buffer (admission
// control's columnar pre-pass).  Returns bytes written, 0 on
// timeout/empty, or -errno when the ring is dead.
int64_t vtpu_uring_drain(void* h, uint8_t* out, int64_t out_cap,
                         int32_t max_msgs, int32_t max_len,
                         int32_t wait_ms, int32_t wait_batch,
                         int32_t* n_msgs,
                         int32_t* n_oversize, int32_t* n_enobufs) {
  VtpuUring* u = (VtpuUring*)h;
  *n_msgs = 0;
  *n_oversize = 0;
  *n_enobufs = 0;
  if (u == nullptr) return -(int64_t)EINVAL;
  if (u->dead_errno) return -(int64_t)u->dead_errno;
  int wr = uring_wait(u, wait_ms, wait_batch);
  if (wr == -ETIME) return 0;
  if (wr < 0) {
    u->dead_errno = -wr;
    return (int64_t)wr;
  }
  int64_t w = 0;
  int64_t kept = uring_walk(
      u, max_msgs, max_len, n_oversize, n_enobufs,
      [&](int32_t bid, int32_t res) {
        memcpy(out + w, u->arena + (int64_t)bid * u->buf_len,
               (size_t)res);
        w += res;
        out[w++] = '\n';
        return false;  // copied out: recycle immediately
      },
      [&](int32_t res) { return w + res + 1 <= out_cap; });
  *n_msgs = (int32_t)kept;
  if (u->dead_errno && kept == 0) return -(int64_t)u->dead_errno;
  return w;
}

// Zero-copy fused drain+parse: waits up to wait_ms, walks completed
// datagrams, and runs the same fused parse pass as vtpu_parse_ingest
// on each datagram IN PLACE in the arena.  Miss/slow offsets
// (m_off/o_off) are ARENA offsets; the buffers backing them are held
// out of the pool until vtpu_uring_release, so the Python commit can
// slice the arena at leisure.  meta layout matches vtpu_parse_ingest.
// io_out: [0] datagrams parsed, [1] oversize rejected, [2] ENOBUFS
// completions, [3] held-buffer count after the call.  ``max_lines``
// bounds scratch usage: consumption stops (CQEs left for the next
// call) once the worst-case line count — every appended cursor is <=
// total nonempty lines, and a datagram of res bytes holds at most
// res/2+1 of them — could overrun the caller's column capacity.
// Returns payload bytes parsed, 0 on timeout/empty, -errno when the
// ring is dead.
int64_t vtpu_uring_parse_ingest(
    void* h, int32_t max_msgs, int32_t max_len, int32_t wait_ms,
    int32_t wait_batch, int32_t max_lines, void* tblp, int64_t hll_p,
    double* counter_dense, uint8_t* counter_touch,
    float* gauge_dense, uint8_t* gauge_mask, uint8_t* gauge_touch,
    int32_t* histo_rows, float* histo_vals, float* histo_wts,
    uint8_t* histo_touch,
    int32_t* set_rows, int32_t* set_pos, uint8_t* set_touch,
    uint64_t* m_keys, uint8_t* m_types, double* m_vals,
    uint64_t* m_members, float* m_wts,
    int64_t* m_off, int32_t* m_len,
    int64_t* o_off, int32_t* o_len, uint8_t* o_kind,
    int64_t* meta, int32_t* io_out) {
  VtpuUring* u = (VtpuUring*)h;
  io_out[0] = 0;
  io_out[1] = 0;
  io_out[2] = 0;
  io_out[3] = (int32_t)(u ? u->held_bid.size() : 0);
  if (u == nullptr) return -(int64_t)EINVAL;
  if (u->dead_errno) return -(int64_t)u->dead_errno;
  int wr = uring_wait(u, wait_ms, wait_batch);
  if (wr == -ETIME) return 0;
  if (wr < 0) {
    u->dead_errno = -wr;
    return (int64_t)wr;
  }
  VtpuIndex* t = (VtpuIndex*)tblp;
  const VtpuTab* tb = index_enter(t);  // see vtpu_ingest's pin note
  FusedCursors cur{meta[0], meta[1], 0, 0, 0, 0, 0, 0};
  int64_t bytes = 0;
  int64_t lines_budget = max_lines;
  int64_t kept = uring_walk(
      u, max_msgs, max_len, &io_out[1], &io_out[2],
      [&](int32_t bid, int32_t res) {
        // budget the EXACT lines this datagram appends (cur.lines
        // delta); the room() check below keeps the res/2+1 worst
        // case as headroom so a pathological datagram still fits
        const int64_t lines_before = cur.lines;
        const int64_t base = (int64_t)bid * u->buf_len;
        parse_ingest_chunk(
            u->arena + base, res, base, tb, hll_p,
            counter_dense, counter_touch, gauge_dense, gauge_mask,
            gauge_touch, histo_rows, histo_vals, histo_wts,
            histo_touch, set_rows, set_pos, set_touch, m_keys,
            m_types, m_vals, m_members, m_wts, m_off, m_len, o_off,
            o_len, o_kind, meta, &cur);
        lines_budget -= cur.lines - lines_before;
        bytes += res;
        u->held_bid.push_back(bid);
        u->held_len.push_back(res);
        return true;  // parsed in place: hold until release
      },
      [&](int32_t res) { return lines_budget >= res / 2 + 1; });
  meta[0] = cur.hn;
  meta[1] = cur.sn;
  meta[2] = cur.mn;
  meta[3] += cur.processed;
  meta[4] += cur.cn;
  meta[5] += cur.gn;
  meta[11] = cur.on;
  index_exit(t);
  io_out[0] = (int32_t)kept;
  io_out[3] = (int32_t)u->held_bid.size();
  if (u->dead_errno && kept == 0) return -(int64_t)u->dead_errno;
  return bytes;
}

// Materialize the held datagrams as one newline-joined buffer — the
// rare paths that need a real bytes object (reindex-epoch replay
// through Table.ingest_buffer).  Returns bytes written, or the
// negated required capacity when out_cap is too small.
int64_t vtpu_uring_pending_copy(void* h, uint8_t* out,
                                int64_t out_cap) {
  VtpuUring* u = (VtpuUring*)h;
  if (u == nullptr) return 0;
  int64_t need = 0;
  for (size_t i = 0; i < u->held_len.size(); i++) {
    need += (int64_t)u->held_len[i] + 1;
  }
  if (need > out_cap) return -need;
  int64_t w = 0;
  for (size_t i = 0; i < u->held_bid.size(); i++) {
    memcpy(out + w,
           u->arena + (int64_t)u->held_bid[i] * u->buf_len,
           (size_t)u->held_len[i]);
    w += u->held_len[i];
    out[w++] = '\n';
  }
  return w;
}

// Return every held buffer to the pool (the commit that referenced
// them is done) and re-arm if the terminal-CQE path left the
// multishot down.  Returns 0, or -errno if the re-arm failed.
int64_t vtpu_uring_release(void* h) {
  VtpuUring* u = (VtpuUring*)h;
  if (u == nullptr) return 0;
  if (!u->held_bid.empty()) {
    for (size_t i = 0; i < u->held_bid.size(); i++) {
      uring_buf_recycle(u, u->held_bid[i]);
    }
    u->held_bid.clear();
    u->held_len.clear();
    uring_buf_store_tail(u);
  }
  if (!u->armed && u->dead_errno == 0) {
    int r = uring_arm(u);
    if (r < 0) {
      u->dead_errno = -r;
      return (int64_t)r;
    }
  }
  return u->dead_errno ? -(int64_t)u->dead_errno : 0;
}

#else  // !VTPU_HAVE_URING

// Stubs so the symbols always export: probe says ENOSYS, new fails,
// the rest are inert.  The Python side never needs dlsym guards.
int64_t vtpu_uring_probe(void) { return -38; }  // -ENOSYS
void* vtpu_uring_new(int32_t, int32_t, int32_t, uint8_t*,
                     int64_t* err_out) {
  *err_out = 38;
  return nullptr;
}
void vtpu_uring_free(void*) {}
void vtpu_uring_stats(void*, int64_t* out) {
  memset(out, 0, 32 * sizeof(int64_t));
}
int64_t vtpu_uring_drain(void*, uint8_t*, int64_t, int32_t, int32_t,
                         int32_t, int32_t, int32_t* n_msgs,
                         int32_t* n_oversize, int32_t* n_enobufs) {
  *n_msgs = 0;
  *n_oversize = 0;
  *n_enobufs = 0;
  return -38;
}
int64_t vtpu_uring_parse_ingest(
    void*, int32_t, int32_t, int32_t, int32_t, int32_t, void*,
    int64_t,
    double*, uint8_t*, float*, uint8_t*, uint8_t*, int32_t*, float*,
    float*, uint8_t*, int32_t*, int32_t*, uint8_t*, uint64_t*,
    uint8_t*, double*, uint64_t*, float*, int64_t*, int32_t*,
    int64_t*, int32_t*, uint8_t*, int64_t*, int32_t* io_out) {
  io_out[0] = 0;
  io_out[1] = 0;
  io_out[2] = 0;
  io_out[3] = 0;
  return -38;
}
int64_t vtpu_uring_pending_copy(void*, uint8_t*, int64_t) {
  return 0;
}
int64_t vtpu_uring_release(void*) { return -38; }

#endif  // VTPU_HAVE_URING

}  // extern "C"
