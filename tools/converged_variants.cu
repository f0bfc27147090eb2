// Design variants of the port's early-convergence kernel K6
// converged_early (src/repro_torch/kernels/contour_mm/csrc/converged.cu),
// built and timed side by side by tools/converged_variants.py.  Not used
// by the port: this file is the record of what each design choice of that
// kernel was measured against.
//
// Every variant is one instance of variant_kernel<F, J, MINB, THREADS>:
//   F     a set of the flags below;
//   J     16-byte vectors (4 consecutive edges) of each edge stream a
//         lane takes a step: lane l takes vectors l, l + 32, ... of its
//         warp's step, so a warp's load is 512 contiguous bytes;
//   MINB  the blocks an SM must hold (__launch_bounds__' second value);
//   THREADS  threads a block.
// The grid is persistent: as many blocks as the occupancy calculator fits
// on the card at once, fewer where the edges need fewer.  The m % 4 edges
// past the last whole vector are tested by the first warp of block 0.
// Every variant takes the kernel's loop state (done, it, bad, ticket) and
// does the loop's step in its last block, as the shipped kernel does.
// Also here: the pointer-jump round K7 with its store evict-first (__stcs,
// as converged.cu's jump_kernel stores them) and plain, to time the test
// on labels as either leaves them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the jump round's blocks
constexpr unsigned kFull = 0xffffffffu;
constexpr int kExitEvery = 4;  // steps between two reads of bad and mark

constexpr int GATHER = 1;      // the first-level gathers L[w], L[v]
constexpr int ROOT = 2;        // L[L[w]] where L[w] == L[v], every edge
constexpr int ROOT_MATCH = 4;  // ... by one lane a distinct label a warp
                               // (__match_any_sync)
constexpr int ROOT_LANE = 8;   // ... skipped where the lane's last checked
                               // label is the same
constexpr int EXIT = 16;       // read bad and the block's mark every
                               // kExitEvery steps; stop on a witness
constexpr int POLICY = 32;     // gathers ld.global.nc.L2::cache_hint under
                               // evict_last; streams L1::no_allocate under
                               // evict_first
constexpr int HUB = 64;        // dst labels of the hub table's vertices from
                               // shared memory
constexpr int CARVE = 128;     // the L1 carveout at its maximum (launcher)
constexpr int SRC_REUSE = 256; // an edge of a vector reuses the edge
                               // before's L[w] where w repeats
constexpr int EXIT1 = 512;     // read bad and the mark every step
constexpr int HUB2 = 1024;     // HUB with two entries a bucket, filled
                               // after the block's first step
constexpr int FILL_BAD = 2048; // ... not where bad is set by then
constexpr int FILL_LATE = 4096;  // ... after the block's second step
constexpr int SELF2 = 8192;    // no table from the host: a two-way cache
                               // of (id, label) pairs in shared memory,
                               // emptied at the start, a miss's pair put
                               // in way 1, a hit in way 1 swapped into
                               // way 0 (the hubs stay in way 0)
constexpr int SELF1 = 16384;   // ... direct-mapped, a miss replaces
constexpr int SELF_LATE = 32768;  // ... emptied after the block's first
                                  // step finds no witness
constexpr int SELF = SELF2 | SELF1;

enum Word { kDone = 0, kIt = 1, kBad = 2, kTicket = 3 };

__device__ __forceinline__ int vload(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}
__device__ __forceinline__ void vstore(int* p, int v) {
  *reinterpret_cast<volatile int*>(p) = v;
}
__device__ __forceinline__ bool inside(int id, int64_t n) {
  return id >= 0 && (int64_t)id < n;
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

// L[i] where pred, else 0: through the read-only path, with the L2 policy
// where F has POLICY
template <int F>
__device__ __forceinline__ int gather(const int* L, int i, bool pred,
                                      uint64_t policy) {
  if (F & POLICY) {
    int v;
    asm volatile(
        "{\n\t.reg .pred q;\n\t"
        "setp.ne.b32 q, %2, 0;\n\t"
        "mov.b32 %0, 0;\n\t"
        "@q ld.global.nc.L2::cache_hint.b32 %0, [%1], %3;\n\t}"
        : "=r"(v)
        : "l"(L + i), "r"((int)pred), "l"(policy));
    return v;
  }
  return pred ? __ldg(L + i) : 0;
}

// one 16-byte vector of an edge stream where pred, else zeros
template <int F>
__device__ __forceinline__ int4 stream4(const int4* p, bool pred,
                                        uint64_t policy) {
  if (F & POLICY) {
    int4 v;
    asm volatile(
        "{\n\t.reg .pred q;\n\t"
        "setp.ne.b32 q, %4, 0;\n\t"
        "mov.b32 %0, 0;\n\tmov.b32 %1, 0;\n\t"
        "mov.b32 %2, 0;\n\tmov.b32 %3, 0;\n\t"
        "@q ld.global.nc.L1::no_allocate.L2::cache_hint.v4.s32 "
        "{%0, %1, %2, %3}, [%5], %6;\n\t}"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "r"((int)pred), "l"(p), "l"(policy));
    return v;
  }
  return pred ? __ldcs(p) : make_int4(0, 0, 0, 0);
}

__device__ __forceinline__ unsigned hub_slot(int id, int bits) {
  return ((unsigned)id * 2654435761u) >> (32 - bits);
}

// Whether edge (s, d) is a witness, one edge by itself (the tail).
template <int F>
__device__ __forceinline__ bool edge_witness(const int* L, int s, int d,
                                             int64_t n) {
  if (!(F & GATHER)) return false;
  if (!inside(s, n) || !inside(d, n)) return true;
  const int ls = __ldg(L + s), ld = __ldg(L + d);
  if (ls != ld) return true;
  if (!(F & (ROOT | ROOT_MATCH | ROOT_LANE))) return false;
  return !inside(ls, n) || __ldg(L + ls) != ls;
}

__device__ __forceinline__ void finish(int* state, const int* mark,
                                       int step) {
  __syncthreads();
  if (threadIdx.x != 0) return;
  int* bad = state + kBad;
  if (*mark && !vload(bad)) vstore(bad, 1);
  if (!step) return;
  __threadfence();
  if (atomicAdd(reinterpret_cast<unsigned*>(state + kTicket), 1u) !=
      gridDim.x - 1)
    return;
  __threadfence();
  if (!vload(state + kDone)) {
    vstore(state + kIt, vload(state + kIt) + 1);
    vstore(state + kDone, vload(bad) == 0);
  }
  vstore(bad, 0);
  vstore(state + kTicket, 0);
}

// The hub table's labels: direct-mapped (HUB: one (id, label) an slot,
// filled before the first step) or two-way (HUB2: two a bucket, read by
// one 16-byte load, filled after the block's first step finds no witness,
// so that a live test does not pay for it).
struct Hubs {
  const int2* slots;
  const int4* buckets;
  unsigned long long* cache;  // SELF: (id << 32 | label), ~0: empty
  int bits;
};

__device__ __forceinline__ unsigned long long pack(int id, int label) {
  return ((unsigned long long)(unsigned)id << 32) | (unsigned)label;
}
__device__ __forceinline__ int id_of(unsigned long long e) {
  return (int)(e >> 32);
}

// The label of vertex d from the hub table, or -1 where it is not there.
template <int F>
__device__ __forceinline__ int hub_label(const Hubs& h, int d) {
  if (F & HUB) {
    const int2 e = h.slots[hub_slot(d, h.bits)];
    return e.x == d ? e.y : -1;
  }
  if (F & HUB2) {
    const int4 b = h.buckets[hub_slot(d, h.bits - 1)];
    return b.x == d ? b.y : (b.z == d ? b.w : -1);
  }
  if (F & SELF1) {
    const unsigned long long e = h.cache[hub_slot(d, h.bits)];
    return id_of(e) == d ? (int)e : -1;
  }
  if (F & SELF2) {
    ulonglong2* b = reinterpret_cast<ulonglong2*>(h.cache) +
                    hub_slot(d, h.bits - 1);
    const ulonglong2 e = *b;
    if (id_of(e.x) == d) return (int)e.x;
    if (id_of(e.y) != d) return -1;
    *b = make_ulonglong2(e.y, e.x);
    return (int)e.y;
  }
  return -1;
}

// SELF: the pair of a vertex whose label was read from L.
template <int F>
__device__ __forceinline__ void hub_keep(const Hubs& h, int d, int label) {
  if (F & SELF1) h.cache[hub_slot(d, h.bits)] = pack(d, label);
  if (F & SELF2) h.cache[2 * hub_slot(d, h.bits - 1) + 1] = pack(d, label);
}

// One step of a warp over vectors v0, v0 + 32, ... (J of them a lane):
// true where the warp stops, on a witness of its own (its block then
// marked) or, with check, on bad or the block's mark.
template <int F, int J, bool TABLE>
__device__ __forceinline__ bool warp_step(
    const int* __restrict__ L, const int4* vs, const int4* vd, int64_t v0,
    int64_t items, int64_t n, const int* bad, int* mark, bool check,
    const Hubs& hubs, uint64_t last_policy, uint64_t first_policy,
    int& known, bool& any, unsigned& fold) {
  constexpr int E = 4 * J;
  const int lane = threadIdx.x & 31;
  const bool seen = check && (vload(bad) != 0 || vload(mark) != 0);
  int s[E], d[E];
  bool ok[E];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const bool okv = v0 + 32 * j < items;
    const int4 a = stream4<F>(vs + v0 + 32 * j, okv, first_policy);
    const int4 b = stream4<F>(vd + v0 + 32 * j, okv, first_policy);
    s[4 * j] = a.x; s[4 * j + 1] = a.y; s[4 * j + 2] = a.z;
    s[4 * j + 3] = a.w;
    d[4 * j] = b.x; d[4 * j + 1] = b.y; d[4 * j + 2] = b.z;
    d[4 * j + 3] = b.w;
#pragma unroll
    for (int k = 0; k < 4; ++k) ok[4 * j + k] = okv;
  }
  if (check && __any_sync(kFull, seen)) return true;
  if (!(F & GATHER)) {
#pragma unroll
    for (int i = 0; i < E; ++i) fold = fold * 31u + (unsigned)(s[i] ^ d[i]);
    return false;
  }
  bool witness = false;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const bool in = inside(s[i], n) && inside(d[i], n);
    witness |= ok[i] && !in;
    ok[i] = ok[i] && in;
  }
  // every first-level gather of the step before any compare
  bool need_s[E], need_d[E];
  int from_hub[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    need_s[i] = ok[i];
    if ((F & SRC_REUSE) && i % 4 != 0)
      need_s[i] = ok[i] && s[i] != s[i - 1];
    from_hub[i] = TABLE && ok[i] ? hub_label<F>(hubs, d[i]) : -1;
    need_d[i] = ok[i] && from_hub[i] < 0;
  }
  int ls[E], ld[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    ls[i] = gather<F>(L, s[i], need_s[i], last_policy);
    ld[i] = gather<F>(L, d[i], need_d[i], last_policy);
  }
#pragma unroll
  for (int i = 0; i < E; ++i) {
    if ((F & SRC_REUSE) && i % 4 != 0 && !need_s[i]) ls[i] = ls[i - 1];
    if (TABLE && from_hub[i] >= 0) ld[i] = from_hub[i];
    if (TABLE && (F & SELF) && need_d[i]) hub_keep<F>(hubs, d[i], ld[i]);
  }
#pragma unroll
  for (int i = 0; i < E; ++i) {
    witness |= ok[i] && ls[i] != ld[i];
    ok[i] = ok[i] && ls[i] == ld[i];
  }
  if (F & (ROOT | ROOT_MATCH | ROOT_LANE)) {
    bool need[E];
    int last = known;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      witness |= ok[i] && !inside(ls[i], n);
      ok[i] = ok[i] && inside(ls[i], n);
      need[i] = ok[i];
      if (F & ROOT_MATCH) {
        const unsigned peers = __match_any_sync(kFull, ok[i] ? ls[i] : -1);
        need[i] = ok[i] && (__ffs(peers) - 1) == lane;
      }
      if (F & ROOT_LANE) {
        need[i] = ok[i] && ls[i] != last;
        if (ok[i]) last = ls[i];
      }
    }
    int l2[E];
#pragma unroll
    for (int i = 0; i < E; ++i)
      l2[i] = gather<F>(L, ls[i], need[i], last_policy);
#pragma unroll
    for (int i = 0; i < E; ++i) witness |= need[i] && l2[i] != ls[i];
    if (F & ROOT_LANE) known = last;
  }
  if (!(F & (EXIT | EXIT1))) {
    any |= witness;
    return false;
  }
  if (!__any_sync(kFull, witness)) return false;
  if (lane == 0) vstore(mark, 1);
  return true;
}

template <int F, int J, int MINB, int THREADS>
__global__ void __launch_bounds__(THREADS, MINB)
variant_kernel(const int* __restrict__ L, const int* __restrict__ src,
               const int* __restrict__ dst, int64_t m, int64_t n,
               int* state, int step, const int* __restrict__ hub_ids,
               int hub_bits, int* sink) {
  if (step && __ldg(state + kDone)) return;
  constexpr int kWarpsHere = THREADS / 32;
  extern __shared__ int4 table[];
  __shared__ int mark;
  const Hubs hubs{reinterpret_cast<const int2*>(table), table,
                  reinterpret_cast<unsigned long long*>(table), hub_bits};
  if ((F & SELF) && !(F & SELF_LATE))
    for (int i = threadIdx.x; i < (1 << hub_bits); i += THREADS)
      hubs.cache[i] = ~0ull;
  if (F & HUB) {
    int2* slots = reinterpret_cast<int2*>(table);
    for (int i = threadIdx.x; i < (1 << hub_bits); i += THREADS) {
      const int id = hub_ids[i];
      slots[i] = make_int2(id, id >= 0 ? __ldg(L + id) : 0);
    }
  }
  if (threadIdx.x == 0) mark = 0;
  __syncthreads();
  const int* bad = state + kBad;
  const int lane = threadIdx.x & 31;
  uint64_t last_policy = 0, first_policy = 0;
  if (F & POLICY) {
    last_policy = evict_last_policy();
    first_policy = evict_first_policy();
  }
  const int64_t items = m / 4;
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const int64_t e = items * 4 + lane;
    const bool w = e < m && edge_witness<F>(L, src[e], dst[e], n);
    if (__any_sync(kFull, w) && lane == 0) vstore(&mark, 1);
  }
  const int4* vs = reinterpret_cast<const int4*>(src);
  const int4* vd = reinterpret_cast<const int4*>(dst);
  const int64_t stride = (int64_t)gridDim.x * kWarpsHere * (32 * J);
  int known = -1;        // ROOT_LANE: a label this lane found a root
  bool any = false;      // a witness, where F has no EXIT
  unsigned fold = 0;     // the streams folded, where F has no GATHER
  int64_t v0 = ((int64_t)blockIdx.x * kWarpsHere + threadIdx.x / 32) *
                   (32 * J) + lane;
  int it = 0;
  bool stop = false;
  if (F & (HUB2 | SELF_LATE)) {
    // the first step (two with FILL_LATE) without the table; the table
    // only where no warp of the block found a witness (nor, with
    // FILL_BAD, another block)
    for (int k = 0; k < ((F & FILL_LATE) ? 2 : 1); ++k, v0 += stride, ++it)
      if (!stop && v0 - lane < items)
        stop = warp_step<F, J, false>(L, vs, vd, v0, items, n, bad, &mark,
                                      true, hubs, last_policy, first_policy,
                                      known, any, fold);
    const bool quit = stop || ((F & FILL_BAD) && threadIdx.x == 0 &&
                               vload(bad) != 0);
    if (__syncthreads_or(quit)) {
      stop = true;
    } else if (F & HUB2) {
      int4* buckets = table;
      for (int i = threadIdx.x; i < (1 << (hub_bits - 1)); i += THREADS) {
        const int a = hub_ids[2 * i], b = hub_ids[2 * i + 1];
        buckets[i] = make_int4(a, a >= 0 ? __ldg(L + a) : 0, b,
                               b >= 0 ? __ldg(L + b) : 0);
      }
      __syncthreads();
    } else {
      for (int i = threadIdx.x; i < (1 << hub_bits); i += THREADS)
        hubs.cache[i] = ~0ull;
      __syncthreads();
    }
  }
  for (; !stop && v0 - lane < items; v0 += stride, ++it) {
    const bool check = (F & EXIT1) || ((F & EXIT) && it % kExitEvery == 0);
    stop = warp_step<F, J, (F & (HUB | HUB2 | SELF)) != 0>(
        L, vs, vd, v0, items, n, bad, &mark, check, hubs, last_policy,
        first_policy, known, any, fold);
  }
  if (!(F & (EXIT | EXIT1)) && (F & GATHER) && __any_sync(kFull, any) &&
      lane == 0)
    vstore(&mark, 1);
  if (!(F & GATHER) && fold == 0x5bd1e995u) *sink = (int)fold;
  finish(state, &mark, step);
}

template <bool STREAMING>
__global__ void __launch_bounds__(kThreads)
jump_kernel(const int* __restrict__ L, int* __restrict__ out, int64_t n) {
  constexpr int E = 4;
  const int64_t v0 = (int64_t)blockIdx.x * (kThreads * E) + threadIdx.x;
  int l[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int64_t v = v0 + kThreads * i;
    l[i] = v < n ? __ldg(L + v) : 0;
  }
  int l2[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int64_t v = v0 + kThreads * i;
    l2[i] = v < n && inside(l[i], n) ? __ldg(L + l[i]) : l[i];
  }
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int64_t v = v0 + kThreads * i;
    if (v >= n) continue;
    if (STREAMING)
      __stcs(out + v, min(l[i], l2[i]));
    else
      out[v] = min(l[i], l2[i]);
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

template <int F, int J, int MINB, int THREADS>
int launch(const int* L, const int* src, const int* dst, int64_t m,
           int64_t n, int* state, int step, const int* hub_ids,
           int hub_bits, int* sink, cudaStream_t stream) {
  auto kernel = variant_kernel<F, J, MINB, THREADS>;
  const size_t smem =
      (F & (HUB | HUB2 | SELF)) ? ((size_t)8 << hub_bits) : 0;
  static size_t configured = (size_t)-1;
  static int per_sm = 0;
  if (configured != smem) {
    cudaError_t rc = cudaSuccess;
    if (F & CARVE)
      rc = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxL1);
    if (rc == cudaSuccess && smem > 48 * 1024)
      rc = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         THREADS, smem);
    if (rc != cudaSuccess) return (int)rc;
    configured = smem;
  }
  constexpr int kWarpsHere = THREADS / 32;
  const int64_t steps = (m / 4 + 32 * J - 1) / (32 * J);
  int64_t blocks = (steps + kWarpsHere - 1) / kWarpsHere;
  const int64_t most = (int64_t)sm_count() * (per_sm < 1 ? 1 : per_sm);
  blocks = blocks < 1 ? 1 : (blocks < most ? blocks : most);
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      L, src, dst, m, n, state, step, hub_ids, hub_bits, sink);
  return (int)cudaGetLastError();
}

}  // namespace

// id, flags, J, MINB, THREADS.  The names are
// tools/converged_variants.py's: ids 1-13 the first set (floors, vector
// widths, the L2 policy, root reads, a direct-mapped table), 20-27 exit
// words every step without the policy and the two-way table, 28-30 when
// the table is filled, 31-34 the cache that the kernel fills itself.
#define VARIANTS(X)                                                        \
  X(1, 0, 2, 4, 256)                                 /* V1_streams */      \
  X(2, GATHER, 2, 4, 256)                            /* V2_gathers */      \
  X(3, GATHER | POLICY | CARVE, 2, 4, 256)           /* V2_policy */       \
  X(4, GATHER | ROOT | EXIT, 1, 8, 256)              /* V3_j1 */           \
  X(5, GATHER | ROOT | EXIT, 2, 4, 256)              /* V3 */              \
  X(6, GATHER | ROOT | EXIT, 4, 2, 256)              /* V3_j4 */           \
  X(7, GATHER | ROOT | EXIT | POLICY, 2, 4, 256)     /* V4_no_carve */     \
  X(8, GATHER | ROOT | EXIT | POLICY | CARVE, 2, 4, 256)   /* V4 */        \
  X(9, GATHER | ROOT | EXIT | POLICY | CARVE, 4, 2, 256)   /* V4_j4 */     \
  X(10, GATHER | ROOT_MATCH | EXIT | POLICY | CARVE, 2, 4, 256)            \
  /* V5_match_root */                                                      \
  X(11, GATHER | ROOT_LANE | SRC_REUSE | EXIT | POLICY | CARVE, 2, 4, 256) \
  /* V6_lane_root */                                                       \
  X(12, GATHER | ROOT_LANE | SRC_REUSE | EXIT | POLICY | HUB, 2, 4, 256)   \
  /* V7_hub12, V7_hub13 */                                                 \
  X(13, GATHER | ROOT_LANE | SRC_REUSE | EXIT | POLICY | CARVE, 1, 8, 256) \
  /* V6_j1 */                                                              \
  X(20, GATHER, 1, 8, 256)                           /* V2_j1 */           \
  X(21, GATHER | ROOT | EXIT1, 1, 8, 256)            /* W_j1 */            \
  X(22, GATHER | ROOT_LANE | SRC_REUSE | EXIT1, 1, 8, 256) /* W_lane */    \
  X(23, GATHER | ROOT_LANE | SRC_REUSE | EXIT1, 2, 4, 256) /* W_lane_j2 */ \
  X(24, GATHER | ROOT_LANE | SRC_REUSE | EXIT1 | HUB2, 1, 3, 256)          \
  /* H_256_13 */                                                           \
  X(25, GATHER | ROOT_LANE | SRC_REUSE | EXIT1 | HUB2, 1, 3, 512)          \
  /* H_512_13 */                                                           \
  X(26, GATHER | ROOT_LANE | SRC_REUSE | EXIT1 | HUB2, 1, 1, 1024)         \
  /* H_1024_14 */                                                          \
  X(27, GATHER | ROOT_LANE | SRC_REUSE | EXIT1 | HUB2, 2, 1, 1024)         \
  /* H_1024_14_j2 */                                                       \
  X(28, GATHER | ROOT_LANE | SRC_REUSE | EXIT1 | HUB2 | FILL_BAD, 1, 1,    \
    1024)                                            /* H_bad */           \
  X(29, GATHER | ROOT_LANE | SRC_REUSE | EXIT1 | HUB2 | FILL_LATE, 1, 1,   \
    1024)                                            /* H_late */          \
  X(30, GATHER | ROOT_LANE | SRC_REUSE | EXIT1 | HUB2 | FILL_BAD |         \
    FILL_LATE, 1, 1, 1024)                           /* H_late_bad */ \
  X(31, GATHER | ROOT_LANE | SRC_REUSE | EXIT1 | SELF2, 1, 1, 1024)        \
  /* S2 */                                                                 \
  X(32, GATHER | ROOT_LANE | SRC_REUSE | EXIT1 | SELF1, 1, 1, 1024)        \
  /* S1 */                                                                 \
  X(33, GATHER | ROOT_LANE | SRC_REUSE | EXIT1 | SELF2 | SELF_LATE, 1, 1,  \
    1024)                                            /* S2_late */         \
  X(34, GATHER | ROOT_LANE | SRC_REUSE | EXIT1 | SELF2, 1, 2, 512)         \
  /* S2_512_13 */

#define CASE(ID, F, J, MINB, THREADS)                                      \
  case ID:                                                                 \
    return launch<(F), (J), (MINB), (THREADS)>(                            \
        (const int*)L, (const int*)src, (const int*)dst, m, n,             \
        (int*)state, step, (const int*)hub_ids, hub_bits, (int*)sink,      \
        (cudaStream_t)stream);

extern "C" {

// Returns the launch's CUDA error, or -1 for an id not built.  src and
// dst must be 16-byte aligned.
int variant_converged(int id, const void* L, const void* src,
                      const void* dst, int64_t m, int64_t n, void* state,
                      int step, const void* hub_ids, int hub_bits,
                      void* sink, void* stream) {
  if (m < 0 || n < 0) return (int)cudaErrorInvalidValue;
  switch (id) { VARIANTS(CASE) }
  return -1;
}

// out = min(L, L[L]) over n labels, stored evict-first (streaming != 0)
// or plainly.
int variant_jump(int streaming, const void* L, void* out, int64_t n,
                 void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreads * 4 - 1) / (kThreads * 4);
  if (streaming)
    jump_kernel<true><<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>((const int*)L, (int*)out, n);
  else
    jump_kernel<false><<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>((const int*)L, (int*)out,
                                                 n);
  return (int)cudaGetLastError();
}

}  // extern "C"
