// The fixpoint loop's device side for Hopper (sm_90a), behind a plain C
// interface: the convergence tests and the pointer-jump round.
//
// None of these replaces a Pallas kernel: the reference computes each in
// XLA inside its lax.while_loop (repro/connectivity/contour.py:244,
// fastsv.py:65, lp.py:49), so the loop never waits on the host.  The port
// keeps that loop's state on the card too, in four int32 words:
//
//   state[0] done    the loop's fixed-point flag; the sweep kernels
//                    (contour_mm.cu, mm2.cu) and jump_kernel read it and
//                    do nothing once it is set
//   state[1] it      the iterations run up to the fixed point
//   state[2] bad     this iteration's test: set to 1 (a plain store; the
//                    store is idempotent, so no atomic) where a witness of
//                    non-convergence turns up
//   state[3] ticket  blocks of this launch that have finished
//
// With step != 0, the last block of a test to finish does the loop's step
// in one thread: if (!done) { it += 1; done = !bad; }, then clears bad
// and ticket for the next iteration, so the host reads (done, it) in one
// 8-byte copy every k iterations instead of a flag every iteration.  With
// step == 0 the test only sets bad (the caller zeroed the words) and the
// result is bad == 0.
//
// converged_kernel  the paper's early-convergence predicate (section
//                   III-B2): edge e < m, (w, v) = (src[e], dst[e]), is a
//                   witness unless L[w] == L[v], L[w] == L[L[w]] and
//                   L[v] == L[L[v]].  Where L[w] == L[v] the last two are
//                   one test, so an edge needs L[L[w]] only then.
// unchanged_kernel  all(a == b) over two n-arrays: the no-change test of
//                   C-Syn, FastSV and label propagation.
// jump_kernel       one synchronous pointer-jump round, out of place:
//                   out[v] = done ? L[v] : min(L[v], L[L[v]]).  Out of
//                   place so that it stays the reference's round (a jump
//                   in place compresses further).
//
// What bounds them on an H100 (3.35 TB/s HBM): bytes.  The tests read
// each input once at the fixed point (8m + 4n bytes for the predicate, 8n
// for the no-change test) and compute nothing to speak of; in every
// iteration before the last a witness turns up in the first edges, so a
// test that stops there costs about a launch.  The design:
//   * a persistent grid (kBlocksPerSM blocks of kThreads threads an SM),
//     each warp walking steps of 32 * E consecutive items, lane l items
//     l, l + 32, ...: 128 contiguous bytes a load of a stream (evict-first,
//     the streams are read once), every stream load of a step issued
//     before the gathers that need them;
//   * the early exit: each warp re-reads bad and its block's witness mark
//     (shared memory) through volatile loads at every step (issued with
//     the step's stream loads, so they cost no round trip of their own),
//     and stops once either is set; a warp that finds a witness sets the
//     mark and stops, and the block stores bad once, at its end (a store
//     from every lane, or every warp, of the first wave queues at one L2
//     slice, which took 0.03-0.09 ms a test on an H100, PERF.md);
//   * the no-change test reads 16 bytes a lane a load where both arrays
//     are 16-byte aligned;
//   * the loop's step in the last block to finish (a ticket taken after
//     the store of bad and a __threadfence, the pattern of CUDA's
//     threadFenceReduction sample), so it costs no launch of its own;
//   * a test or a jump with done set returns at once: the iterations that
//     a chunk of k enqueues past the fixed point cost their launches and
//     the jump's copy (jump_kernel must still write out).  done is read
//     through the read-only path: no kernel writes it while another
//     reads it (the step writes it at the end of a test, after every
//     block of that test has read it).
// Ids are compared with n before they are followed: on the card an id
// outside [0, n) is never read through.  The tests count its edge as a
// witness; the jump copies its label.  (The plain versions raise
// IndexError.)  Each launcher returns the cudaGetLastError() code of its
// launch (0 = cudaSuccess).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 8;
constexpr int kEdges = 4;    // edges a lane a step of the predicate
constexpr int kPairs = 2;    // 16-byte vectors a lane a step of the
                             // no-change test (four times as many
                             // 4-byte items where unaligned)
constexpr int kJumps = 4;    // vertices a lane of the jump
constexpr unsigned kFull = 0xffffffffu;

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

// The block's witness mark (in shared memory), cleared at the start of a
// test.  A warp that finds a witness sets it and stops; the block's other
// warps see it at their next step, other blocks see bad once the block
// ends and stores it.
__device__ __forceinline__ void clear_mark(int* mark) {
  if (threadIdx.x == 0) *mark = 0;
  __syncthreads();
}

// Whether a warp's step should stop: a witness in bad or in its block's
// mark (the caller votes on it).
__device__ __forceinline__ bool witnessed(const int* bad, const int* mark) {
  return vload(bad) != 0 || vload(mark) != 0;
}

__device__ __forceinline__ void mark_witness(int* mark) {
  if ((threadIdx.x & 31) == 0) vstore(mark, 1);
}

// Every thread of every block calls this at the end of a test.  Thread 0
// stores a witness of its block into bad (unless bad is set already), and
// with step takes the block's ticket; the last block to arrive does the
// loop's step and clears bad and ticket.
__device__ __forceinline__ void finish(int* state, const int* mark,
                                       int step) {
  __syncthreads();  // every warp's mark before thread 0 reads it
  if (threadIdx.x != 0) return;
  int* bad = state + kBad;
  if (*mark && !vload(bad)) vstore(bad, 1);
  if (!step) return;
  __threadfence();  // the store of bad before the ticket
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

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
converged_kernel(const int* __restrict__ L, const int* __restrict__ src,
                 const int* __restrict__ dst, int64_t m, int64_t n,
                 int* state, int step) {
  // done is set only by the step at the end of a test, so every block of
  // this launch reads the same value here
  if (step && __ldg(state + kDone)) return;
  __shared__ int mark;
  clear_mark(&mark);
  const int* bad = state + kBad;
  constexpr int E = kEdges;
  const int64_t stride = (int64_t)gridDim.x * kWarps * (32 * E);
  for (int64_t e0 = ((int64_t)blockIdx.x * kWarps + threadIdx.x / 32) *
                        (32 * E) +
                    (threadIdx.x & 31);
       e0 - (threadIdx.x & 31) < m; e0 += stride) {
    const bool seen = witnessed(bad, &mark);
    int s[E], d[E];
    bool ok[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      ok[i] = e0 + 32 * i < m;
      s[i] = ok[i] ? __ldcs(src + e0 + 32 * i) : 0;
      d[i] = ok[i] ? __ldcs(dst + e0 + 32 * i) : 0;
    }
    if (__any_sync(kFull, seen)) break;
    bool witness = false;
    int ls[E], ld[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const bool in = inside(s[i], n) && inside(d[i], n);
      witness |= ok[i] && !in;
      ok[i] = ok[i] && in;
      ls[i] = ok[i] ? __ldg(L + s[i]) : 0;
      ld[i] = ok[i] ? __ldg(L + d[i]) : 0;
    }
    // L[w] == L[v] leaves one test, L[L[w]] == L[w]
#pragma unroll
    for (int i = 0; i < E; ++i) {
      witness |= ok[i] && (ls[i] != ld[i] || !inside(ls[i], n));
      ok[i] = ok[i] && ls[i] == ld[i] && inside(ls[i], n);
    }
    int l2[E];
#pragma unroll
    for (int i = 0; i < E; ++i) l2[i] = ok[i] ? __ldg(L + ls[i]) : 0;
#pragma unroll
    for (int i = 0; i < E; ++i) witness |= ok[i] && l2[i] != ls[i];
    if (__any_sync(kFull, witness)) {
      mark_witness(&mark);
      break;
    }
  }
  finish(state, &mark, step);
}

// Whether x and y differ in any of their four lanes.
__device__ __forceinline__ bool differ(const int4& x, const int4& y) {
  return x.x != y.x || x.y != y.y || x.z != y.z || x.w != y.w;
}

__device__ __forceinline__ bool differ(int x, int y) { return x != y; }

// T is int4 (both arrays 16-byte aligned; items are vectors of four, and
// the n % 4 elements past the last vector are compared by the first warp)
// or int.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
unchanged_kernel(const int* __restrict__ a, const int* __restrict__ b,
                 int64_t n, int* state, int step) {
  if (step && __ldg(state + kDone)) return;
  __shared__ int mark;
  clear_mark(&mark);
  const int* bad = state + kBad;
  constexpr int W = sizeof(T) / sizeof(int);
  constexpr int E = kPairs * (4 / W);
  const T* va = reinterpret_cast<const T*>(a);
  const T* vb = reinterpret_cast<const T*>(b);
  const int64_t items = n / W;
  const int lane = threadIdx.x & 31;
  if (W > 1 && blockIdx.x == 0 && threadIdx.x < 32) {
    const int64_t i = items * W + lane;
    if (__any_sync(kFull, i < n && __ldcs(a + i) != __ldcs(b + i)))
      mark_witness(&mark);
  }
  const int64_t stride = (int64_t)gridDim.x * kWarps * (32 * E);
  for (int64_t i0 = ((int64_t)blockIdx.x * kWarps + threadIdx.x / 32) *
                        (32 * E) +
                    lane;
       i0 - lane < items; i0 += stride) {
    const bool seen = witnessed(bad, &mark);
    T x[E], y[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const bool ok = i0 + 32 * i < items;
      x[i] = ok ? __ldcs(va + i0 + 32 * i) : T{};
      y[i] = ok ? __ldcs(vb + i0 + 32 * i) : T{};
    }
    if (__any_sync(kFull, seen)) break;
    bool witness = false;
#pragma unroll
    for (int i = 0; i < E; ++i) witness |= differ(x[i], y[i]);
    if (__any_sync(kFull, witness)) {
      mark_witness(&mark);
      break;
    }
  }
  finish(state, &mark, step);
}

__global__ void __launch_bounds__(kThreads)
jump_kernel(const int* __restrict__ L, int* __restrict__ out, int64_t n,
            const int* done) {
  const bool frozen = done != nullptr && __ldg(done);
  constexpr int E = kJumps;
  const int64_t v0 = (int64_t)blockIdx.x * (kThreads * E) + threadIdx.x;
  int l[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int64_t v = v0 + kThreads * i;
    l[i] = v < n ? __ldg(L + v) : 0;
  }
  if (!frozen) {
    int l2[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int64_t v = v0 + kThreads * i;
      l2[i] = v < n && inside(l[i], n) ? __ldg(L + l[i]) : l[i];
    }
#pragma unroll
    for (int i = 0; i < E; ++i) l[i] = min(l[i], l2[i]);
  }
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int64_t v = v0 + kThreads * i;
    if (v < n) __stcs(out + v, l[i]);
  }
}

// A persistent grid over `items` items, E a lane a step: at most
// kBlocksPerSM blocks an SM, at least one (the step needs a block even
// with no item).
int64_t test_blocks(int64_t items, int per_lane) {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess)
      sms = 132;
  }
  const int64_t steps = (items + 32 * per_lane - 1) / (32 * per_lane);
  const int64_t blocks = (steps + kWarps - 1) / kWarps;
  const int64_t most = (int64_t)sms * kBlocksPerSM;
  return blocks < 1 ? 1 : (blocks < most ? blocks : most);
}

}  // namespace

extern "C" {

// The predicate over edges [0, m) (the wrapper passes m = min(m,
// edge_limit)) of labels L of length n; state is four int32 words as
// above.  With step == 0 and m == 0 nothing is launched.
int contour_converged_early(const void* L, const void* src, const void* dst,
                            int64_t m, int64_t n, void* state, int step,
                            void* stream) {
  if (m < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (m == 0 && !step) return (int)cudaSuccess;
  converged_kernel<<<(unsigned)test_blocks(m, kEdges), kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const int*)L, (const int*)src, (const int*)dst, m, n, (int*)state,
      step);
  return (int)cudaGetLastError();
}

// all(a == b) over n elements; state and step as above.
int contour_labels_unchanged(const void* a, const void* b, int64_t n,
                             void* state, int step, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0 && !step) return (int)cudaSuccess;
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  if (aligned)
    unchanged_kernel<int4><<<(unsigned)test_blocks(n / 4, kPairs), kThreads,
                             0, (cudaStream_t)stream>>>(
        (const int*)a, (const int*)b, n, (int*)state, step);
  else
    unchanged_kernel<int><<<(unsigned)test_blocks(n, 4 * kPairs), kThreads,
                            0, (cudaStream_t)stream>>>(
        (const int*)a, (const int*)b, n, (int*)state, step);
  return (int)cudaGetLastError();
}

// out = one pointer-jump round of L (length n), or a copy of L when the
// word done (may be null) is set.  L and out are distinct.
int contour_pointer_jump(const void* L, void* out, int64_t n,
                         const void* done, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int64_t blocks = (n + kThreads * kJumps - 1) / (kThreads * kJumps);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  jump_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)L, (int*)out, n, (const int*)done);
  return (int)cudaGetLastError();
}

}  // extern "C"
