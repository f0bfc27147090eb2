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
// The kernels:
//   converged_vec_kernel  the paper's early-convergence predicate (section
//       III-B2; repro/connectivity/minmap.py:88 converged_early): edge
//       e < m, (w, v) = (src[e], dst[e]), is a witness unless L[w] == L[v],
//       L[w] == L[L[w]] and L[v] == L[L[v]] (where L[w] == L[v] the last
//       two are one test).  src and dst 16-byte aligned.
//   converged_kernel  the same predicate where src or dst is not 16-byte
//       aligned (a view): 4-byte loads, 4 edges a lane 32 apart.
//   unchanged_kernel  all(a == b) over two n-arrays: the no-change test of
//       C-Syn, FastSV and label propagation.
//   jump_kernel  one synchronous pointer-jump round, out of place:
//       out[v] = done ? L[v] : min(L[v], L[L[v]]).  Out of place so that it
//       stays the reference's round (a jump in place compresses further).
//
// What bounds the predicate on an H100: in a live iteration, a launch (a
// witness turns up in the first step of almost every warp); at the fixed
// point, a full pass over the edges, whose byte bound is 8m + 4n at 3.35
// TB/s (rmat(22,16) 0.158 ms, delaunay_like(24) 0.140) but which the label
// gathers hold far above it.  The canonical edges are sorted by w, so
// L[w] is nearly a stream; L[v] is one random 4-byte read an edge, and
// each costs the SM a 32-byte sector and a line of L1's tag throughput.
// Measured side by side on an H100 (tools/converged_variants.py, PERF.md
// section 6), at rmat(22,16)'s fixed point right after a jump round: the
// streams alone take 0.17 ms, the streams and the two first-level gathers
// 0.52 (the gather floor), this kernel 0.536 and the 4-byte kernel
// (converged_kernel) 0.539.  So on a power-law graph the floor is the
// rate at which the SMs take random sectors, not HBM, and no reordering
// of the same reads (16-byte stream loads, 4-16 edges a lane, every
// gather of a step before any compare, the root read once a label) moves
// it by more than 2%.  An L2 policy (labels evict_last through
// ld.global.nc.L2::cache_hint, streams evict_first and L1::no_allocate)
// gained nothing on rmat, whose 16.8 MB of labels stay in L2 anyway, and
// cost 13% on delaunay_like(24), whose 67 MB do not fit; the L1 carveout
// at its maximum and a plain store of K7's output (in place of __stcs)
// moved nothing.  None ships.  Only fewer sectors move the floor: the
// labels of rmat's 16384 most frequent destinations (38% of the L[v]
// reads) from shared memory took the pass to 0.42 ms, but a table made
// on the host costs 3.5 ms a graph to build, and one that each block
// fills itself (0.45 ms on rmat) takes 128 KB of shared memory, one block
// an SM, and made delaunay_like(24) 40% slower.  Neither ships.  What
// ships is what the mesh gains from (delaunay 0.185 ms, 0.207 for
// converged_kernel; live tests 2-16% faster):
//   * 16-byte stream loads (evict-first: read once), 4 consecutive edges
//     a lane a step, a persistent grid of 1024-thread blocks, two an SM
//     (256-thread blocks: 1-6% slower); an edge whose w repeats the edge
//     before reuses its L[w]; a lane reads L[L[w]] only for a label other
//     than the last it checked (a lane of the giant component checks its
//     root once);
//   * the early exit: each warp reads bad and its block's witness mark at
//     every step (issued with the step's stream loads; every 4 steps
//     doubled the test at rmat's state 2, where witnesses are sparse) and
//     stops once either is set; a warp that finds a witness sets the mark
//     and stops, and the block stores bad once, at its end (a store from
//     every lane, or every warp, of the first wave queues at one L2 slice,
//     which took 0.03-0.09 ms a test on an H100, PERF.md);
//   * the m % 4 edges past the last whole vector are tested by the first
//     warp of block 0;
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
// No launch sets a cache setting of its own (no persisting-L2 limit, no
// access-policy window, no carveout).  Ids are compared with n before
// they are followed: on the card an id outside [0, n) is never read
// through.  The tests count
// its edge as a witness; the jump copies its label.  (The plain versions
// raise IndexError.)  Each launcher returns the cudaGetLastError() code
// of its launch (0 = cudaSuccess).

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
// the fleet's no-change test: 16-byte vectors of each array a thread a
// tile, and the labels a tile (tools/unchanged_variants.py)
constexpr int kUnchangedVecs = 1;
constexpr int kUnchangedTile = kThreads * kUnchangedVecs * 4;
constexpr int kVecThreads = 1024;  // a block of the aligned predicate
constexpr int kVecBlocksPerSM = 2;
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

// The predicate on 16-byte aligned edges.

// One edge by itself (the m % 4 tail): whether it is a witness.
__device__ __forceinline__ bool edge_witness(const int* __restrict__ L,
                                             int w, int v, int64_t n) {
  if (!inside(w, n) || !inside(v, n)) return true;
  const int lw = __ldg(L + w), lv = __ldg(L + v);
  return lw != lv || !inside(lw, n) || __ldg(L + lw) != lw;
}

// One step of a warp: lane l tests the 4 edges of vector `vec` (vectors
// past `items` are no edges).  True where the warp stops: on a witness of
// its own (its block then marked) or on bad or the block's mark.
// `checked` is the last label whose root the lane checked.
__device__ __forceinline__ bool vec_step(const int* __restrict__ L,
                                         const int4* __restrict__ vs,
                                         const int4* __restrict__ vd,
                                         int64_t vec, int64_t items,
                                         int64_t n, const int* bad,
                                         int* mark, int& checked) {
  const bool seen = witnessed(bad, mark);
  const bool live = vec < items;
  const int4 a = live ? __ldcs(vs + vec) : make_int4(0, 0, 0, 0);
  const int4 b = live ? __ldcs(vd + vec) : make_int4(0, 0, 0, 0);
  if (__any_sync(kFull, seen)) return true;
  const int w[4] = {a.x, a.y, a.z, a.w};
  const int v[4] = {b.x, b.y, b.z, b.w};
  bool ok[4], need_w[4];
  bool witness = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool in = inside(w[i], n) && inside(v[i], n);
    witness |= live && !in;
    ok[i] = live && in;
  }
  // every first-level gather of the step before any compare; an edge
  // whose w repeats the edge before's reuses its L[w]
#pragma unroll
  for (int i = 0; i < 4; ++i)
    need_w[i] = ok[i] && !(i > 0 && ok[i - 1] && w[i] == w[i - 1]);
  int lw[4], lv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lw[i] = need_w[i] ? __ldg(L + w[i]) : 0;
    lv[i] = ok[i] ? __ldg(L + v[i]) : 0;
  }
#pragma unroll
  for (int i = 1; i < 4; ++i)
    if (ok[i] && !need_w[i]) lw[i] = lw[i - 1];
  // L[w] == L[v] leaves one test, L[L[w]] == L[w], asked once a label
  int last = checked;
  bool need_root[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    witness |= ok[i] && (lw[i] != lv[i] || !inside(lw[i], n));
    ok[i] = ok[i] && lw[i] == lv[i] && inside(lw[i], n);
    need_root[i] = ok[i] && lw[i] != last;
    if (ok[i]) last = lw[i];
  }
  int root[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    root[i] = need_root[i] ? __ldg(L + lw[i]) : 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) witness |= need_root[i] && root[i] != lw[i];
  // every label of a step without a witness had its root checked
  checked = last;
  if (!__any_sync(kFull, witness)) return false;
  mark_witness(mark);
  return true;
}

__global__ void __launch_bounds__(kVecThreads, kVecBlocksPerSM)
converged_vec_kernel(const int* __restrict__ L, const int* __restrict__ src,
                     const int* __restrict__ dst, int64_t m, int64_t n,
                     int* state, int step) {
  if (step && __ldg(state + kDone)) return;
  __shared__ int mark;
  clear_mark(&mark);
  const int* bad = state + kBad;
  const int lane = threadIdx.x & 31;
  const int64_t items = m / 4;
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const int64_t e = items * 4 + lane;
    if (__any_sync(kFull, e < m && edge_witness(L, src[e], dst[e], n)))
      mark_witness(&mark);
  }
  const int4* vs = reinterpret_cast<const int4*>(src);
  const int4* vd = reinterpret_cast<const int4*>(dst);
  const int64_t stride = (int64_t)gridDim.x * kVecThreads;
  int checked = -1;
  bool stop = false;
  for (int64_t vec = (int64_t)blockIdx.x * kVecThreads + threadIdx.x;
       !stop && vec - lane < items; vec += stride)
    stop = vec_step(L, vs, vd, vec, items, n, bad, &mark, checked);
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

// The fleet's loop (solve_batch): B graphs in one [B * n] label array,
// lane b's vertex v at b * n + v, and the stacked [B, m] edge arrays with
// the graphs' own ids (an edge's lane is its index / m).  Each lane keeps
// the four words above, lanes[4 * b + w]; the fleet keeps four more,
// fleet[w]: done (every lane done), it (the tests that found a lane
// live), and the test's ticket.  A test looks only at lanes not done and
// whose bad is not set yet; a witness stores its lane's bad (and fences,
// so the last block sees it).  The last block to take the fleet's ticket
// does each lane's step (if (!done) { it += 1; done = !bad; }; bad = 0)
// and sets the fleet's done once every lane is done, so the host reads
// (done, it) of the fleet, one 8-byte copy for all lanes.  A test with
// the fleet done returns at once.  The jump copies a lane that is done:
// a lane freezes at the iteration its test passes, as the reference's
// vmapped while_loop freezes it, and no later sweep or jump round of
// another lane moves it.  converged_batched_kernel and
// jump_batched_kernel are simple kernels, one item a thread of a
// persistent grid, no early exit: K6 fleet's and K7 fleet's "global"
// route, for lanes whose labels do not fit a block's shared memory; the
// others take the lane route of fleet.cu (kernels/contour_mm/fleet.py:
// fleet_route).
//
// unchanged_lanes_kernel, the fleet's no-change test (C-Syn's, Alg. 1
// line 10), replaces no Pallas kernel: the reference computes
// jnp.all(L_new == s.L) (repro/connectivity/contour.py:238) in XLA under
// its vmap (repro/connectivity/batch.py:198).  For each live lane b it
// asks all(a[b * n + v] == b[b * n + v]) over v < n, and then takes each
// lane's step through fleet_step.  Its bound on an H100 is 8 * B * n
// bytes at the fixed point (each array read once; 1024 x rmat(12,16):
// 33.5 MB, 0.0100 ms at 3.35 TB/s) and, live, the bytes up to each
// lane's first witness.  It holds no lane in shared memory, so one kernel
// takes every n.  The design:
//   * tiles of one lane: a tile is a slice of kUnchangedTile labels of
//     one lane, tile k = (slice k / B, lane k % B) in slice-major order
//     (one 32-bit division a tile, none a label: B * n < 2^31, so every
//     offset is 32-bit), walked by a persistent grid of kBlocksPerSM
//     blocks an SM, so a live fleet's first wave takes the lanes' first
//     slices and later tiles find their lane witnessed;
//   * thread 0 reads the lane's done and bad words once a tile, and the
//     block skips the tile (no label read) where either is set;
//   * 16-byte streaming loads (__ldcs), one vector of each array a
//     thread a tile, where a and b share their 16-byte phase; lane b
//     starts at b * n ints, so each lane's head up to its first 16-byte
//     boundary and its tail past its last whole vector (at most 3 labels
//     each) are compared as scalars by the lane's first tile.  Where the
//     phases differ (a view one int off), items are single ints, four a
//     thread;
//   * one witness a block: the block votes (__syncthreads_or), and
//     thread 0 makes the one store to the lane's bad word, with one
//     __threadfence a block, before its ticket, not one a witness;
//   * fleet_step, and the return at once on the fleet's done word, as
//     for the other fleet tests.
// The shape was timed against others by tools/unchanged_variants.py
// (PERF.md, NVIDIA H100 80GB HBM3): tiles of 2048 labels (two vectors a
// thread) took 1.5-1.6x as long live on the rmat fleet and as long at
// the fixed point; four vectors a thread spilled and took 1.4x; 128-,
// 512- and 1024-thread blocks, or 4 blocks an SM, were no faster on all
// three fleets; reading the next tile's words during a tile took 1.3x
// live and gained nothing at the fixed point.  The last block's pass over
// the lanes' words costs 1-2 us of the rmat fleet's 12-20 (B = 1024).

__device__ __forceinline__ bool lane_live(const int* lanes, int64_t lane) {
  // done through the read-only path (only the last block writes it, at
  // the end); bad read as it stands, to skip a lane already witnessed
  return !__ldg(lanes + 4 * lane + kDone) &&
         !vload(lanes + 4 * lane + kBad);
}

__device__ __forceinline__ void lane_witness(int* lanes, int64_t lane) {
  vstore(lanes + 4 * lane + kBad, 1);
  __threadfence();
}

// Every thread of every block calls this at the end of a fleet test.
__device__ void fleet_step(int* lanes, int64_t B, int* fleet) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(reinterpret_cast<unsigned*>(fleet + kTicket), 1u) ==
           gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  int all = 1, live = 0;
  for (int64_t b = threadIdx.x; b < B; b += blockDim.x) {
    int* w = lanes + 4 * b;
    if (!vload(w + kDone)) {
      live = 1;
      const int ok = vload(w + kBad) == 0;
      vstore(w + kIt, vload(w + kIt) + 1);
      vstore(w + kDone, ok);
      all &= ok;
    }
    vstore(w + kBad, 0);
  }
  all = __syncthreads_and(all);
  live = __syncthreads_or(live);
  if (threadIdx.x == 0) {
    if (live) vstore(fleet + kIt, vload(fleet + kIt) + 1);
    vstore(fleet + kDone, all);
    vstore(fleet + kTicket, 0);
  }
}

__global__ void __launch_bounds__(kThreads)
converged_batched_kernel(const int* __restrict__ L,
                         const int* __restrict__ src,
                         const int* __restrict__ dst, int64_t m,
                         int64_t B, int64_t n, int* lanes, int* fleet) {
  if (__ldg(fleet + kDone)) return;
  const int64_t total = m * B, size = B * n;
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * kThreads) {
    const int64_t lane = e / m;
    if (!lane_live(lanes, lane)) continue;
    const int ws = __ldcs(src + e), wd = __ldcs(dst + e);
    bool witness = !inside(ws, n) || !inside(wd, n);
    if (!witness) {
      const int lw = __ldg(L + lane * n + ws), lv = __ldg(L + lane * n + wd);
      witness = lw != lv || !inside(lw, size) || __ldg(L + lw) != lw;
    }
    if (witness) lane_witness(lanes, lane);
  }
  fleet_step(lanes, B, fleet);
}

// T is int4 (a and b share their 16-byte phase: items are vectors of 4
// labels after each lane's scalar head) or int.  per = the tiles a lane,
// phase = a's first label's index mod 4 (its 4-byte slot in 16 bytes).
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
unchanged_lanes_kernel(const int* __restrict__ a, const int* __restrict__ b,
                       uint32_t B, uint32_t n, uint32_t per, uint32_t phase,
                       int* lanes, int* fleet) {
  if (__ldg(fleet + kDone)) return;
  constexpr uint32_t W = sizeof(T) / sizeof(int);
  constexpr int E = kUnchangedTile / (kThreads * W);  // items a thread
  const uint32_t tiles = B * per, lid = threadIdx.x & 31;
  bool stored = false;  // thread 0's
  for (uint32_t k = blockIdx.x; k < tiles; k += gridDim.x) {
    const uint32_t slice = k / B, lane = k - slice * B;
    int* words = lanes + 4 * (size_t)lane;
    if (__syncthreads_or(threadIdx.x == 0 &&
                         (__ldg(words + kDone) || vload(words + kBad))))
      continue;
    const uint32_t first = lane * n;
    const uint32_t head =
        W == 1 ? 0u : min((4u - ((phase + first) & 3u)) & 3u, n);
    const uint32_t items = (n - head) / W;
    const T* va = reinterpret_cast<const T*>(a + first + head);
    const T* vb = reinterpret_cast<const T*>(b + first + head);
    const uint32_t i0 = slice * (kThreads * E) +
                        (threadIdx.x / 32) * (32 * E) + lid;
    T x[E], y[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const bool ok = i0 + 32 * i < items;
      x[i] = ok ? __ldcs(va + i0 + 32 * i) : T{};
      y[i] = ok ? __ldcs(vb + i0 + 32 * i) : T{};
    }
    bool witness = false;
    // the lane's head (threads 0-3) and tail (threads 4-7), with its
    // first tile
    if (W > 1 && slice == 0 && threadIdx.x < 8) {
      const uint32_t v = threadIdx.x < 4 ? threadIdx.x
                                         : head + items * W + threadIdx.x - 4;
      if (v < (threadIdx.x < 4 ? head : n))
        witness = __ldcs(a + first + v) != __ldcs(b + first + v);
    }
#pragma unroll
    for (int i = 0; i < E; ++i) witness |= differ(x[i], y[i]);
    if (__syncthreads_or(witness) && threadIdx.x == 0) {
      vstore(words + kBad, 1);
      stored = true;
    }
  }
  if (stored) __threadfence();  // the stores of bad before the ticket
  fleet_step(lanes, B, fleet);
}

__global__ void __launch_bounds__(kThreads)
jump_batched_kernel(const int* __restrict__ L, int* __restrict__ out,
                    int64_t size, int64_t n, const int* __restrict__ lanes) {
  const int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (v >= size) return;
  int l = __ldg(L + v);
  if (lanes == nullptr || !__ldg(lanes + 4 * (v / n) + kDone)) {
    if (inside(l, size)) l = min(l, __ldg(L + l));
  }
  __stcs(out + v, l);
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

// A persistent grid over `items` items, E a lane a step: at most
// kBlocksPerSM blocks an SM, at least one (the step needs a block even
// with no item).
int64_t test_blocks(int64_t items, int per_lane) {
  const int64_t steps = (items + 32 * per_lane - 1) / (32 * per_lane);
  const int64_t blocks = (steps + kWarps - 1) / kWarps;
  const int64_t most = (int64_t)sm_count() * kBlocksPerSM;
  return blocks < 1 ? 1 : (blocks < most ? blocks : most);
}

// The aligned predicate: a persistent grid of kVecBlocksPerSM blocks an
// SM, fewer where the vectors need fewer, at least one.
int vec_blocks(int64_t m) {
  const int64_t blocks = (m / 4 + kVecThreads - 1) / kVecThreads;
  const int64_t most = (int64_t)sm_count() * kVecBlocksPerSM;
  return (int)(blocks < 1 ? 1 : (blocks < most ? blocks : most));
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
  const bool aligned = ((reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  if (aligned)
    converged_vec_kernel<<<(unsigned)vec_blocks(m), kVecThreads, 0,
                           (cudaStream_t)stream>>>(
        (const int*)L, (const int*)src, (const int*)dst, m, n, (int*)state,
        step);
  else
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

// The fleet's early-convergence test over the stacked [B, m] edges of
// labels of length B * n; lanes [B, 4] and fleet [4] as above.
int contour_converged_early_batched(const void* L, const void* src,
                                    const void* dst, int64_t m, int64_t B,
                                    int64_t n, void* lanes, void* fleet,
                                    void* stream) {
  if (m < 0 || B <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  converged_batched_kernel<<<(unsigned)test_blocks(m * B, 1), kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const int*)L, (const int*)src, (const int*)dst, m, B, n,
      (int*)lanes, (int*)fleet);
  return (int)cudaGetLastError();
}

// The fleet's no-change test over two [B * n] arrays (B * n < 2^31).
int contour_labels_unchanged_batched(const void* a, const void* b,
                                     int64_t B, int64_t n, void* lanes,
                                     void* fleet, void* stream) {
  if (B <= 0 || n < 0 || B * n >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a),
                  pb = reinterpret_cast<uintptr_t>(b);
  const uint32_t per = (uint32_t)((n + kUnchangedTile - 1) / kUnchangedTile);
  const int64_t most = (int64_t)sm_count() * kBlocksPerSM;
  const int64_t tiles = B * per;
  const unsigned blocks =
      (unsigned)(tiles < 1 ? 1 : (tiles < most ? tiles : most));
  if (((pa ^ pb) & 15) == 0)
    unchanged_lanes_kernel<int4><<<blocks, kThreads, 0,
                                   (cudaStream_t)stream>>>(
        (const int*)a, (const int*)b, (uint32_t)B, (uint32_t)n, per,
        (uint32_t)((pa >> 2) & 3), (int*)lanes, (int*)fleet);
  else
    unchanged_lanes_kernel<int><<<blocks, kThreads, 0,
                                  (cudaStream_t)stream>>>(
        (const int*)a, (const int*)b, (uint32_t)B, (uint32_t)n, per, 0u,
        (int*)lanes, (int*)fleet);
  return (int)cudaGetLastError();
}

// out = one pointer-jump round of the fleet's labels (length size = B *
// n), a copy of each lane whose done word is set (lanes may be null).
int contour_pointer_jump_batched(const void* L, void* out, int64_t size,
                                 int64_t n, const void* lanes,
                                 void* stream) {
  if (size <= 0 || n <= 0) return (int)cudaSuccess;
  const int64_t blocks = (size + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  jump_batched_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int*)L, (int*)out, size, n, (const int*)lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
