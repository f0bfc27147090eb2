// The fleet's lane-resident kernels for Hopper (sm_90a), behind a plain C
// interface: K1's order-2 sweep, K6's early-convergence test, K2's
// scatter-min of an update stream and K7's pointer-jump round over a fleet
// of B graphs (solve_batch), each lane's labels held in shared memory
// while its edges (K2: its runs of updates) stream past them.
//
// relax_lane_kernel      replaces, for the fleet,
//     repro/kernels/contour_mm/blocked.py::fused_relax_pallas (blocked.py:
//     236), which the reference's solve_batch vmaps; its whole-L-in-VMEM
//     tile is what the reference's planner picks for graphs of n <= 4096
//     (repro/connectivity/planner/heuristics.py:28, SINGLE_TILE_MAX_N).
//     Per edge (s, d) of lane b: ls = L[s], ld = L[d], z = min(L[ls],
//     L[ld]), min'ed into s, d, ls and ld of the output.
// converged_lane_kernel  the paper's early-convergence predicate
//     (repro/connectivity/minmap.py:88 converged_early, XLA in the
//     reference's vmapped loop) of each live lane over its own edges, and
//     each lane's loop step.
// scatter_lane_kernel    replaces, for the fleet,
//     repro/kernels/contour_mm/blocked.py::binned_scatter_min_pallas
//     (blocked.py:92), vmapped: L[t] min= v over the order-1 and order-h
//     update streams, whose 2 * order segments of [B, m] put lane b's
//     updates in contiguous runs of m (the wrapper's run=).
// jump_lane_kernel       one pointer-jump round min(L, L[L])
//     (repro/connectivity/minmap.py:75 pointer_jump, XLA in the reference's
//     vmapped loop), a copy of each frozen lane.
//
// The fleet's layout is that of contour_mm.cu / converged.cu's batched
// kernels (the "global" route, kept there): one [B * n] label array, lane
// b's vertex v at b * n + v, labels that are such ids; the stacked [B, m]
// edge arrays with each graph's own ids; lanes the fleet's [B, 4] loop
// words (done, it, bad, unused) and fleet its four (done, it, unused,
// ticket).
//
// What bounds them on an H100: the edges, 8 bytes an edge read once from
// HBM (3.35 TB/s), against the label gathers.  The global route gathers
// every label from L2 (four dependent reads an edge for K1, three for K6)
// and finds its lane with an int64 division an item; here a block takes
// one lane (or one of c slices of its edges, c from blocks_per_lane, set
// by the Python side's fleet_route from B, n and the card), copies the
// lane's n labels into shared memory (16-byte loads, four in flight a
// thread), and streams the lane's contiguous edges through a ring of
// kStages tiles in shared memory, one thread issuing a stage's
// cp.async.bulk copies, which complete on the stage's mbarrier.  (Every
// thread loading the next tile with 16-byte ld.global.nc.L1::no_allocate
// while the block worked on the current one took 24-73% longer at K1's
// first sweep and K6's fixed point, on both fleets, in each card run of
// the shipped shapes, PERF.md, and was dropped.)  A tile's window starts
// at the 16-byte boundary at or below its first edge, for src and dst
// each, so any 4-byte aligned view and any m are taken.  Every gather of
// an in-lane label is a shared-memory read; a label outside its lane (the
// entry points take any labels in [0, B * n)) is read from global memory
// and an update to it goes to the global output with atomicMin, so the
// result stays exact.
//
// The shapes (RelaxCfg, TestCfg, ScatterCfg, JumpCfg) were timed against
// others on the card by
// tools/fleet_variants.py (PERF.md): a block-wide __syncthreads_or a tile
// beat a release a warp through a shared counter (the warps drifting
// apart cost 8-18%), more stages bought nothing, more edges a thread and
// 512-thread blocks did (a delaunay_like(14) lane's 128 KB of K1 labels
// leaves one block an SM), and a warp combine of runs of updates to one
// target before K1's shared atomics cost 8%.  K1 at the fixed point (no
// update) takes as long as at the first sweep: the stream and the
// gathers hold it, not the atomics or the merge.
//
// K2's shape (ScatterCfg) is K1's: 256 x 8 and 512 x 4 x 3 stages came
// within 1-3% on the rmat and delaunay fleets (the latter 4% slower on
// the ragged one), 256 x 16 8% slower on delaunay, 1024 x 4 4% slower on
// rmat.  K7's (JumpCfg), 512 threads x 8 labels (two 16-byte vectors a
// thread) at 4 blocks an SM, keeps 2048 threads an SM on 16 KB lanes and
// 1536 on 64 KB ones (3 blocks an SM by shared memory): 256 x 16 took
// 1-12% longer, 256 x 16 at 8 an SM was 6% faster on rmat but 10-12%
// slower on the ragged fleet, 1024 x 8 25% slower on rmat.  After the L2 flush that
// precedes each timed call, K7 takes 1.04x a plain copy of its labels:
// the flushed lines, not the second-level reads, hold it there.  With the
// labels in L2, as in a solve, it is 11-35% faster than the global route
// on each fleet.
//
// K1's sweep keeps the global route's pruning: an edge's duplicate
// targets are dropped, an update that cannot lower its target's input
// label is dropped, the second-level read of a root (L[v] == v) is
// skipped, and the shared output is read before the shared atomicMin (a
// hub's label falls early in the first sweep).  The block's output starts
// as a copy of the lane's input; at the end the entries it lowered are
// min'ed into the wrapper's copy of L with atomicMin (REDG), which does
// not depend on order, so the c slices of a lane and any out-of-lane
// updates merge exactly.  A frozen lane's blocks return at once.
//
// K6's test fetches a block's first tile alone and stops the block at the
// first tile with a witness (the __syncthreads_or), so a live lane costs
// its labels and one tile; with c > 1 a block also stops once another
// block of its lane has stored the lane's bad word (read once a tile).
// With c == 1 the lane's own block does its step (if (!done) { it += 1;
// done = !witness; }) and marks the lane as stepped in its bad word; the
// last block to take the fleet's ticket reads every lane's done and bad
// once, clears the marks, adds 1 to the fleet's it if any lane stepped and
// sets the fleet's done if every lane is done.  With c > 1 a block that
// finds a witness stores the lane's bad, and the last block does each
// lane's step as the global route's does.  After every test the words
// equal fleet_step_plain's.
//
// K2 streams 8 bytes an update (the bound: 8 B * n + 8 K at 3.35 TB/s); the
// global route paid an int64 division, a read of its lane's done word and
// an L2 gather an update and sent every update that could lower its label
// to L2 as a red, which piled onto each lane's hubs.  Here a block takes
// one lane, copies its n labels once into one shared array S (no second
// array: its input is read again from L2 at the merge, which doubles the
// lane cap), and streams its slice of each of the lane's runs through the
// ring (the runs sit B * run apart; a block takes [lo, hi) of every run).
// An in-lane update reads S first and issues the shared atomicMin only
// where it lowers S (a hub's label falls early); an update to another
// lane's target goes to the global output where it lowers that target's
// input label and that lane is live.  A K2 update is frozen by its
// target's lane: a frozen lane's block holds no labels and drops its
// in-lane updates, but still streams its runs for their out-of-lane
// updates.  The merge mins the entries of S below their input into the
// wrapper's copy of L (REDG), exact for any c and any out-of-lane update.
//
// K7 moves 8 bytes a label (the lane read once, written once); the global
// route paid an int64 division and a read of the lane's done word a label.
// Here a block takes one lane (c > 1: a slice of its 16-byte vectors),
// reads the done word once, copies a live lane's n labels into shared
// memory with 16-byte loads and writes min(L[v], L[L[v]]) with 16-byte
// streaming stores, the second level a shared read (a label of another
// lane from global memory, one outside [0, B * n) copied); a frozen lane
// is copied and reads no second level.  Reading both levels through L1
// instead (a lane is 16 KB on the rmat fleet), with no copy in shared
// memory, was 1-10% slower on each fleet at the shipped shape, so the
// shared read ships and the L1 read was dropped.
//
// Ids are compared with their range before they are followed: an edge
// whose endpoint is outside [0, n), or whose label is outside [0, B * n),
// is skipped by K1 and is a witness for K6 (as on the global route).
// Each launcher returns the cudaGetLastError() code of its launch (0 =
// cudaSuccess), or cudaErrorInvalidValue for arguments it refuses (a
// lane's labels past the block's shared memory among them).

#include <cuda_runtime.h>
#include <stdint.h>

// The design's knobs, each kernel's own: threads a block, edges a thread
// a tile, stages of the ring, and the blocks an SM that its registers must
// allow (__launch_bounds__).  tools/fleet_variants.py builds this file with
// other values (-D) to time them against each other.
#ifndef FLEET_RELAX_THREADS
#define FLEET_RELAX_THREADS 512
#endif
#ifndef FLEET_RELAX_EDGES
#define FLEET_RELAX_EDGES 8
#endif
#ifndef FLEET_RELAX_STAGES
#define FLEET_RELAX_STAGES 2
#endif
#ifndef FLEET_RELAX_MIN_BLOCKS
#define FLEET_RELAX_MIN_BLOCKS 2
#endif
#ifndef FLEET_TEST_THREADS
#define FLEET_TEST_THREADS 256
#endif
#ifndef FLEET_TEST_EDGES
#define FLEET_TEST_EDGES 8
#endif
#ifndef FLEET_TEST_STAGES
#define FLEET_TEST_STAGES 2
#endif
#ifndef FLEET_TEST_MIN_BLOCKS
#define FLEET_TEST_MIN_BLOCKS 4
#endif
#ifndef FLEET_SCATTER_THREADS
#define FLEET_SCATTER_THREADS 512
#endif
#ifndef FLEET_SCATTER_EDGES
#define FLEET_SCATTER_EDGES 8
#endif
#ifndef FLEET_SCATTER_STAGES
#define FLEET_SCATTER_STAGES 2
#endif
#ifndef FLEET_SCATTER_MIN_BLOCKS
#define FLEET_SCATTER_MIN_BLOCKS 2
#endif
// K7's labels a thread a pass (a multiple of 4: 16-byte vectors)
#ifndef FLEET_JUMP_THREADS
#define FLEET_JUMP_THREADS 512
#endif
#ifndef FLEET_JUMP_EDGES
#define FLEET_JUMP_EDGES 8
#endif
#ifndef FLEET_JUMP_MIN_BLOCKS
#define FLEET_JUMP_MIN_BLOCKS 4
#endif

namespace {

// A kernel's shape: kThreads a block, kEdges a thread a tile, a ring of
// kStages tiles, each stage a window of kWindow ints of src and of dst (a
// tile and the 16-byte boundary around it).
template <int kThreads_, int kEdges_, int kStages_, int kMinBlocks_>
struct Cfg {
  static constexpr int kThreads = kThreads_;
  static constexpr int kEdges = kEdges_;
  static constexpr int kTile = kThreads * kEdges;
  static constexpr int kStages = kStages_;
  static constexpr int kMinBlocks = kMinBlocks_;
  static constexpr int kWindow = kTile + 4;
  static constexpr int kRingInts = kStages * 2 * kWindow;
};

using RelaxCfg = Cfg<FLEET_RELAX_THREADS, FLEET_RELAX_EDGES,
                     FLEET_RELAX_STAGES, FLEET_RELAX_MIN_BLOCKS>;
using TestCfg = Cfg<FLEET_TEST_THREADS, FLEET_TEST_EDGES, FLEET_TEST_STAGES,
                    FLEET_TEST_MIN_BLOCKS>;
using ScatterCfg = Cfg<FLEET_SCATTER_THREADS, FLEET_SCATTER_EDGES,
                       FLEET_SCATTER_STAGES, FLEET_SCATTER_MIN_BLOCKS>;
// no ring: K7 reads its lane's labels alone
using JumpCfg = Cfg<FLEET_JUMP_THREADS, FLEET_JUMP_EDGES, 0,
                    FLEET_JUMP_MIN_BLOCKS>;
static_assert(JumpCfg::kEdges % 4 == 0, "K7 takes 16-byte vectors");

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

// ---------------------------------------------------------------------------
// the edge stream
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Whether the phase of `bar` with this parity has completed (the wait
// may suspend the thread for a while first).
__device__ __forceinline__ bool bar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  while (!bar_try(bar, parity)) {
  }
}

__device__ __forceinline__ void bulk_load(int* dst, const int* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Where edge e of an array sits in its tile's window: the ints between
// the 16-byte boundary at or below it and e.
__device__ __forceinline__ int lead(const int* base, int64_t e) {
  return (int)((reinterpret_cast<uintptr_t>(base + e) >> 2) & 3);
}

// The ints of a window that covers `cnt` edges from a lead of r: a whole
// number of 16-byte chunks.
__device__ __forceinline__ int window_ints(int r, int cnt) {
  return (r + cnt + 3) & ~3;
}

// The ring in shared memory: stage s holds src's window, then dst's.
template <class C>
struct Ring {
  int* ints;

  __device__ __forceinline__ int* src(int s) const {
    return ints + s * 2 * C::kWindow;
  }
  __device__ __forceinline__ int* dst(int s) const {
    return ints + s * 2 * C::kWindow + C::kWindow;
  }
};

// One barrier a stage, which completes once the stage's two copies have
// landed.
template <class C>
struct Barriers {
  uint64_t full[C::kStages];
};

// One thread issues tile [e, e + cnt)'s two copies into stage s.
template <class C>
__device__ __forceinline__ void issue_bulk(const Ring<C>& ring, int s,
                                           uint64_t* bar, const int* src,
                                           const int* dst, int64_t e,
                                           int cnt) {
  const int rs = lead(src, e), rd = lead(dst, e);
  const int ws = window_ints(rs, cnt), wd = window_ints(rd, cnt);
  bar_expect(bar, (uint32_t)(ws + wd) * 4u);
  bulk_load(ring.src(s), src + e - rs, (uint32_t)ws * 4u, bar);
  bulk_load(ring.dst(s), dst + e - rd, (uint32_t)wd * 4u, bar);
}

// The tiles a block streams: `segs` segments, segment r the elements
// [first + r * stride + lo, first + r * stride + hi) of both arrays (K1 and
// K6: one segment, a slice of the lane's edges; K2: a slice of each of the
// lane's runs of updates), each cut into tiles of C::kTile.  Each thread
// finds a tile's place once a tile, on the path of every tile: one segment
// takes no division, and several take one 32-bit division (a block's
// tiles are far fewer than 2^32), since an int64 division there cost K1
// and K6 fleet 1-3% on the card.
template <class C>
struct Tiles {
  int64_t first, stride, lo, hi, segs;
  uint32_t per;

  __device__ __forceinline__ Tiles(int64_t first_, int64_t stride_,
                                   int64_t lo_, int64_t hi_, int64_t segs_)
      : first(first_), stride(stride_), lo(lo_), hi(hi_), segs(segs_),
        per((uint32_t)((hi_ - lo_ + C::kTile - 1) / C::kTile)) {}

  __device__ __forceinline__ int64_t count() const { return segs * per; }
  // tile k's segment and its index there
  __device__ __forceinline__ void place(int64_t k, int64_t& r,
                                        int64_t& j) const {
    if (segs == 1) {
      r = 0;
      j = k;
    } else {
      const uint32_t q = (uint32_t)k / per;
      r = q;
      j = (uint32_t)k - q * per;
    }
  }
  __device__ __forceinline__ int64_t start(int64_t k) const {
    int64_t r, j;
    place(k, r, j);
    return first + r * stride + lo + j * C::kTile;
  }
  __device__ __forceinline__ int size(int64_t k) const {
    int64_t r, j;
    place(k, r, j);
    const int64_t left = hi - lo - j * C::kTile;
    return (int)(left < C::kTile ? left : C::kTile);
  }
};

// Streams the tiles of src/dst (K2: targets/values) through the ring:
// body(ts, td, cnt) gets a tile's elements at ts[i], td[i] (i < cnt) and
// returns this thread's stop vote; the block stops after the first tile
// on which a thread voted to stop (a __syncthreads_or a tile, which also
// frees the tile's stage).  Every thread of the block calls this; no copy
// is in flight once it returns.
//
// Thread 0 issues the first kStages tiles (with kStops, the first tile
// alone: a block that stops there fetches nothing more), and each tile's
// stage takes tile + kStages once the block is past it; every thread
// waits on its tile's barrier.  After a stop, thread 0 waits for the
// copies still in flight.
template <class C, bool kStops, typename Body>
__device__ __forceinline__ void stream_tiles(const int* __restrict__ src,
                                             const int* __restrict__ dst,
                                             const Tiles<C>& map,
                                             const Ring<C>& ring,
                                             Barriers<C>& bars, Body&& body) {
  const int64_t tiles = map.count();
  auto issue = [&](int64_t k) {
    const int s = (int)(k % C::kStages);
    issue_bulk(ring, s, bars.full + s, src, dst, map.start(k), map.size(k));
  };
  int64_t issued = 0;  // thread 0's
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) bar_init(bars.full + s);
    bar_init_fence();
    for (; issued < tiles && issued < (kStops ? 1 : C::kStages); ++issued)
      issue(issued);
  }
  __syncthreads();
  int64_t k = 0;
  for (; k < tiles; ++k) {
    const int s = (int)(k % C::kStages);
    bar_wait(bars.full + s, (uint32_t)((k / C::kStages) & 1));
    const int64_t e = map.start(k);
    const bool vote = body(ring.src(s) + lead(src, e),
                           ring.dst(s) + lead(dst, e), map.size(k));
    if (__syncthreads_or(kStops && vote)) break;
    if (threadIdx.x == 0)
      for (; issued < tiles && issued < k + 1 + C::kStages; ++issued)
        issue(issued);
  }
  // after a stop at tile k, tiles k + 1 .. issued - 1 are in flight
  if (threadIdx.x == 0)
    for (int64_t j = k + 1; j < issued; ++j)
      bar_wait(bars.full + j % C::kStages, (uint32_t)((j / C::kStages) & 1));
  __syncthreads();
}

// The lane's n labels from global memory into in (and out, where not
// null): 16-byte loads where the lane's labels and out are 16-byte
// aligned (in always is).
template <class C>
__device__ __forceinline__ void load_labels(const int* __restrict__ g,
                                            int* __restrict__ in,
                                            int* __restrict__ out,
                                            int64_t n) {
  constexpr int kLoads = 4;  // loads a thread has in flight
  const bool vec = ((reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int64_t head = vec ? n / 4 * 4 : 0;
  if (vec) {
    const int4* v = reinterpret_cast<const int4*>(g);
    const int64_t q = n / 4;
    for (int64_t i0 = threadIdx.x; i0 < q; i0 += kLoads * C::kThreads) {
      int4 x[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int64_t i = i0 + u * C::kThreads;
        if (i < q) x[u] = __ldg(v + i);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int64_t i = i0 + u * C::kThreads;
        if (i >= q) break;
        reinterpret_cast<int4*>(in)[i] = x[u];
        if (out != nullptr) reinterpret_cast<int4*>(out)[i] = x[u];
      }
    }
  }
  for (int64_t i = head + threadIdx.x; i < n; i += C::kThreads) {
    const int x = __ldg(g + i);
    in[i] = x;
    if (out != nullptr) out[i] = x;
  }
}

// Lane (blockIdx.x / c) and the bounds of slice (blockIdx.x % c) of its
// edges, as flat indices of the [B, m] arrays.
struct Slice {
  int64_t lane, e0, e1;
};

// Items [lo, hi) of m that block `part` of a lane's c takes
// (fleet.slice_bounds).
struct Part {
  int64_t lo, hi;
};

__device__ __forceinline__ Part part_of(int64_t m, int c, int64_t part) {
  const int64_t q = (m + c - 1) / c;
  return {part * q < m ? part * q : m,
          (part + 1) * q < m ? (part + 1) * q : m};
}

__device__ __forceinline__ Slice slice_of(int64_t m, int c) {
  const int64_t lane = blockIdx.x / c;
  const Part p = part_of(m, c, blockIdx.x % c);
  return {lane, lane * m + p.lo, lane * m + p.hi};
}

// The lane's labels: in [base, base + n) from shared memory, else from
// global memory.
struct LaneLabels {
  const int* in;
  const int* __restrict__ global;
  int base;
  int n;

  __device__ __forceinline__ bool own(int id) const {
    return (unsigned)(id - base) < (unsigned)n;
  }
  __device__ __forceinline__ int operator[](int id) const {
    return own(id) ? in[id - base] : __ldg(global + id);
  }
};

// ---------------------------------------------------------------------------
// K1 fleet: the order-2 sweep
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(RelaxCfg::kThreads, RelaxCfg::kMinBlocks)
relax_lane_kernel(const int* __restrict__ L_in, int* __restrict__ L_out,
                  const int* __restrict__ src, const int* __restrict__ dst,
                  int64_t m, int64_t n, int64_t size, int c,
                  const int* __restrict__ lanes) {
  using C = RelaxCfg;
  extern __shared__ __align__(16) int smem[];
  __shared__ Barriers<C> bars;
  const Slice sl = slice_of(m, c);
  if (lanes != nullptr && __ldg(lanes + 4 * sl.lane) != 0) return;
  const Ring<C> ring{smem};
  int* in = smem + C::kRingInts;
  int* out = in + n;
  const int base = (int)(sl.lane * n);
  load_labels<C>(L_in + base, in, out, n);  // visible after the stream's sync
  const LaneLabels lab{in, L_in, base, (int)n};
  auto update = [&](bool live, int t, int z) {
    if (!live) return;
    if (lab.own(t)) {
      int* p = out + (t - base);
      // a stale read is never below the current value: sound
      if (*p > z) atomicMin(p, z);
    } else {
      atomicMin(L_out + t, z);
    }
  };
  stream_tiles<C, false>(
      src, dst, Tiles<C>(sl.e0, 0, 0, sl.e1 - sl.e0, 1), ring, bars,
      [&](const int* ts, const int* td, int cnt) {
        int s[C::kEdges], d[C::kEdges], ls[C::kEdges], ld[C::kEdges];
        bool ok[C::kEdges];
#pragma unroll
        for (int i = 0; i < C::kEdges; ++i) {
          const int j = threadIdx.x + i * C::kThreads;
          const int ws = j < cnt ? ts[j] : -1, wd = j < cnt ? td[j] : -1;
          ok[i] = inside(ws, n) && inside(wd, n);
          s[i] = ok[i] ? base + ws : 0;
          d[i] = ok[i] ? base + wd : 0;
        }
#pragma unroll
        for (int i = 0; i < C::kEdges; ++i) {
          ls[i] = ok[i] ? in[s[i] - base] : 0;
          ld[i] = ok[i] ? in[d[i] - base] : 0;
          ok[i] = ok[i] && inside(ls[i], size) && inside(ld[i], size);
        }
        int l2s[C::kEdges], l2d[C::kEdges];
#pragma unroll
        for (int i = 0; i < C::kEdges; ++i) {
          // a root's label is its own: L[L[s]] == L[s] where L[s] == s
          l2s[i] = ok[i] && ls[i] != s[i] ? lab[ls[i]] : ls[i];
          l2d[i] = ok[i] && ld[i] != d[i] ? lab[ld[i]] : ld[i];
        }
#pragma unroll
        for (int i = 0; i < C::kEdges; ++i) {
          const int z = min(l2s[i], l2d[i]);
          // each target with its input label; a later copy of an earlier
          // target has the same label, so the same condition: dropped
          update(ok[i] && z < ls[i], s[i], z);
          update(ok[i] && z < ld[i] && d[i] != s[i], d[i], z);
          update(ok[i] && z < l2s[i] && ls[i] != s[i] && ls[i] != d[i],
                 ls[i], z);
          update(ok[i] && z < l2d[i] && ld[i] != s[i] && ld[i] != d[i] &&
                     ld[i] != ls[i],
                 ld[i], z);
        }
        return false;
      });
  for (int64_t v = threadIdx.x; v < n; v += C::kThreads) {
    const int o = out[v];
    if (o < in[v]) atomicMin(L_out + base + v, o);
  }
}

// ---------------------------------------------------------------------------
// K6 fleet: the early-convergence test and each lane's step
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(TestCfg::kThreads, TestCfg::kMinBlocks)
converged_lane_kernel(const int* __restrict__ L, const int* __restrict__ src,
                      const int* __restrict__ dst, int64_t m, int64_t n,
                      int64_t size, int c, int* lanes, int* fleet) {
  using C = TestCfg;
  // done is set only by the last block of a test, after every block of
  // the launch has read it here
  if (__ldg(fleet + kDone)) return;
  extern __shared__ __align__(16) int smem[];
  __shared__ Barriers<C> bars;
  __shared__ int live, witnessed, last;
  const Slice sl = slice_of(m, c);
  int* w = lanes + 4 * sl.lane;
  if (threadIdx.x == 0) {
    live = !vload(w + kDone);
    // a bad word already set (with c > 1: another block's) is a witness
    witnessed = vload(w + kBad);
  }
  __syncthreads();
  if (live && !witnessed) {
    const Ring<C> ring{smem};
    int* in = smem + C::kRingInts;
    const int base = (int)(sl.lane * n);
    load_labels<C>(L + base, in, nullptr, n);
    const LaneLabels lab{in, L, base, (int)n};
    stream_tiles<C, true>(
        src, dst, Tiles<C>(sl.e0, 0, 0, sl.e1 - sl.e0, 1), ring, bars,
        [&](const int* ts, const int* td, int cnt) {
          bool witness = false;
#pragma unroll
          for (int i = 0; i < C::kEdges; ++i) {
            const int j = threadIdx.x + i * C::kThreads;
            if (j >= cnt) continue;
            const int ws = ts[j], wd = td[j];
            if (!inside(ws, n) || !inside(wd, n)) {
              witness = true;
              continue;
            }
            const int lw = in[ws], lv = in[wd];
            // L[w] == L[v] leaves one test, L[L[w]] == L[w]; a root's
            // label is its own
            witness |= lw != lv || !inside(lw, size) ||
                       (lw != base + ws && lab[lw] != lw);
          }
          if (witness) witnessed = 1;
          // another block of the lane has found a witness
          const bool other = c > 1 && threadIdx.x == 0 && vload(w + kBad);
          return witness || other;
        });
  }
  if (threadIdx.x == 0) {
    if (c == 1) {
      if (live) {
        vstore(w + kIt, vload(w + kIt) + 1);
        vstore(w + kDone, !witnessed);
        vstore(w + kBad, 1);  // stepped: the last block reads and clears it
      }
    } else if (live && witnessed) {
      vstore(w + kBad, 1);
    }
    __threadfence();  // the lane's words before the ticket
    last = atomicAdd(reinterpret_cast<unsigned*>(fleet + kTicket), 1u) ==
           gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int64_t lanes_b = gridDim.x / c;
  int all = 1, stepped = 0;
  for (int64_t b = threadIdx.x; b < lanes_b; b += C::kThreads) {
    int* x = lanes + 4 * b;
    const int done = __ldcg(x + kDone), bad = __ldcg(x + kBad);
    if (c == 1) {
      stepped |= bad;
      all &= done;
    } else if (!done) {
      stepped = 1;
      x[kIt] = __ldcg(x + kIt) + 1;
      x[kDone] = !bad;
      all &= !bad;
    }
    if (bad) x[kBad] = 0;
  }
  all = __syncthreads_and(all);
  stepped = __syncthreads_or(stepped);
  if (threadIdx.x == 0) {
    if (stepped) vstore(fleet + kIt, vload(fleet + kIt) + 1);
    vstore(fleet + kDone, all);
    vstore(fleet + kTicket, 0);
  }
}

// ---------------------------------------------------------------------------
// K2 fleet: the scatter-min of an update stream
// ---------------------------------------------------------------------------

// Lane b's in-lane updates min'ed into its copy S; an update to a target
// of another lane (in [0, size), its lane live) goes to the global output
// when it lowers that target's input label.  A frozen lane's block holds
// no labels and drops its in-lane updates (a K2 update is frozen by its
// target's lane).  At the end a live lane's block mins the entries of S
// below their input (read again from L2) into the wrapper's copy of L.
__global__ void __launch_bounds__(ScatterCfg::kThreads, ScatterCfg::kMinBlocks)
scatter_lane_kernel(const int* __restrict__ L_in, int* __restrict__ L_out,
                    const int* __restrict__ targets,
                    const int* __restrict__ values, int64_t run,
                    int64_t segs, int64_t lanes_b, int64_t n, int c,
                    const int* __restrict__ lanes) {
  using C = ScatterCfg;
  extern __shared__ __align__(16) int smem[];
  __shared__ Barriers<C> bars;
  const int64_t lane = blockIdx.x / c;
  const Part p = part_of(run, c, blockIdx.x % c);
  const bool live = lanes == nullptr || __ldg(lanes + 4 * lane) == 0;
  const Ring<C> ring{smem};
  int* S = smem + C::kRingInts;
  const int base = (int)(lane * n);
  const int64_t size = lanes_b * n;
  // visible after the stream's first __syncthreads
  if (live) load_labels<C>(L_in + base, S, nullptr, n);
  auto elsewhere = [&](int t, int v) {
    if (!inside(t, size)) return;
    if (lanes != nullptr && __ldg(lanes + 4 * ((unsigned)t / (unsigned)n)))
      return;
    if (v < __ldg(L_in + t)) atomicMin(L_out + t, v);
  };
  stream_tiles<C, false>(
      targets, values, Tiles<C>(lane * run, lanes_b * run, p.lo, p.hi, segs),
      ring, bars, [&](const int* tt, const int* tv, int cnt) {
        int t[C::kEdges], v[C::kEdges];
#pragma unroll
        for (int i = 0; i < C::kEdges; ++i) {
          const int j = threadIdx.x + i * C::kThreads;
          t[i] = j < cnt ? tt[j] : -1;
          v[i] = j < cnt ? tv[j] : 0;
        }
#pragma unroll
        for (int i = 0; i < C::kEdges; ++i) {
          const unsigned o = (unsigned)t[i] - (unsigned)base;
          if (o < (unsigned)n) {
            // a stale read is never below the current value: sound
            if (live && v[i] < S[o]) atomicMin(S + o, v[i]);
          } else {
            elsewhere(t[i], v[i]);
          }
        }
        return false;
      });
  if (!live) return;
  const int* g = L_in + base;
  const bool vec = ((reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(L_out + base)) & 15) == 0;
  const int64_t head = vec ? n / 4 * 4 : 0;
  for (int64_t i = threadIdx.x; i < head / 4; i += C::kThreads) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(g) + i);
    const int4 o = reinterpret_cast<const int4*>(S)[i];
    int* q = L_out + base + 4 * i;
    if (o.x < x.x) atomicMin(q, o.x);
    if (o.y < x.y) atomicMin(q + 1, o.y);
    if (o.z < x.z) atomicMin(q + 2, o.z);
    if (o.w < x.w) atomicMin(q + 3, o.w);
  }
  for (int64_t v = head + threadIdx.x; v < n; v += C::kThreads) {
    const int o = S[v];
    if (o < __ldg(g + v)) atomicMin(L_out + base + v, o);
  }
}

// ---------------------------------------------------------------------------
// K7 fleet: one pointer-jump round
// ---------------------------------------------------------------------------

// Block `part` of lane b's c writes labels [lo, hi) of the lane (lo a
// multiple of 4): out[v] = min(L[v], L[L[v]]), the second level from the
// lane's copy in shared memory; a label
// outside the lane from global memory, one outside [0, size) copied.  A
// frozen lane is copied.  16-byte loads and streaming stores where the
// lane's labels and output are 16-byte aligned.
__global__ void __launch_bounds__(JumpCfg::kThreads, JumpCfg::kMinBlocks)
jump_lane_kernel(const int* __restrict__ L, int* __restrict__ out,
                 int64_t n, int64_t size, int c,
                 const int* __restrict__ lanes) {
  using C = JumpCfg;
  constexpr int kVecs = C::kEdges / 4;  // 16-byte vectors a thread a pass
  extern __shared__ __align__(16) int smem[];
  const int64_t lane = blockIdx.x / c;
  const Part q = part_of((n + 3) / 4, c, blockIdx.x % c);
  const int64_t lo = 4 * q.lo < n ? 4 * q.lo : n;
  const int64_t hi = 4 * q.hi < n ? 4 * q.hi : n;
  const int base = (int)(lane * n);
  const int* g = L + base;
  int* o = out + base;
  const bool live = lanes == nullptr || __ldg(lanes + 4 * lane) == 0;
  if (live) {
    load_labels<C>(g, smem, nullptr, n);
    __syncthreads();
  }
  const LaneLabels lab{smem, L, base, (int)n};
  auto load4 = [&](int64_t i) {
    return live ? reinterpret_cast<const int4*>(smem)[i]
                : __ldg(reinterpret_cast<const int4*>(g) + i);
  };
  auto load1 = [&](int64_t v) { return live ? smem[v] : __ldg(g + v); };
  auto jump = [&](int x) {
    return live && inside(x, size) ? min(x, lab[x]) : x;
  };
  const bool vec = ((reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  const int64_t head = vec ? lo + (hi - lo) / 4 * 4 : lo;
  for (int64_t i0 = lo / 4 + threadIdx.x; i0 < head / 4;
       i0 += kVecs * C::kThreads) {
    int4 x[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int64_t i = i0 + u * C::kThreads;
      if (i < head / 4) x[u] = load4(i);
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int64_t i = i0 + u * C::kThreads;
      if (i >= head / 4) break;
      __stcs(reinterpret_cast<int4*>(o) + i,
             make_int4(jump(x[u].x), jump(x[u].y), jump(x[u].z),
                       jump(x[u].w)));
    }
  }
  for (int64_t v = head + threadIdx.x; v < hi; v += C::kThreads)
    __stcs(o + v, jump(load1(v)));
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The dynamic shared memory of a block of C: the ring and `arrays` label
// arrays of n.
template <class C>
int64_t smem_bytes(int64_t n, int arrays) {
  return (int64_t)C::kRingInts * 4 + (int64_t)arrays * 4 * n;
}

// Allow `bytes` of dynamic shared memory to the kernel (needed above 48
// KB); false where the card's block cannot hold them with the kernel's
// static shared memory.
bool allow_smem(const void* kernel, int64_t bytes) {
  int device = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kernel) != cudaSuccess)
    return false;
  if (bytes + (int64_t)attr.sharedSizeBytes > optin) return false;
  if (bytes > attr.maxDynamicSharedSizeBytes &&
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes) != cudaSuccess)
    return false;
  return true;
}

bool args_ok(int64_t lanes_b, int c, const void* src, const void* dst) {
  return lanes_b > 0 && c >= 1 && lanes_b * c <= 0x7fffffff &&
         ((reinterpret_cast<uintptr_t>(src) |
           reinterpret_cast<uintptr_t>(dst)) & 3) == 0;
}

}  // namespace

extern "C" {

// The card's opt-in shared memory of a block, shared memory of an SM,
// shared memory the system reserves for each block, and SM count, into
// out[0..3]; returns the CUDA error code of the queries.
int contour_fleet_device(int* out) {
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  const cudaDeviceAttr attrs[4] = {
      cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrReservedSharedMemoryPerBlock,
      cudaDevAttrMultiProcessorCount};
  for (int i = 0; i < 4 && rc == cudaSuccess; ++i)
    rc = cudaDeviceGetAttribute(out + i, attrs[i], device);
  return (int)rc;
}

// Each kernel's shape, for the Python side's route: threads a block, items
// a tile, stages, dynamic shared memory of the ring (bytes) and the blocks
// an SM its registers allow, five ints a kernel into out[0..19]: K1, K6,
// K2, K7 (fleet.SHAPES' order).
void contour_fleet_shapes(int* out) {
  const int shapes[20] = {
      RelaxCfg::kThreads, RelaxCfg::kTile, RelaxCfg::kStages,
      RelaxCfg::kRingInts * 4, RelaxCfg::kMinBlocks,
      TestCfg::kThreads, TestCfg::kTile, TestCfg::kStages,
      TestCfg::kRingInts * 4, TestCfg::kMinBlocks,
      ScatterCfg::kThreads, ScatterCfg::kTile, ScatterCfg::kStages,
      ScatterCfg::kRingInts * 4, ScatterCfg::kMinBlocks,
      JumpCfg::kThreads, JumpCfg::kTile, JumpCfg::kStages,
      JumpCfg::kRingInts * 4, JumpCfg::kMinBlocks};
  for (int i = 0; i < 20; ++i) out[i] = shapes[i];
}

// One order-2 sweep of the fleet on the lane route: B lanes of n labels
// (L_in, L_out distinct, L_out a copy of L_in), [B, m] edges (4-byte
// aligned), lanes the fleet's [B, 4] words (may be null), c blocks a
// lane.
int contour_fleet_relax_lane(const void* L_in, void* L_out, const void* src,
                             const void* dst, int64_t m, int64_t lanes_b,
                             int64_t n, const void* lanes, int c,
                             void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaSuccess;
  if (!args_ok(lanes_b, c, src, dst)) return (int)cudaErrorInvalidValue;
  const int64_t bytes = smem_bytes<RelaxCfg>(n, 2);
  if (!allow_smem((const void*)relax_lane_kernel, bytes))
    return (int)cudaErrorInvalidValue;
  relax_lane_kernel<<<(unsigned)(lanes_b * c), RelaxCfg::kThreads, bytes,
                      (cudaStream_t)stream>>>(
      (const int*)L_in, (int*)L_out, (const int*)src, (const int*)dst, m, n,
      lanes_b * n, c, (const int*)lanes);
  return (int)cudaGetLastError();
}

// The fleet's early-convergence test and each lane's step on the lane
// route: labels L of B lanes of n, [B, m] edges (4-byte aligned), lanes
// [B, 4] and fleet [4] as above; c as above.
int contour_fleet_converged_lane(const void* L, const void* src,
                                 const void* dst, int64_t m, int64_t lanes_b,
                                 int64_t n, void* lanes, void* fleet, int c,
                                 void* stream) {
  if (m < 0 || n <= 0 || !args_ok(lanes_b, c, src, dst))
    return (int)cudaErrorInvalidValue;
  const int64_t bytes = smem_bytes<TestCfg>(n, 1);
  if (!allow_smem((const void*)converged_lane_kernel, bytes))
    return (int)cudaErrorInvalidValue;
  converged_lane_kernel<<<(unsigned)(lanes_b * c), TestCfg::kThreads, bytes,
                          (cudaStream_t)stream>>>(
      (const int*)L, (const int*)src, (const int*)dst, m, n, lanes_b * n, c,
      (int*)lanes, (int*)fleet);
  return (int)cudaGetLastError();
}

// L_out[t] min= v over the fleet's update stream on the lane route: B
// lanes of n labels (L_in, L_out distinct, L_out a copy of L_in), the
// stream `segs` segments of [B, run] (lane b's run of segment r at
// targets[(r * B + b) * run], 4-byte aligned), lanes as above, c blocks a
// lane.
int contour_fleet_scatter_lane(const void* L_in, void* L_out,
                               const void* targets, const void* values,
                               int64_t run, int64_t segs, int64_t lanes_b,
                               int64_t n, const void* lanes, int c,
                               void* stream) {
  if (run <= 0 || segs <= 0 || n <= 0) return (int)cudaSuccess;
  if (!args_ok(lanes_b, c, targets, values)) return (int)cudaErrorInvalidValue;
  const int64_t bytes = smem_bytes<ScatterCfg>(n, 1);
  if (!allow_smem((const void*)scatter_lane_kernel, bytes))
    return (int)cudaErrorInvalidValue;
  scatter_lane_kernel<<<(unsigned)(lanes_b * c), ScatterCfg::kThreads, bytes,
                        (cudaStream_t)stream>>>(
      (const int*)L_in, (int*)L_out, (const int*)targets, (const int*)values,
      run, segs, lanes_b, n, c, (const int*)lanes);
  return (int)cudaGetLastError();
}

// out = one pointer-jump round of the fleet's labels L (B lanes of n, out
// distinct), a copy of each lane whose done word in lanes (may be null) is
// set; c blocks a lane.
int contour_fleet_jump_lane(const void* L, void* out, int64_t lanes_b,
                            int64_t n, const void* lanes, int c,
                            void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (lanes_b <= 0 || c < 1 || lanes_b * c > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int64_t bytes = smem_bytes<JumpCfg>(n, 1);
  if (!allow_smem((const void*)jump_lane_kernel, bytes))
    return (int)cudaErrorInvalidValue;
  jump_lane_kernel<<<(unsigned)(lanes_b * c), JumpCfg::kThreads, bytes,
                     (cudaStream_t)stream>>>(
      (const int*)L, (int*)out, n, lanes_b * n, c, (const int*)lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
