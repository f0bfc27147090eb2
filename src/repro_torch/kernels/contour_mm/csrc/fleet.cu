// The fleet's lane-resident kernels for Hopper (sm_90a), behind a plain C
// interface: K1's order-2 sweep and K6's early-convergence test over a
// fleet of B graphs (solve_batch), each lane's labels held in shared
// memory while its edges stream past them.
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
// The shapes (RelaxCfg, TestCfg) were timed against others on the card by
// tools/fleet_variants.py (PERF.md): a block-wide __syncthreads_or a tile
// beat a release a warp through a shared counter (the warps drifting
// apart cost 8-18%), more stages bought nothing, more edges a thread and
// 512-thread blocks did (a delaunay_like(14) lane's 128 KB of K1 labels
// leaves one block an SM), and a warp combine of runs of updates to one
// target before K1's shared atomics cost 8%.  K1 at the fixed point (no
// update) takes as long as at the first sweep: the stream and the
// gathers hold it, not the atomics or the merge.
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

// Streams edges [e0, e1) of src/dst through the ring, a tile at a time:
// body(ts, td, cnt) gets the tile's edges at ts[i], td[i] (i < cnt) and
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
__device__ __forceinline__ void stream_edges(const int* __restrict__ src,
                                             const int* __restrict__ dst,
                                             int64_t e0, int64_t e1,
                                             const Ring<C>& ring,
                                             Barriers<C>& bars, Body&& body) {
  const int64_t tiles = (e1 - e0 + C::kTile - 1) / C::kTile;
  auto count = [&](int64_t k) {
    const int64_t left = e1 - (e0 + k * C::kTile);
    return (int)(left < C::kTile ? left : C::kTile);
  };
  auto issue = [&](int64_t k) {
    const int s = (int)(k % C::kStages);
    issue_bulk(ring, s, bars.full + s, src, dst, e0 + k * C::kTile,
               count(k));
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
    const int64_t e = e0 + k * C::kTile;
    const bool vote = body(ring.src(s) + lead(src, e),
                           ring.dst(s) + lead(dst, e), count(k));
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

__device__ __forceinline__ Slice slice_of(int64_t m, int c) {
  const int64_t lane = blockIdx.x / c;
  const int64_t part = blockIdx.x % c;
  const int64_t q = (m + c - 1) / c;
  const int64_t lo = part * q < m ? part * q : m;
  const int64_t hi = (part + 1) * q < m ? (part + 1) * q : m;
  return {lane, lane * m + lo, lane * m + hi};
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
  stream_edges<C, false>(
      src, dst, sl.e0, sl.e1, ring, bars,
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
    stream_edges<C, true>(
        src, dst, sl.e0, sl.e1, ring, bars,
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

// Each kernel's shape, for the Python side's route: threads a block, edges
// a tile, stages, dynamic shared memory of the ring (bytes) and the blocks
// an SM its registers allow; K1's into out[0..4], K6's into out[5..9].
void contour_fleet_shapes(int* out) {
  const int shapes[10] = {
      RelaxCfg::kThreads, RelaxCfg::kTile, RelaxCfg::kStages,
      RelaxCfg::kRingInts * 4, RelaxCfg::kMinBlocks,
      TestCfg::kThreads, TestCfg::kTile, TestCfg::kStages,
      TestCfg::kRingInts * 4, TestCfg::kMinBlocks};
  for (int i = 0; i < 10; ++i) out[i] = shapes[i];
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

}  // extern "C"
