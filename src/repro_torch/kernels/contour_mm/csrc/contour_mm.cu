// Min-mapping sweep kernels for Hopper (sm_90a), behind a plain C interface.
//
// Two kernels, both scatter-mins into an int32 label array:
//
// fused_relax  replaces repro/kernels/contour_mm/blocked.py::fused_relax_pallas
//              (blocked.py:236, body _fused_relax_kernel :193).  One
//              synchronous order-2 sweep: per edge (s, d) it reads
//              ls = L[s], ld = L[d], z = min(L[ls], L[ld]) from the input
//              labels and min-s z into {s, d, ls, ld} of a separate output
//              array seeded with the input.  On the TPU the whole of L had
//              to fit one VMEM tile (n <= 4096) and the gathers were
//              one-hot compares; here every thread gathers from device
//              memory directly, so there is no n limit and no padding.
//
// scatter_min  replaces repro/kernels/contour_mm/blocked.py::
//              binned_scatter_min_pallas (blocked.py:92, body
//              _scatter_min_kernel :54).  L_out[targets[i]] min= values[i]
//              over the 2h*m update stream, skipping updates whose valid
//              byte is 0.  The TPU radix-sorted the stream by label block
//              and combined one-hot per tile; here the updates are combined
//              in the warp where they pile up, and reduced at L2.
//
// What bounds them on an H100 (3.35 TB/s HBM, 50 MB L2): random 4-byte
// gathers and read-modify-writes at random addresses, not arithmetic.  An
// edge makes two levels of dependent label reads, and each red (a
// reduction at L2 with no result) is a read-modify-write that serialises
// with every other red to its address.  Where updates pile onto a few
// targets (a power-law graph's hubs on the first sweep, its hub labels on
// the second, a star's centre) those reds queue at one L2 slice; on a mesh
// they spread out and cost little.  The design (each choice timed against
// the others by tools/sweep_variants.py; PERF.md, section 6):
//   * one warp a step of 32 * E consecutive items (E = 2 edges for
//     fused_relax, 4 updates for scatter_min), lane l items l, l + 32, ...:
//     each load of a stream is 128 contiguous bytes (4-byte loads,
//     evict-first: the streams are read once, L stays in L2), and a warp
//     instruction's label reads and reds fall in few L2 sectors where the
//     graph has locality.  A lane's first-level label reads all go out
//     before any second-level one.  A block is 8 warps and the grid one
//     step a warp, so the blocks' order of issue balances the load;
//   * one update per target an edge: where an endpoint is a root
//     (L[v] == v), v and L[v] are one address with one condition and one
//     value, so an edge's four targets are deduplicated in registers (a
//     later copy of a target is dropped): on the first sweep from identity
//     labels that halves the updates;
//   * no update that cannot lower its label.  The output starts as a copy
//     of the input and only decreases, so an update whose value is not
//     below the input label of its target is dropped (fused_relax has
//     those labels from its gathers; scatter_min reads them), and a step
//     with no update left in any lane ends on one warp vote (the fixed
//     point costs only the gathers);
//   * the test before the red: the lane reads L_out[t] of all its updates
//     at once, through L1, and drops those it already meets.  A value read
//     from L1 may be older than L2's, never lower, so the test is sound;
//     on a hub, whose label falls early in the sweep, it keeps nearly every
//     red out of the queue;
//   * the warp combine, only where a slot is hot: while the test's reads
//     are in flight, each slot (the lanes' j-th update) is tested on its
//     targets before the test: hot where its first live lane's target is
//     shared by at least kHot lanes.  After the test, a hot slot's lanes
//     group by target (__match_any_sync), take their group's minimum
//     (__reduce_min_sync), and only the group's first lane keeps the
//     update.  That turns up to 32 reds to a hub into one where the test
//     cannot help (a sweep's first wave of warps, which all read the hub's
//     label before any red lands); a slot of spread-out targets never runs
//     MATCH, which costs more per slot than the reds it saves there;
//   * the red itself is atomicMin with its result unused, which compiles to
//     REDG, not ATOMG.
// Labels are read through the read-only path (__ldg) from L_in, which the
// kernels never write.  Every load is of one 4-byte item (one byte of the
// valid mask), so any 4-byte-aligned base (a slice) and any length are
// taken.
//
// A sweep whose done word (the fixpoint loop's flag, converged.cu) is set
// returns at once: the wrapper's output is a copy of L, so the labels stay
// as they are.  Past the loop's early-convergence point a sweep is an
// exact no-op anyway; the word saves the pass over the edges.
//
// Index ranges are checked here, on the card: every id the kernels follow
// (an edge endpoint, the label found there, an update target) is compared
// with n before it is used.  An id outside [0, n) is never read or written
// through; its edge or update is skipped and, when the caller passes an
// error word, the word is set to 1 so that the wrapper raises IndexError.
// An optional int64[4] counter receives, in this order: the updates before
// the test (the items' live updates, an edge's copies of a target
// dropped), the hot slots (warp-steps times slots), the updates left after
// the test, and the reds issued to memory (after the combine).  The first
// two depend only on the input, the last two also on the order in which
// the reds land.  The Python wrappers check the rest: int32 arrays,
// contiguous, on the current device, L_in and L_out distinct.  Each
// launcher returns the cudaGetLastError() code of its launch (0 =
// cudaSuccess).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFusedEdges = 2;     // edges a lane a step
constexpr int kScatterUpdates = 4; // updates a lane a step
constexpr int kHot = 8;            // lanes on one target that make a slot hot
constexpr unsigned kFull = 0xffffffffu;

// The loop's done word, or 0 where the caller passes none.  No kernel
// writes it while a sweep runs, so the read-only path may cache it: after
// the first warp of an SM the read is an L1 hit.
__device__ __forceinline__ int done_word(const int* done) {
  return done != nullptr ? __ldg(done) : 0;
}

__device__ __forceinline__ bool outside(int id, int64_t n) {
  return id < 0 || (int64_t)id >= n;
}

// err may be null: the id is then skipped without a record.
__device__ __forceinline__ void flag(int* err) {
  if (err != nullptr) *err = 1;
}

// The lanes of one slot that hold an update (t >= 0) group by target; each
// group's first lane keeps the group's minimum value, the others drop out.
__device__ __forceinline__ void combine(int& t, int& v) {
  const unsigned live = __ballot_sync(kFull, t >= 0);
  if (__popc(live) < 2 || t < 0) return;
  const unsigned bit = 1u << (threadIdx.x & 31);
  const unsigned group = __match_any_sync(live, t);
  if (group != bit) {
    v = __reduce_min_sync(group, v);
    if (group & (bit - 1)) t = -1;
  }
}

// The warp's updates (t[j], v[j]) of this step, t[j] = -1 where a lane has
// none in slot j: the test of L_out, the combine of the hot slots, then
// one red each.  c gathers the counter's four numbers.
template <int N>
__device__ __forceinline__ void reds(int* __restrict__ L_out, int (&t)[N],
                                     int (&v)[N], unsigned (&c)[4]) {
  bool any = false;
#pragma unroll
  for (int j = 0; j < N; ++j) any |= t[j] >= 0;
  if (!__any_sync(kFull, any)) return;
  int cur[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    c[0] += t[j] >= 0;
    cur[j] = t[j] >= 0 ? __ldca(L_out + t[j]) : 0;
  }
  // which slots are hot, on the targets before the test
  unsigned hot = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const unsigned live = __ballot_sync(kFull, t[j] >= 0);
    if (__popc(live) >= kHot) {
      const int first = __shfl_sync(kFull, t[j], __ffs(live) - 1);
      if (__popc(__ballot_sync(kFull, t[j] == first)) >= kHot)
        hot |= 1u << j;
    }
  }
  if ((threadIdx.x & 31) == 0) c[1] += __popc(hot);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (cur[j] <= v[j]) t[j] = -1;
    c[2] += t[j] >= 0;
  }
  if (hot) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (hot >> j & 1) combine(t[j], v[j]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (t[j] >= 0) {
      atomicMin(L_out + t[j], v[j]);
      ++c[3];
    }
  }
}

// The warp's counts into counter[0..3]; counter may be null.
__device__ __forceinline__ void count(unsigned long long* counter,
                                      const unsigned (&c)[4]) {
  if (counter == nullptr) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned sum = __reduce_add_sync(kFull, c[k]);
    if ((threadIdx.x & 31) == 0 && sum != 0)
      atomicAdd(counter + k, (unsigned long long)sum);
  }
}

__global__ void __launch_bounds__(kThreads, 8)
fused_relax_kernel(const int* __restrict__ L_in, int* __restrict__ L_out,
                   const int* __restrict__ src, const int* __restrict__ dst,
                   int64_t m, int64_t n, int* err,
                   unsigned long long* counter, const int* done) {
  constexpr int E = kFusedEdges;
  const int64_t e0 = ((int64_t)blockIdx.x * kWarps + threadIdx.x / 32) *
                         (32 * E) +
                     (threadIdx.x & 31);
  if (done_word(done)) return;
  // every load of the lane before any check (a check may store to err,
  // which would hold back the loads after it)
  int s[E], d[E];
  bool ok[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    ok[i] = e0 + 32 * i < m;
    s[i] = ok[i] ? __ldcs(src + e0 + 32 * i) : 0;
    d[i] = ok[i] ? __ldcs(dst + e0 + 32 * i) : 0;
  }
#pragma unroll
  for (int i = 0; i < E; ++i) {
    if (ok[i] && (outside(s[i], n) || outside(d[i], n))) {
      flag(err);
      ok[i] = false;
    }
  }
  // every first-level read of the lane, then every second-level one
  int ls[E], ld[E], l2s[E], l2d[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    ls[i] = ok[i] ? __ldg(L_in + s[i]) : 0;
    ld[i] = ok[i] ? __ldg(L_in + d[i]) : 0;
  }
#pragma unroll
  for (int i = 0; i < E; ++i) {
    if (ok[i] && (outside(ls[i], n) || outside(ld[i], n))) {
      flag(err);
      ok[i] = false;
    }
  }
#pragma unroll
  for (int i = 0; i < E; ++i) {
    l2s[i] = ok[i] ? __ldg(L_in + ls[i]) : 0;
    l2d[i] = ok[i] ? __ldg(L_in + ld[i]) : 0;
  }
  // each target with its input label; a later copy of an earlier target
  // has the same label, so the same condition: dropped
  int t[4 * E], v[4 * E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int z = min(l2s[i], l2d[i]);
    t[4 * i] = ok[i] && z < ls[i] ? s[i] : -1;
    t[4 * i + 1] = ok[i] && z < ld[i] && d[i] != s[i] ? d[i] : -1;
    t[4 * i + 2] =
        ok[i] && z < l2s[i] && ls[i] != s[i] && ls[i] != d[i] ? ls[i] : -1;
    t[4 * i + 3] = ok[i] && z < l2d[i] && ld[i] != s[i] && ld[i] != d[i] &&
                           ld[i] != ls[i]
                       ? ld[i]
                       : -1;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[4 * i + k] = z;
  }
  unsigned c[4] = {0, 0, 0, 0};
  reds(L_out, t, v, c);
  count(counter, c);
}

__global__ void __launch_bounds__(kThreads, 8)
scatter_min_kernel(const int* __restrict__ L_in, int* __restrict__ L_out,
                   const int* __restrict__ targets,
                   const int* __restrict__ values,
                   const uint8_t* __restrict__ valid, int64_t k, int64_t n,
                   int* err, unsigned long long* counter, const int* done) {
  constexpr int E = kScatterUpdates;
  const int64_t e0 = ((int64_t)blockIdx.x * kWarps + threadIdx.x / 32) *
                         (32 * E) +
                     (threadIdx.x & 31);
  if (done_word(done)) return;
  // every load of the lane before any check, as in fused_relax
  int t[E], v[E];
  bool ok[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int64_t e = e0 + 32 * i;
    ok[i] = e < k;
    t[i] = ok[i] ? __ldcs(targets + e) : 0;
    v[i] = ok[i] ? __ldcs(values + e) : 0;
  }
  if (valid != nullptr) {
#pragma unroll
    for (int i = 0; i < E; ++i)
      ok[i] = ok[i] && __ldcs(valid + e0 + 32 * i) != 0;
  }
#pragma unroll
  for (int i = 0; i < E; ++i) {
    if (ok[i] && outside(t[i], n)) {
      flag(err);
      ok[i] = false;
    }
  }
  int lab[E];
#pragma unroll
  for (int i = 0; i < E; ++i) lab[i] = ok[i] ? __ldg(L_in + t[i]) : 0;
#pragma unroll
  for (int i = 0; i < E; ++i)
    if (!ok[i] || v[i] >= lab[i]) t[i] = -1;
  unsigned c[4] = {0, 0, 0, 0};
  reds(L_out, t, v, c);
  count(counter, c);
}

// The fleet's sweeps (solve_batch): B graphs of n vertices and m edges
// each, in one launch.  Lane b's vertex v is b * n + v in one [B * n]
// label array, whose labels are such ids too; the edges are the stacked
// [B, m] arrays as they are, with the graphs' own ids, and an item's lane
// comes from its index (an edge) or its target (an update).  Lanes never
// share an edge, so the sweep over the union is each lane's own sweep.
// lanes is the fleet's per-lane loop state, [B, 4] int32 (converged.cu):
// a lane whose done word is set takes no part, so it stays frozen while
// the others sweep on.  Simple kernels: one item a thread, an edge's
// targets deduplicated and an update that cannot lower its input label
// dropped, then atomicMin; an id outside the label array is skipped.
// fused_relax_batched_kernel is K1 fleet's "global" route, for lanes whose
// labels do not fit a block's shared memory; the others take the lane
// route of fleet.cu (kernels/contour_mm/fleet.py: fleet_route).

__device__ __forceinline__ bool lane_done(const int* lanes, int64_t lane) {
  return lanes != nullptr && __ldg(lanes + 4 * lane) != 0;
}

__global__ void __launch_bounds__(kThreads)
fused_relax_batched_kernel(const int* __restrict__ L_in,
                           int* __restrict__ L_out,
                           const int* __restrict__ src,
                           const int* __restrict__ dst, int64_t m,
                           int64_t total, int64_t n,
                           const int* __restrict__ lanes) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int64_t lane = e / m;
  if (lane_done(lanes, lane)) return;
  const int64_t size = total / m * n;  // B * n labels
  const int ws = __ldcs(src + e), wd = __ldcs(dst + e);
  if (outside(ws, n) || outside(wd, n)) return;
  const int s = (int)(lane * n + ws), d = (int)(lane * n + wd);
  const int ls = __ldg(L_in + s), ld = __ldg(L_in + d);
  if (outside(ls, size) || outside(ld, size)) return;
  const int l2s = __ldg(L_in + ls), l2d = __ldg(L_in + ld);
  const int z = min(l2s, l2d);
  if (z < ls) atomicMin(L_out + s, z);
  if (z < ld && d != s) atomicMin(L_out + d, z);
  if (z < l2s && ls != s && ls != d) atomicMin(L_out + ls, z);
  if (z < l2d && ld != s && ld != d && ld != ls) atomicMin(L_out + ld, z);
}

__global__ void __launch_bounds__(kThreads)
scatter_min_batched_kernel(const int* __restrict__ L_in,
                           int* __restrict__ L_out,
                           const int* __restrict__ targets,
                           const int* __restrict__ values, int64_t k,
                           int64_t size, int64_t n,
                           const int* __restrict__ lanes) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= k) return;
  const int t = __ldcs(targets + i), v = __ldcs(values + i);
  if (outside(t, size) || lane_done(lanes, t / n)) return;
  if (v < __ldg(L_in + t)) atomicMin(L_out + t, v);
}

// One step a warp, eight warps a block.
int64_t blocks_for(int64_t items, int per_lane) {
  const int64_t steps = (items + 32 * per_lane - 1) / (32 * per_lane);
  return (steps + kWarps - 1) / kWarps;
}

}  // namespace

extern "C" {

// Edges e >= m are not visited: the wrapper passes m = min(m, edge_limit).
// src and dst are 4-byte aligned.  n is the length of L_in and L_out; err
// (one int32, zeroed by the caller), counter (four int64, zeroed by the
// caller) and done (the loop's int32 flag) may be null.
int contour_fused_relax(const void* L_in, void* L_out, const void* src,
                        const void* dst, int64_t m, void* counter,
                        const void* done, int64_t n, void* err,
                        void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  if ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
      3)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = blocks_for(m, kFusedEdges);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  fused_relax_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)L_in, (int*)L_out, (const int*)src, (const int*)dst, m, n,
      (int*)err, (unsigned long long*)counter, (const int*)done);
  return (int)cudaGetLastError();
}

// valid may be null (every update live); the rest as above.
int contour_scatter_min(const void* L_in, void* L_out, const void* targets,
                        const void* values, const void* valid, int64_t k,
                        void* counter, const void* done, int64_t n, void* err,
                        void* stream) {
  if (k <= 0) return (int)cudaSuccess;
  if ((reinterpret_cast<uintptr_t>(targets) |
       reinterpret_cast<uintptr_t>(values)) &
      3)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = blocks_for(k, kScatterUpdates);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  scatter_min_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)L_in, (int*)L_out, (const int*)targets, (const int*)values,
      (const uint8_t*)valid, k, n, (int*)err, (unsigned long long*)counter,
      (const int*)done);
  return (int)cudaGetLastError();
}

// One order-2 sweep of the fleet: edges [0, B * m) of the stacked [B, m]
// arrays (4-byte aligned), labels of length B * n, lanes the fleet's
// [B, 4] loop state (may be null: every lane sweeps).
int contour_fused_relax_batched(const void* L_in, void* L_out,
                                const void* src, const void* dst, int64_t m,
                                int64_t lanes_b, int64_t n,
                                const void* lanes, void* stream) {
  if (m <= 0 || lanes_b <= 0 || n <= 0) return (int)cudaSuccess;
  const int64_t total = m * lanes_b;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  fused_relax_batched_kernel<<<(unsigned)blocks, kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const int*)L_in, (int*)L_out, (const int*)src, (const int*)dst, m,
      total, n, (const int*)lanes);
  return (int)cudaGetLastError();
}

// L_out[t] min= v over the fleet's k updates, whose targets are ids of the
// [size] label array (size = B * n); lanes as above.
int contour_scatter_min_batched(const void* L_in, void* L_out,
                                const void* targets, const void* values,
                                int64_t k, int64_t size, int64_t n,
                                const void* lanes, void* stream) {
  if (k <= 0 || n <= 0) return (int)cudaSuccess;
  const int64_t blocks = (k + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  scatter_min_batched_kernel<<<(unsigned)blocks, kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const int*)L_in, (int*)L_out, (const int*)targets,
      (const int*)values, k, size, n, (const int*)lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
