// In-order asynchronous 2-order sweep for Hopper (sm_90a), behind a plain C
// interface.
//
// mm2  replaces repro/kernels/contour_mm/kernel.py::mm2_pallas (kernel.py:53,
//      body _mm2_kernel :31).  For each edge e in order, with the labels
//      that earlier edges already lowered:
//          w, v = src[e], dst[e];  lw, lv = L[w], L[v];
//          z = min(L[lw], L[lv]);
//          L[t] = min(L[t], z)  for t in w, v, lw, lv.
//      L is updated in place (the TPU kernel aliased it in and out).  This
//      is the deterministic-async semantics of the paper's in-place
//      updates: the result depends on the edge order, and must equal
//      ref.mm_block_ref bit for bit.
//
// What bounds it on an H100: the chain of dependent label reads, not
// bytes and not arithmetic.  Each edge reads L[w] and L[v], then L[L[w]]
// and L[L[v]], and the next edge may read what this one wrote, so the
// edges cannot overlap: at least two dependent round trips to L1 or L2 per
// edge.  L (4n bytes) fits the 50 MB L2 up to ~12M vertices.  The bytes
// bound (8m + 8n over the HBM rate) is far below that chain.
//
// The design answers the chain only where it is free to: one block of one
// warp.  The warp stages a tile of edges into shared memory with coalesced
// loads, then lane 0 walks the tile in order, so the edge reads are off the
// chain; the grid over edge blocks of the TPU kernel existed only to
// stream edges through VMEM and has no counterpart.  All four label reads
// of an edge happen before its writes, so each target t is written only
// when z < L[t] as read: with aliased targets (t repeated) the writes
// agree, and the result equals the four read-min-writes in order.
//
// L is written and read back by the same thread, so it is neither
// const __restrict__ nor read through the read-only path (__ldg): that
// path may return a label this thread has already lowered.
//
// Index ranges are checked as in contour_mm.cu: every id the kernel follows
// (w, v, L[w], L[v]) is compared with n before use.  An edge with an id
// outside [0, n) is skipped and, when the caller passes an error word, the
// word is set to 1 so that the wrapper raises IndexError.  The launcher
// returns the cudaGetLastError() code of its launch (0 = cudaSuccess).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
// edges staged per round: 2 x 8 KB of static shared memory
constexpr int kTile = 2048;

__device__ __forceinline__ bool outside(int id, int64_t n) {
  return id < 0 || (int64_t)id >= n;
}

__global__ void __launch_bounds__(kLanes)
mm2_kernel(int* L, const int* __restrict__ src, const int* __restrict__ dst,
           int64_t m, int64_t n, int* err) {
  __shared__ int s_src[kTile];
  __shared__ int s_dst[kTile];
  const int lane = threadIdx.x;
  for (int64_t base = 0; base < m; base += kTile) {
    const int count = (int)(m - base < kTile ? m - base : kTile);
    for (int i = lane; i < count; i += kLanes) {
      s_src[i] = src[base + i];
      s_dst[i] = dst[base + i];
    }
    __syncwarp();
    if (lane == 0) {
      bool bad = false;
      for (int i = 0; i < count; ++i) {
        const int w = s_src[i];
        const int v = s_dst[i];
        if (outside(w, n) || outside(v, n)) {
          bad = true;
          continue;
        }
        const int lw = L[w];
        const int lv = L[v];
        if (outside(lw, n) || outside(lv, n)) {
          bad = true;
          continue;
        }
        const int l2w = L[lw];
        const int l2v = L[lv];
        const int z = min(l2w, l2v);
        if (z < lw) L[w] = z;
        if (z < lv) L[v] = z;
        if (z < l2w) L[lw] = z;
        if (z < l2v) L[lv] = z;
      }
      if (bad && err != nullptr) *err = 1;
    }
    // the tile is read to its end before the warp overwrites it
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Sweeps edges [0, m) in order over L (length n), in place: the wrapper
// passes m = min(m, edge_limit) and a copy of the caller's labels.  err
// (one int32, zeroed by the caller) may be null.
int contour_mm2(void* L, const void* src, const void* dst, int64_t m,
                int64_t n, void* err, void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  mm2_kernel<<<1, kLanes, 0, (cudaStream_t)stream>>>(
      (int*)L, (const int*)src, (const int*)dst, m, n, (int*)err);
  return (int)cudaGetLastError();
}

}  // extern "C"
