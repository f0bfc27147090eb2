// Min-mapping sweep kernels for Hopper (sm_90a), behind a plain C interface.
//
// Two kernels, both scatter-mins into an int32 label array:
//
// fused_relax  replaces repro/kernels/contour_mm/blocked.py::fused_relax_pallas
//              (blocked.py:236, body _fused_relax_kernel :193).  One
//              synchronous order-2 sweep: per edge (s, d) it reads
//              ls = L[s], ld = L[d], z = min(L[ls], L[ld]) from the input
//              labels and atomicMin-s z into {s, d, ls, ld} of a separate
//              output array seeded with the input.  On the TPU the whole of
//              L had to fit one VMEM tile (n <= 4096) and the gathers were
//              one-hot compares; here every thread gathers from device
//              memory directly, so there is no n limit and no padding.
//
// scatter_min  replaces repro/kernels/contour_mm/blocked.py::
//              binned_scatter_min_pallas (blocked.py:92, body
//              _scatter_min_kernel :54).  L_out[targets[i]] min= values[i]
//              over the 2h*m update stream, skipping updates whose valid
//              byte is 0.  The TPU radix-sorted the stream by label block
//              and combined one-hot per tile; on Hopper a global atomicMin
//              per update needs no sort at all.
//
// What bounds them on an H100 (3.35 TB/s HBM, 50 MB L2): random 4-byte
// gathers and atomics, not arithmetic.  Each edge reads 8 contiguous bytes
// of src/dst but then makes four dependent random label reads, and each
// update is a read-modify-write to a random address; a 32-byte sector is
// fetched for every 4 bytes used unless L is L2-resident (it is up to
// ~12M vertices).  The design answers that in three ways:
//   * the edge and update streams are read coalesced, one element per
//     thread in a grid-stride loop, so the only scattered traffic is the
//     label traffic the algorithm itself needs;
//   * an atomic is issued only when it can lower the label: the output
//     starts as a copy of the input and only ever decreases, so a target
//     whose input label is already <= z cannot change and is skipped.
//     For fused_relax the four input labels of the targets are exactly the
//     values the gathers already loaded (L[s] = ls, L[d] = ld, L[ls],
//     L[ld]), so the test costs no extra read.  Near convergence almost
//     every atomic is skipped;
//   * reads of the input labels go through the read-only path (__ldg) on
//     an array that the kernel never writes.
// Hub vertices (a star's centre) receive one atomic from every incident
// update, and those serialise at one address; a per-block shared-memory
// pre-combine for hot label blocks is left to a later change.
//
// Index ranges are checked here, on the card: every id the kernels follow
// (an edge endpoint, the label found there, an update target) is compared
// with n before it is used.  An id outside [0, n) is never read or written
// through; its edge or update is skipped and, when the caller passes an
// error word, the word is set to 1 so that the wrapper raises IndexError.
// The Python wrappers check the rest: int32 arrays, contiguous, on the
// current device, L_in and L_out distinct.  Each launcher returns the
// cudaGetLastError() code of its launch (0 = cudaSuccess).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool outside(int id, int64_t n) {
  return id < 0 || (int64_t)id >= n;
}

// err may be null: the id is then skipped without a record.
__device__ __forceinline__ void flag(int* err) {
  if (err != nullptr) *err = 1;
}

__global__ void __launch_bounds__(kThreads)
fused_relax_kernel(const int* __restrict__ L_in, int* __restrict__ L_out,
                   const int* __restrict__ src, const int* __restrict__ dst,
                   int64_t m, int64_t n, int* err) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < m;
       e += stride) {
    const int s = src[e];
    const int d = dst[e];
    if (outside(s, n) || outside(d, n)) {
      flag(err);
      continue;
    }
    const int ls = __ldg(L_in + s);
    const int ld = __ldg(L_in + d);
    if (outside(ls, n) || outside(ld, n)) {
      flag(err);
      continue;
    }
    const int l2s = __ldg(L_in + ls);
    const int l2d = __ldg(L_in + ld);
    const int z = min(l2s, l2d);
    if (z < ls) atomicMin(L_out + s, z);
    if (z < ld) atomicMin(L_out + d, z);
    if (z < l2s) atomicMin(L_out + ls, z);
    if (z < l2d) atomicMin(L_out + ld, z);
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_min_kernel(const int* __restrict__ L_in, int* __restrict__ L_out,
                   const int* __restrict__ targets,
                   const int* __restrict__ values,
                   const uint8_t* __restrict__ valid, int64_t k, int64_t n,
                   int* err) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < k;
       i += stride) {
    if (valid != nullptr && valid[i] == 0) continue;
    const int t = targets[i];
    if (outside(t, n)) {
      flag(err);
      continue;
    }
    const int v = values[i];
    if (v < __ldg(L_in + t)) atomicMin(L_out + t, v);
  }
}

// Enough blocks to fill every SM several times over; the grid-stride loop
// covers the rest.
int grid_for(int64_t work) {
  int device = 0;
  int sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const int64_t cap = (int64_t)sms * 16;
  const int64_t need = (work + kThreads - 1) / kThreads;
  return (int)(need < cap ? need : cap);
}

}  // namespace

extern "C" {

// Edges e >= m are not visited: the wrapper passes m = min(m, edge_limit).
// n is the length of L_in and L_out; err (one int32, zeroed by the caller)
// may be null.
int contour_fused_relax(const void* L_in, void* L_out, const void* src,
                        const void* dst, int64_t m, int64_t n, void* err,
                        void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  fused_relax_kernel<<<grid_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)L_in, (int*)L_out, (const int*)src, (const int*)dst, m, n,
      (int*)err);
  return (int)cudaGetLastError();
}

// valid may be null (every update live); n and err as above.
int contour_scatter_min(const void* L_in, void* L_out, const void* targets,
                        const void* values, const void* valid, int64_t k,
                        int64_t n, void* err, void* stream) {
  if (k <= 0) return (int)cudaSuccess;
  scatter_min_kernel<<<grid_for(k), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)L_in, (int*)L_out, (const int*)targets, (const int*)values,
      (const uint8_t*)valid, k, n, (int*)err);
  return (int)cudaGetLastError();
}

}  // extern "C"
