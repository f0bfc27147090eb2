// Fused RMSNorm over rows for Hopper (sm_90a), behind a plain C interface.
//
// rmsnorm_rows  replaces repro/kernels/fused_rmsnorm/kernel.py::rmsnorm_rows
//      (kernel.py:31, body _rmsnorm_kernel :22).  For every row r of
//      x (rows, d):
//          y[r] = (x[r] * rsqrt(mean(x[r]^2) + eps)) * w
//      in float32, cast back to x's type (float32, bfloat16 or float16,
//      rounded to nearest even).  w is float32 (the wrapper casts it, as the reference
//      does with w.astype(f32)).
//
// What bounds it on an H100: bytes.  It reads x once and writes y once,
// 2 * rows * d * sizeof(x) bytes (plus 4d for w), against ~4 float
// operations per element: a few hundredths of an operation per byte, far
// under the ~20 float32 operations per byte at which the CUDA cores would
// take over.  So the design is about moving each byte once, in wide loads.
//
// The design: one block per row (a grid-stride loop over rows).  Each
// thread loads its share of the row with 16-byte vector loads (8 bfloat16
// or float16, or 4 float32) into registers, VPT vectors a thread, sums the squares in
// float32, and the block reduces the sum with warp shuffles and one word of
// shared memory per warp.  The same registers are then scaled and stored,
// so x is read from device memory once, where the TPU kernel kept a block
// of rows in VMEM.  The TPU grid over row blocks needed the row count
// padded to a multiple of the block; a block here owns one row, so any
// row count is taken and nothing is padded.  Rows wider than the register
// stage (8 vectors for each of 512 threads: 16,384 float32 or 32,768
// 16-bit values) read x twice, the second time from L2, in blocks of
// 1024 threads.  A row whose width or base is not a whole number
// of 16-byte vectors takes scalar loads.
//
// The launcher returns the cudaGetLastError() code of its launch
// (0 = cudaSuccess).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// a row of at most kMaxVpt vectors for each of kStageThreads threads is
// kept in registers; a wider row is read twice by kLoopThreads threads
constexpr int kMaxVpt = 8;
constexpr int kStageThreads = 512;
constexpr int kLoopThreads = 1024;

template <typename T, int VEC>
struct __align__(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// Sum of v over the block; every thread gets the total.  part holds one
// word per warp.
__device__ __forceinline__ float block_sum(float v, float* part) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = (blockDim.x + 31) >> 5;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < warps ? part[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) part[0] = v;
  }
  __syncthreads();
  const float total = part[0];
  __syncthreads();  // part is reused by the next row
  return total;
}

template <typename T, int VEC>
__device__ __forceinline__ float sum_sq(const Pack<T, VEC>& p) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float f = to_f32(p.v[j]);
    s += f * f;
  }
  return s;
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> scale(const Pack<T, VEC>& p,
                                              const float* __restrict__ w,
                                              int i, float inv) {
  Pack<T, VEC> out;
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    out.v[j] = from_f32<T>((to_f32(p.v[j]) * inv) * __ldg(w + i * VEC + j));
  return out;
}

// VPT > 0: the row is staged in VPT vectors a thread; VPT == 0: any width,
// read twice.
template <typename T, int VEC, int VPT>
__global__ void __launch_bounds__(VPT > 0 ? kStageThreads : kLoopThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, int64_t rows, int d, float eps) {
  using P = Pack<T, VEC>;
  __shared__ float part[32];
  const int nvec = d / VEC;
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const P* xr = reinterpret_cast<const P*>(x + r * d);
    P* yr = reinterpret_cast<P*>(y + r * d);
    float ss = 0.f;
    if constexpr (VPT > 0) {
      P buf[VPT];
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int i = threadIdx.x + k * blockDim.x;
        if (i < nvec) {
          buf[k] = xr[i];
          ss += sum_sq(buf[k]);
        }
      }
      const float inv = rsqrtf(block_sum(ss, part) / (float)d + eps);
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int i = threadIdx.x + k * blockDim.x;
        if (i < nvec) yr[i] = scale(buf[k], w, i, inv);
      }
    } else {
      for (int i = threadIdx.x; i < nvec; i += blockDim.x) ss += sum_sq(xr[i]);
      const float inv = rsqrtf(block_sum(ss, part) / (float)d + eps);
      for (int i = threadIdx.x; i < nvec; i += blockDim.x)
        yr[i] = scale(xr[i], w, i, inv);
    }
  }
}

int64_t round_up_warp(int64_t t) { return (t + 31) / 32 * 32; }

template <typename T, int VEC>
cudaError_t launch_vec(const T* x, const float* w, T* y, int64_t rows, int d,
                       float eps, cudaStream_t stream) {
  const int64_t nvec = d / VEC;
  // the smallest register stage that holds the row, else the two-read
  // loop
  int vpt = 0, threads = kLoopThreads;
  for (int v = 1; v <= kMaxVpt; v *= 2) {
    if (round_up_warp((nvec + v - 1) / v) <= kStageThreads) {
      vpt = v;
      threads = (int)round_up_warp((nvec + v - 1) / v);
      break;
    }
  }
  const unsigned grid = (unsigned)(rows < (1u << 30) ? rows : (1u << 30));
  switch (vpt) {
    case 1: rmsnorm_kernel<T, VEC, 1><<<grid, threads, 0, stream>>>(x, w, y, rows, d, eps); break;
    case 2: rmsnorm_kernel<T, VEC, 2><<<grid, threads, 0, stream>>>(x, w, y, rows, d, eps); break;
    case 4: rmsnorm_kernel<T, VEC, 4><<<grid, threads, 0, stream>>>(x, w, y, rows, d, eps); break;
    case 8: rmsnorm_kernel<T, VEC, 8><<<grid, threads, 0, stream>>>(x, w, y, rows, d, eps); break;
    default: rmsnorm_kernel<T, VEC, 0><<<grid, threads, 0, stream>>>(x, w, y, rows, d, eps); break;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* w, void* y, int64_t rows,
                   int d, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = d % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (aligned)
    return launch_vec<T, kVec>(static_cast<const T*>(x), w, static_cast<T*>(y),
                               rows, d, eps, stream);
  return launch_vec<T, 1>(static_cast<const T*>(x), w, static_cast<T*>(y),
                          rows, d, eps, stream);
}

}  // namespace

// x, y: (rows, d) contiguous, dtype 0 = float32, 1 = bfloat16, 2 =
// float16; w: float32 (d,).  Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int fused_rmsnorm_rows(const void* x, const void* w, void* y,
                                  int64_t rows, int64_t d, float eps,
                                  int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  if (d > INT32_MAX || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  switch (dtype) {
    case 0: return (int)launch<float>(x, wf, y, rows, (int)d, eps, s);
    case 1: return (int)launch<__nv_bfloat16>(x, wf, y, rows, (int)d, eps, s);
    default: return (int)launch<__half>(x, wf, y, rows, (int)d, eps, s);
  }
}

extern "C" const char* fused_rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
