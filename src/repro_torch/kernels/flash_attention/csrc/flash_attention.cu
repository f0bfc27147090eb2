// GQA flash attention (forward, streaming softmax) for Hopper (sm_90a),
// behind a plain C interface.
//
// flash_mha  replaces repro/kernels/flash_attention/kernel.py::flash_mha
//      (kernel.py:77, body _flash_kernel :30).  For q (B, H, T, hd) and
//      k, v (B, Hkv, S, hd), query head h attends to KV head h / (H / Hkv):
//          o[b, h, t] = softmax_s(q[b, h, t] . k[b, kvh, s] * scale) v[b, kvh, s]
//      with scale = 1 / sqrt(hd), the top-left causal mask (key s is seen
//      by query t when s <= t) when asked, and masked scores set to -1e30
//      as the reference does.  The running max m, the normaliser l and the
//      output accumulator stay in float32; the output is q's type
//      (float32 or bfloat16, rounded to nearest even).
//
// What bounds it on an H100: operations.  The work is 4 * T * S * hd
// floating-point operations a head (half of it when causal) against
// (2T + 2S) * hd elements moved: in bfloat16 T * S / (T + S) operations a
// byte, 2,048 at T = S = 4096 (1,024 causal), far above the ~295 at which
// the bf16 tensor cores and not the memory are the limit.  So the least
// time is the tensor cores' rate.  This first version does its products
// with float32 FMAs on the CUDA cores (67 TFLOP/s at best), so it is bound
// by those FMAs and by the shared-memory reads that feed them; mma.sync /
// wgmma, TMA and a pipelined ring of K/V tiles are later work.
//
// The design: one block of 256 threads per (64-query tile, batch * head).
// The TPU kernel's sequential nk grid axis, which carried m, l and the
// accumulator in VMEM scratch from one K/V block to the next, becomes a
// loop over 64-key tiles inside the block, with m, l and the accumulator
// in registers.  Each tile of K and V is staged in shared memory as
// float32: Q and K transposed (d-major), so that a thread reads its four
// query rows and its four keys as one 16-byte load each, and V row-major.
// Thread (ty, tx) of the 16 x 16 grid owns query rows 4ty..4ty+3: it
// computes their scores against keys 4tx..4tx+3 of the tile, the softmax
// statistics of a row are reduced over the 16 lanes that share it with
// warp shuffles, the probabilities go to shared memory (transposed), and
// the thread accumulates output columns 64g + 4tx .. +3 of its rows.  The
// KV head is chosen from the block's head (h / (H / Hkv)), so K and V are
// never repeated, as the reference's index map did.  Key tiles wholly past
// the causal diagonal are not visited; keys at or past S are masked, so
// no length is padded; query tiles are launched longest (most keys) first.
//
// Shared memory is (2 * hd * 68 + 64 * hd + 64 * 68) * 4 bytes: 119,808 at
// hd = 128 and 222,208 at hd = 256, above the 48 KB a launch gets without
// asking.  The launcher sets cudaFuncAttributeMaxDynamicSharedMemorySize to
// the limit its caller passes (the wrapper passes what the kernel needs)
// and returns cudaGetLastError() of the launch, so a refused launch is
// reported, not silent (0 = cudaSuccess).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBq = 64;        // query rows per block
constexpr int kBk = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int kLdq = kBq + 4;  // row stride of Q^T and P^T (16-byte rows)
constexpr int kLdk = kBk + 4;  // row stride of K^T
constexpr int kMaxHd = 256;
constexpr float kNegInf = -1e30f;

template <typename T, int N>
struct __align__(sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

size_t smem_bytes(int64_t hd) {
  return sizeof(float) *
         (size_t)(hd * kLdq + hd * kLdk + kBk * hd + kBk * kLdq);
}

// Rows [r0, r0 + rows) of a (len, hd) matrix into dst[d * ld + r] as
// float32 (transposed); rows at or past len are zero.
template <typename T>
__device__ __forceinline__ void load_transposed(const T* __restrict__ src,
                                                int r0, int len, int hd,
                                                int rows, float* dst, int ld) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = hd / kVec;
  // consecutive threads take consecutive rows: the transposed stores then
  // fall in consecutive banks
  for (int c = threadIdx.x; c < rows * chunks; c += kThreads) {
    const int r = c % rows, d0 = (c / rows) * kVec;
    float f[kVec];
    if (r0 + r < len) {
      const Pack<T, kVec> p = *reinterpret_cast<const Pack<T, kVec>*>(
          src + (int64_t)(r0 + r) * hd + d0);
#pragma unroll
      for (int j = 0; j < kVec; ++j) f[j] = to_f32(p.v[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) f[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[(d0 + j) * ld + r] = f[j];
  }
}

// Rows [r0, r0 + kBk) of a (len, hd) matrix into dst[r * hd + d] as
// float32; rows at or past len are zero.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, int r0,
                                          int len, int hd, float* dst) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = hd / kVec;
  for (int c = threadIdx.x; c < kBk * chunks; c += kThreads) {
    const int r = c / chunks, d0 = (c % chunks) * kVec;
    float f[kVec];
    if (r0 + r < len) {
      const Pack<T, kVec> p = *reinterpret_cast<const Pack<T, kVec>*>(
          src + (int64_t)(r0 + r) * hd + d0);
#pragma unroll
      for (int j = 0; j < kVec; ++j) f[j] = to_f32(p.v[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) f[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kVec; j += 4)
      *reinterpret_cast<float4*>(dst + r * hd + d0 + j) =
          make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
  }
}

// reduce over the 16 lanes (tx = 0..15) that share a query row
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// C = ceil(hd / 64): groups of 4 output columns a thread, 64 apart
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int64_t bh_count,
             int heads, int group, int kv_heads, int t_len, int s_len, int hd,
             int q_tiles, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;              // [hd][kLdq]  Q^T
  float* sK = sQ + hd * kLdq;    // [hd][kLdk]  K^T
  float* sV = sK + hd * kLdk;    // [kBk][hd]   V
  float* sP = sV + kBk * hd;     // [kBk][kLdq] P^T

  const int64_t bh = blockIdx.x % bh_count;
  // the last query tiles see the most keys under the causal mask: first
  const int q0 = (q_tiles - 1 - (int)(blockIdx.x / bh_count)) * kBq;
  const int64_t kvh = (bh / heads) * kv_heads + (int)(bh % heads) / group;
  const T* qb = q + bh * t_len * hd;
  const T* kb = k + kvh * s_len * hd;
  const T* vb = v + kvh * s_len * hd;
  T* ob = o + bh * t_len * hd;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_transposed(qb, q0, t_len, hd, kBq, sQ, kLdq);

  float acc[4][4 * C];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * C; ++c) acc[i][c] = 0.f;
  }

  int tiles = (s_len + kBk - 1) / kBk;
  // key tiles wholly past the diagonal: every score there is masked
  if (causal) tiles = min(tiles, (q0 + kBq - 1) / kBk + 1);
  for (int kt = 0; kt < tiles; ++kt) {
    const int k0 = kt * kBk;
    __syncthreads();  // Q is in; the last tile's K, V and P are read
    load_transposed(kb, k0, s_len, hd, kBk, sK, kLdk);
    load_rows(vb, k0, s_len, hd, sV);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(sQ + d * kLdq + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(sK + d * kLdk + 4 * tx);
      const float qa[4] = {a.x, a.y, a.z, a.w};
      const float kb4[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb4[j], s[i][j]);
    }

    // online softmax over this tile; s becomes the probabilities p
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * tx + j;
        float x = s[i][j] * scale;
        if (kpos >= s_len || (causal && kpos > qpos)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * C; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(sP + (4 * tx + j) * kLdq + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // keys past S have p = 0: not visited
    const int keys = min(kBk, s_len - k0);
    for (int kk = 0; kk < keys; ++kk) {
      const float4 pp = *reinterpret_cast<const float4*>(sP + kk * kLdq + 4 * ty);
      const float p[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int g = 0; g < C; ++g) {
        const int col = 64 * g + 4 * tx;
        if (col < hd) {
          const float4 vv = *reinterpret_cast<const float4*>(sV + kk * hd + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * g + 0] = fmaf(p[i], vv.x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(p[i], vv.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(p[i], vv.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(p[i], vv.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= t_len) continue;
    const float lsafe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < C; ++g) {
      const int col = 64 * g + 4 * tx;
      if (col < hd) {
        Pack<T, 4> out;
#pragma unroll
        for (int j = 0; j < 4; ++j) out.v[j] = from_f32<T>(acc[i][4 * g + j] / lsafe);
        *reinterpret_cast<Pack<T, 4>*>(ob + (int64_t)row * hd + col) = out;
      }
    }
  }
}

template <typename T, int C>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int64_t bh, int heads, int group, int kv_heads, int t_len,
                   int s_len, int hd, int causal, int64_t smem_limit,
                   cudaStream_t stream) {
  void (*kern)(const T*, const T*, const T*, T*, int64_t, int, int, int, int,
               int, int, int, int, float) = flash_kernel<T, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_limit);
  if (err != cudaSuccess) return err;
  const int q_tiles = (t_len + kBq - 1) / kBq;
  const float scale = 1.0f / sqrtf((float)hd);
  kern<<<(unsigned)(q_tiles * bh), kThreads, smem_bytes(hd), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), bh, heads, group,
      kv_heads, t_len, s_len, hd, q_tiles, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      int64_t bh, int heads, int group, int kv_heads,
                      int t_len, int s_len, int hd, int causal,
                      int64_t smem_limit, cudaStream_t stream) {
  switch ((hd + 63) / 64) {
    case 1: return launch<T, 1>(q, k, v, o, bh, heads, group, kv_heads, t_len, s_len, hd, causal, smem_limit, stream);
    case 2: return launch<T, 2>(q, k, v, o, bh, heads, group, kv_heads, t_len, s_len, hd, causal, smem_limit, stream);
    case 3: return launch<T, 3>(q, k, v, o, bh, heads, group, kv_heads, t_len, s_len, hd, causal, smem_limit, stream);
    default: return launch<T, 4>(q, k, v, o, bh, heads, group, kv_heads, t_len, s_len, hd, causal, smem_limit, stream);
  }
}

}  // namespace

// Dynamic shared memory the kernel needs at head dim hd.
extern "C" int64_t flash_attention_smem_bytes(int64_t hd) {
  return (int64_t)smem_bytes(hd);
}

// q, o: (B, H, T, hd), k, v: (B, Hkv, S, hd), contiguous and 16-byte
// aligned, dtype 0 = float32, 1 = bfloat16; hd a multiple of 8 in [8, 256],
// H a multiple of Hkv.  Sets the kernel's dynamic shared memory limit to smem_limit bytes,
// launches on `stream`, and returns cudaGetLastError() of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int64_t B,
                                   int64_t H, int64_t Hkv, int64_t T,
                                   int64_t S, int64_t hd, int causal,
                                   int dtype, int64_t smem_limit,
                                   void* stream) {
  if (B * H == 0 || T == 0) return 0;
  if (hd < 8 || hd > kMaxHd || hd % 8 != 0 || Hkv <= 0 || H % Hkv != 0 ||
      T > INT32_MAX || S > INT32_MAX || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  // 16-byte vector loads and stores
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if ((T + kBq - 1) / kBq * B * H > INT32_MAX)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = (int)(H / Hkv);
  const cudaError_t err =
      dtype == 0
          ? launch_hd<float>(q, k, v, o, B * H, (int)H, group, (int)Hkv,
                             (int)T, (int)S, (int)hd, causal, smem_limit, s)
          : launch_hd<__nv_bfloat16>(q, k, v, o, B * H, (int)H, group,
                                     (int)Hkv, (int)T, (int)S, (int)hd,
                                     causal, smem_limit, s);
  return (int)err;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
