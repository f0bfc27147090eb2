// GQA flash attention (forward, streaming softmax) for Hopper (sm_90a),
// behind a plain C interface: a kernel for bfloat16 and float16 on wgmma,
// TMA and warp specialisation, and a float32 kernel on the CUDA cores.
//
// flash_mha  replaces repro/kernels/flash_attention/kernel.py::flash_mha
//      (kernel.py:77, body _flash_kernel :30).  For q (B, H, T, hd) and
//      k, v (B, Hkv, S, hd), query head h attends to KV head h / (H / Hkv):
//          o[b, h, t] = softmax_s(q[b, h, t] . k[b, kvh, s] * scale) v[b, kvh, s]
//      with scale = 1 / sqrt(hd), the top-left causal mask (key s is seen
//      by query t when s <= t) when asked, and masked scores set to -1e30
//      as the reference does.  The running max m, the normaliser l and the
//      output accumulator stay in float32; the output is q's type, rounded
//      to nearest even.  Both kernels: the TPU kernel's sequential nk grid
//      axis (m, l and the accumulator carried in VMEM scratch) becomes a
//      loop over key tiles inside one CTA with m, l and the accumulator in
//      registers; the KV head is chosen from the CTA's head, so K and V are
//      never repeated; key tiles wholly past the causal diagonal are not
//      visited; keys at or past S are masked, so no length is padded; query
//      tiles are launched longest (most keys) first.
//
// What bounds it on an H100: operations.  The work is 4 * T * S * hd
// floating-point operations a head (half of it when causal) against
// (2T + 2S) * hd elements moved: in a 16-bit type T * S / (T + S)
// operations a byte, 2,048 at T = S = 4096 (1,024 causal), far above the
// ~295 at which the bf16 and fp16 tensor cores (989 TFLOP/s each) and not
// the memory are the limit.  At
// mistral-nemo-12b's heads (B = 2, H = 32, T = S = 4096, hd = 128, causal)
// that is 2.749e11 FLOP: 0.278 ms at 989 TFLOP/s.
//
// bfloat16 and float16: flash_wgmma_kernel<D, T>, T = __nv_bfloat16 or
// __half (the same kernel; the products are wgmma's .bf16 or .f16 forms, the
// tensor maps of that type).  One CTA of three warpgroups per
// (128-query tile, batch * head).  A producer warpgroup lowers its
// registers (setmaxnreg) and one of its threads issues TMA loads: the Q
// tile once, then K and V tiles into a ring of two stages, each with a
// full mbarrier (TMA's byte count) for K and for V and an empty mbarrier
// (one arrival from each consumer warp, after its P V product).  The loads
// use 3-D tensor maps (hd, T or S, B * heads), built on the host and passed
// as __grid_constant__ parameters, with 128-byte swizzle: 64 16-bit columns
// a panel, so rows past T or S and columns past hd arrive as zeros and are
// never read from the next head.  Two consumer warpgroups raise their
// registers and own 64 query rows each.  S = Q K^T is wgmma m64nBk k16
// (T -> f32) with both operands read from shared memory through
// descriptors (K-major); the online softmax runs in registers on the
// accumulator's fragments (row max and sum over the quad of threads that
// share a row, exp2 with scale * log2(e) folded in, masks only on tiles
// that cross the diagonal or S); O += P V is wgmma with P from registers
// (the S fragments are already the A operand's layout) and V from shared
// memory as stored (MN-major, transposed by the descriptor).  Each consumer
// writes its 64 output rows in T into its own rows of the Q tile, in the
// same swizzle, and one of its threads stores them with TMA through a map
// of O, which clips rows past T and columns past hd.  Head dims are
// rounded up to a bucket D in {64, 128, 192, 256}; the key tile Bk is 128,
// or 64 from D = 192 on, where two stages of 128-key K and V tiles would not
// fit in shared memory beside Q (and the accumulators would crowd the 240
// registers a consumer thread gets).  Shared memory: Q 256 * D bytes plus
// 2 stages * 2 * Bk * D * 2, 164,920 bytes at D = 128 with the mbarriers
// and 1 KB to align the ring to the swizzle's 1024-byte pattern, so one
// CTA a SM.
//
// P keeps float32's precision: the reference multiplies P by V in float32
// (kernel.py:52-65), and P rounded to bfloat16 (as SDPA does) is off the
// exact output by an rms ratio of ~2e-3, four times the check's limit.  So
// P is split, P_hi = T(P) and P_lo = T(P - P_hi), and both are multiplied
// by V into the same float32 accumulator; the residual is about 2^-17 of P
// in bfloat16 and 2^-22 in float16 (below P = 2^-3, where P_lo is a float16
// subnormal, at most 2^-25 absolute, against a row's largest P of 1).  The
// tensor cores then issue 1.5x the counted work (a third
// product of the same size as each of the two counted ones): 4.12e11 FLOP
// at nemo's shape, 0.417 ms at the peak rate.  Not done here: an overlap of
// one warpgroup's softmax with the other's products (pingpong), and of a
// warpgroup's softmax with its own next QK^T.
//
// float32: flash_fma_kernel, float32 FMAs on the CUDA cores (67 TFLOP/s at
// best; TF32 would miss the float32 check of 1e-5).  One block of 256
// threads per (64-query tile, batch * head); each tile of K and V is
// staged in shared memory as float32, Q and K transposed (d-major) so that
// a thread reads its four query rows and its four keys as one 16-byte load
// each; thread (ty, tx) of the 16 x 16 grid owns query rows 4ty..4ty+3 and
// keys 4tx..4tx+3 of the tile, the row statistics are reduced over the 16
// lanes that share a row with shuffles, P goes through shared memory
// (transposed) and the thread accumulates output columns 64g + 4tx .. +3.
// Shared memory is (2 * hd * 68 + 64 * hd + 64 * 68) * 4 bytes: 119,808 at
// hd = 128.
//
// Both kernels need more than the 48 KB a launch gets without asking.  The
// launcher sets cudaFuncAttributeMaxDynamicSharedMemorySize to the limit
// its caller passes (the wrapper passes what the kernel needs) and returns
// cudaGetLastError() of the launch, so a refused launch is reported, not
// silent (0 = cudaSuccess).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHd = 256;
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// bfloat16 and float16: wgmma + TMA + warp specialisation

constexpr int kBq = 128;         // query rows a CTA
constexpr int kThreadsW = 384;   // producer + two consumer warpgroups
constexpr int kPanel = 64;       // 16-bit columns in one 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr int kConsumerWarps = 8;

__host__ __device__ constexpr int head_bucket(int hd) {
  return hd <= 64 ? 64 : hd <= 128 ? 128 : hd <= 192 ? 192 : 256;
}

template <int D>
struct Layout {
  static constexpr int kBk = D <= 128 ? 128 : 64;  // keys a tile
  static constexpr int kStages = 2;                // K/V ring
  static constexpr int kPanels = D / kPanel;
  static constexpr int kQBytes = kBq * D * 2;
  static constexpr int kTileBytes = kBk * D * 2;   // K or V, one stage
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  // full Q, full K and V per stage, empty per stage
  static constexpr int kBars = 1 + 3 * kStages;
  // + slack to align the base to the 1024 bytes of a swizzle pattern
  static constexpr int kBytes = kBar + 8 * kBars + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// spin until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// box {64, rows, 1} at (c0, c1, c2) of a 3-D tensor map into dst; the
// bytes complete a transaction on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// box {64, rows, 1} of smem into (c0, c1, c2) of a 3-D tensor map; what
// lies outside the tensor is not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (in 16-byte units)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving reads or writes of wgmma's registers across
// its fence and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32) = [d +] A (64 x 16) B (16 x N): A and B in shared memory,
// both K-major; T = __nv_bfloat16 or __half, the type of A and B
template <int N, typename T>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                         int accumulate);
// d (64 x N, f32) += A (64 x 16, registers) B (16 x N): B in shared memory,
// MN-major (transposed)
template <int N, typename T>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t db);

#define WG_D8(i)                                                        \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]),   \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]),             \
      "+f"(d[(i) + 7])
#define WG_D32(i) WG_D8(i), WG_D8((i) + 8), WG_D8((i) + 16), WG_D8((i) + 24)

// the accumulator's operands in the asm strings
#define WG_ACC32                                                              \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_ACC64                                                              \
  WG_ACC32 ","                                                                \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_ACC96                                                              \
  WG_ACC64 ","                                                                \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79," \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define WG_ACC128                                                             \
  WG_ACC96 ","                                                                \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111," \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

// One instance of each form for element type T, named TY in PTX ("bf16",
// "f16"); PRED, A and B are the operand numbers after the accumulator's.
#define WGMMA_SS(N, T, TY, ACC, PRED, A, B, ...)                         \
  template <>                                                            \
  __device__ __forceinline__ void wgmma_ss<N, T>(                        \
      float(&d)[N / 2], uint64_t da, uint64_t db, int accumulate) {      \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " PRED ", 0;\n"       \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY    \
                 "." TY " {" ACC "}, " A ", " B ", p, 1, 1, 0, 0;\n}\n"  \
                 : __VA_ARGS__                                           \
                 : "l"(da), "l"(db), "r"(accumulate));                   \
  }
#define WGMMA_RS(N, T, TY, ACC, PRED, A, B, ...)                         \
  template <>                                                            \
  __device__ __forceinline__ void wgmma_rs<N, T>(                        \
      float(&d)[N / 2], const uint32_t(&a)[4], uint64_t db) {            \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " PRED ", 0;\n"       \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY    \
                 "." TY " {" ACC "}, " A ", " B ", p, 1, 1, 1;\n}\n"     \
                 : __VA_ARGS__                                           \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),  \
                   "r"(1));                                              \
  }
#define WGMMA_ALL(T, TY)                                                  \
  WGMMA_SS(64, T, TY, WG_ACC32, "%34", "%32", "%33", WG_D32(0))           \
  WGMMA_SS(128, T, TY, WG_ACC64, "%66", "%64", "%65", WG_D32(0),          \
           WG_D32(32))                                                    \
  WGMMA_RS(64, T, TY, WG_ACC32, "%37", "{%32, %33, %34, %35}", "%36",     \
           WG_D32(0))                                                     \
  WGMMA_RS(128, T, TY, WG_ACC64, "%69", "{%64, %65, %66, %67}", "%68",    \
           WG_D32(0), WG_D32(32))                                         \
  WGMMA_RS(192, T, TY, WG_ACC96, "%101", "{%96, %97, %98, %99}", "%100",  \
           WG_D32(0), WG_D32(32), WG_D32(64))                             \
  WGMMA_RS(256, T, TY, WG_ACC128, "%133", "{%128, %129, %130, %131}",     \
           "%132", WG_D32(0), WG_D32(32), WG_D32(64), WG_D32(96))

WGMMA_ALL(__nv_bfloat16, "bf16")
WGMMA_ALL(__half, "f16")

#undef WGMMA_ALL
#undef WGMMA_RS
#undef WGMMA_SS
#undef WG_ACC128
#undef WG_ACC96
#undef WG_ACC64
#undef WG_ACC32
#undef WG_D32
#undef WG_D8

// The 16-bit element types: two floats rounded to nearest even into one
// 32-bit register and back, and the type's name for a tensor map.
template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  }
};
template <>
struct Elem<__half> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    __half2 v = __floats2half2_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __half22float2(*reinterpret_cast<__half2*>(&u));
  }
};

// D = head-dim bucket, T = the element type.  Thread layout of an m64nN
// accumulator: warp w of the warpgroup holds rows 16w + lane / 4 and + 8;
// element i is in row half (i / 2) % 2, column 8 (i / 4) + 2 (lane % 4) +
// i % 2.
template <int D, typename T>
__global__ void __launch_bounds__(kThreadsW, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap omap, int bh_count,
                   int heads, int group, int kv_heads, int s_len,
                   int q_tiles, int causal, float scale_log2) {
  using L = Layout<D>;
  constexpr int kBk = L::kBk, kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  auto full_k = [&](int s) { return bar_q + 8 * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + 2 * kStages + s); };

  const int bh = blockIdx.x % bh_count;
  // the last query tiles see the most keys under the causal mask: first
  const int q0 = (q_tiles - 1 - (int)(blockIdx.x / bh_count)) * kBq;
  const int kvh = (bh / heads) * kv_heads + (bh % heads) / group;
  int tiles = (s_len + kBk - 1) / kBk;
  // key tiles wholly past the diagonal: every score there is masked
  if (causal) tiles = min(tiles, (q0 + kBq - 1) / kBk + 1);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // warpgroup 0 produces, 1 and 2 consume; setmaxnreg and wgmma are
  // executed by whole warpgroups
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int p = 0; p < L::kPanels; ++p)
        tma_load(sQ + p * kBq * kRowBytes, &qmap, bar_q, p * kPanel, q0, bh);
      for (int kt = 0; kt < tiles; ++kt) {
        const int s = kt % kStages;
        // a fresh barrier passes the wait for parity 1: the first round of
        // stages starts empty
        mbar_wait(empty(s), ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full_k(s), L::kTileBytes);
        for (int p = 0; p < L::kPanels; ++p)
          tma_load(sK + s * L::kTileBytes + p * kBk * kRowBytes, &kmap,
                   full_k(s), p * kPanel, kt * kBk, kvh);
        mbar_expect_tx(full_v(s), L::kTileBytes);
        for (int p = 0; p < L::kPanels; ++p)
          tma_load(sV + s * L::kTileBytes + p * kBk * kRowBytes, &vmap,
                   full_v(s), p * kPanel, kt * kBk, kvh);
      }
    }
  } else {
    // consumer warpgroups: cw owns query rows q0 + 64 cw .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int wg_row0 = q0 + 64 * cw;
    const int row0 = wg_row0 + 16 * warp + lane / 4;  // and row0 + 8
    const int col0 = 2 * (lane % 4);
    // this warpgroup's 64 rows of each Q panel
    const uint32_t sQw = sQ + 64 * cw * kRowBytes;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

    mbar_wait(bar_q, 0);
    for (int kt = 0; kt < tiles; ++kt) {
      const int s = kt % kStages;
      const uint32_t phase = (kt / kStages) & 1;
      const uint32_t sKs = sK + s * L::kTileBytes;
      const uint32_t sVs = sV + s * L::kTileBytes;

      // S = Q K^T: D / 16 steps of k16; within a 64-column panel a step
      // moves the start address 32 bytes along the swizzled row
      float sc[kBk / 2];
      mbar_wait(full_k(s), phase);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int p = ks / 4, kk = ks % 4;
        wgmma_ss<kBk, T>(
            sc,
            smem_desc(sQw + p * kBq * kRowBytes + kk * 32, 16, 8 * kRowBytes),
            smem_desc(sKs + p * kBk * kRowBytes + kk * 32, 16, 8 * kRowBytes),
            ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // online softmax in base 2 on the fragments
      const int k0 = kt * kBk;
      const bool edge = k0 + kBk > s_len || (causal && k0 + kBk - 1 > wg_row0);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kBk / 2; ++i) {
        float x = sc[i] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * (i / 4) + col0 + (i & 1);
          const int row = row0 + 8 * ((i / 2) & 1);
          if (col >= s_len || (causal && col > row)) x = kNegInf;
        }
        sc[i] = x;
        mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], x);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
      // P, split into hi and lo halves of type T in the A operand's layout:
      // the 16 keys of step kk are accumulator elements 8kk .. 8kk + 7
      uint32_t p_hi[kBk / 16][4], p_lo[kBk / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j;
          const float a = exp2f(sc[i] - m[(i / 2) & 1]);
          const float b = exp2f(sc[i + 1] - m[(i / 2) & 1]);
          l[(i / 2) & 1] += a + b;
          p_hi[kk][j] = Elem<T>::pack(a, b);
          const float2 hf = Elem<T>::unpack(p_hi[kk][j]);
          p_lo[kk][j] = Elem<T>::pack(a - hf.x, b - hf.y);
        }
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i / 2) & 1];

      // O += P_hi V + P_lo V: V as stored, [key][d] in 64-column panels,
      // is the MN-major B operand; a step of 16 keys is 2048 bytes, the
      // next panel of d Bk rows on
      mbar_wait(full_v(s), phase);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk) {
        const uint64_t dv = smem_desc(sVs + kk * 16 * kRowBytes,
                                      kBk * kRowBytes, 8 * kRowBytes);
        wgmma_rs<D, T>(acc, p_hi[kk], dv);
        wgmma_rs<D, T>(acc, p_lo[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      // this warp is done with stage s
      if (lane == 0) mbar_arrive(empty(s));
    }

    // epilogue: the row sums over the quad, then o = acc / l in T,
    // written into this warpgroup's own rows of the Q tile (free after its
    // last QK^T) in the same 128-byte swizzle, and stored by TMA, which
    // clips rows past T and columns past hd
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
    const int row_w = 16 * warp + lane / 4;  // and + 8, within the 64
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t row = sQw + (row_w + 8 * r) * kRowBytes + 4 * (lane % 4);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        // 16-byte chunk j % 8 of panel j / 8, swizzled by the row mod 8
        const uint32_t at = row + (j / 8) * kBq * kRowBytes +
                            (((j % 8) ^ (lane / 4)) << 4);
        st_shared_u32(at, Elem<T>::pack(acc[4 * j + 2 * r] / l[r],
                                        acc[4 * j + 2 * r + 1] / l[r]));
      }
    }
    // the writes to the async proxy, then the warpgroup's 128 threads
    // meet on named barrier 1 + cw before one of them stores
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
    if (threadIdx.x % 128 == 0) {
      for (int p = 0; p < L::kPanels; ++p)
        tma_store(&omap, sQw + p * kBq * kRowBytes, p * kPanel, wg_row0, bh);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // shared memory stays until the stores have read it
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
}

// cuTensorMapEncodeTiled, found through the runtime so that the library
// needs no link to the driver
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// (mats, rows, hd) 16-bit elements of type `type` at ptr as a 3-D tensor
// map of {64, box_rows, 1} boxes with 128-byte swizzle; what lies past rows
// or hd reads as zeros and is not written
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                int64_t mats, int64_t rows, int64_t hd, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)(rows * hd * 2)};
  const cuuint32_t box[3] = {(cuuint32_t)kPanel, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, type, 3,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, typename T>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, int64_t bh, int heads, int group,
                         int kv_heads, int t_len, int s_len, int hd,
                         int causal, int64_t smem_limit,
                         cudaStream_t stream) {
  using L = Layout<D>;
  CUtensorMap qmap, kmap, vmap, omap;
  constexpr CUtensorMapDataType type = Elem<T>::kMap;
  if (!tensor_map(&qmap, type, q, bh, t_len, hd, kBq) ||
      !tensor_map(&omap, type, o, bh, t_len, hd, kBq / 2))
    return cudaErrorInvalidValue;
  if (s_len > 0) {
    if (!tensor_map(&kmap, type, k, bh / group, s_len, hd, L::kBk) ||
        !tensor_map(&vmap, type, v, bh / group, s_len, hd, L::kBk))
      return cudaErrorInvalidValue;
  } else {
    kmap = vmap = qmap;  // no key tile is loaded
  }
  auto kern = flash_wgmma_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_limit);
  if (err != cudaSuccess) return err;
  const int q_tiles = (t_len + kBq - 1) / kBq;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)hd);
  kern<<<(unsigned)(q_tiles * bh), kThreadsW, L::kBytes, stream>>>(
      qmap, kmap, vmap, omap, (int)bh, heads, group, kv_heads, s_len,
      q_tiles, causal, scale_log2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: FMAs on the CUDA cores

constexpr int kBqF = 64;        // query rows per block
constexpr int kBkF = 64;        // keys per tile
constexpr int kThreadsF = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int kLdq = kBqF + 4;  // row stride of Q^T and P^T (16-byte rows)
constexpr int kLdk = kBkF + 4;  // row stride of K^T

size_t fma_smem_bytes(int64_t hd) {
  return sizeof(float) *
         (size_t)(hd * kLdq + hd * kLdk + kBkF * hd + kBkF * kLdq);
}

// Rows [r0, r0 + rows) of a (len, hd) matrix into dst[d * ld + r]
// (transposed); rows at or past len are zero.
__device__ __forceinline__ void load_transposed(const float* __restrict__ src,
                                                int r0, int len, int hd,
                                                int rows, float* dst, int ld) {
  const int chunks = hd / 4;
  // consecutive threads take consecutive rows: the transposed stores then
  // fall in consecutive banks
  for (int c = threadIdx.x; c < rows * chunks; c += kThreadsF) {
    const int r = c % rows, d0 = (c / rows) * 4;
    const float4 f = r0 + r < len
                         ? *reinterpret_cast<const float4*>(
                               src + (int64_t)(r0 + r) * hd + d0)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[(d0 + 0) * ld + r] = f.x;
    dst[(d0 + 1) * ld + r] = f.y;
    dst[(d0 + 2) * ld + r] = f.z;
    dst[(d0 + 3) * ld + r] = f.w;
  }
}

// Rows [r0, r0 + kBkF) of a (len, hd) matrix into dst[r * hd + d]; rows at
// or past len are zero.
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          int r0, int len, int hd,
                                          float* dst) {
  const int chunks = hd / 4;
  for (int c = threadIdx.x; c < kBkF * chunks; c += kThreadsF) {
    const int r = c / chunks, d0 = (c % chunks) * 4;
    *reinterpret_cast<float4*>(dst + r * hd + d0) =
        r0 + r < len ? *reinterpret_cast<const float4*>(
                           src + (int64_t)(r0 + r) * hd + d0)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
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
template <int C>
__global__ void __launch_bounds__(kThreadsF)
flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int64_t bh_count, int heads, int group, int kv_heads,
                 int t_len, int s_len, int hd, int q_tiles, int causal,
                 float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;              // [hd][kLdq]  Q^T
  float* sK = sQ + hd * kLdq;    // [hd][kLdk]  K^T
  float* sV = sK + hd * kLdk;    // [kBkF][hd]  V
  float* sP = sV + kBkF * hd;    // [kBkF][kLdq] P^T

  const int64_t bh = blockIdx.x % bh_count;
  // the last query tiles see the most keys under the causal mask: first
  const int q0 = (q_tiles - 1 - (int)(blockIdx.x / bh_count)) * kBqF;
  const int64_t kvh = (bh / heads) * kv_heads + (int)(bh % heads) / group;
  const float* qb = q + bh * t_len * hd;
  const float* kb = k + kvh * s_len * hd;
  const float* vb = v + kvh * s_len * hd;
  float* ob = o + bh * t_len * hd;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_transposed(qb, q0, t_len, hd, kBqF, sQ, kLdq);

  float acc[4][4 * C];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * C; ++c) acc[i][c] = 0.f;
  }

  int tiles = (s_len + kBkF - 1) / kBkF;
  // key tiles wholly past the diagonal: every score there is masked
  if (causal) tiles = min(tiles, (q0 + kBqF - 1) / kBkF + 1);
  for (int kt = 0; kt < tiles; ++kt) {
    const int k0 = kt * kBkF;
    __syncthreads();  // Q is in; the last tile's K, V and P are read
    load_transposed(kb, k0, s_len, hd, kBkF, sK, kLdk);
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
    const int keys = min(kBkF, s_len - k0);
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
      if (col < hd)
        *reinterpret_cast<float4*>(ob + (int64_t)row * hd + col) =
            make_float4(acc[i][4 * g + 0] / lsafe, acc[i][4 * g + 1] / lsafe,
                        acc[i][4 * g + 2] / lsafe, acc[i][4 * g + 3] / lsafe);
    }
  }
}

template <int C>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       int64_t bh, int heads, int group, int kv_heads,
                       int t_len, int s_len, int hd, int causal,
                       int64_t smem_limit, cudaStream_t stream) {
  auto kern = flash_fma_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_limit);
  if (err != cudaSuccess) return err;
  const int q_tiles = (t_len + kBqF - 1) / kBqF;
  const float scale = 1.0f / sqrtf((float)hd);
  kern<<<(unsigned)(q_tiles * bh), kThreadsF, fma_smem_bytes(hd), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), bh, heads, group,
      kv_heads, t_len, s_len, hd, q_tiles, causal, scale);
  return cudaGetLastError();
}

// the wgmma kernel for element type T at the head dim's bucket
template <typename T>
int launch_16bit(const void* q, const void* k, const void* v, void* o,
                 int64_t bh, int heads, int group, int kv_heads, int t_len,
                 int s_len, int hd, int causal, int64_t smem_limit,
                 cudaStream_t s) {
  switch (head_bucket(hd)) {
    case 64: return (int)launch_wgmma<64, T>(q, k, v, o, bh, heads, group, kv_heads, t_len, s_len, hd, causal, smem_limit, s);
    case 128: return (int)launch_wgmma<128, T>(q, k, v, o, bh, heads, group, kv_heads, t_len, s_len, hd, causal, smem_limit, s);
    case 192: return (int)launch_wgmma<192, T>(q, k, v, o, bh, heads, group, kv_heads, t_len, s_len, hd, causal, smem_limit, s);
    default: return (int)launch_wgmma<256, T>(q, k, v, o, bh, heads, group, kv_heads, t_len, s_len, hd, causal, smem_limit, s);
  }
}

}  // namespace

// Dynamic shared memory the kernel for this head dim and dtype needs
// (dtype 0 = float32, 1 = bfloat16, 2 = float16).
extern "C" int64_t flash_attention_smem_bytes(int64_t hd, int dtype) {
  if (dtype == 0) return (int64_t)fma_smem_bytes(hd);
  switch (head_bucket((int)hd)) {
    case 64: return Layout<64>::kBytes;
    case 128: return Layout<128>::kBytes;
    case 192: return Layout<192>::kBytes;
    default: return Layout<256>::kBytes;
  }
}

// q, o: (B, H, T, hd), k, v: (B, Hkv, S, hd), contiguous and 16-byte
// aligned, dtype 0 = float32, 1 = bfloat16, 2 = float16; hd a multiple of 8
// in [8, 256],
// H a multiple of Hkv.  Sets the kernel's dynamic shared memory limit to
// smem_limit bytes, launches on `stream`, and returns cudaGetLastError()
// of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int64_t B,
                                   int64_t H, int64_t Hkv, int64_t T,
                                   int64_t S, int64_t hd, int causal,
                                   int dtype, int64_t smem_limit,
                                   void* stream) {
  if (B * H == 0 || T == 0) return 0;
  if (hd < 8 || hd > kMaxHd || hd % 8 != 0 || Hkv <= 0 || H % Hkv != 0 ||
      T > INT32_MAX || S > INT32_MAX || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  // 16-byte vector loads and stores; TMA's global addresses
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if ((T + kBqF - 1) / kBqF * B * H > INT32_MAX)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = (int)(H / Hkv);
  const int64_t bh = B * H;
  if (dtype == 0) {
    switch ((hd + 63) / 64) {
      case 1: return (int)launch_fma<1>(q, k, v, o, bh, (int)H, group, (int)Hkv, (int)T, (int)S, (int)hd, causal, smem_limit, s);
      case 2: return (int)launch_fma<2>(q, k, v, o, bh, (int)H, group, (int)Hkv, (int)T, (int)S, (int)hd, causal, smem_limit, s);
      case 3: return (int)launch_fma<3>(q, k, v, o, bh, (int)H, group, (int)Hkv, (int)T, (int)S, (int)hd, causal, smem_limit, s);
      default: return (int)launch_fma<4>(q, k, v, o, bh, (int)H, group, (int)Hkv, (int)T, (int)S, (int)hd, causal, smem_limit, s);
    }
  }
  return dtype == 1 ? launch_16bit<__nv_bfloat16>(q, k, v, o, bh, (int)H, group, (int)Hkv, (int)T, (int)S, (int)hd, causal, smem_limit, s)
                    : launch_16bit<__half>(q, k, v, o, bh, (int)H, group, (int)Hkv, (int)T, (int)S, (int)hd, causal, smem_limit, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
