// Design variants of the fleet's no-change test (unchanged_lanes_kernel,
// src/repro_torch/kernels/contour_mm/csrc/converged.cu), built beside it
// by tools/unchanged_variants.py and timed on one CUDA GPU.
//
// The shipped source is included whole, so each variant reuses its
// helpers (vload, vstore, differ, fleet_step) and differs from the
// shipped kernel only where its parameters say:
//   kT, kV, kMin  threads a block, 16-byte vectors of each array a thread
//                 a tile (a tile is kT * kV * 4 labels) and blocks an SM;
//   kStep         0: fleet_step as shipped; 1: the same step with each
//                 lane's four words read and written as one 16-byte
//                 volatile access; 2: the tickets alone, no pass over the
//                 lanes (a floor: it leaves the lanes' words unstepped);
//   kPre          thread 0 reads the next tile's words during this tile
//                 and skips by them, so no tile waits on its own words.
// Items are 16-byte vectors where a and b share their 16-byte phase,
// else single ints, as shipped.

#include "../src/repro_torch/kernels/contour_mm/csrc/converged.cu"

namespace {

__device__ __forceinline__ int4 vload4(const int* p) {
  int4 v;
  asm volatile("ld.volatile.global.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void vstore4(int* p, int4 v) {
  asm volatile("st.volatile.global.v4.s32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// fleet_step with one 16-byte read and one 16-byte write of each lane's
// words (kStep 1), or the tickets alone (kStep 2).
template <int kStep>
__device__ void variant_step(int* lanes, int64_t B, int* fleet) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(reinterpret_cast<unsigned*>(fleet + kTicket), 1u) ==
           gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (kStep == 2) {
    if (threadIdx.x == 0) vstore(fleet + kTicket, 0);
    return;
  }
  int all = 1, live = 0;
  for (int64_t b = threadIdx.x; b < B; b += blockDim.x) {
    int4 w = vload4(lanes + 4 * b);
    if (!w.x) {
      live = 1;
      const int ok = w.z == 0;
      w.y += 1;
      w.x = ok;
      all &= ok;
    }
    w.z = 0;
    vstore4(lanes + 4 * b, w);
  }
  all = __syncthreads_and(all);
  live = __syncthreads_or(live);
  if (threadIdx.x == 0) {
    if (live) vstore(fleet + kIt, vload(fleet + kIt) + 1);
    vstore(fleet + kDone, all);
    vstore(fleet + kTicket, 0);
  }
}

// Whether thread 0 should skip tile k (its lane done or witnessed).
__device__ __forceinline__ bool skip_word(const int* lanes, uint32_t k,
                                          uint32_t B, uint32_t tiles) {
  if (k >= tiles) return true;
  const int* words = lanes + 4 * (size_t)(k % B);
  return __ldg(words + kDone) || vload(words + kBad);
}

template <typename T, int kT, int kV, int kMin, int kStep, bool kPre>
__global__ void __launch_bounds__(kT, kMin)
variant_kernel(const int* __restrict__ a, const int* __restrict__ b,
               uint32_t B, uint32_t n, uint32_t per, uint32_t phase,
               int* lanes, int* fleet) {
  if (__ldg(fleet + kDone)) return;
  constexpr uint32_t W = sizeof(T) / sizeof(int);
  constexpr int E = kV * 4 / W;
  const uint32_t tiles = B * per, lid = threadIdx.x & 31;
  bool stored = false;
  // kPre: thread 0 reads the next tile's words while this tile's labels
  // are in flight, and skips by them (done is exact, bad as it stood then)
  bool next_skip = kPre && threadIdx.x == 0 &&
                   skip_word(lanes, blockIdx.x, B, tiles);
  for (uint32_t k = blockIdx.x; k < tiles; k += gridDim.x) {
    const uint32_t slice = k / B, lane = k - slice * B;
    int* words = lanes + 4 * (size_t)lane;
    bool skip;
    if constexpr (kPre) {
      skip = __syncthreads_or(next_skip);
      if (threadIdx.x == 0)
        next_skip = skip_word(lanes, k + gridDim.x, B, tiles);
    } else {
      skip = __syncthreads_or(threadIdx.x == 0 &&
                              (__ldg(words + kDone) || vload(words + kBad)));
    }
    if (skip) continue;
    const uint32_t first = lane * n;
    const uint32_t head =
        W == 1 ? 0u : min((4u - ((phase + first) & 3u)) & 3u, n);
    const uint32_t items = (n - head) / W;
    const T* va = reinterpret_cast<const T*>(a + first + head);
    const T* vb = reinterpret_cast<const T*>(b + first + head);
    const uint32_t i0 =
        slice * (kT * E) + (threadIdx.x / 32) * (32 * E) + lid;
    T x[E], y[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const bool ok = i0 + 32 * i < items;
      x[i] = ok ? __ldcs(va + i0 + 32 * i) : T{};
      y[i] = ok ? __ldcs(vb + i0 + 32 * i) : T{};
    }
    bool witness = false;
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
  if (stored) __threadfence();
  if constexpr (kStep == 0)
    fleet_step(lanes, B, fleet);
  else
    variant_step<kStep>(lanes, B, fleet);
}

template <int kT, int kV, int kMin, int kStep, bool kPre = false>
int launch_variant(const int* a, const int* b, int64_t B, int64_t n,
                   int* lanes, int* fleet, cudaStream_t stream) {
  if (B <= 0 || n < 0 || B * n >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a),
                  pb = reinterpret_cast<uintptr_t>(b);
  constexpr int kTile = kT * kV * 4;
  const uint32_t per = (uint32_t)((n + kTile - 1) / kTile);
  const int64_t most = (int64_t)sm_count() * kMin;
  const int64_t tiles = B * per;
  const unsigned blocks =
      (unsigned)(tiles < 1 ? 1 : (tiles < most ? tiles : most));
  if (((pa ^ pb) & 15) == 0)
    variant_kernel<int4, kT, kV, kMin, kStep, kPre>
        <<<blocks, kT, 0, stream>>>(
        a, b, (uint32_t)B, (uint32_t)n, per, (uint32_t)((pa >> 2) & 3),
        lanes, fleet);
  else
    variant_kernel<int, kT, kV, kMin, kStep, kPre>
        <<<blocks, kT, 0, stream>>>(
        a, b, (uint32_t)B, (uint32_t)n, per, 0u, lanes, fleet);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Variant `id` (tools/unchanged_variants.py: VARIANTS) over two [B * n]
// arrays with the fleet's words; returns the launch's error code, or
// cudaErrorInvalidValue for an unknown id.
int variant_unchanged(int id, const void* a, const void* b, int64_t B,
                      int64_t n, void* lanes, void* fleet, void* stream) {
  const int* x = (const int*)a;
  const int* y = (const int*)b;
  int* l = (int*)lanes;
  int* f = (int*)fleet;
  cudaStream_t s = (cudaStream_t)stream;
  switch (id) {
    case 0: return launch_variant<256, 2, 8, 0>(x, y, B, n, l, f, s);
    case 1: return launch_variant<256, 2, 8, 1>(x, y, B, n, l, f, s);
    case 2: return launch_variant<256, 2, 8, 2>(x, y, B, n, l, f, s);
    case 3: return launch_variant<256, 4, 8, 0>(x, y, B, n, l, f, s);
    case 4: return launch_variant<512, 2, 4, 0>(x, y, B, n, l, f, s);
    case 5: return launch_variant<256, 2, 4, 0>(x, y, B, n, l, f, s);
    case 6: return launch_variant<1024, 1, 2, 0>(x, y, B, n, l, f, s);
    case 7: return launch_variant<128, 2, 16, 0>(x, y, B, n, l, f, s);
    case 8: return launch_variant<256, 1, 8, 0>(x, y, B, n, l, f, s);
    case 9: return launch_variant<256, 1, 4, 0>(x, y, B, n, l, f, s);
    case 10: return launch_variant<128, 1, 16, 0>(x, y, B, n, l, f, s);
    case 11: return launch_variant<256, 1, 8, 1>(x, y, B, n, l, f, s);
    case 12: return launch_variant<512, 1, 4, 0>(x, y, B, n, l, f, s);
    case 13: return launch_variant<256, 1, 8, 2>(x, y, B, n, l, f, s);
    case 14: return launch_variant<256, 1, 8, 0, true>(x, y, B, n, l, f, s);
    case 15: return launch_variant<256, 2, 8, 0, true>(x, y, B, n, l, f, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
