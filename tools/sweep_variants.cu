// Design variants of the port's sweep kernels K1 fused_relax and K2
// scatter_min (src/repro_torch/kernels/contour_mm/csrc/contour_mm.cu),
// built and timed side by side by tools/sweep_variants.py.  Not used by
// the port: this file is the record of what each design choice of those
// kernels was measured against.
//
// Each kernel is a template over
//   F       what happens to an item's updates once they are known, a set of
//           the flags below;
//   LAYOUT  0: lane l takes items l, l + 32, ... of a warp's step (4-byte
//           loads); 1: lane l takes EPT consecutive items (one 16-byte load
//           of each stream, EPT = 4);
//   EPT     items a lane a step;
//   MINB    the blocks an SM must hold (__launch_bounds__' second value; 1
//           leaves the registers to the compiler).
// Both kernels check ids against n and take the counter: [0] updates that
// can lower their input label (an edge's copies of a target dropped),
// [1] those left after a combine that comes before the test, [2] reds
// issued to memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

constexpr int TEST = 1;           // read L_out[t] through L1, drop if met
constexpr int VOTE = 2;           // end a step on a warp vote where no lane
                                  // has an update
constexpr int COMBINE_ALL = 4;    // MATCH + REDUX on every slot
constexpr int COMBINE_FIRST = 32; // the combine before the test, not after
constexpr int EARLY_GATE = 1024;  // MATCH + REDUX only on a hot slot (its
                                  // first live lane's target shared by kHot
                                  // lanes), judged before the L1 test while
                                  // its reads are in flight (the shipped
                                  // kernels' order)
constexpr int kHot = 8;           // lanes on one target that make it hot

__device__ __forceinline__ bool outside(int id, int64_t n) {
  return id < 0 || (int64_t)id >= n;
}
__device__ __forceinline__ void flag(int* err) {
  if (err != nullptr) *err = 1;
}

// one red per target of the slot: the lanes of each target combine
__device__ __forceinline__ void combine(int& t, int& v) {
  const unsigned live = __ballot_sync(kFull, t >= 0);
  if (__popc(live) < 2) return;
  if (t >= 0) {
    const unsigned bit = 1u << (threadIdx.x & 31);
    const unsigned g = __match_any_sync(live, t);
    if (g != bit) {
      v = __reduce_min_sync(g, v);
      if (g & (bit - 1)) t = -1;
    }
  }
}

template <int F, int N>
__device__ __forceinline__ void combine_slots(int (&t)[N], int (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (F & COMBINE_ALL) combine(t[j], v[j]);
  }
}

template <int F, int N>
__device__ __forceinline__ void tail(int* __restrict__ L_out, int (&t)[N],
                                     int (&v)[N], unsigned (&c)[3]) {
  if (F & VOTE) {
    bool any = false;
#pragma unroll
    for (int j = 0; j < N; ++j) any |= t[j] >= 0;
    if (!__any_sync(kFull, any)) return;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) c[0] += t[j] >= 0;
  if (F & COMBINE_FIRST) combine_slots<F>(t, v);
#pragma unroll
  for (int j = 0; j < N; ++j) c[1] += t[j] >= 0;
  if (F & EARLY_GATE) {
    int cur[N];
#pragma unroll
    for (int j = 0; j < N; ++j) cur[j] = t[j] >= 0 ? __ldca(L_out + t[j]) : 0;
    unsigned hot = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const unsigned live = __ballot_sync(kFull, t[j] >= 0);
      if (__popc(live) >= kHot) {
        const int t0 = __shfl_sync(kFull, t[j], __ffs(live) - 1);
        if (__popc(__ballot_sync(kFull, t[j] == t0)) >= kHot) hot |= 1u << j;
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (cur[j] <= v[j]) t[j] = -1;
    if (hot) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (hot >> j & 1) combine(t[j], v[j]);
    }
  } else if (F & TEST) {
    int cur[N];
#pragma unroll
    for (int j = 0; j < N; ++j) cur[j] = t[j] >= 0 ? __ldca(L_out + t[j]) : 0;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (cur[j] <= v[j]) t[j] = -1;
  }
  if (!(F & COMBINE_FIRST)) combine_slots<F>(t, v);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (t[j] >= 0) {
      atomicMin(L_out + t[j], v[j]);
      ++c[2];
    }
  }
}

__device__ __forceinline__ void count(unsigned long long* counter,
                                      const unsigned (&c)[3]) {
  if (counter == nullptr) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const unsigned s = __reduce_add_sync(kFull, c[k]);
    if ((threadIdx.x & 31) == 0) atomicAdd(counter + k, (unsigned long long)s);
  }
}

// a lane's items of step c: (first, stride)
template <int LAYOUT, int EPT>
__device__ __forceinline__ int64_t first_item(int64_t c) {
  const int lane = threadIdx.x & 31;
  return LAYOUT ? c * 32 * EPT + lane * EPT : c * 32 * EPT + lane;
}

// the lane's EPT items of two int32 streams
template <int LAYOUT, int EPT>
__device__ __forceinline__ void load2(const int* __restrict__ a,
                                      const int* __restrict__ b, int64_t e0,
                                      int64_t m, int (&x)[EPT], int (&y)[EPT],
                                      bool (&ok)[EPT]) {
  if constexpr (LAYOUT == 1) {
    static_assert(EPT == 4, "a 16-byte load takes 4 items");
    if (e0 + EPT <= m) {
      const int4 p = __ldcs(reinterpret_cast<const int4*>(a + e0));
      const int4 q = __ldcs(reinterpret_cast<const int4*>(b + e0));
      x[0] = p.x; x[1] = p.y; x[2] = p.z; x[3] = p.w;
      y[0] = q.x; y[1] = q.y; y[2] = q.z; y[3] = q.w;
#pragma unroll
      for (int i = 0; i < EPT; ++i) ok[i] = true;
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int64_t e = e0 + (LAYOUT ? 1 : 32) * i;
    ok[i] = e < m;
    x[i] = ok[i] ? __ldcs(a + e) : 0;
    y[i] = ok[i] ? __ldcs(b + e) : 0;
  }
}

template <int F, int LAYOUT, int EPT, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
k1(const int* __restrict__ L_in, int* __restrict__ L_out,
   const int* __restrict__ src, const int* __restrict__ dst, int64_t m,
   int64_t n, int* err, unsigned long long* counter) {
  const int64_t steps = (m + 32 * EPT - 1) / (32 * EPT);
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  unsigned c3[3] = {0, 0, 0};
  for (int64_t c = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / 32;
       c < steps; c += warps) {
    int s[EPT], d[EPT];
    bool ok[EPT];
    load2<LAYOUT, EPT>(src, dst, first_item<LAYOUT, EPT>(c), m, s, d, ok);
#pragma unroll
    for (int i = 0; i < EPT; ++i)
      if (ok[i] && (outside(s[i], n) || outside(d[i], n))) {
        flag(err);
        ok[i] = false;
      }
    int ls[EPT], ld[EPT], l2s[EPT], l2d[EPT];
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      ls[i] = ok[i] ? __ldg(L_in + s[i]) : 0;
      ld[i] = ok[i] ? __ldg(L_in + d[i]) : 0;
    }
#pragma unroll
    for (int i = 0; i < EPT; ++i)
      if (ok[i] && (outside(ls[i], n) || outside(ld[i], n))) {
        flag(err);
        ok[i] = false;
      }
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      l2s[i] = ok[i] ? __ldg(L_in + ls[i]) : 0;
      l2d[i] = ok[i] ? __ldg(L_in + ld[i]) : 0;
    }
    int t[4 * EPT], v[4 * EPT];
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
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
    tail<F>(L_out, t, v, c3);
  }
  count(counter, c3);
}

template <int F, int LAYOUT, int EPT, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
k2(const int* __restrict__ L_in, int* __restrict__ L_out,
   const int* __restrict__ targets, const int* __restrict__ values, int64_t k,
   int64_t n, int* err, unsigned long long* counter) {
  const int64_t steps = (k + 32 * EPT - 1) / (32 * EPT);
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  unsigned c3[3] = {0, 0, 0};
  for (int64_t c = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / 32;
       c < steps; c += warps) {
    int t[EPT], v[EPT];
    bool ok[EPT];
    load2<LAYOUT, EPT>(targets, values, first_item<LAYOUT, EPT>(c), k, t, v,
                       ok);
#pragma unroll
    for (int i = 0; i < EPT; ++i)
      if (ok[i] && outside(t[i], n)) {
        flag(err);
        ok[i] = false;
      }
    int lab[EPT];
#pragma unroll
    for (int i = 0; i < EPT; ++i) lab[i] = ok[i] ? __ldg(L_in + t[i]) : 0;
#pragma unroll
    for (int i = 0; i < EPT; ++i)
      if (!ok[i] || v[i] >= lab[i]) t[i] = -1;
    tail<F>(L_out, t, v, c3);
  }
  count(counter, c3);
}

int grid_for(const void* fn, int64_t steps, int mode) {
  int device = 0, sms = 132, per_sm = mode;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t need = (steps + kThreads / 32 - 1) / (kThreads / 32);
  if (mode < 0) return (int)need;  // one step a warp, no grid stride
  if (mode == 0)                   // one wave of resident blocks
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
  const int64_t cap = (int64_t)sms * per_sm;
  return (int)(need < cap ? need : cap);
}

}  // namespace

// (F, LAYOUT, EPT, MINB) instances
#define VARIANTS(X)                                                         \
  X(3, 0, 4, 8) X(3, 0, 2, 8) X(2, 0, 4, 8) X(7, 0, 4, 8) X(39, 0, 4, 8)   \
  X(3, 1, 4, 8) X(39, 1, 4, 8) X(1027, 0, 4, 1) X(1027, 0, 2, 8)           \
  X(1027, 0, 4, 8)

#define K1_CASE(F_, L_, E_, B_)                                              \
  if (f == F_ && layout == L_ && ept == E_ && minb == B_) {                  \
    k1<F_, L_, E_, B_><<<grid_for((const void*)k1<F_, L_, E_, B_>,           \
                                  (m + 32 * E_ - 1) / (32 * E_), grid_mode), \
                         kThreads, 0, (cudaStream_t)stream>>>(               \
        (const int*)L_in, (int*)L_out, (const int*)src, (const int*)dst, m,  \
        n, (int*)err, (unsigned long long*)counter);                         \
    return (int)cudaGetLastError();                                          \
  }
#define K2_CASE(F_, L_, E_, B_)                                              \
  if (f == F_ && layout == L_ && ept == E_ && minb == B_) {                  \
    k2<F_, L_, E_, B_><<<grid_for((const void*)k2<F_, L_, E_, B_>,           \
                                  (k + 32 * E_ - 1) / (32 * E_), grid_mode), \
                         kThreads, 0, (cudaStream_t)stream>>>(               \
        (const int*)L_in, (int*)L_out, (const int*)targets,                  \
        (const int*)values, k, n, (int*)err, (unsigned long long*)counter);  \
    return (int)cudaGetLastError();                                          \
  }

extern "C" {

// Returns the launch's CUDA error, or -1 for an instance not built.
int variant_fused_relax(int f, int layout, int ept, int minb, int grid_mode,
                        const void* L_in, void* L_out, const void* src,
                        const void* dst, int64_t m, int64_t n, void* err,
                        void* counter, void* stream) {
  VARIANTS(K1_CASE)
  return -1;
}

int variant_scatter_min(int f, int layout, int ept, int minb, int grid_mode,
                        const void* L_in, void* L_out, const void* targets,
                        const void* values, int64_t k, int64_t n, void* err,
                        void* counter, void* stream) {
  VARIANTS(K2_CASE)
  return -1;
}

}  // extern "C"
