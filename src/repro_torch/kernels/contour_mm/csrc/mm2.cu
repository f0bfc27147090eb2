// In-order asynchronous 2-order sweep for Hopper (sm_90a), behind a plain C
// interface.
//
// mm2  replaces repro/kernels/contour_mm/kernel.py::mm2_pallas (kernel.py:53,
//      body _mm2_kernel :31).  For each edge e in order, with the labels
//      that earlier edges already lowered:
//          w, v = src[e], dst[e];  lw, lv = L[w], L[v];
//          z = min(L[lw], L[lv]);
//          L[t] = min(L[t], z)  for t in w, v, lw, lv,
//      all four labels read before any write.  L is updated in place (the
//      TPU kernel aliased it in and out).  The result depends on the edge
//      order and must equal ref.mm_block_ref bit for bit, so one thread
//      walks the edges: the CTA is single because the semantics are
//      sequential.
//
// What bounds it on an H100: the chain of dependent label reads, not bytes
// and not arithmetic.  Each edge reads L[w] and L[v], then L[L[w]] and
// L[L[v]], and the next edge may read what this one wrote.  From device
// memory that is two dependent L2 trips an edge (a one-warp kernel that
// read them so took 0.18-0.29 us an edge on an H100); the bytes bound
// (8m + 8n over the HBM rate) is four orders of magnitude below.  Taken
// into shared memory, the chain is one thread's instruction stream, so the
// design also keeps that short.
//
// One CTA of 1 + P warps (P = min(2, depth)):
//
// * Producer warps.  Warp p fills windows p, p + P, ... of `window` edges
//   each into a ring of `depth` slots, and window j (j >= depth) only after
//   the consumer released window j - depth from its slot.  For each edge:
//   src/dst, loaded coalesced; L[w], L[v] and, where those lie in [0, n),
//   L[L[w]], L[L[v]] (pw, pv, ppw, ppv); the byte offsets of the cache
//   slots of w, v, pw, pv; and `quick`: w, v, pw, pv lie in [0, n) and no
//   two distinct ones share a slot.  A producer never follows an id outside
//   [0, n); the consumer decides `err` on the true values.
// * One consumer thread walks the windows in order.  Its cache is a
//   direct-mapped table of `cache_slots` slots {vertex, label, window} in
//   shared memory: the vertex it holds (-1: none) with its label, and the
//   latest window in which the consumer wrote any vertex that has held the
//   slot (-1: none).  Each label read of x (the spec,
//   kernel.py::mm2_pipelined_replay) takes
//     1. the slot's label, if it holds x: exact, because the consumer is the
//        only writer of L and every write enters the written vertex;
//     2. else the prefetched label, if the prefetch read address x (always
//        for L[w], L[v]; for L[lw] when pw == lw) and the slot's window is
//        below rel = max(0, j - depth + 1), j the current window;
//     3. else L[x] from device memory: the only serial global load;
//   and enters x with that label into the slot, keeping its window.  Then
//   each write L[t] = z (z < L[t] as read) sets t's slot to {t, z, j}.
//
// Why the prefetch in 2. is exact.  The producer of window j loaded after
// the consumer's release of window j - depth, so it saw every write of
// windows < rel.  A write to x sets x's slot's window to its own, and a
// slot's window never falls.  So a window below rel means that no write to
// x was made at a window >= rel, and the label the producer read is the
// current one.  The read also happened before the consumer's wait for
// window j, so no later write races with it.
//
// The ordering that argument needs: the consumer's global stores of windows
// <= j - depth are visible to the producer's loads of window j.  The
// consumer issues `fence.acq_rel.cta` and then
// `mbarrier.arrive.shared::cta.b64` on the slot's `empty` barrier (whose
// default semantics are .release at .cta scope); the producer waits with
// `mbarrier.try_wait.parity.shared::cta.b64` (default .acquire, .cta) and
// issues `fence.acq_rel.cta` after it.  Producer and consumer are threads of
// one CTA, so the release/acquire pair, and independently of those defaults
// the two fences, order the stores before the loads.  The ring's
// shared-memory stores reach the consumer through the `full` barriers the
// same way.  A racing label load returns some label; it is taken only where
// no write raced with it, and followed only after its range check.
//
// The consumer's fast path.  One thread's instructions issue in order, so
// an edge is written to have few of them and few branches.  It loads the
// slots of w, v, pw and pv at once, on the guess that the labels the
// producer read are still the labels (lw == pw, lv == pv); where the slots
// of w and v show otherwise, it loads the slots of the true labels instead.
// Where every read is then a hit or a fresh prefetch and no two distinct
// vertices of {w, v, lw, lv} share a slot, the spec's state after the edge
// is the label stores L[x] = z where z < label and four slot stores
// {x, min(label, z), z < label ? j : window}: the copies for one vertex in
// two roles are made from the same inputs and agree (a vertex read twice in
// an edge is read from one slot, and a prefetch of the same address under
// the same window check is exact both times).  The stores are predicated on
// that condition in place of a branch before them; where it fails, nothing
// is stored and the edge runs the spec through shared memory (slow_edge).
//
// A launch whose done word (the fixpoint loop's flag, converged.cu) is set
// returns at once, as the sweeps of contour_mm.cu do: L is the wrapper's
// copy of the caller's labels, so it stays as it was.
//
// Index ranges are checked as in contour_mm.cu: every id the kernel follows
// (w, v, L[w], L[v]) is compared with n before use.  An edge with an id
// outside [0, n) is skipped and, when the caller passes an error word, the
// word is set to 1 so that the wrapper raises IndexError.  `counts`, when not
// null, receives the three counts of where the consumer's label reads came
// from (global loads, cache hits, prefetch hits), as the spec counts them,
// written once at the end from registers.  The launcher sets the dynamic
// shared-memory limit and returns the cudaGetLastError() code of its launch
// (0 = cudaSuccess).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kMaxProducers = 2;
// edges each producer lane has in flight
constexpr int kPerLane = 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// spin until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ int4 ld_slot(uint32_t addr) {
  int4 e;
  asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(e.x), "=r"(e.y), "=r"(e.z), "=r"(e.w)
               : "r"(addr)
               : "memory");
  return e;
}

// Stores slot {x, y, z} (its fourth word repeats the vertex) where `store`
// holds, predicated in place of a branch.
__device__ __forceinline__ void st_slot(uint32_t addr, int x, int y, int z,
                                        bool store = true) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
      "@p st.shared.v4.s32 [%0], {%1, %2, %3, %4};\n}\n" ::"r"(addr),
      "r"(x), "r"(y), "r"(z), "r"(x), "r"((int)store)
      : "memory");
}

__device__ __forceinline__ void fence_cta() {
  asm volatile("fence.acq_rel.cta;" ::: "memory");
}

// A label load that the compiler issues exactly once (its value is checked
// against n before it is followed) and keeps after the thread's earlier
// stores to L.
__device__ __forceinline__ int ld_label(const int* p) {
  int v;
  asm volatile("ld.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// what the consumer's label reads were served from
struct Counts {
  unsigned long long global_loads = 0, cache_hits = 0, prefetch_hits = 0;
};

// A cache slot is an int4: x = vertex, y = label, z = window.
// The consumer addresses slots by their 32-bit shared-memory address.
struct Consumer {
  int* L;
  uint32_t cache;  // shared address of slot 0; slot k at cache + 16 k
  int mask;
  int n;
  int rel;  // max(0, j - depth + 1) of the current window j
  int j;    // the current window
  bool bad;  // an edge met an id outside [0, n)
  Counts c;

  __device__ __forceinline__ bool inside(int x) const {
    return (unsigned)x < (unsigned)n;
  }

  __device__ __forceinline__ uint32_t slot_of(int x) const {
    return cache + ((uint32_t)(x & mask) << 4);
  }

  // x and y are one vertex or lie in two slots
  __device__ __forceinline__ bool apart(int x, int y) const {
    return x == y || ((x ^ y) & mask) != 0;
  }

  // --- the spec, through shared memory ----------------------------------

  // The label of x from its slot, or the prefetched `value` read at `addr`,
  // or L; x then holds the slot.
  __device__ __forceinline__ int slow_read(int x, int addr, int value) {
    const uint32_t slot = slot_of(x);
    const int4 e = ld_slot(slot);
    int label;
    if (e.x == x) {
      ++c.cache_hits;
      label = e.y;
    } else if (addr == x && e.z < rel) {
      ++c.prefetch_hits;
      label = value;
    } else {
      ++c.global_loads;
      label = ld_label(L + x);
    }
    st_slot(slot, x, label, e.z);
    return label;
  }

  __device__ __forceinline__ void slow_write(int t, int z) {
    st_slot(slot_of(t), t, z, j);
    L[t] = z;
  }

  // the spec's whole edge; an id outside [0, n) sets `bad`
  __device__ __forceinline__ void slow_edge(int4 a, int4 b) {
    const int w = a.x, v = a.y;
    if (!inside(w) || !inside(v)) {
      bad = true;
      return;
    }
    const int lw = slow_read(w, w, a.z);
    const int lv = slow_read(v, v, a.w);
    if (!inside(lw) || !inside(lv)) {
      bad = true;
      return;
    }
    const int l2w = slow_read(lw, a.z, b.x);
    const int l2v = slow_read(lv, a.w, b.y);
    const int z = min(l2w, l2v);
    if (z < lw) slow_write(w, z);
    if (z < lv) slow_write(v, z);
    if (z < l2w) slow_write(lw, z);
    if (z < l2v) slow_write(lv, z);
  }

  // --- one edge ---------------------------------------------------------
  // a = {w, v, pw, pv}, b = {ppw, ppv, quick}, o = the shared addresses of
  // the slots of w, v, pw, pv.  Conditions are combined with & and |: a
  // branch costs the one thread more than an operation.
  template <bool kCount>
  __device__ __forceinline__ void edge(int4 a, int4 b, int4 o) {
    const int w = a.x, v = a.y, pw = a.z, pv = a.w;
    const int4 e0 = ld_slot(o.x);
    const int4 e1 = ld_slot(o.y);
    int4 e2 = ld_slot(o.z);
    int4 e3 = ld_slot(o.w);
    const bool tag0 = e0.x == w, tag1 = e1.x == v;
    const int lw = tag0 ? e0.y : pw;
    const int lv = tag1 ? e1.y : pv;
    bool ok = (tag0 | (e0.z < rel)) & (tag1 | (e1.z < rel));
    bool quick = b.z != 0;
    uint32_t o2 = o.z, o3 = o.w;
    if ((lw != pw) | (lv != pv)) {
      quick = inside(w) & inside(v) & inside(lw) & inside(lv) & apart(w, v) &
              apart(w, lw) & apart(w, lv) & apart(v, lw) & apart(v, lv) &
              apart(lw, lv);
      o2 = slot_of(lw);
      o3 = slot_of(lv);
      e2 = ld_slot(o2);
      e3 = ld_slot(o3);
    }
    const bool tag2 = e2.x == lw, tag3 = e3.x == lv;
    ok = ok & quick & (tag2 | ((lw == pw) & (e2.z < rel))) &
         (tag3 | ((lv == pv) & (e3.z < rel)));
    const int l2w = tag2 ? e2.y : b.x;
    const int l2v = tag3 ? e3.y : b.y;
    if (kCount && ok) {
      // as the spec counts: a vertex read again in the edge hits
      const int hits = tag0 + (tag1 | (v == w)) +
                       (tag2 | (lw == w) | (lw == v)) +
                       (tag3 | (lv == w) | (lv == v) | (lv == lw));
      c.cache_hits += hits;
      c.prefetch_hits += 4 - hits;
    }
    // the fast path's stores, predicated on ok; else the spec runs after
    const int z = min(l2w, l2v);
    if (ok & (z < lw)) L[w] = z;
    if (ok & (z < lv)) L[v] = z;
    if (ok & (z < l2w)) L[lw] = z;
    if (ok & (z < l2v)) L[lv] = z;
    st_slot(o.x, w, min(lw, z), z < lw ? j : e0.z, ok);
    st_slot(o.y, v, min(lv, z), z < lv ? j : e1.z, ok);
    st_slot(o2, lw, min(l2w, z), z < l2w ? j : e2.z, ok);
    st_slot(o3, lv, min(l2v, z), z < l2v ? j : e3.z, ok);
    if (__builtin_expect(!ok, 0)) slow_edge(a, b);
  }
};

template <bool kCount>
__global__ void __launch_bounds__(kLanes*(1 + kMaxProducers))
mm2_kernel(int* L, const int* __restrict__ src, const int* __restrict__ dst,
           int64_t m, int window, int depth, int cache_slots, int producers,
           unsigned long long* counts, int n, int* err, const int* done) {
  // done is not written during a sweep, so every thread reads one value
  if (done != nullptr && __ldg(done)) return;
  extern __shared__ __align__(16) unsigned char smem[];
  int4* cache = reinterpret_cast<int4*>(smem);
  int4* ring_e = cache + cache_slots;
  int4* ring_l = ring_e + (size_t)depth * window;
  int4* ring_o = ring_l + (size_t)depth * window;
  // one int4 of padding: the consumer's load one past a window stays in it
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring_o + (size_t)depth * window + 1);
  uint64_t* empty = full + depth;

  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int windows = (int)((m + window - 1) / window);
  const int mask = cache_slots - 1;

  for (int i = threadIdx.x; i < cache_slots; i += blockDim.x)
    cache[i] = make_int4(-1, 0, -1, -1);
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) {
      mbar_init(full + s, kLanes);  // every lane of the filling warp
      mbar_init(empty + s, 1);      // the consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp > 0) {
    // producer p = warp - 1: windows p, p + producers, ...; producers <=
    // depth, so a slot's `empty` is never two phases behind its waiter
    const int base16 = (int)smem_u32(cache);
    const auto in = [n](int x) { return (unsigned)x < (unsigned)n; };
    const auto apart = [mask](int x, int y) {
      return x == y || ((x ^ y) & mask) != 0;
    };
    for (int j = warp - 1; j < windows; j += producers) {
      const int s = j % depth;
      if (j >= depth) {
        mbar_wait(empty + s, (uint32_t)((j / depth - 1) & 1));
        fence_cta();
      }
      const int64_t base = (int64_t)j * window;
      const int count = (int)min((int64_t)window, m - base);
      int4* re = ring_e + (size_t)s * window;
      int4* rl = ring_l + (size_t)s * window;
      int4* ro = ring_o + (size_t)s * window;
      for (int i0 = 0; i0 < count; i0 += kLanes * kPerLane) {
        int w[kPerLane], v[kPerLane], pw[kPerLane], pv[kPerLane];
        int ppw[kPerLane], ppv[kPerLane];
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int i = i0 + k * kLanes + lane;
          w[k] = i < count ? __ldg(src + base + i) : -1;
          v[k] = i < count ? __ldg(dst + base + i) : -1;
        }
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          pw[k] = in(w[k]) ? ld_label(L + w[k]) : -1;
          pv[k] = in(v[k]) ? ld_label(L + v[k]) : -1;
        }
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          ppw[k] = in(pw[k]) ? ld_label(L + pw[k]) : -1;
          ppv[k] = in(pv[k]) ? ld_label(L + pv[k]) : -1;
        }
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int i = i0 + k * kLanes + lane;
          if (i < count) {
            const bool quick = in(w[k]) && in(v[k]) && in(pw[k]) &&
                               in(pv[k]) && apart(w[k], v[k]) &&
                               apart(w[k], pw[k]) && apart(w[k], pv[k]) &&
                               apart(v[k], pw[k]) && apart(v[k], pv[k]) &&
                               apart(pw[k], pv[k]);
            re[i] = make_int4(w[k], v[k], pw[k], pv[k]);
            rl[i] = make_int4(ppw[k], ppv[k], quick, 0);
            ro[i] = make_int4(base16 + ((w[k] & mask) << 4),
                              base16 + ((v[k] & mask) << 4),
                              base16 + ((pw[k] & mask) << 4),
                              base16 + ((pv[k] & mask) << 4));
          }
        }
      }
      mbar_arrive(full + s);
    }
    return;
  }
  if (lane != 0) return;

  Consumer con{L, smem_u32(cache), mask, n, 0, 0, false, Counts{}};
  int s = 0;
  uint32_t phase = 0;
  for (int j = 0; j < windows; ++j) {
    mbar_wait(full + s, phase);
    con.j = j;
    con.rel = max(0, j - depth + 1);
    const int count = (int)min((int64_t)window, m - (int64_t)j * window);
    const int4* re = ring_e + (size_t)s * window;
    const int4* rl = ring_l + (size_t)s * window;
    const int4* ro = ring_o + (size_t)s * window;
    // each edge's ring entries are loaded while the edge before is walked,
    // two edges a turn, so that they stay in their registers; the load one
    // past the window stays inside shared memory and is not used
    int4 a0 = re[0], b0 = rl[0], o0 = ro[0];
    int i = 0;
    for (; i + 1 < count; i += 2) {
      const int4 a1 = re[i + 1], b1 = rl[i + 1], o1 = ro[i + 1];
      con.edge<kCount>(a0, b0, o0);
      a0 = re[i + 2];
      b0 = rl[i + 2];
      o0 = ro[i + 2];
      con.edge<kCount>(a1, b1, o1);
    }
    if (i < count) con.edge<kCount>(a0, b0, o0);
    fence_cta();
    mbar_arrive(empty + s);
    if (++s == depth) {
      s = 0;
      phase ^= 1;
    }
  }
  if (con.bad && err != nullptr) *err = 1;
  if (kCount && counts != nullptr) {
    counts[0] = con.c.global_loads;
    counts[1] = con.c.cache_hits;
    counts[2] = con.c.prefetch_hits;
  }
}

// dynamic shared memory of one launch: the cache, the ring and its
// padding, the barriers
size_t smem_bytes(int64_t window, int64_t depth, int64_t cache_slots) {
  return 16 * (size_t)cache_slots + 48 * (size_t)(depth * window) + 16 +
         16 * (size_t)depth;
}

template <bool kCount>
int launch(int* L, const int* src, const int* dst, int64_t m, int window,
           int depth, int cache_slots, unsigned long long* counts, int n,
           int* err, const int* done, cudaStream_t stream, size_t smem) {
  const cudaError_t rc = cudaFuncSetAttribute(
      mm2_kernel<kCount>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) {
    cudaGetLastError();  // not left behind for the next launch to report
    return (int)rc;
  }
  const int producers = depth < kMaxProducers ? depth : kMaxProducers;
  mm2_kernel<kCount><<<1, kLanes * (1 + producers), smem, stream>>>(
      L, src, dst, m, window, depth, cache_slots, producers, counts, n, err,
      done);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Sweeps edges [0, m) in order over L (length n), in place: the wrapper
// passes m = min(m, edge_limit) and a copy of the caller's labels.  window
// and depth >= 1; cache_slots a power of two; the three must fit the CTA's
// shared memory.  counts (three uint64, null on the solve path), done (the
// loop's int32 flag) and err (one int32, zeroed by the caller) may be null.
int contour_mm2(void* L, const void* src, const void* dst, int64_t m,
                int64_t window, int64_t depth, int64_t cache_slots,
                void* counts, const void* done, int64_t n, void* err,
                void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  if (window < 1 || depth < 1 || cache_slots < 1 ||
      (cache_slots & (cache_slots - 1)) != 0 || window > (1 << 20) ||
      depth > (1 << 10) || cache_slots > (1 << 20) || n > INT32_MAX ||
      (m + window - 1) / window > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(window, depth, cache_slots);
  if (counts != nullptr)
    return launch<true>((int*)L, (const int*)src, (const int*)dst, m,
                        (int)window, (int)depth, (int)cache_slots,
                        (unsigned long long*)counts, (int)n, (int*)err,
                        (const int*)done, (cudaStream_t)stream, smem);
  return launch<false>((int*)L, (const int*)src, (const int*)dst, m,
                       (int)window, (int)depth, (int)cache_slots, nullptr,
                       (int)n, (int*)err, (const int*)done,
                       (cudaStream_t)stream, smem);
}

}  // extern "C"
