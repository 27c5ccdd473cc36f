// The slot stream and row tiling shared by spmv.cu and spmv_band.cu.
//
// Both SpMV kernels read an ELL matrix in the slot format that
// isph_tpu_torch/ops/spmv_cuda.py:slot_format builds once per neighbor
// build:
//
// - vals (K, N): the values, exact zeros on masked slots;
// - cols (K, N): a column code per slot, the int32 index (spmv.cu) or the
//   16-bit window offset (spmv_band.cu);
// - slot_end (N,) 16-bit: 1 + the row's last set slot.  Masked slots are the
//   tail of each row, so a warp on the V-row path stops at the largest slot
//   end of its rows; the slots between a row's own end and that hold exact
//   zeros, as do the slots past it that the one-row path reads.
//
// Each row keeps one accumulator per component, summed over ascending k,
// and the diagonal term is added last: the result is bitwise the
// one-thread-per-row loop's.  Two paths (scripts/spmv_variants.py measured
// both and every constant below on an H100):
//
// - V rows (Tile<T>: 16 bytes of values a slot, V = 4 in f32, 2 in f64)
//   where N / V >= kMinVecThreads.  A thread covers V consecutive rows with
//   one vector load of values and one of column codes per slot, so a warp
//   reads whole lines of both streams, and it issues the loads of U slots
//   before any of their x reads (a chunk): U loads of each stream are in
//   flight per thread.  The stream is far larger than L2 there (171 MB at
//   TGV-1024^2), so it is loaded evict-first (ld.global.cs) and leaves the
//   caches to x.
// - One row (OneRow) for a smaller N, an N that V does not divide, or a base
//   address that breaks the vector alignment: the first kernel's loop over
//   all K slots, unrolled (OneRow<T>::kUnroll), so that the compiler issues
//   the loads of many slots ahead of their x reads.  With V rows the TGV-256^2 grid
//   would hold 16K threads for 132 SMs, too few to cover each thread's chain
//   of chunks; explicit chunks on one row lost to this loop there too.  Its
//   loads keep the default cache policy: at 256^2 the stream (11 MB) stays
//   in L2 from one matvec to the next.
//
// The threshold counts V-row threads (scripts/spmv_variants.py, each path
// forced, PERF.md).  The one-row path reads every slot; the V-row path stops
// each warp at its rows' slot end, so it wins where rows carry padding and
// enough threads cover the loads' latency.  On the ny = 1024 channel (K = 48,
// ~52% of the slots live, N / V = 106,016) V rows are 1.9x faster in f32 (33
// against 64 us).  At TGV-64^3 Quintic (K = 392, 99% live, N / V = 65,536 in
// f32) nothing is skipped and one row, with 262,144 threads and 32 slots'
// loads in flight each, is 7% faster at C = 1 (280 against 299 us) and level
// at C = 3; in f64 (N / V = 131,072) V rows win by 3% (C = 1) and 7% (C = 3).
// At TGV-256^2 (16,384 V-row threads) one row is 2.9x faster, at TGV-24^3
// (3,456) 4.4x in f32; only 24^3 f64 at C = 3, off every path, goes the
// other way.  3 * 2^15 lies between the measured points 65,536 and 106,016.

#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace isph_spmv {

constexpr int kThreads = 256;  // threads per block
constexpr int64_t kMinVecThreads = 3 << 15;  // fewer V-row threads: one row each

// The V-row path's tuning: V rows a thread, U slots a chunk, whether the
// vals/column stream loads evict-first.
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int V = 4, U = 4;
  static constexpr bool kEvictFirst = true;
};
template <>
struct Tile<double> {
  static constexpr int V = 2, U = 4;
  static constexpr bool kEvictFirst = true;
};
// The one-row path's: the unroll of its loop over the slots, by value type
// (left to itself nvcc unrolled it 16 times at C = 1 but 4 at C = 2).
template <typename T>
struct OneRow {
  static constexpr int V = 1;
  static constexpr int kUnroll = sizeof(T) == 4 ? 32 : 8;
};

template <bool kEvictFirst, typename W>
__device__ __forceinline__ W ld(const W* p) {
  if constexpr (kEvictFirst) {
    return __ldcs(p);
  } else {
    return __ldg(p);
  }
}

// a[0..V) = p[0..V) through the read-only path (evict-first with
// kEvictFirst), as one load of V * sizeof(W) bytes when that is 4, 8 or 16
// (p aligned to it).
template <typename W, int V, bool kEvictFirst = false>
__device__ __forceinline__ void load_vec(W (&a)[V], const W* __restrict__ p) {
  constexpr int kBytes = V * static_cast<int>(sizeof(W));
  if constexpr (kBytes == 16) {
    const uint4 w = ld<kEvictFirst>(reinterpret_cast<const uint4*>(p));
    memcpy(a, &w, 16);
  } else if constexpr (kBytes == 8) {
    const uint2 w = ld<kEvictFirst>(reinterpret_cast<const uint2*>(p));
    memcpy(a, &w, 8);
  } else if constexpr (kBytes == 4) {
    const unsigned w = ld<kEvictFirst>(reinterpret_cast<const unsigned*>(p));
    memcpy(a, &w, 4);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) a[v] = ld<kEvictFirst>(p + v);
  }
}

// p[0..V) = a[0..V), one 16-byte store when V * sizeof(T) is 16 (p aligned).
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const T (&a)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 w;
    memcpy(&w, a, 16);
    *reinterpret_cast<uint4*>(p) = w;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = a[v];
  }
}

// The slots a thread reads.  On the V-row path, up to the largest slot end
// over the warp's rows: every lane of the warp calls it (an inactive lane
// passes has = false), and it returns the same count to all of them, capped
// at K.  On the one-row path, all K: at 256^2 the stream stays in L2, at
// 64^3 1% of its slots are padding, and a slot end read first puts one
// more load at the head of every thread's chain and keeps the unrolled
// loop from issuing its loads early (47% slower at TGV-256^2 f32, PERF.md).
template <typename P>
__device__ __forceinline__ int slot_bound(const uint16_t* __restrict__ slot_end, int64_t i,
                                          bool has, int K) {
  constexpr int V = P::V;
  if constexpr (V == 1) {
    return K;
  } else {
    unsigned e = 0;
    if (has) {
      uint16_t s[V];
      load_vec<uint16_t, V>(s, slot_end + i);
#pragma unroll
      for (int v = 0; v < V; ++v) e = s[v] > e ? s[v] : e;
    }
    e = __reduce_max_sync(0xffffffffu, e);
    return static_cast<int>(e) < K ? static_cast<int>(e) : K;
  }
}

// The values and column codes of slots kb .. kb+U-1 (those below kend) of
// rows i .. i+V-1, on the V-row path P.
template <typename T, typename I, typename P>
struct Chunk {
  static constexpr int V = P::V, U = P::U;
  T a[U][V];
  I j[U][V];

  __device__ __forceinline__ void load(const T* __restrict__ vals, const I* __restrict__ cols,
                                       int64_t n, int64_t i, int kb, int kend) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (kb + u < kend) {
        load_vec<T, V, P::kEvictFirst>(a[u], vals + (kb + u) * n + i);
        load_vec<I, V, P::kEvictFirst>(j[u], cols + (kb + u) * n + i);
      }
    }
  }

  // acc[c][v] += a * x_c[column], slot by slot.  fetch.pos(code) is the
  // place of the column in fetch's x (-1: the term is dropped, where
  // Fetch::kMayDrop) and fetch.x(c, pos) the value there.
  template <int C, typename Fetch>
  __device__ __forceinline__ void accumulate(T (&acc)[C][V], int kb, int kend,
                                             const Fetch& fetch) const {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (kb + u < kend) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int64_t p = fetch.pos(j[u][v]);
          if (!Fetch::kMayDrop || p >= 0) {
#pragma unroll
            for (int c = 0; c < C; ++c) acc[c][v] += a[u][v] * fetch.x(c, p);
          }
        }
      }
    }
  }
};

// acc[c] = the sum of the terms of slots [0, kend) of row i, ascending: the
// one-row path, its loop unrolled kUnroll times.
template <int kUnroll, int C, typename T, typename I, typename Fetch>
__device__ __forceinline__ void sum_row(T (&acc)[C][1], const T* __restrict__ vals,
                                        const I* __restrict__ cols, int64_t n, int64_t i,
                                        int kend, const Fetch& fetch) {
  const T* v = vals + i;
  const I* j = cols + i;
#pragma unroll(kUnroll)
  for (int k = 0; k < kend; ++k) {
    const T a = __ldg(v);
    const int64_t p = fetch.pos(__ldg(j));
    if (!Fetch::kMayDrop || p >= 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c][0] += a * fetch.x(c, p);
    }
    v += n;
    j += n;
  }
}

// acc[c][v] = the sum of the terms of slots [0, kend) of rows i .. i+V-1,
// ascending.
template <int C, typename P, typename T, typename I, typename Fetch>
__device__ __forceinline__ void sum_slots(T (&acc)[C][P::V], const T* __restrict__ vals,
                                          const I* __restrict__ cols, int64_t n, int64_t i,
                                          int kend, const Fetch& fetch) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int v = 0; v < P::V; ++v) acc[c][v] = T(0);
  }
  if constexpr (P::V == 1) {
    sum_row<P::kUnroll>(acc, vals, cols, n, i, kend, fetch);
  } else {
    Chunk<T, I, P> ch;
    for (int kb = 0; kb < kend; kb += P::U) {
      ch.load(vals, cols, n, i, kb, kend);
      ch.template accumulate<C>(acc, kb, kend, fetch);
    }
  }
}

// y[c][i + v] = diag[i + v] * x[c][i + v] + acc[c][v] for the thread's rows.
template <typename T, int C, int V>
__device__ __forceinline__ void write_rows(T* __restrict__ y, const T* __restrict__ diag,
                                           const T* __restrict__ x, int64_t n, int64_t i,
                                           const T (&acc)[C][V]) {
  T d[V];
  load_vec<T, V>(d, diag + i);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    T xi[V], out[V];
    load_vec<T, V>(xi, x + c * n + i);
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = d[v] * xi[v] + acc[c][v];
    store_vec<T, V>(y + c * n + i, out);
  }
}

// Whether the V-row path takes this launch: N large enough and a multiple
// of V, every pointer aligned to its V-wide access.
template <typename T, typename I>
bool use_vec(int64_t n, const void* diag, const void* vals, const void* cols,
             const void* slot_end, const void* x, const void* y) {
  constexpr int V = Tile<T>::V;
  auto ok = [](const void* p, size_t bytes) {
    return bytes < 4 || reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const size_t t = V * sizeof(T);
  return n % V == 0 && n / V >= kMinVecThreads && ok(diag, t) && ok(vals, t) && ok(x, t) &&
         ok(y, t) && ok(cols, V * sizeof(I)) && ok(slot_end, V * sizeof(uint16_t));
}

}  // namespace isph_spmv
