// Neighbor gather (take) on Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel isph_tpu/ops/spmv_pallas.py:_take_kernel (:332-349,
// launched by _take_call :609, entry take() :703-725).  Computes
//
//     out[c, k, i] = x[c, idx[k, i]]      c < C, k < K, i < m
//
// for a contiguous (C, nx) field x and a (K, m) int32 index array; m may
// differ from nx (rectangular gathers, e.g. a halo strip).  f32, f64, int32,
// uint8 and bool fields gather natively, as words of their size
// (gather_vec.cuh); the TPU's round trip through f32
// (isph_tpu/ops/neighbors.py:95-99) goes away.
//
// Bound on this card: bytes.  Per output element it reads 4 B of idx and
// writes sizeof(T) bytes, with no arithmetic; x (C * nx * sizeof(T) bytes)
// sits in the 50 MB L2 at the main path's N.  At N = 1,048,576 and K = 32,
// f32: 134 MB of idx in, 134 MB out, 4 MB of x: 81 us at 3.35 TB/s.
//
// What held the first version (one element per thread) back was bytes in
// flight: one 4-byte idx load per thread, 8 KB per SM, about half of what
// covers HBM latency, and 32-byte warp stores for bool.  The design now:
// out[c] is the flat (K * m) index plane gathered from x[c], so the kernel
// tiles that plane, one tile of U * 256 * V consecutive entries per block.
// Thread t covers V consecutive entries at U places 256 * V apart, issues
// all its idx loads (V ints each, as 16- or 8-byte vectors) before its
// first gather, and writes each V words as one 16-byte store, so loads and
// stores are coalesced across the warp (gather_vec.cuh).  x reads stay
// scalar __ldg (L2 hits); the indices are loaded once for all C
// components.  A plane whose length is not a multiple of V, or an idx whose
// base is not 16-byte aligned, takes the same kernel with V = 1 (scalar
// loads and stores, 16 in flight): nothing is dropped.

#include <cstdint>
#include <cuda_runtime.h>

#include "gather_vec.cuh"

namespace {

using isph_gather::load_idx;
using isph_gather::store_vec;
using isph_gather::Tile;

constexpr int kThreads = 256;

template <typename W, int V, int U>
__global__ void __launch_bounds__(kThreads) take_kernel(
    const W* __restrict__ x, const int32_t* __restrict__ idx, W* __restrict__ out,
    int C, int64_t L, int64_t nx) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * U * kThreads * V;
  int32_t j[U][V];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t f = base + static_cast<int64_t>(u * kThreads + threadIdx.x) * V;
    if (f < L) load_idx<V>(j[u], idx + f);
  }
  for (int c = 0; c < C; ++c) {
    const W* xc = x + c * nx;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t f = base + static_cast<int64_t>(u * kThreads + threadIdx.x) * V;
      if (f < L) {
        W g[V];
#pragma unroll
        for (int v = 0; v < V; ++v) g[v] = __ldg(xc + j[u][v]);
        store_vec<W, V>(out + c * L + f, g);
      }
    }
  }
}

template <typename W, int V, int U>
cudaError_t launch_v(const void* x, const void* idx, void* out, int C, int64_t L,
                     int64_t nx, cudaStream_t stream) {
  constexpr int64_t kTile = static_cast<int64_t>(U) * kThreads * V;
  const unsigned tiles = static_cast<unsigned>((L + kTile - 1) / kTile);
  take_kernel<W, V, U><<<tiles, kThreads, 0, stream>>>(
      static_cast<const W*>(x), static_cast<const int32_t*>(idx), static_cast<W*>(out),
      C, L, nx);
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch(const void* x, const void* idx, void* out, int C, int64_t L,
                   int64_t nx, cudaStream_t stream) {
  constexpr int V = Tile<W>::V;
  const bool vec = reinterpret_cast<uintptr_t>(idx) % 16 == 0 && L % V == 0;
  return vec ? launch_v<W, V, Tile<W>::U>(x, idx, out, C, L, nx, stream)
             : launch_v<W, 1, isph_gather::kScalarU>(x, idx, out, C, L, nx, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64, 2 = int32, 3 = uint8 (also bool).  out
// is a fresh (C, K, m) allocation (16-byte aligned).  Returns the launch's
// cudaError_t.
extern "C" int isph_take(int dtype, const void* x, const void* idx, void* out,
                         int C, int K, long long m, long long nx, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (m <= 0 || K <= 0) return cudaSuccess;
  const int64_t L = static_cast<int64_t>(K) * m;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
    case 2:
      return launch<uint32_t>(x, idx, out, C, L, nx, s);
    case 1:
      return launch<unsigned long long>(x, idx, out, C, L, nx, s);
    case 3:
      return launch<uint8_t>(x, idx, out, C, L, nx, s);
    default:
      return cudaErrorInvalidValue;
  }
}
