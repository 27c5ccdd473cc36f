// Neighbor gather (take) on Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel isph_tpu/ops/spmv_pallas.py:_take_kernel (:332-349,
// launched by _take_call, entry take()).  Computes
//
//     out[c, k, i] = x[c, idx[k, i]]      c < C, k < K, i < m
//
// for a contiguous (C, nx) field x and a (K, m) int32 index array; m may
// differ from nx (rectangular gathers, e.g. a halo strip).  Templated on
// float, double, int32 and uint8, so bool and integer fields (kind
// bitmasks) gather natively; the TPU's round trip through f32
// (isph_tpu/ops/neighbors.py:95-99) goes away.
//
// Bound on this card: bytes.  Per output element it reads 4 B of idx and
// writes sizeof(T) bytes, with no arithmetic; the x reads touch C * nx *
// sizeof(T) bytes in all, which the 50 MB L2 holds at the main path's N.
//
// What the design does about it: one thread per (k, i); blockIdx.y is the
// slot k, so a warp reads 32 consecutive idx entries and writes 32
// consecutive outputs of one row of the (K, m) plane — both coalesced.  The
// x reads go through the read-only path (__ldg) and hit neighbouring lines,
// because particles are cell-sorted and slots column-sorted.  The index is
// loaded once and reused for every component.  Offsets are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) take_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ idx,
    T* __restrict__ out, int C, int K, int64_t m, int64_t nx) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int64_t k = blockIdx.y;
  const int64_t j = __ldg(idx + k * m + i);
  for (int c = 0; c < C; ++c) {
    out[(c * static_cast<int64_t>(K) + k) * m + i] = __ldg(x + c * nx + j);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* idx, void* out, int C, int K,
                   int64_t m, int64_t nx, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((m + kThreads - 1) / kThreads),
                  static_cast<unsigned>(K));
  take_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(idx),
      static_cast<T*>(out), C, K, m, nx);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64, 2 = int32, 3 = uint8 (also bool).
// Returns the launch's cudaError_t.
extern "C" int isph_take(int dtype, const void* x, const void* idx, void* out,
                         int C, int K, long long m, long long nx, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (m <= 0 || K <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, idx, out, C, K, m, nx, s);
    case 1:
      return launch<double>(x, idx, out, C, K, m, nx, s);
    case 2:
      return launch<int32_t>(x, idx, out, C, K, m, nx, s);
    case 3:
      return launch<uint8_t>(x, idx, out, C, K, m, nx, s);
    default:
      return cudaErrorInvalidValue;
  }
}
