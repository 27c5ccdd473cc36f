// Band-window neighbor gather (take) on Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel isph_tpu/ops/spmv_pallas.py:_take_stream_kernel
// (:635-663, launched by _take_stream_call :676, entry take() :710-716).
// Computes what take.cu computes for a square (K, N) index array,
//
//     out[c, k, i] = x[c, idx[k, i]]      c < C, k < K, i < N
//
// under the band check's guarantee (isph_tpu_torch/ops/neighbors.py) that
// every column of a row lies in the band window of the row's step; x is
// read only through that window, staged in shared memory
// (band_window.cuh).  Templated on float, double, int32 and uint8 (bool),
// so kind bitmasks gather natively; the TPU moved ints through f32.
//
// Bound on this card: bytes.  Per output element it reads 4 B of idx and
// writes sizeof(T) bytes (at N = 1,048,576, K = 32, f32: 134 MB read and
// 134 MB written per component), with no arithmetic.
//
// Design: as spmv_band.cu, a block covers R = min(S, 1024) rows of one
// step, one thread per row, and stages the step's S + 2W window of each
// component (C * (S + 2W) * sizeof(T) bytes: 57 KB for f32 (N,), 115 KB
// for (2, N) positions at S = 8192, W = 3072).  At slot k a warp reads 32
// consecutive idx entries and writes 32 consecutive outputs of row k of
// the (K, N) plane, both coalesced; the index is loaded once and reused for
// every component.  Components whose windows exceed the card's shared
// memory go one call each (the wrapper splits them).

#include <cstdint>
#include <cuda_runtime.h>

#include "band_window.cuh"

namespace {

using isph_band::kMaxRows;

template <typename T>
__global__ void __launch_bounds__(kMaxRows) take_band_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ idx,
    T* __restrict__ out, int C, int K, int64_t n, int64_t step_rows, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  const int win_len = static_cast<int>(step_rows) + 2 * window;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  const int64_t start = isph_band::window_start(row0, step_rows, window, n);
  isph_band::stage_window(win, x, C, n, start, win_len);

  const int64_t i = row0 + threadIdx.x;
  if (i >= n) return;
  for (int k = 0; k < K; ++k) {
    const int p = isph_band::window_pos(__ldg(idx + k * n + i), static_cast<int>(start),
                                        static_cast<int>(n), win_len);
    for (int c = 0; c < C; ++c) {
      out[(c * static_cast<int64_t>(K) + k) * n + i] =
          p >= 0 ? win[c * win_len + p] : T(0);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* idx, void* out, int C, int K,
                   int64_t n, int64_t step_rows, int window, cudaStream_t stream) {
  const int rows = static_cast<int>(step_rows < kMaxRows ? step_rows : kMaxRows);
  const size_t smem = sizeof(T) * C * (static_cast<size_t>(step_rows) + 2 * window);
  cudaError_t err = isph_band::allow_smem(take_band_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(n / rows);
  take_band_kernel<T><<<blocks, rows, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(idx),
      static_cast<T*>(out), C, K, n, step_rows, window);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64, 2 = int32, 3 = uint8 (also bool).  n,
// step_rows and window are multiples of 128 and step_rows divides n (the
// wrapper checks).  Returns the launch's cudaError_t.
extern "C" int isph_take_band(int dtype, const void* x, const void* idx, void* out,
                              int C, int K, long long n, long long step_rows,
                              int window, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0 || K <= 0) return cudaSuccess;
  if (step_rows <= 0 || n % step_rows != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, idx, out, C, K, n, step_rows, window, s);
    case 1:
      return launch<double>(x, idx, out, C, K, n, step_rows, window, s);
    case 2:
      return launch<int32_t>(x, idx, out, C, K, n, step_rows, window, s);
    case 3:
      return launch<uint8_t>(x, idx, out, C, K, n, step_rows, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}
