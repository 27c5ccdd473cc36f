// Band-window ELL SpMV on Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel isph_tpu/ops/spmv_pallas.py:_spmv_stream_kernel
// (:458-506, launched by _spmv_stream_call :524, entry spmv() :572-580).
// Computes what spmv.cu computes, for C <= 3 right-hand sides stored as a
// contiguous (C, N) block,
//
//     y[c, i] = diag[i] * x[c, i] + sum_k vals[k, i] * x[c, idx[k, i]]
//
// with vals already masked, under the guarantee of the band check
// (isph_tpu_torch/ops/neighbors.py) that every column of a row lies in the
// band window of the row's step.  As on the TPU, only that window of x is
// read from fast memory: the block stages it into shared memory
// (band_window.cuh) and every x read, the diagonal term's included, comes
// from there.
//
// Bound on this card: bytes.  Per nonzero the kernel streams 4 B of vals
// and 4 B of idx in f32 (8 B + 4 B in f64); at N = 1,048,576 and K = 32
// that is 268 MB per f32 matvec, five times the 50 MB L2, so the stream
// comes from HBM.  x itself (4 MB in f32) would sit in L2 either way; the
// window turns its gathers into shared-memory reads, which is what the TPU
// needed and what this card does not strictly need (PERF.md has both
// times beside each other).
//
// Design: a block covers R = min(S, 1024) consecutive rows of one step of
// S rows, one thread per row; at the large-N configuration (S = 8192,
// W = 3072) that is 8 blocks per step, each staging the step's whole
// S + 2W = 14,336-element window, a re-read factor of 14,336 / 1024 = 14
// window elements per row (from L2: 57 KB per block in f32 against the
// block's 256 KB of vals/idx).  At slot k the 32 threads of a warp read
// vals[k*N + i .. i+31] and idx[k*N + i .. i+31] coalesced, as in spmv.cu.
// C is a template parameter: the C components share one vals/idx stream.
// Shared memory is C * (S + 2W) * sizeof(T): 57 KB (f32, C = 1) to 172 KB
// (f32, C = 3), above the 48 KB default, so the launch opts in; a C whose
// windows exceed the card's limit is refused here and split into
// one-component calls by the wrapper, as the TPU splits past its scratch
// budget.

#include <cstdint>
#include <cuda_runtime.h>

#include "band_window.cuh"

namespace {

using isph_band::kMaxRows;

template <typename T, int C>
__global__ void __launch_bounds__(kMaxRows) spmv_band_kernel(
    const T* __restrict__ diag, const T* __restrict__ vals,
    const int32_t* __restrict__ idx, const T* __restrict__ x,
    T* __restrict__ y, int K, int64_t n, int64_t step_rows, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  const int win_len = static_cast<int>(step_rows) + 2 * window;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  const int64_t start = isph_band::window_start(row0, step_rows, window, n);
  isph_band::stage_window(win, x, C, n, start, win_len);

  const int64_t i = row0 + threadIdx.x;
  if (i >= n) return;
  T acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = T(0);
  const T* v = vals + i;
  const int32_t* ix = idx + i;
  for (int k = 0; k < K; ++k) {
    const T a = __ldg(v);
    const int p = isph_band::window_pos(__ldg(ix), static_cast<int>(start),
                                        static_cast<int>(n), win_len);
    if (p >= 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += a * win[c * win_len + p];
    }
    v += n;
    ix += n;
  }
  // own x[i] sits at window position W + (i - step base)
  const int own = window + static_cast<int>(i % step_rows);
  const T d = __ldg(diag + i);
#pragma unroll
  for (int c = 0; c < C; ++c) y[c * n + i] = d * win[c * win_len + own] + acc[c];
}

template <typename T, int C>
cudaError_t launch_c(const T* d, const T* v, const int32_t* ix, const T* xx, T* yy,
                     int K, int64_t n, int64_t step_rows, int window,
                     cudaStream_t stream) {
  const int rows = static_cast<int>(step_rows < kMaxRows ? step_rows : kMaxRows);
  const size_t smem = sizeof(T) * C * (static_cast<size_t>(step_rows) + 2 * window);
  cudaError_t err = isph_band::allow_smem(spmv_band_kernel<T, C>, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(n / rows);
  spmv_band_kernel<T, C><<<blocks, rows, smem, stream>>>(d, v, ix, xx, yy, K, n,
                                                         step_rows, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* diag, const void* vals, const void* idx,
                   const void* x, void* y, int K, int64_t n, int C,
                   int64_t step_rows, int window, cudaStream_t stream) {
  const T* d = static_cast<const T*>(diag);
  const T* v = static_cast<const T*>(vals);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  switch (C) {
    case 1:
      return launch_c<T, 1>(d, v, ix, xx, yy, K, n, step_rows, window, stream);
    case 2:
      return launch_c<T, 2>(d, v, ix, xx, yy, K, n, step_rows, window, stream);
    case 3:
      return launch_c<T, 3>(d, v, ix, xx, yy, K, n, step_rows, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  n, step_rows and window are multiples of
// 128 and step_rows divides n (the wrapper checks).  Returns the launch's
// cudaError_t; a window larger than the card's shared memory is refused by
// the launch itself.
extern "C" int isph_spmv_band(int dtype, const void* diag, const void* vals,
                              const void* idx, const void* x, void* y, int K,
                              long long n, int C, long long step_rows, int window,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  if (step_rows <= 0 || n % step_rows != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(diag, vals, idx, x, y, K, n, C, step_rows, window, s);
    case 1:
      return launch<double>(diag, vals, idx, x, y, K, n, C, step_rows, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Shared memory one block may use after opting in, in bytes (227 KB on an
// H100), or the negated cudaError_t.
extern "C" int isph_smem_optin(int device) {
  int bytes = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}
