// Band-window ELL SpMV on Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel isph_tpu/ops/spmv_pallas.py:_spmv_stream_kernel
// (:458-506, launched by _spmv_stream_call :524, entry spmv() :572-580).
// Computes what spmv.cu computes, for C <= 3 right-hand sides stored as a
// contiguous (C, N) block,
//
//     y[c, i] = diag[i] * x[c, i] + sum_k vals[k, i] * x[c, col[k, i]]
//
// for a matrix on a streaming neighbor list, whose band check
// (isph_tpu_torch/ops/neighbors.py) places every column of a row in step s
// (rows [s*S, (s+1)*S)) inside the band window [s*S - W, s*S + S + W) of
// the particle axis, with the periodic wrap.  The column stream is the
// window offset of each column, 16 bits wide:
//
//     off[k, i] = (col[k, i] - start(s)) mod N,   start(s) = (s*S - W) mod N
//
// in [0, S + 2W), or 0xFFFF where the column lies outside the window (only
// where the band check reported overflow): that term is dropped, as the TPU
// kernel's unmatched passes drop it.  On the V-row path each warp reads its
// rows' slots up to their largest slot end (spmv_vec.cuh).
//
// Bound on this card: bytes.  At N = 1,048,576, K = 32, f32, the ~26.4M
// live slots stream 6 B each (4 B value + 2 B offset) and diag, x and y
// add 12.6 MB: ~171 MB a matvec (51 us at 3.35 TB/s), against 268 MB for
// the first version's 8 B on all K slots.
//
// Design (spmv_vec.cuh for the row tiles and the two paths): a thread covers
// V rows with U slots' loads in flight, decodes start + off and reads x
// through the read-only path.  x (4 MB in f32 at 1M) sits in the 50 MB L2
// and a step's window (57 KB) largely in L1, so the kernel stages no window
// of x.  The TPU's way, a step's window staged in shared memory before the
// gathers, lost to it on an H100 at 1M at every shape measured (PERF.md):
// by 9% in f32 and 12% in f64 at C = 1, and 1.8x to 2.7x at C = 3, whose
// windows no longer fit an SM together.

#include <cstdint>
#include <cuda_runtime.h>

#include "band_window.cuh"
#include "spmv_vec.cuh"

namespace {

using isph_spmv::kThreads;

constexpr uint16_t kOutside = 0xFFFF;  // offset of a column outside the window

// Offset -> column of x, from the start of the row's step window.
template <typename T>
struct L2Fetch {
  static constexpr bool kMayDrop = true;
  const T* __restrict__ xs;
  int64_t n;
  int64_t start;
  __device__ __forceinline__ int64_t pos(uint16_t o) const {
    if (o == kOutside) return -1;
    const int64_t j = start + o;
    return j >= n ? j - n : j;
  }
  __device__ __forceinline__ T x(int c, int64_t p) const { return __ldg(xs + c * n + p); }
};

template <typename T, int C, typename P>
__global__ void __launch_bounds__(kThreads) spmv_band_kernel(
    const T* __restrict__ diag, const T* __restrict__ vals, const uint16_t* __restrict__ off,
    const uint16_t* __restrict__ slot_end, const T* __restrict__ x, T* __restrict__ y,
    int K, int64_t n, int64_t step_rows, int window) {
  constexpr int V = P::V;
  const int64_t vec = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t i = vec * V;
  const bool has = i < n;
  const int kend = isph_spmv::slot_bound<P>(slot_end, i, has, K);
  if (!has) return;
  T acc[C][V];
  // a thread's V rows lie in one step (V divides S)
  isph_spmv::sum_slots<C, P>(acc, vals, off, n, i, kend,
                             L2Fetch<T>{x, n, isph_band::window_start(i, step_rows, window, n)});
  isph_spmv::write_rows<T, C, V>(y, diag, x, n, i, acc);
}

template <typename T, typename P>
cudaError_t launch_p(const T* d, const T* v, const uint16_t* off, const uint16_t* se,
                     const T* xx, T* yy, int K, int64_t n, int C, int64_t step_rows,
                     int window, cudaStream_t stream) {
  const int64_t nvec = n / P::V;
  const unsigned blocks = static_cast<unsigned>((nvec + kThreads - 1) / kThreads);
  switch (C) {
    case 1:
      spmv_band_kernel<T, 1, P><<<blocks, kThreads, 0, stream>>>(d, v, off, se, xx, yy, K, n,
                                                                 step_rows, window);
      break;
    case 2:
      spmv_band_kernel<T, 2, P><<<blocks, kThreads, 0, stream>>>(d, v, off, se, xx, yy, K, n,
                                                                 step_rows, window);
      break;
    case 3:
      spmv_band_kernel<T, 3, P><<<blocks, kThreads, 0, stream>>>(d, v, off, se, xx, yy, K, n,
                                                                 step_rows, window);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* diag, const void* vals, const void* off, const void* slot_end,
                   const void* x, void* y, int K, int64_t n, int C, int64_t step_rows,
                   int window, cudaStream_t stream) {
  const T* d = static_cast<const T*>(diag);
  const T* v = static_cast<const T*>(vals);
  const uint16_t* o = static_cast<const uint16_t*>(off);
  const uint16_t* se = static_cast<const uint16_t*>(slot_end);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  if (isph_spmv::use_vec<T, uint16_t>(n, diag, vals, off, slot_end, x, y)) {
    return launch_p<T, isph_spmv::Tile<T>>(d, v, o, se, xx, yy, K, n, C, step_rows, window,
                                           stream);
  }
  return launch_p<T, isph_spmv::OneRow<T>>(d, v, o, se, xx, yy, K, n, C, step_rows, window,
                                        stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  n, step_rows and window are multiples
// of 128 and step_rows divides n (the wrapper checks).  off is (K, n)
// uint16, slot_end (n,) uint16 with every entry <= K.  Returns the launch's
// cudaError_t.
extern "C" int isph_spmv_band(int dtype, const void* diag, const void* vals, const void* off,
                              const void* slot_end, const void* x, void* y, int K, long long n,
                              int C, long long step_rows, int window, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  if (step_rows <= 0 || step_rows % 128 != 0 || n % step_rows != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(diag, vals, off, slot_end, x, y, K, n, C, step_rows, window, s);
    case 1:
      return launch<double>(diag, vals, off, slot_end, x, y, K, n, C, step_rows, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}
