// ELL SpMV on Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel isph_tpu/ops/spmv_pallas.py:_spmv_kernel (:298-329,
// launched by _spmv_call, entry spmv()).  Computes, for C <= 3 right-hand
// sides stored as a contiguous (C, N) block,
//
//     y[c, i] = diag[i] * x[c, i] + sum_k vals[k, i] * x[c, idx[k, i]]
//
// with vals already masked (padded slots hold exact zeros and an in-range
// index, isph_tpu_torch/ops/ell.py), vals and idx in the (K, N) layout of the
// neighbor list, particle axis last.
//
// Bound on this card: bytes.  Per nonzero the kernel streams 4 B of vals and
// 4 B of idx in f32 (8 B + 4 B in f64) and does 2 flops per component, far
// below the card's ~20 flop/B balance point.  The gather of x[c, j] touches
// C * N * sizeof(T) bytes in all (256 KB at N = 65,536 in f32), which the
// 50 MB L2 holds, so past the first touch the x reads are L2 hits and the
// HBM traffic is the vals/idx stream plus one read of x and diag and one
// write of y.
//
// What the design does about it: one thread per row.  At slot k the 32
// threads of a warp read vals[k*N + i .. i+31] and idx[k*N + i .. i+31], one
// fully used 128-byte line each, so the stream runs at the coalesced rate.
// The x gather goes through the read-only path (__ldg); particles are
// cell-sorted and each row's slots are column-sorted, so neighbouring rows'
// k-th columns are close and their lines are shared within a warp.  C is a
// template parameter: one launch reads vals/idx once for all C components
// (the Helmholtz (D, N) right-hand side and the multivector w = A v).
// Offsets are 64-bit, so any N that fits the device is indexed correctly.
// The TPU's int16 pass encoding is not carried over: it existed only because
// Mosaic lacks a general gather (spmv_pallas.py:5-9).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int C>
__global__ void __launch_bounds__(kThreads) ell_spmv_kernel(
    const T* __restrict__ diag, const T* __restrict__ vals,
    const int32_t* __restrict__ idx, const T* __restrict__ x,
    T* __restrict__ y, int K, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = T(0);
  const T* v = vals + i;
  const int32_t* ix = idx + i;
  for (int k = 0; k < K; ++k) {
    const T a = __ldg(v);
    const int64_t j = __ldg(ix);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] += a * __ldg(x + c * n + j);
    v += n;
    ix += n;
  }
  const T d = __ldg(diag + i);
#pragma unroll
  for (int c = 0; c < C; ++c) y[c * n + i] = d * __ldg(x + c * n + i) + acc[c];
}

template <typename T>
cudaError_t launch(const void* diag, const void* vals, const void* idx,
                   const void* x, void* y, int K, int64_t n, int C,
                   cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const T* d = static_cast<const T*>(diag);
  const T* v = static_cast<const T*>(vals);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  switch (C) {
    case 1:
      ell_spmv_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(d, v, ix, xx, yy, K, n);
      break;
    case 2:
      ell_spmv_kernel<T, 2><<<blocks, kThreads, 0, stream>>>(d, v, ix, xx, yy, K, n);
      break;
    case 3:
      ell_spmv_kernel<T, 3><<<blocks, kThreads, 0, stream>>>(d, v, ix, xx, yy, K, n);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  Returns the launch's cudaError_t.
extern "C" int isph_ell_spmv(int dtype, const void* diag, const void* vals,
                             const void* idx, const void* x, void* y, int K,
                             long long n, int C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(diag, vals, idx, x, y, K, n, C, s);
    case 1:
      return launch<double>(diag, vals, idx, x, y, K, n, C, s);
    default:
      return cudaErrorInvalidValue;
  }
}
