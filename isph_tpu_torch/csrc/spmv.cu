// ELL SpMV on Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel isph_tpu/ops/spmv_pallas.py:_spmv_kernel (:298-329,
// launched by _spmv_call, entry spmv()).  Computes, for C <= 3 right-hand
// sides stored as a contiguous (C, N) block,
//
//     y[c, i] = diag[i] * x[c, i] + sum_k vals[k, i] * x[c, col[k, i]]
//
// with vals already masked (padded slots hold exact zeros, ops/ell.py), in
// the slot format of spmv_vec.cuh: the int32 column index, and each warp's
// rows read up to their largest slot end.
//
// Bound on this card: bytes.  Per nonzero the kernel streams 4 B of vals and
// 4 B of column in f32 (8 B + 4 B in f64) and does 2 flops per component,
// far below the card's ~20 flop/B balance point.  The gather of x[c, j]
// touches C * N * sizeof(T) bytes in all (256 KB at N = 65,536 in f32),
// which the 50 MB L2 holds, so the HBM traffic is the vals/column stream
// up to the slot ends, one read of x, diag and slot_end, one write of y.
//
// What held the first version (one thread per row, all K slots) back at
// 1M: the 21% of slots that are padding at TGV-1024^2, and one 4-byte load
// of each stream in flight per thread.  The design now (spmv_vec.cuh):
// at 1M a thread covers V rows with 16-byte value loads streamed
// evict-first, several slots' loads in flight, and each warp stops at its
// rows' slot end; at the 256^2 main path's N (or a ragged N, or an
// unaligned base) it runs the first version's loop on one row over all K
// slots, unrolled further, which nothing measured beat there.  16-bit
// columns, as the TPU kernel streamed them, bought nothing at 256^2 (the
// only N <= 65,536 the paths run), where the stream comes from L2 either
// way (PERF.md).  C is a template parameter: one launch reads the stream
// once for all C components.

#include <cstdint>
#include <cuda_runtime.h>

#include "spmv_vec.cuh"

namespace {

using isph_spmv::kThreads;

// Column -> place in x: the column itself.
template <typename T>
struct DirectFetch {
  static constexpr bool kMayDrop = false;
  const T* __restrict__ xs;
  int64_t n;
  __device__ __forceinline__ int64_t pos(int32_t j) const { return j; }
  __device__ __forceinline__ T x(int c, int64_t p) const { return __ldg(xs + c * n + p); }
};

template <typename T, int C, typename P>
__global__ void __launch_bounds__(kThreads) ell_spmv_kernel(
    const T* __restrict__ diag, const T* __restrict__ vals, const int32_t* __restrict__ idx,
    const uint16_t* __restrict__ slot_end, const T* __restrict__ x, T* __restrict__ y,
    int K, int64_t n) {
  constexpr int V = P::V;
  const int64_t vec = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t i = vec * V;
  const bool has = i < n;
  const int kend = isph_spmv::slot_bound<P>(slot_end, i, has, K);
  if (!has) return;
  T acc[C][V];
  isph_spmv::sum_slots<C, P>(acc, vals, idx, n, i, kend, DirectFetch<T>{x, n});
  isph_spmv::write_rows<T, C, V>(y, diag, x, n, i, acc);
}

template <typename T, typename P>
cudaError_t launch_p(const T* d, const T* v, const int32_t* ix, const uint16_t* se, const T* xx,
                     T* yy, int K, int64_t n, int C, cudaStream_t stream) {
  const int64_t nvec = n / P::V;
  const unsigned blocks = static_cast<unsigned>((nvec + kThreads - 1) / kThreads);
  switch (C) {
    case 1:
      ell_spmv_kernel<T, 1, P><<<blocks, kThreads, 0, stream>>>(d, v, ix, se, xx, yy, K, n);
      break;
    case 2:
      ell_spmv_kernel<T, 2, P><<<blocks, kThreads, 0, stream>>>(d, v, ix, se, xx, yy, K, n);
      break;
    case 3:
      ell_spmv_kernel<T, 3, P><<<blocks, kThreads, 0, stream>>>(d, v, ix, se, xx, yy, K, n);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* diag, const void* vals, const void* idx, const void* slot_end,
                   const void* x, void* y, int K, int64_t n, int C, cudaStream_t stream) {
  const T* d = static_cast<const T*>(diag);
  const T* v = static_cast<const T*>(vals);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const uint16_t* se = static_cast<const uint16_t*>(slot_end);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  if (isph_spmv::use_vec<T, int32_t>(n, diag, vals, idx, slot_end, x, y)) {
    return launch_p<T, isph_spmv::Tile<T>>(d, v, ix, se, xx, yy, K, n, C, stream);
  }
  return launch_p<T, isph_spmv::OneRow<T>>(d, v, ix, se, xx, yy, K, n, C, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  idx is (K, n) int32, slot_end (n,)
// uint16 with every entry <= K.  Returns the launch's cudaError_t.
extern "C" int isph_ell_spmv(int dtype, const void* diag, const void* vals, const void* idx,
                             const void* slot_end, const void* x, void* y, int K, long long n,
                             int C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(diag, vals, idx, slot_end, x, y, K, n, C, s);
    case 1:
      return launch<double>(diag, vals, idx, slot_end, x, y, K, n, C, s);
    default:
      return cudaErrorInvalidValue;
  }
}
