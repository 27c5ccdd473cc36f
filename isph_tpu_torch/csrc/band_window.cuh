// Band-window staging shared by spmv_band.cu and take_band.cu.
//
// A streaming neighbor list (isph_tpu_torch/ops/neighbors.py, band check)
// guarantees that every column j of a row in step s (rows [s*S, (s+1)*S))
// lies in the band window [s*S - W, s*S + S + W) of the particle axis, taken
// with the periodic wrap.  A block of the band kernels covers rows of one
// step (spmv_band.cu) or of R consecutive rows in whole steps (take_band.cu)
// and copies their window, S + 2W (R + 2W) elements per component, from x in
// device memory into shared memory:
//
//     win[c][p] = x[c][(start + p) mod n],   start = (s*S - W) mod n
//
// and column j of any of its rows then sits at win[c][(j - start) mod n].
//
// The copy is cp.async of 16-byte pieces (global -> shared without passing
// through registers).  S, W and n are multiples of 128 elements, so every
// wrapped segment of the window starts on a 128-element boundary and no
// 16-byte piece straddles the wrap; x must be 16-byte aligned (the SpMV's
// wrapper checks it; the gather copies an unaligned x with copy_window).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace isph_band {

constexpr int kMaxRows = 1024;  // rows (= threads) per block, at most

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// First element of the block's step window, in [0, n).
__device__ __forceinline__ int64_t window_start(int64_t row0, int64_t step_rows,
                                                int window, int64_t n) {
  const int64_t base = row0 / step_rows * step_rows;
  int64_t start = (base - window) % n;
  return start < 0 ? start + n : start;
}

// Start copying the C components' windows of win_len elements into win
// (C * win_len elements of shared memory) as one committed cp.async group;
// the block may issue other loads before wait_window().
template <typename T>
__device__ __forceinline__ void issue_window(T* win, const T* __restrict__ x,
                                             int C, int64_t n, int64_t start,
                                             int win_len) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvec = win_len / kVec;
  for (int v = threadIdx.x; v < C * nvec; v += blockDim.x) {
    const int c = v / nvec;
    const int e = (v - c * nvec) * kVec;
    int64_t src = start + e;
    if (src >= n) src %= n;
    cp_async16(win + static_cast<int64_t>(c) * win_len + e,
               x + static_cast<int64_t>(c) * n + src);
  }
  cp_async_commit();
}

// Wait for this thread's cp.async groups, then barrier: the window is whole.
__device__ __forceinline__ void wait_window() {
  cp_async_wait_all();
  __syncthreads();
}

// issue_window + wait_window.
template <typename T>
__device__ __forceinline__ void stage_window(T* win, const T* __restrict__ x,
                                             int C, int64_t n, int64_t start,
                                             int win_len) {
  issue_window(win, x, C, n, start, win_len);
  wait_window();
}

// The window copied element by element through registers, for an x whose
// base is not 16-byte aligned (cp.async pieces need it); wait_window()
// then only barriers.
template <typename T>
__device__ __forceinline__ void copy_window(T* win, const T* __restrict__ x, int C,
                                            int64_t n, int64_t start, int win_len) {
  for (int v = threadIdx.x; v < C * win_len; v += blockDim.x) {
    const int c = v / win_len;
    int64_t src = start + (v - c * win_len);
    if (src >= n) src %= n;
    win[v] = x[static_cast<int64_t>(c) * n + src];
  }
}

// Window position of column j, or -1 when j lies outside the window (only
// possible where the band check reported overflow; the caller then drops
// the term, as the TPU kernel's unmatched passes do).
__device__ __forceinline__ int window_pos(int j, int start, int n, int win_len) {
  int p = j - start;
  if (p < 0) p += n;
  return p < win_len ? p : -1;
}

// Opt in to more than 48 KB of dynamic shared memory for `kernel`.
template <typename F>
cudaError_t allow_smem(F kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace isph_band
