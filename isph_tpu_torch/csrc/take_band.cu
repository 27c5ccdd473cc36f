// Band-window neighbor gather (take) on Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel isph_tpu/ops/spmv_pallas.py:_take_stream_kernel
// (:635-663, launched by _take_stream_call :676, entry take() :710-716).
// Computes what take.cu computes for a square (K, N) index array,
//
//     out[c, k, i] = x[c, idx[k, i]]      c < C, k < K, i < N
//
// under the band check's guarantee (isph_tpu_torch/ops/neighbors.py) that
// every column of a row in step s (rows [s*S, (s+1)*S)) lies in the band
// window [s*S - W, s*S + S + W); x is read only through that window, staged
// in shared memory (band_window.cuh).  Elements move as words of their size
// (gather_vec.cuh), so f32, f64, int32, uint8 and bool gather natively.  A
// column outside the window (possible only where the band check reported
// overflow) yields 0.
//
// Bound on this card: bytes.  Per output element it reads 4 B of idx and
// writes sizeof(T) bytes (at N = 1,048,576, K = 32, f32: 134 MB read and
// 134 MB written per component, 81 us at 3.35 TB/s), with no arithmetic.
//
// What held the first version back: a block of 1024 rows staged the step's
// whole S + 2W window (14,336 elements at S = 8192, W = 3072: a 14x re-read
// of x per step), waited for it before loading any index, then moved one
// 4-byte index and one element per thread and slot.  The design now:
//
// - A block covers R rows, a whole number of steps (R = S on the main
//   path), and one group of slots; it stages the R + 2W window of its steps
//   once.  ops/spmv_cuda.py:take_band_plan picks R and the slot groups so
//   the grid fills the SMs: at 1M, 128 steps x 2 groups of 16 slots, a
//   window re-read of 3.5x.
// - Thread t covers V consecutive rows of U slots per iteration, with the
//   vector idx loads and 16-byte output stores of take.cu (gather_vec.cuh).
// - The window copy is a committed cp.async group; the block loads its first
//   iteration's indices before it waits for the window, and every later
//   iteration's indices before it gathers and stores the current one, so
//   the index stream, which does not depend on the window, stays in flight.
// - An x whose base is not 16-byte aligned is copied into the window element
//   by element, and an idx whose base is not takes V = 1: nothing is refused
//   for alignment.

#include <cstdint>
#include <cuda_runtime.h>

#include "band_window.cuh"
#include "gather_vec.cuh"

namespace {

using isph_gather::load_idx;
using isph_gather::store_vec;
using isph_gather::Tile;

constexpr int kThreads = 512;  // ops/spmv_cuda.py:_BAND_THREADS

// One iteration's place: slots kb .. kb+U-1 (those below k1) of row vector
// `vec` (rows row0 + vec*V .. +V-1), when vec < nvec.
struct Iter {
  int kb;
  int vec;
};

__device__ __forceinline__ Iter iter_at(int it, int passes, int k0, int U) {
  return Iter{k0 + it / passes * U, it % passes * kThreads + static_cast<int>(threadIdx.x)};
}

template <int V, int U>
__device__ __forceinline__ void load_iter(int32_t (&j)[U][V], const int32_t* __restrict__ idx,
                                          int64_t n, int64_t row0, Iter p, int k1, int nvec) {
  if (p.vec >= nvec) return;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (p.kb + u < k1) load_idx<V>(j[u], idx + (p.kb + u) * n + row0 + p.vec * V);
  }
}

template <typename W, int V, int U>
__global__ void __launch_bounds__(kThreads) take_band_kernel(
    const W* __restrict__ x, const int32_t* __restrict__ idx, W* __restrict__ out,
    int C, int K, int64_t n, int64_t step_rows, int window, int64_t block_rows,
    int k_per_group, bool x_aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* win = reinterpret_cast<W*>(smem_raw);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * block_rows;
  const int rows = static_cast<int>(n - row0 < block_rows ? n - row0 : block_rows);
  const int win_len = rows + 2 * window;
  const int64_t start = isph_band::window_start(row0, step_rows, window, n);
  if (x_aligned) {
    isph_band::issue_window(win, x, C, n, start, win_len);
  } else {
    isph_band::copy_window(win, x, C, n, start, win_len);
  }

  const int k0 = static_cast<int>(blockIdx.y) * k_per_group;
  const int k1 = K - k0 < k_per_group ? K : k0 + k_per_group;
  const int nvec = rows / V;
  const int passes = (nvec + kThreads - 1) / kThreads;
  const int iters = (k1 - k0 + U - 1) / U * passes;
  int32_t nxt[U][V];
  load_iter<V, U>(nxt, idx, n, row0, iter_at(0, passes, k0, U), k1, nvec);
  isph_band::wait_window();

  for (int it = 0; it < iters; ++it) {
    int32_t cur[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int v = 0; v < V; ++v) cur[u][v] = nxt[u][v];
    }
    if (it + 1 < iters) {
      load_iter<V, U>(nxt, idx, n, row0, iter_at(it + 1, passes, k0, U), k1, nvec);
    }
    const Iter p = iter_at(it, passes, k0, U);
    if (p.vec >= nvec) continue;
    const int64_t i = row0 + static_cast<int64_t>(p.vec) * V;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = p.kb + u;
      if (k >= k1) continue;
      int pos[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        pos[v] = isph_band::window_pos(cur[u][v], static_cast<int>(start),
                                       static_cast<int>(n), win_len);
      }
      for (int c = 0; c < C; ++c) {
        const W* wc = win + c * win_len;
        W g[V];
#pragma unroll
        for (int v = 0; v < V; ++v) g[v] = pos[v] >= 0 ? wc[pos[v]] : W(0);
        store_vec<W, V>(out + (static_cast<int64_t>(c) * K + k) * n + i, g);
      }
    }
  }
}

template <typename W, int V, int U>
cudaError_t launch_v(const void* x, const void* idx, void* out, int C, int K, int64_t n,
                     int64_t step_rows, int window, int64_t block_rows, int k_per_group,
                     cudaStream_t stream) {
  const int64_t rows = block_rows < n ? block_rows : n;
  const size_t smem = sizeof(W) * C * (static_cast<size_t>(rows) + 2 * window);
  cudaError_t err = isph_band::allow_smem(take_band_kernel<W, V, U>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((n + block_rows - 1) / block_rows),
                  static_cast<unsigned>((K + k_per_group - 1) / k_per_group));
  const bool x_aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  take_band_kernel<W, V, U><<<grid, kThreads, smem, stream>>>(
      static_cast<const W*>(x), static_cast<const int32_t*>(idx), static_cast<W*>(out),
      C, K, n, step_rows, window, block_rows, k_per_group, x_aligned);
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch(const void* x, const void* idx, void* out, int C, int K, int64_t n,
                   int64_t step_rows, int window, int64_t block_rows, int k_per_group,
                   cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(idx) % 16 == 0) {
    return launch_v<W, Tile<W>::V, Tile<W>::U>(x, idx, out, C, K, n, step_rows, window,
                                              block_rows, k_per_group, stream);
  }
  // scalar path: 8 slots in flight (16, take.cu's count, spills at 512 threads)
  return launch_v<W, 1, 8>(x, idx, out, C, K, n, step_rows, window, block_rows, k_per_group,
                           stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64, 2 = int32, 3 = uint8 (also bool).  n,
// step_rows and window are multiples of 128, step_rows divides n and
// block_rows, and out is a fresh (C, K, n) allocation or one component's
// slice of one (the wrapper checks and plans).  Returns the launch's
// cudaError_t.
extern "C" int isph_take_band(int dtype, const void* x, const void* idx, void* out,
                              int C, int K, long long n, long long step_rows,
                              int window, long long block_rows, int k_per_group,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0 || K <= 0) return cudaSuccess;
  if (step_rows <= 0 || n % step_rows != 0 || block_rows <= 0 ||
      block_rows % step_rows != 0 || k_per_group <= 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
    case 2:
      return launch<uint32_t>(x, idx, out, C, K, n, step_rows, window, block_rows,
                              k_per_group, s);
    case 1:
      return launch<unsigned long long>(x, idx, out, C, K, n, step_rows, window,
                                        block_rows, k_per_group, s);
    case 3:
      return launch<uint8_t>(x, idx, out, C, K, n, step_rows, window, block_rows,
                             k_per_group, s);
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
