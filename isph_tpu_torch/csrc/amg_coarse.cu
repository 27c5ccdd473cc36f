// The aggregation multigrid's V-cycle below the fine level on Hopper
// (sm_90a), hand-written CUDA C++: every stencil level's l1-Jacobi
// smoothing, residual, restriction and prolongation, and the coarsest
// level's dense product, in one launch (isph_tpu_torch/solvers/amg.py:
// AMG._cycle from level 1; ops/amg_coarse_cuda.py lays out its inputs).
//
// Replaces no Pallas kernel.  The JAX package's coarse levels are XLA code:
// each coarse matvec is eight (2-D) or 26 (3-D) jnp.roll shifts of the grid
// image (isph_tpu/solvers/amg.py:_stencil_matvec, :339).  Run eagerly, the
// port's copy of that code (_stencil_matvec, the plain path) is ~34 launches
// a matvec and ~150 a stencil level of a V-cycle (two post-smoothing sweeps),
// each over at most 12,769 cells: ~1-2 us of device work behind 10-20 us of
// the host's Python and launch.
//
// Bound on this card: none of the card's rates, but the dependence of each
// phase on the one before.  A sweep reads its neighbours' values from the
// previous sweep, so every phase ends at a barrier across all the rows.
// The data a call reads once (the pack's stencil values, columns, diagonals,
// transfers and dense inverse: ~1.2 MB at the 1M cell's hierarchy, f32,
// and at the cylinder's, f64) take 0.4 us at 3.35 TB/s; the chain of the
// phases' L2 round trips and barriers sets the time.
//
// Design.  One thread-block cluster of up to kMaxBlocks blocks of kThreads
// threads (the wrapper picks the blocks from level 1's rows: one for every
// kThreads rows, at most kMaxBlocks); each phase is a grid-stride loop of a
// thread a row over all the cluster's threads, ended by the cluster barrier
// (release / acquire; __syncthreads for one block).  The vectors (each
// level's iterate, its spare, its right-hand side, the coarsest's) live in a
// workspace that the wrapper allocates (~0.1 MB at the 1M cell),
// written and read through L2 (__ldcg); the pack is read-only (__ldg).
//
// Arithmetic, row by row as the plain version's PyTorch operations:
//   matvec      y = diag * x, then + vm[q] * x[idx[q]] for q = 0 .. S - 1 in
//               ELL slot order (vm = vals * mask, premultiplied once a build)
//   pre-smooth  x = dinv * b, then npre - 1 sweeps x' = x + dinv * (b - A x)
//   residual    r = b - A x, restricted: each aggregate adds its members'
//               r in the order of `order` (rows sorted by aggregate), from 0
//   coarsest    xc = cinv bc: a thread sums kCols columns of a row in order
//               by fused multiply-adds (cinv is stored by columns, so a
//               warp's rows read coalesced), then a row's partials are
//               added in order through shared memory, each row in one block
//   prolong     x = x + xc[agg], then npost sweeps
// Every product and sum of a row is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn: no contraction), so the matvecs and the Jacobi
// updates have the bits of the plain version; the restriction and the dense
// product add in their own fixed orders.  No atomics: two calls, or two
// ranks with the same replicated levels, give the same bits.  S = 3^D - 1
// (8 or 26) is a template argument, as is the float type.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;  // threads a block
constexpr int kMaxBlocks = 8;   // blocks of the cluster: the portable cluster size
constexpr int kMaxLevels = 8;   // stencil levels
constexpr int kMaxSweeps = 64;  // npre, npost
constexpr int kChunk = 8;       // stencil slots loaded before any is summed
constexpr int kCols = 32;       // columns of the dense product a thread sums
constexpr int kHead = 7;        // layout entries before the levels'
constexpr int kPerLevel = 12;   // layout entries of a level

template <typename T>
__device__ __forceinline__ T add_rn(T a, T b);
template <>
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
template <>
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__device__ __forceinline__ T sub_rn(T a, T b);
template <>
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
template <>
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T>
__device__ __forceinline__ T fma_rn(T a, T b, T c);
template <>
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
template <>
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T>
__device__ __forceinline__ T mul_rn(T a, T b);
template <>
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
template <>
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// A stencil level: its rows and the next level's, offsets into the pack's
// float buffer (vm (S, n), diag, dinv), into its int32 buffer (idx (S, n),
// order (n), start (nn + 1), agg (n)) and into the workspace (two iterate
// buffers, the right-hand side; b < 0 on level 1, whose b is the input).
struct Level {
  long long n, nn;
  long long vm, diag, dinv;
  long long idx, order, start, agg;
  long long xa, xb, b;
};

struct Params {
  int nlev, npre, npost;
  long long nc, cinv, bc, xc;  // the coarsest level: rows, offsets of cinv (by columns), b, x
  Level lv[kMaxLevels];
};

// The barrier that ends a phase: every row of the phase is written and
// visible to every thread of the cluster.
__device__ __forceinline__ void phase_end() {
  if (gridDim.x == 1) {
    __syncthreads();
    return;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// (A x)_i of a stencil level: the diagonal first, then the slots in order.
template <typename T, int S>
__device__ __forceinline__ T stencil_row(const Level& L, const T* __restrict__ vals,
                                         const int32_t* __restrict__ ints, const T* x,
                                         long long i) {
  const T* __restrict__ vm = vals + L.vm;
  const int32_t* __restrict__ idx = ints + L.idx;
  const long long n = L.n;
  T y = mul_rn(__ldg(vals + L.diag + i), __ldcg(x + i));
#pragma unroll
  for (int q0 = 0; q0 < S; q0 += kChunk) {
    int32_t j[kChunk];
    T v[kChunk], xv[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (q0 + u < S) j[u] = __ldg(idx + (q0 + u) * n + i);
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (q0 + u < S) {
        v[u] = __ldg(vm + (q0 + u) * n + i);
        xv[u] = __ldcg(x + j[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (q0 + u < S) y = add_rn(y, mul_rn(v[u], xv[u]));
    }
  }
  return y;
}

// One l1-Jacobi sweep: out = x + dinv * (b - A x).
template <typename T, int S>
__device__ __forceinline__ void sweep(const Level& L, const T* __restrict__ vals,
                                      const int32_t* __restrict__ ints, const T* b,
                                      const T* x, T* out, long long t0, long long nt) {
  const T* __restrict__ dinv = vals + L.dinv;
  for (long long i = t0; i < L.n; i += nt) {
    const T y = stencil_row<T, S>(L, vals, ints, x, i);
    out[i] = add_rn(__ldcg(x + i), mul_rn(__ldg(dinv + i), sub_rn(__ldcg(b + i), y)));
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads, 1) amg_coarse_kernel(
    const __grid_constant__ Params p, const T* __restrict__ vals,
    const int32_t* __restrict__ ints, const T* b1, T* ws) {
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nt = static_cast<long long>(gridDim.x) * blockDim.x;
  // A level's iterate is first written to buffer P and swaps buffers once a
  // sweep after the first: P is xa where the swaps are even in number, so
  // every level ends in its xa (level 1's xa is the output).
  const int pre_swaps = p.npre > 0 ? p.npre - 1 : 0;
  const bool even = ((pre_swaps + p.npost) & 1) == 0;
  const bool pre_even = (pre_swaps & 1) == 0;
  auto buf = [&](const Level& L, bool first) { return ws + (first == even ? L.xa : L.xb); };

  const T* b = b1;
  for (int l = 0; l < p.nlev; ++l) {
    const Level& L = p.lv[l];
    T* x = buf(L, true);
    T* s = buf(L, false);
    const T* __restrict__ dinv = vals + L.dinv;
    for (long long i = t0; i < L.n; i += nt) {
      x[i] = p.npre > 0 ? mul_rn(__ldg(dinv + i), __ldcg(b + i)) : T(0);
    }
    phase_end();
    for (int k = 1; k < p.npre; ++k) {
      sweep<T, S>(L, vals, ints, b, x, s, t0, nt);
      phase_end();
      T* t = x;
      x = s;
      s = t;
    }
    for (long long i = t0; i < L.n; i += nt) {
      s[i] = sub_rn(__ldcg(b + i), stencil_row<T, S>(L, vals, ints, x, i));
    }
    phase_end();
    T* bn = ws + (l + 1 < p.nlev ? p.lv[l + 1].b : p.bc);
    const int32_t* __restrict__ order = ints + L.order;
    const int32_t* __restrict__ start = ints + L.start;
    for (long long a = t0; a < L.nn; a += nt) {
      const int32_t e = __ldg(start + a + 1);
      T acc = T(0);
      for (int32_t k = __ldg(start + a); k < e; ++k) {
        acc = add_rn(acc, __ldcg(s + __ldg(order + k)));
      }
      bn[a] = acc;
    }
    phase_end();
    b = bn;
  }

  {  // the coarsest level; column k of cinv is row k of the buffer
    __shared__ T part[kThreads];
    const T* __restrict__ cinv = vals + p.cinv;
    const T* bc = ws + p.bc;
    T* xc = ws + p.xc;
    const long long nc = p.nc;
    const int G = static_cast<int>((nc + kCols - 1) / kCols);  // partials a row
    const int R = kThreads / G;                                // rows a batch
    const int g = threadIdx.x / R;
    const int rr = threadIdx.x % R;
    for (long long j = blockIdx.x; j * R < nc; j += gridDim.x) {
      const long long r = j * R + rr;
      if (g < G && r < nc) {
        const long long k1 = min(nc, static_cast<long long>(g + 1) * kCols);
        T acc = T(0);
#pragma unroll 8
        for (long long k = static_cast<long long>(g) * kCols; k < k1; ++k) {
          acc = fma_rn(__ldg(cinv + k * nc + r), __ldcg(bc + k), acc);
        }
        part[threadIdx.x] = acc;
      }
      __syncthreads();
      if (g == 0 && r < nc) {
        T acc = part[rr];
        for (int h = 1; h < G; ++h) acc = add_rn(acc, part[h * R + rr]);
        xc[r] = acc;
      }
      __syncthreads();
    }
  }
  phase_end();

  const T* xn = ws + p.xc;
  for (int l = p.nlev - 1; l >= 0; --l) {
    const Level& L = p.lv[l];
    T* x = buf(L, pre_even);
    T* s = buf(L, !pre_even);
    const T* bl = l == 0 ? b1 : ws + L.b;
    const int32_t* __restrict__ agg = ints + L.agg;
    for (long long i = t0; i < L.n; i += nt) {
      x[i] = add_rn(__ldcg(x + i), __ldcg(xn + __ldg(agg + i)));
    }
    phase_end();
    for (int k = 0; k < p.npost; ++k) {
      sweep<T, S>(L, vals, ints, bl, x, s, t0, nt);
      phase_end();
      T* t = x;
      x = s;
      s = t;
    }
    xn = x;
  }
}

template <typename T, int S>
cudaError_t launch(const Params& p, const void* vals, const void* ints, const void* b1, void* ws,
                   int blocks, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(blocks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, amg_coarse_kernel<T, S>, p, static_cast<const T*>(vals),
      static_cast<const int32_t*>(ints), static_cast<const T*>(b1), static_cast<T*>(ws));
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Level 1's correction of one V-cycle from its right-hand side b1, in
// ws[layout's level-1 xa ...]; dtype 0 = f32, 1 = f64.  layout (host memory):
// slots, stencil levels, the coarsest's rows and its cinv / b / x offsets,
// the workspace's length, then kPerLevel entries a stencil level in the
// order of Level.  Sets the device only when it is not current.
extern "C" int isph_amg_coarse_cycle(int dtype, const void* vals, const void* ints,
                                     const void* b1, void* ws, const long long* layout,
                                     int npre, int npost, int blocks, int device,
                                     void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return err;
  const long long slots = layout[0];
  const long long nlev = layout[1];
  if (nlev < 1 || nlev > kMaxLevels || blocks < 1 || blocks > kMaxBlocks || npre < 0 ||
      npost < 0 || npre > kMaxSweeps || npost > kMaxSweeps || (slots != 8 && slots != 26) ||
      layout[2] < 1 || layout[2] > static_cast<long long>(kCols) * kThreads) {
    return cudaErrorInvalidValue;
  }
  Params p = {};
  p.nlev = static_cast<int>(nlev);
  p.npre = npre;
  p.npost = npost;
  p.nc = layout[2];
  p.cinv = layout[3];
  p.bc = layout[4];
  p.xc = layout[5];
  for (int l = 0; l < p.nlev; ++l) {
    const long long* e = layout + kHead + kPerLevel * l;
    p.lv[l] = {e[0], e[1], e[2], e[3], e[4], e[5], e[6], e[7], e[8], e[9], e[10], e[11]};
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype * 100 + static_cast<int>(slots)) {
    case 8:
      return launch<float, 8>(p, vals, ints, b1, ws, blocks, st);
    case 26:
      return launch<float, 26>(p, vals, ints, b1, ws, blocks, st);
    case 108:
      return launch<double, 8>(p, vals, ints, b1, ws, blocks, st);
    case 126:
      return launch<double, 26>(p, vals, ints, b1, ws, blocks, st);
    default:
      return cudaErrorInvalidValue;
  }
}
