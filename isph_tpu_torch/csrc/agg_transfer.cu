// The aggregation multigrid's transfers on Hopper (sm_90a), hand-written
// CUDA C++: restriction and prolongation between a level and its
// aggregates (isph_tpu_torch/solvers/amg.py), indexed by aggregate ids.
//
// Replaces no Pallas kernel.  The JAX package leaves the transfers to XLA as
// one-hot matrix products (isph_tpu/solvers/amg.py: DenseTransfer,
// FactoredTransfer), which suit the TPU's matrix unit; on this card the same
// products ran as FP32 SIMT GEMMs of ~27 GFLOP each way at 1M particles,
// ~300x their bytes.  The work is a segment sum and a gather:
//
//     restrict:     rc[c, a] = sum_{j in [start[a], start[a+1])} v[c, order[j]]
//     prolong-add:  out[i]   = x[i] + xc[agg[i]]          (x[i] + xc[agg[i]] * own[i]
//                                                          on a slab's owned rows)
//
// agg is the aggregate of every row, order the rows sorted by aggregate
// (stable) and start the (nc + 1) offsets of each aggregate in order; the AMG
// build makes them once.  Each one-hot column holds exactly one 1, so the
// prolongation's products were exact: prolong-add gives their bits, with the
// V-cycle's x + P xc in the same launch.
//
// Bound on this card: bytes.  restrict reads v and order once and writes rc
// (8 B a row in f32: 8.4 MB, 2.5 us at 3.35 TB/s at 1M); prolong-add reads x
// and agg and writes out (12 B a row: 12.6 MB, 3.8 us).  xc (at most 51 KB
// at 1M) and start stay in L1/L2.
//
// Design.  restrict: a group of G lanes (a power of two from 1 to 1024,
// chosen by the wrapper from the mean members per aggregate N / nc so that a
// lane folds about kMembersPerLane of them) owns one aggregate.  Lane l folds
// the members l, l + G, l + 2G, ... in that order, kUnroll of them in flight
// (their order entries, then their values), then the group adds its lanes in
// a fixed xor-shuffle tree, across warps through shared memory when G > 32.
// There are no atomics: every addition's order follows from (N, nc) alone, so
// two calls give the same bits.  Groups of G <= 32 share blocks of kThreads
// threads; a larger group is a block of its own.  All C rows of a (C, N) v
// go in one launch (grid.y).  prolong-add: a thread covers V consecutive
// rows, with one 16-byte load of x (V = 4 in f32, 2 in f64), one vector load
// of agg and one 16-byte store; the add and the mask's multiply are rounded
// one at a time (__fadd_rn, __fmul_rn), as the two PyTorch operations they
// replace.  A length that is not a multiple of V, or a base that is not
// 16-byte aligned, takes the same kernel with V = 1.

#include <cstdint>
#include <cuda_runtime.h>

#include "gather_vec.cuh"

namespace {

using isph_gather::load_idx;

constexpr int kThreads = 256;  // threads a block of groups of G <= 32, and of prolong-add
constexpr int kMaxGroup = 1024;  // lanes of the largest group: one block
constexpr int kUnroll = 4;  // members a lane has in flight

template <typename T>
__device__ __forceinline__ T add_rn(T a, T b);
template <>
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
template <>
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__device__ __forceinline__ T mul_rn(T a, T b);
template <>
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
template <>
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kMaxGroup) agg_restrict_kernel(
    const T* __restrict__ v, const int32_t* __restrict__ order,
    const int32_t* __restrict__ start, T* __restrict__ rc, int64_t n, int nc, int G) {
  __shared__ T warp_sums[kMaxGroup / 32];
  const int lane = threadIdx.x & (G - 1);
  const int64_t a = static_cast<int64_t>(blockIdx.x) * (blockDim.x / G) + threadIdx.x / G;
  const T* __restrict__ vc = v + static_cast<int64_t>(blockIdx.y) * n;
  T acc = T(0);
  if (a < nc) {
    const int32_t e = __ldg(start + a + 1);
    int32_t j = __ldg(start + a) + lane;
    for (; j + (kUnroll - 1) * G < e; j += kUnroll * G) {
      int32_t r[kUnroll];
      T x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) r[u] = __ldg(order + j + u * G);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x[u] = __ldg(vc + r[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = add_rn(acc, x[u]);
    }
    for (; j < e; j += G) acc = add_rn(acc, __ldg(vc + __ldg(order + j)));
  }
  // lane l and lane l ^ off add the same two values, so every lane of the
  // group ends with the same bits
  for (int off = (G < 32 ? G : 32) / 2; off > 0; off >>= 1) {
    acc = add_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  T* __restrict__ out = rc + static_cast<int64_t>(blockIdx.y) * nc;
  if (G <= 32) {
    if (lane == 0 && a < nc) out[a] = acc;
    return;
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    const int warps = G >> 5;
    acc = threadIdx.x < warps ? warp_sums[threadIdx.x] : T(0);
    for (int off = warps / 2; off > 0; off >>= 1) {
      acc = add_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    }
    if (threadIdx.x == 0) out[a] = acc;
  }
}

// d[0..V) = p[0..V); p is 16-byte aligned when V > 1
template <int V>
__device__ __forceinline__ void load_vals(float (&d)[V], const float* __restrict__ p) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    d[0] = t.x;
    d[1] = t.y;
    d[2] = t.z;
    d[3] = t.w;
  } else {
    d[0] = __ldg(p);
  }
}
template <int V>
__device__ __forceinline__ void load_vals(double (&d)[V], const double* __restrict__ p) {
  if constexpr (V == 2) {
    const double2 t = __ldg(reinterpret_cast<const double2*>(p));
    d[0] = t.x;
    d[1] = t.y;
  } else {
    d[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vals(float* __restrict__ p, const float (&d)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  } else {
    *p = d[0];
  }
}
template <int V>
__device__ __forceinline__ void store_vals(double* __restrict__ p, const double (&d)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<double2*>(p) = make_double2(d[0], d[1]);
  } else {
    *p = d[0];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) agg_prolong_add_kernel(
    const T* __restrict__ x, const T* __restrict__ xc, const int32_t* __restrict__ agg,
    const T* __restrict__ own, T* __restrict__ out, int64_t n) {
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (i >= n) return;
  int32_t j[V];
  T xv[V], y[V];
  load_idx<V>(j, agg + i);
  load_vals<V>(xv, x + i);
#pragma unroll
  for (int u = 0; u < V; ++u) y[u] = __ldg(xc + j[u]);
  if (own != nullptr) {
    T o[V];
    load_vals<V>(o, own + i);
#pragma unroll
    for (int u = 0; u < V; ++u) y[u] = mul_rn(y[u], o[u]);
  }
#pragma unroll
  for (int u = 0; u < V; ++u) y[u] = add_rn(xv[u], y[u]);
  store_vals<V>(out + i, y);
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t restrict_launch(const void* v, const void* order, const void* start, void* rc,
                            int64_t n, int nc, int C, int G, cudaStream_t s) {
  const int threads = G <= 32 ? kThreads : G;
  const int groups = threads / G;
  const dim3 grid(static_cast<unsigned>((nc + groups - 1) / groups), static_cast<unsigned>(C));
  agg_restrict_kernel<T><<<grid, threads, 0, s>>>(
      static_cast<const T*>(v), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(start), static_cast<T*>(rc), n, nc, G);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t prolong_launch_v(const void* x, const void* xc, const void* agg, const void* own,
                             void* out, int64_t n, cudaStream_t s) {
  constexpr int64_t kTile = static_cast<int64_t>(kThreads) * V;
  const unsigned blocks = static_cast<unsigned>((n + kTile - 1) / kTile);
  agg_prolong_add_kernel<T, V><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(xc), static_cast<const int32_t*>(agg),
      static_cast<const T*>(own), static_cast<T*>(out), n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t prolong_launch(const void* x, const void* xc, const void* agg, const void* own,
                           void* out, int64_t n, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (n % V == 0 && aligned16(x) && aligned16(agg) && aligned16(own) && aligned16(out)) {
    return prolong_launch_v<T, V>(x, xc, agg, own, out, n, s);
  }
  return prolong_launch_v<T, 1>(x, xc, agg, own, out, n, s);
}

}  // namespace

// rc (C, nc) from v (C, n): dtype 0 = f32, 1 = f64; G a power of two <= 1024.
extern "C" int isph_agg_restrict(int dtype, const void* v, const void* order,
                                 const void* start, void* rc, long long n, int nc, int C,
                                 int G, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (G < 1 || G > kMaxGroup || (G & (G - 1)) != 0 || C > 65535) {
    return cudaErrorInvalidValue;
  }
  if (nc <= 0 || C <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return restrict_launch<float>(v, order, start, rc, n, nc, C, G, s);
    case 1:
      return restrict_launch<double>(v, order, start, rc, n, nc, C, G, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// out (n,) = x + xc[agg] (* own, where own is not null).
extern "C" int isph_agg_prolong_add(int dtype, const void* x, const void* xc, const void* agg,
                                    const void* own, void* out, long long n, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return prolong_launch<float>(x, xc, agg, own, out, n, s);
    case 1:
      return prolong_launch<double>(x, xc, agg, own, out, n, s);
    default:
      return cudaErrorInvalidValue;
  }
}
