// The correction tensors of computePre on Hopper (sm_90a), hand-written CUDA
// C++: the Shepard volume, Gc, Lc, the interface normals and pnd of
// isph_tpu_torch/physics/ns_projection.py:compute_pre, two launches a call.
//
// Replaces no Pallas kernel.  The JAX package leaves computePre to XLA
// (isph_tpu/ops/corrected.py), and the port's plain version
// (isph_tpu_torch/ops/corrected.py: shepard_volume, gradient_correction,
// laplacian_correction, interface_normal) forms every three-way product of
// its slot sums as a (K, N) array: ~250 elementwise passes over (K, N) at
// 64^3 (K = 408, N = 262,144: 428 MB an f32 array), plus the (3, K, N) `a`
// and the (6, K, N) `C` and ~150 launches of the 6x6 elimination on (N,)
// vectors.
//
// Bound on this card: reading the pair arrays once.  The work needs rij
// (D, K, N), r, dwdr, w and mask (K, N), idx (K, N) int32, each read once,
// and the (N,) outputs written: 3.4 GB at 64^3 f32, ~1.0 ms at 3.35 TB/s.
// The kernel reads them in three passes (the Gc sums need the whole row
// before the A sums can start, and A before C), ~3x the bound.
//
// Design.  A thread a particle, walking its K slots in order.  The pair
// arrays are (K, N), so slot k of 32 consecutive particles is one coalesced
// 128-byte line (f32) per array; a warp a particle would read 32 strided
// 4-byte words a line.  kAhead slots are loaded before any is summed, so a
// warp has ~30 lines in flight.  vfrac[idx] and kind[idx] are (N,) vectors
// (1 MB at 64^3, 4 MB at 1M) read through L2, at the list's absolute
// columns (a band list keeps absolute columns too).  The sums live in
// registers, in double whatever T is: the products are rounded in T as the
// plain version rounds them, and only their sum is carried in double and
// rounded to T once it is complete.  A sum along the 408 slots in order
// carries ~sqrt(K) times the rounding of PyTorch's tree of partial sums; in
// double that drops out, so the f32 kernel stays at least as close to the
// f64 result as the plain f32 version (tests/test_torch_pre_kernel.py).
//
// Launch 1 (pre_volume_kernel): vfrac = 1 / (W(0) + sum_k w mask).  The
// sharded step refreshes vfrac's halo between the launches.
// Launch 2 (pre_tensors_kernel), three passes over the row:
//   1. G (symmetric, D(D+1)/2 sums), then the lonely-row pin (a row without
//      neighbors gets the identity) and the cofactor inverse of
//      utils/dense.py (inv2, inv3, _safe_recip): Gc, written;
//   2. A (D x DL sums) and the interface normal's gradient sum, sharing
//      Gc^T r_ij; the normal written;
//   3. C and L (DL x DL sums) and pnd; then Lc = L^-1 (-I packed), by
//      dense.solve_leading's arithmetic: inv3 at DL = 3, the pivot-free
//      elimination at DL = 6, the right-hand side a constant here.
// Every operation is the plain version's, in its order, each rounded on its
// own (the _rn intrinsics: no contraction into FMAs), so the kernel's bits
// are those of the emulation in tests/test_torch_pre_kernel.py, which holds
// that arithmetic to the plain version at 1e-12 in f64.  eij is rij[d] / r
// by IEEE division, the bits of PairGeom.eij.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAhead = 4;  // slots loaded before any is summed
constexpr int kSolid = (1 << 1) | (1 << 4);  // Kind.SOLID | Kind.BOUNDARY

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float to_t(double a, float) { return __double2float_rn(a); }
__device__ __forceinline__ double to_t(double a, double) { return a; }

// dense._safe_recip: 1 / x where |x| > 1e-30 (1e-30 rounded to T), else 0
template <typename T>
__device__ __forceinline__ T safe_recip(T x) {
  return fabs(x) > T(1e-30) ? div(T(1), x) : T(0);
}

// the packed upper triangle in the reference's column order (utils/packed.py)
template <int D>
struct Packed;
template <>
struct Packed<2> {
  static constexpr int L = 3;
  __device__ static constexpr int m(int q) { return q == 2 ? 1 : 0; }
  __device__ static constexpr int n(int q) { return q == 0 ? 0 : 1; }
};
template <>
struct Packed<3> {
  static constexpr int L = 6;
  __device__ static constexpr int m(int q) { return q == 2 || q == 4 ? 1 : q == 5 ? 2 : 0; }
  __device__ static constexpr int n(int q) { return q == 0 ? 0 : q <= 2 ? 1 : 2; }
};

// one slot of a row: what a pass reads of it
template <typename T, int D>
struct Slot {
  T rij[D], r, dwdr, mask, vj, w;
  int sj;
};

template <typename T, int D>
struct Args {
  const T* rij;     // (D, K, n)
  const T* r;       // (K, n)
  const T* dwdr;    // (K, n)
  const T* w;       // (K, n)
  const T* mask;    // (K, n), 0 or 1
  const int32_t* idx;  // (K, n) absolute columns
  const T* vfrac;   // (n,)
  const int32_t* kind;  // (n,)
  const T* w_self;  // ()
  T* Gc;            // (D, D, n)
  T* Lc;            // (DL, n)
  T* normal;        // (D, n)
  T* pnd;           // (n,)
  int64_t n;
  int K;
};

// loads slot k of row i for a pass: the geometry always, w and kind[idx]
// when the pass sums them
template <typename T, int D, bool W, bool KIND>
__device__ __forceinline__ Slot<T, D> load(const Args<T, D>& a, int k, int64_t i) {
  Slot<T, D> s;
  const int64_t at = static_cast<int64_t>(k) * a.n + i;
  const int64_t kn = static_cast<int64_t>(a.K) * a.n;
#pragma unroll
  for (int d = 0; d < D; ++d) s.rij[d] = __ldcs(a.rij + d * kn + at);
  s.r = __ldcs(a.r + at);
  s.dwdr = __ldcs(a.dwdr + at);
  s.mask = __ldcs(a.mask + at);
  const int j = __ldcs(a.idx + at);
  s.vj = __ldg(a.vfrac + j);
  s.w = W ? __ldcs(a.w + at) : T(0);
  s.sj = KIND ? __ldg(a.kind + j) : 0;
  return s;
}

// the row's K slots in order, kAhead loaded before any is summed
template <typename T, int D, bool W, bool KIND, typename F>
__device__ __forceinline__ void walk(const Args<T, D>& a, int64_t i, F&& f) {
  int k = 0;
  for (; k + kAhead <= a.K; k += kAhead) {
    Slot<T, D> s[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) s[u] = load<T, D, W, KIND>(a, k + u, i);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) f(s[u]);
  }
  for (; k < a.K; ++k) f(load<T, D, W, KIND>(a, k, i));
}

// Gc^T r: sum_a Gc[a][b] r[a] in the plain version's order (_g_dot_r)
template <typename T, int D>
__device__ __forceinline__ T gt_r(const T (&Gc)[D][D], const T (&r)[D], int b) {
  T s = mul(Gc[0][b], r[0]);
#pragma unroll
  for (int a = 1; a < D; ++a) s = add(s, mul(Gc[a][b], r[a]));
  return s;
}

// dense.inv2 / dense.inv3: the cofactors over the determinant
template <typename T>
__device__ __forceinline__ void inverse(const T (&G)[2][2], T (&X)[2][2]) {
  const T det = sub(mul(G[0][0], G[1][1]), mul(G[0][1], G[1][0]));
  const T inv = safe_recip(det);
  X[0][0] = mul(G[1][1], inv);
  X[0][1] = mul(-G[0][1], inv);
  X[1][0] = mul(-G[1][0], inv);
  X[1][1] = mul(G[0][0], inv);
}

template <typename T>
__device__ __forceinline__ void inverse(const T (&G)[3][3], T (&X)[3][3]) {
  T c[3][3];
  c[0][0] = sub(mul(G[1][1], G[2][2]), mul(G[1][2], G[2][1]));
  c[0][1] = sub(mul(G[0][2], G[2][1]), mul(G[0][1], G[2][2]));
  c[0][2] = sub(mul(G[0][1], G[1][2]), mul(G[0][2], G[1][1]));
  c[1][0] = sub(mul(G[1][2], G[2][0]), mul(G[1][0], G[2][2]));
  c[1][1] = sub(mul(G[0][0], G[2][2]), mul(G[0][2], G[2][0]));
  c[1][2] = sub(mul(G[0][2], G[1][0]), mul(G[0][0], G[1][2]));
  c[2][0] = sub(mul(G[1][0], G[2][1]), mul(G[1][1], G[2][0]));
  c[2][1] = sub(mul(G[0][1], G[2][0]), mul(G[0][0], G[2][1]));
  c[2][2] = sub(mul(G[0][0], G[1][1]), mul(G[0][1], G[1][0]));
  const T det = add(add(mul(G[0][0], c[0][0]), mul(G[0][1], c[1][0])), mul(G[0][2], c[2][0]));
  const T inv = safe_recip(det);
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int q = 0; q < 3; ++q) X[p][q] = mul(c[p][q], inv);
}

// Lc = L^-1 b with b = -(packed identity), dense.solve_leading's arithmetic
template <typename T>
__device__ __forceinline__ void solve(T (&L)[3][3], T (&x)[3]) {
  const T b[3] = {T(-1), T(-0.0), T(-1)};
  T X[3][3];
  inverse(L, X);
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    x[p] = add(add(mul(X[p][0], b[0]), mul(X[p][1], b[1])), mul(X[p][2], b[2]));
  }
}

template <typename T>
__device__ __forceinline__ void solve(T (&A)[6][6], T (&x)[6]) {
  T b[6] = {T(-1), T(-0.0), T(-1), T(-0.0), T(-0.0), T(-1)};
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const T piv = safe_recip(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const T f = mul(A[i][k], piv);
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] = sub(A[i][j], mul(f, A[k][j]));
      b[i] = sub(b[i], mul(f, b[k]));
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    T s = b[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s = sub(s, mul(A[i][j], x[j]));
    x[i] = mul(s, safe_recip(A[i][i]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pre_volume_kernel(const T* __restrict__ w, const T* __restrict__ mask,
                      const T* __restrict__ w_self, T* __restrict__ vfrac, int64_t n, int K) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  double s = 0.0;
  int k = 0;
  for (; k + kAhead <= K; k += kAhead) {
    T p[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int64_t at = static_cast<int64_t>(k + u) * n + i;
      p[u] = mul(__ldcs(w + at), __ldcs(mask + at));
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) s = __dadd_rn(s, static_cast<double>(p[u]));
  }
  for (; k < K; ++k) {
    const int64_t at = static_cast<int64_t>(k) * n + i;
    s = __dadd_rn(s, static_cast<double>(mul(__ldcs(w + at), __ldcs(mask + at))));
  }
  vfrac[i] = div(T(1), add(__ldg(w_self), to_t(s, T())));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) pre_tensors_kernel(const Args<T, D> a) {
  using P = Packed<D>;
  constexpr int DL = P::L;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const int64_t n = a.n;
  const bool si = (__ldg(a.kind + i) & kSolid) != 0;
  const T one = T(1), orient = si ? T(1) : T(-1);

  // pass 1: G = sum_j (-dw/dr / r V_j) r x r, the lonely pin, Gc = G^-1
  double g[D][D] = {};
  bool live = false;
  walk<T, D, false, false>(a, i, [&](const Slot<T, D>& s) {
    const T coef = mul(mul(div(-s.dwdr, s.r), s.vj), s.mask);
    live |= s.mask != T(0);
#pragma unroll
    for (int p = 0; p < D; ++p)
#pragma unroll
      for (int q = p; q < D; ++q)
        g[p][q] = __dadd_rn(g[p][q], static_cast<double>(mul(mul(coef, s.rij[p]), s.rij[q])));
  });
  T G[D][D], Gc[D][D];
#pragma unroll
  for (int p = 0; p < D; ++p)
#pragma unroll
    for (int q = p; q < D; ++q) G[p][q] = G[q][p] = to_t(g[p][q], T());
  if (!live) {
#pragma unroll
    for (int p = 0; p < D; ++p) G[p][p] = add(G[p][p], one);
  }
  inverse(G, Gc);
#pragma unroll
  for (int p = 0; p < D; ++p)
#pragma unroll
    for (int q = 0; q < D; ++q) a.Gc[(p * D + q) * n + i] = Gc[p][q];

  // pass 2: A^{k,mn} = sum_j (Gc^T r)_k dw/dr / r V_j r^m r^n, and the
  // normal's sum_j (Gc^T r) orient cross dw/dr / r V_j
  double A[D][DL] = {}, gs[D] = {};
  walk<T, D, false, true>(a, i, [&](const Slot<T, D>& s) {
    const T vj = mul(s.vj, s.mask);
    const T wgt = mul(div(s.dwdr, s.r), vj);
    const T cross = mul((((s.sj & kSolid) != 0) != si) ? one : T(0), s.mask);
    const T coef = mul(div(mul(mul(orient, cross), s.dwdr), s.r), vj);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const T gr = gt_r(Gc, s.rij, k);
      const T ak = mul(gr, wgt);
#pragma unroll
      for (int q = 0; q < DL; ++q)
        A[k][q] = __dadd_rn(A[k][q],
                            static_cast<double>(mul(mul(ak, s.rij[P::m(q)]), s.rij[P::n(q)])));
      gs[k] = __dadd_rn(gs[k], static_cast<double>(mul(gr, coef)));
    }
  });
  T At[D][DL], gc[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    gc[k] = to_t(gs[k], T());
#pragma unroll
    for (int q = 0; q < DL; ++q) At[k][q] = to_t(A[k][q], T());
  }
  T mag2 = mul(gc[0], gc[0]);
#pragma unroll
  for (int d = 1; d < D; ++d) mag2 = add(mag2, mul(gc[d], gc[d]));
  const T mag = sqrt_rn(mag2);
  const T den = fmax(mag, T(1e-30));
#pragma unroll
  for (int d = 0; d < D; ++d) a.normal[d * n + i] = mag > T(0) ? div(gc[d], den) : T(0);

  // pass 3: C^{mn} = (sum_k A^{k,mn} e^k + r^m e^n) dw/dr V_j,
  // L^{mn,op} = sum_j C^{mn} e^o e^p (x2 off the diagonal), pnd
  double L[DL][DL] = {}, ps = 0.0;
  walk<T, D, true, true>(a, i, [&](const Slot<T, D>& s) {
    const T vj = mul(s.vj, s.mask);
    const T dwv = mul(s.dwdr, vj);
    T e[D];
#pragma unroll
    for (int d = 0; d < D; ++d) e[d] = div(s.rij[d], s.r);
    const T cross = mul((((s.sj & kSolid) != 0) != si) ? one : T(0), s.mask);
    ps = __dadd_rn(ps, static_cast<double>(mul(s.w, mul(sub(one, cross), s.mask))));
#pragma unroll
    for (int q = 0; q < DL; ++q) {
      T c = mul(At[0][q], e[0]);
#pragma unroll
      for (int k = 1; k < D; ++k) c = add(c, mul(At[k][q], e[k]));
      c = mul(add(c, mul(s.rij[P::m(q)], e[P::n(q)])), dwv);
#pragma unroll
      for (int t = 0; t < DL; ++t)
        L[q][t] = __dadd_rn(L[q][t], static_cast<double>(mul(mul(c, e[P::m(t)]), e[P::n(t)])));
    }
  });
  a.pnd[i] = add(__ldg(a.w_self), to_t(ps, T()));
  T Lt[DL][DL], x[DL];
#pragma unroll
  for (int q = 0; q < DL; ++q)
#pragma unroll
    for (int t = 0; t < DL; ++t) {
      const T v = to_t(L[q][t], T());
      Lt[q][t] = P::m(t) == P::n(t) ? v : mul(v, T(2));
    }
  if (!live) {
#pragma unroll
    for (int q = 0; q < DL; ++q) Lt[q][q] = add(Lt[q][q], one);
  }
  solve(Lt, x);
#pragma unroll
  for (int q = 0; q < DL; ++q) a.Lc[q * n + i] = x[q];
}

template <typename T>
int launch_volume(const void* w, const void* mask, const void* w_self, void* vfrac, int64_t n,
                  int K, cudaStream_t s) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  pre_volume_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(w), static_cast<const T*>(mask), static_cast<const T*>(w_self),
      static_cast<T*>(vfrac), n, K);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_tensors(const void* rij, const void* r, const void* dwdr, const void* w,
                   const void* mask, const void* idx, const void* vfrac, const void* kind,
                   const void* w_self, void* Gc, void* Lc, void* normal, void* pnd, int64_t n,
                   int K, cudaStream_t s) {
  Args<T, D> a{static_cast<const T*>(rij), static_cast<const T*>(r),
               static_cast<const T*>(dwdr), static_cast<const T*>(w),
               static_cast<const T*>(mask), static_cast<const int32_t*>(idx),
               static_cast<const T*>(vfrac), static_cast<const int32_t*>(kind),
               static_cast<const T*>(w_self), static_cast<T*>(Gc), static_cast<T*>(Lc),
               static_cast<T*>(normal), static_cast<T*>(pnd), n, K};
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  pre_tensors_kernel<T, D><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int isph_pre_volume(int dtype, const void* w, const void* mask, const void* w_self,
                               void* vfrac, long long n, int K, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (K < 1 || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_volume<float>(w, mask, w_self, vfrac, n, K, s);
    case 1: return launch_volume<double>(w, mask, w_self, vfrac, n, K, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int isph_pre_tensors(int dtype, int dim, const void* rij, const void* r,
                                const void* dwdr, const void* w, const void* mask,
                                const void* idx, const void* vfrac, const void* kind,
                                const void* w_self, void* Gc, void* Lc, void* normal,
                                void* pnd, long long n, int K, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (K < 1 || n < 0 || (dim != 2 && dim != 3) || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ISPH_PRE_ARGS rij, r, dwdr, w, mask, idx, vfrac, kind, w_self, Gc, Lc, normal, pnd, n, K, s
  if (dtype == 0) {
    return dim == 2 ? launch_tensors<float, 2>(ISPH_PRE_ARGS)
                    : launch_tensors<float, 3>(ISPH_PRE_ARGS);
  }
  return dim == 2 ? launch_tensors<double, 2>(ISPH_PRE_ARGS)
                  : launch_tensors<double, 3>(ISPH_PRE_ARGS);
#undef ISPH_PRE_ARGS
}
