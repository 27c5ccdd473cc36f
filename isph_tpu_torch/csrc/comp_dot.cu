// Compensated dot products of the f32 Krylov solves on Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces XLA code, not a Pallas kernel: isph_tpu/utils/fsum.py:comp_sum2
// (:56) and comp_dot (:75), reached through isph_tpu/solvers/krylov.py:_dot
// (:44) and _fused_dots (:57), which XLA fuses inside the solvers' compiled
// loops.  Run eagerly, the same cascade is ~8 elementwise launches for each
// of its log2(N) folds; here it is one launch below 32,769 elements and two
// or three above.
//
// Computes, for up to kMaxPairs pairs (a_p, b_p) of one contiguous (C, N)
// shape and every row c, the unmerged (hi, lo) of
//
//     fsum.comp_sum2(a_p[c] * b_p[c], 0)
//
// bit for bit: the products are zero-padded (+0.0) to p = 2^ceil(log2 N),
// at least 2, and folded in halves, entry i with entry i + h for
// h = p/2, p/4, ..., 1; each fold is a Knuth TwoSum of the two sums and adds
// the two errors, (e[i] + e[i + h]) + err, in that order.  Every product and
// sum is an __fmul_rn / __fadd_rn / __fsub_rn, which nvcc neither contracts
// into an FMA nor reassociates (the library's other sources keep -fmad).
// out is (2, P * C): row p * C + c holds hi in out[0] and lo in out[1].
//
// The schedule follows the fold tree.  After l folds, entry j holds the
// indices = j (mod p / 2^l), so a pass of G threads (a power of two) over a
// row of L entries gives thread g the R = L / G entries g + G * r: it folds
// them in registers, r with r + R/2 first, and ends with entry g of the
// length-G array, which it writes to scratch.  Consecutive threads read
// consecutive addresses.  Passes repeat until one block of T <= 1024
// threads takes the rest (comp_dot_final): the same register fold, then a
// halving tree in shared memory down to 32 entries and __shfl_down_sync
// with offsets 16, 8, 4, 2, 1, which pairs lane t with lane t + offset.  No
// atomics: the bits do not depend on which block runs first.  Rows and
// pairs sit on blockIdx.y, so one launch serves a whole stack.
//
// Bound on this card: bytes.  The inputs are read once (2 * N * 4 bytes a
// row); a pass writes 8 bytes a thread, 1/R of what it read.  At N =
// 1,048,576, 8.4 MB: 2.5 us at 3.35 TB/s.  A pass of 256-thread blocks keeps
// 2R loads in flight a thread; the last pass is one block a row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPairs = 4;
constexpr int kMaxR = 32;                    // entries a thread folds in one pass
constexpr int kFinalThreads = 1024;          // threads of the last pass's block
constexpr int kPassThreads = 256;            // threads of an earlier pass's block
constexpr long long kPassTarget = 8192;      // an earlier pass's output entries a row
constexpr long long kFinalMax = static_cast<long long>(kFinalThreads) * kMaxR;

struct Pairs {
  const float* a[kMaxPairs];
  const float* b[kMaxPairs];
};

// One fold of comp_sum2: (s, e) with (t, f), s the lower entry.
__device__ __forceinline__ void fold(float& s, float& e, float t, float f) {
  const float sum = __fadd_rn(s, t);
  const float z = __fsub_rn(sum, s);
  const float err = __fadd_rn(__fsub_rn(s, __fsub_rn(sum, z)), __fsub_rn(t, z));
  e = __fadd_rn(__fadd_rn(e, f), err);
  s = sum;
}

// The folds of H, H/2, ..., 1 over register entries [0, 2H).
template <int H, int M>
__device__ __forceinline__ void fold_regs(float (&s)[M], float (&e)[M]) {
  if constexpr (H >= 1) {
#pragma unroll
    for (int r = 0; r < H; ++r) fold(s[r], e[r], s[r + H], e[r + H]);
    fold_regs<H / 2, M>(s, e);
  }
}

// Entry i of a row: the product (zero past n) on the first pass, the
// previous pass's (s, e) after it.
template <bool FIRST>
__device__ __forceinline__ void load(const float* __restrict__ a,
                                     const float* __restrict__ b, long long n,
                                     const float* __restrict__ in_s,
                                     const float* __restrict__ in_e, long long i,
                                     float& s, float& e) {
  if constexpr (FIRST) {
    s = i < n ? __fmul_rn(__ldg(a + i), __ldg(b + i)) : 0.0f;
    e = 0.0f;
  } else {
    s = __ldg(in_s + i);
    e = __ldg(in_e + i);
  }
}

// Thread g's fold of the R entries g + G * r of its row, G the threads a
// row; the first level (r with r + R/2) folds as the pairs arrive, so R/2
// pairs stay live.
template <int R, bool FIRST>
__device__ __forceinline__ void thread_fold(const Pairs& pairs, int C, long long n,
                                            const float* in_s, const float* in_e,
                                            long long L, long long G, long long g,
                                            float& s_out, float& e_out) {
  const int row = blockIdx.y;
  const float* a = nullptr;
  const float* b = nullptr;
  if constexpr (FIRST) {
    const int pair = row / C;
    a = pairs.a[0];
    b = pairs.b[0];
#pragma unroll
    for (int q = 1; q < kMaxPairs; ++q) {
      if (q == pair) {
        a = pairs.a[q];
        b = pairs.b[q];
      }
    }
    const long long off = static_cast<long long>(row - pair * C) * n;
    a += off;
    b += off;
  } else {
    in_s += static_cast<long long>(row) * L;
    in_e += static_cast<long long>(row) * L;
  }
  if constexpr (R == 1) {
    load<FIRST>(a, b, n, in_s, in_e, g, s_out, e_out);
  } else {
    constexpr int H = R / 2;
    float s[H], e[H];
#pragma unroll
    for (int r = 0; r < H; ++r) {
      float t, f;
      load<FIRST>(a, b, n, in_s, in_e, g + G * r, s[r], e[r]);
      load<FIRST>(a, b, n, in_s, in_e, g + G * (r + H), t, f);
      fold(s[r], e[r], t, f);
    }
    fold_regs<H / 2, H>(s, e);
    s_out = s[0];
    e_out = e[0];
  }
}

// An earlier pass: G = gridDim.x * kPassThreads threads a row, each writing
// its (s, e) to entry g of the row's scratch (rows x G sums, then errors).
template <int R, bool FIRST>
__global__ void __launch_bounds__(kPassThreads) comp_dot_pass(
    Pairs pairs, int C, long long n, const float* __restrict__ in_s,
    const float* __restrict__ in_e, long long L, float* __restrict__ out_s,
    float* __restrict__ out_e) {
  const long long G = static_cast<long long>(gridDim.x) * kPassThreads;
  const long long g = static_cast<long long>(blockIdx.x) * kPassThreads + threadIdx.x;
  float s, e;
  thread_fold<R, FIRST>(pairs, C, n, in_s, in_e, L, G, g, s, e);
  const long long o = static_cast<long long>(blockIdx.y) * G + g;
  out_s[o] = s;
  out_e[o] = e;
}

// The last pass: one block of T = blockDim.x threads a row (a power of two,
// at most kFinalThreads); hi to out_s[row], lo to out_e[row].
template <int R, bool FIRST>
__global__ void __launch_bounds__(kFinalThreads) comp_dot_final(
    Pairs pairs, int C, long long n, const float* __restrict__ in_s,
    const float* __restrict__ in_e, long long L, float* __restrict__ out_s,
    float* __restrict__ out_e) {
  __shared__ float sh_s[kFinalThreads];
  __shared__ float sh_e[kFinalThreads];
  const int t = threadIdx.x;
  const int T = blockDim.x;
  float s, e;
  thread_fold<R, FIRST>(pairs, C, n, in_s, in_e, L, T, t, s, e);
  if (T > 32) {
    sh_s[t] = s;
    sh_e[t] = e;
    __syncthreads();
    // level h reads entries [h, 2h) and writes [0, h): no entry is read
    // and written in one level
    for (int h = T / 2; h >= 32; h /= 2) {
      if (t < h) {
        fold(s, e, sh_s[t + h], sh_e[t + h]);
        sh_s[t] = s;
        sh_e[t] = e;
      }
      __syncthreads();
    }
  }
  if (t < 32) {
    const int w = T < 32 ? T : 32;  // entries left, in lanes [0, w)
    const unsigned mask = T < 32 ? (1u << T) - 1u : 0xffffffffu;
    // lanes >= offset fold values no lower lane reads again
    for (int off = w / 2; off >= 1; off /= 2) {
      const float s1 = __shfl_down_sync(mask, s, off);
      const float e1 = __shfl_down_sync(mask, e, off);
      fold(s, e, s1, e1);
    }
    if (t == 0) {
      out_s[blockIdx.y] = s;
      out_e[blockIdx.y] = e;
    }
  }
}

template <int R, bool FIRST>
cudaError_t launch(bool last, dim3 grid, int threads, cudaStream_t st, const Pairs& p,
                   int C, long long n, const float* in_s, const float* in_e, long long L,
                   float* out_s, float* out_e) {
  if (last)
    comp_dot_final<R, FIRST><<<grid, threads, 0, st>>>(p, C, n, in_s, in_e, L, out_s, out_e);
  else
    comp_dot_pass<R, FIRST><<<grid, threads, 0, st>>>(p, C, n, in_s, in_e, L, out_s, out_e);
  return cudaGetLastError();
}

template <bool FIRST>
cudaError_t dispatch(int R, bool last, dim3 grid, int threads, cudaStream_t st,
                     const Pairs& p, int C, long long n, const float* in_s,
                     const float* in_e, long long L, float* out_s, float* out_e) {
  switch (R) {
    case 1: return launch<1, FIRST>(last, grid, threads, st, p, C, n, in_s, in_e, L, out_s, out_e);
    case 2: return launch<2, FIRST>(last, grid, threads, st, p, C, n, in_s, in_e, L, out_s, out_e);
    case 4: return launch<4, FIRST>(last, grid, threads, st, p, C, n, in_s, in_e, L, out_s, out_e);
    case 8: return launch<8, FIRST>(last, grid, threads, st, p, C, n, in_s, in_e, L, out_s, out_e);
    case 16: return launch<16, FIRST>(last, grid, threads, st, p, C, n, in_s, in_e, L, out_s, out_e);
    case 32: return launch<32, FIRST>(last, grid, threads, st, p, C, n, in_s, in_e, L, out_s, out_e);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// (hi, lo) of every row of npairs pairs (a_q, b_q), each a contiguous
// (C, n) f32 array; unused pointers may be null.  buf holds 2 * rows floats
// of output (rows = npairs * C; hi row, then lo row) followed by the
// earlier passes' scratch, 2 * rows * (sum of their G) floats, the plan
// being: while L > kFinalMax, a pass with R = min(kMaxR, L / kPassTarget)
// and G = L / R, L = G; then the last pass with T = min(L, kFinalThreads)
// threads of R = L / T entries (ops/comp_dot_cuda.py:comp_dot_plan).
extern "C" int isph_comp_dots(const void* a0, const void* b0, const void* a1, const void* b1,
                              const void* a2, const void* b2, const void* a3, const void* b3,
                              int npairs, int C, long long n, void* buf, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (npairs < 1 || npairs > kMaxPairs || C < 1 || n < 0) return cudaErrorInvalidValue;
  const Pairs p = {{static_cast<const float*>(a0), static_cast<const float*>(a1),
                    static_cast<const float*>(a2), static_cast<const float*>(a3)},
                   {static_cast<const float*>(b0), static_cast<const float*>(b1),
                    static_cast<const float*>(b2), static_cast<const float*>(b3)}};
  const int rows = npairs * C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(buf);
  float* scratch = out + 2 * static_cast<long long>(rows);
  long long L = 2;
  while (L < n) L *= 2;
  const float* in_s = nullptr;
  const float* in_e = nullptr;
  bool first = true;
  while (L > kFinalMax) {
    const int R = static_cast<int>(L / kPassTarget < kMaxR ? L / kPassTarget : kMaxR);
    const long long G = L / R;
    float* out_s = scratch;
    float* out_e = scratch + rows * G;
    scratch += 2 * rows * G;
    const dim3 grid(static_cast<unsigned>(G / kPassThreads), rows);
    err = first ? dispatch<true>(R, false, grid, kPassThreads, st, p, C, n, in_s, in_e, L,
                                 out_s, out_e)
                : dispatch<false>(R, false, grid, kPassThreads, st, p, C, n, in_s, in_e, L,
                                  out_s, out_e);
    if (err != cudaSuccess) return err;
    in_s = out_s;
    in_e = out_e;
    L = G;
    first = false;
  }
  const int T = static_cast<int>(L < kFinalThreads ? L : kFinalThreads);
  const int R = static_cast<int>(L / T);
  const dim3 grid(1, rows);
  return first ? dispatch<true>(R, true, grid, T, st, p, C, n, in_s, in_e, L, out, out + rows)
               : dispatch<false>(R, true, grid, T, st, p, C, n, in_s, in_e, L, out, out + rows);
}
