// Compensated dot products of the f32 Krylov solves on Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces XLA code, not a Pallas kernel: isph_tpu/utils/fsum.py:comp_sum2
// (:56) and comp_dot (:75), reached through isph_tpu/solvers/krylov.py:_dot
// (:44) and _fused_dots (:57), which XLA fuses inside the solvers' compiled
// loops.  Run eagerly, the same cascade is ~8 elementwise launches for each
// of its log2(N) folds; here it is one launch to 2^22 padded entries a row.
//
// Computes, for up to kMaxPairs pairs (a_p, b_p) of one contiguous (C, N)
// shape and every row c, the unmerged (hi, lo) of
//
//     fsum.comp_sum2(a_p[c] * b_p[c], 0)
//
// bit for bit, and their sum: the products are zero-padded (+0.0) to
// p = 2^ceil(log2 N), at least 2, and folded in halves, entry i with entry
// i + h for h = p/2, p/4, ..., 1; each fold is a Knuth TwoSum of the two
// sums and adds the two errors, (e[i] + e[i + h]) + err, in that order.
// Every product and sum is an __fmul_rn / __fadd_rn / __fsub_rn, which nvcc
// neither contracts into an FMA nor reassociates (the library's other
// sources keep -fmad).  out is (3, P * C): row p * C + c holds hi in out[0],
// lo in out[1] and __fadd_rn(hi, lo), the bits of hi + lo, in out[2].
//
// The schedule follows the fold tree.  After l folds, entry j holds the
// indices = j (mod p / 2^l).  A launch of B blocks of T threads a row
// (G = B * T, powers of two) gives thread g the R = L / G entries g + G * r
// of its row's L entries, which it folds in registers (r with r + R/2
// first) into entry g of the length-G array.  With K = kChunk = 16, thread
// t of block b holds g = (b + B * (t / K)) * K + t % K: each half-warp
// reads 64 consecutive bytes, and every partner of the levels
// h = G/2 .. K B lies in the same block (t with t + T/2, ..., t + K).  A
// block halves its T entries to 32 in shared memory and to K with the
// shuffle of offset 16: entries K b + k of the length-K B array.  Its
// levels h = K B / 2 .. K pair block b with b + B/2, ..., b + 1, and the
// shuffles with offsets 8, 4, 2, 1 end the tree.  Blocks are combined
// without atomics in the sums, so the bits do not depend on which block
// finishes first:
//
//   - one block (L <= kSingleMax) folds its row alone;
//   - a cluster of kClusterBlocks blocks (L <= kClusterMax): each block
//     stores its K entries into block 0's shared memory (distributed
//     shared memory) and arrives at the cluster barrier (release); block 0
//     waits (acquire) and folds the K B entries in warp 0.  Every block
//     arrives once at the start, and waits for that before its remote
//     store, so block 0 is running when it is written to; the other blocks
//     exit without waiting for block 0;
//   - a grid of about kGridBlocks blocks, all rows together (larger L):
//     each block writes its K (s, e) to scratch and takes a ticket (an
//     acq_rel atomicAdd on its row's counter, after a __syncthreads); the
//     block that arrives last folds the K B entries of its row in the fixed
//     order (the ticket picks the block, not the order) and resets the
//     counter to 0 for the next launch or a CUDA graph's replay.  Past one
//     launch's reach (the last block's fold above kLastR entries a thread)
//     earlier launches write the length-K B array without a ticket, and
//     the next launch folds it.
//
// Rows and pairs sit on blockIdx.y, so one launch serves a whole stack.
// The kernel launches on the caller's stream and allocates nothing: the
// wrapper passes the output, the scratch after it and the counters.
//
// Bound on this card: bytes.  The inputs are read once (2 * N * 4 bytes a
// row); a grid block writes 128 bytes of scratch.  At N = 1,048,576,
// 8.4 MB: 2.5 us at 3.35 TB/s.  Up to ~2^18 entries a row the call is
// latency-bound (an empty launch takes ~4.8 us where the dot kernel is
// timed): a grid or a cluster spreads the loads over SMs and combines the
// blocks in the same launch.  scripts/comp_dot_variants.py times the
// choices of the constants below against their alternatives.

#include <cooperative_groups.h>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxPairs = 4;
constexpr int kMaxR = 32;                    // entries a thread folds in registers
constexpr int kLastR = 8;                    // entries a thread of a grid's last block folds
constexpr int kThreads = 512;                // threads a block, at most
constexpr long long kSingleMax = 256;        // rows to this padded length: one block
constexpr int kClusterBlocks = 8;            // blocks of a cluster (at most 8: portable)
constexpr long long kClusterMax = 32768;     // rows to this padded length: a cluster
constexpr int kGridBlocks = 128;             // blocks of a grid launch, all rows together
constexpr int kMaxRows = 65535;              // rows of one launch (gridDim.y)
constexpr int kChunk = 16;                   // consecutive entries of a lane group (64 bytes)

struct Args {
  const float* a[kMaxPairs];
  const float* b[kMaxPairs];
  const float* in_s;  // non-null: an earlier launch's rows x L (s, e) instead of the products
  const float* in_e;
  long long n;        // entries of a product row
  long long L;        // this launch's padded entries a row
  int C;
  int R2;             // grid: entries a thread of the last block folds; 0 for no ticket
  float* out;         // (3, rows): hi, lo, hi + lo
  float* out_s;       // grid: rows x kChunk B sums, then as many errors
  float* out_e;
  int* counters;      // grid with a ticket: one a row, 0 between launches
};

// One fold of comp_sum2: (s, e) with (t, f), s the lower entry.
__device__ __forceinline__ void fold(float& s, float& e, float t, float f) {
  const float sum = __fadd_rn(s, t);
  const float z = __fsub_rn(sum, s);
  const float err = __fadd_rn(__fsub_rn(s, __fsub_rn(sum, z)), __fsub_rn(t, z));
  e = __fadd_rn(__fadd_rn(e, f), err);
  s = sum;
}

// Entry i of a product row, zero past n.
struct Products {
  const float* __restrict__ a;
  const float* __restrict__ b;
  long long n;
  __device__ __forceinline__ void operator()(long long i, float& s, float& e) const {
    s = i < n ? __fmul_rn(__ldg(a + i), __ldg(b + i)) : 0.0f;
    e = 0.0f;
  }
};

// Entry i of an earlier launch's (s, e).
struct Partials {
  const float* __restrict__ s_;
  const float* __restrict__ e_;
  __device__ __forceinline__ void operator()(long long i, float& s, float& e) const {
    s = __ldg(s_ + i);
    e = __ldg(e_ + i);
  }
};

// Entry i of this launch's scratch, written by other blocks: read from L2.
struct Fresh {
  const float* s_;
  const float* e_;
  __device__ __forceinline__ void operator()(long long i, float& s, float& e) const {
    s = __ldcg(s_ + i);
    e = __ldcg(e_ + i);
  }
};

// Entry i of a shared-memory array of this block (a cluster's partials).
struct Shared {
  const float* s_;
  const float* e_;
  __device__ __forceinline__ void operator()(long long i, float& s, float& e) const {
    s = s_[i];
    e = e_[i];
  }
};

// The levels r with r + h, h = H, H/2, ..., 1, of those below Hrt: indices
// known at compile time, so s and e stay in registers.
template <int H, int M>
__device__ __forceinline__ void fold_levels(float (&s)[M], float (&e)[M], int Hrt) {
  if constexpr (H >= 1) {
    if (H < Hrt) {
#pragma unroll
      for (int r = 0; r < H; ++r) fold(s[r], e[r], s[r + H], e[r + H]);
    }
    fold_levels<H / 2, M>(s, e, Hrt);
  }
}

// Thread g's fold of the R entries g + G * r (R a power of two, at most
// RMAX; a constant where RMAX is): r with r + R/2 as the pairs arrive, so
// R/2 pairs stay live, then r with r + R/4, ..., r with r + 1.
template <int RMAX, class Load>
__device__ __forceinline__ void fold_strided(const Load& load, int R, long long g, long long G,
                                             float& s_out, float& e_out) {
  if (R == 1) {
    load(g, s_out, e_out);
    return;
  }
  constexpr int HMAX = RMAX > 1 ? RMAX / 2 : 1;
  float s[HMAX], e[HMAX];
  const int H = R / 2;
#pragma unroll
  for (int r = 0; r < HMAX; ++r) {
    if (r < H) {
      float t, f;
      load(g + G * r, s[r], e[r]);
      load(g + G * (r + H), t, f);
      fold(s[r], e[r], t, f);
    }
  }
  fold_levels<HMAX / 2, HMAX>(s, e, H);
  s_out = s[0];
  e_out = e[0];
}

// Entries [0, Ta) of a block, entry t in thread t: the levels h = Ta/2 ..
// 32 in shared memory (level h reads [h, 2h) and writes [0, h), so no
// entry is read and written in one level); entry t < min(Ta, 32) is left
// in thread t.  Every thread of the block calls it.
__device__ __forceinline__ void block_tree(float* sh_s, float* sh_e, int t, int Ta, float& s,
                                           float& e) {
  if (Ta <= 32) return;
  if (t < Ta) {
    sh_s[t] = s;
    sh_e[t] = e;
  }
  __syncthreads();
  for (int h = Ta / 2; h >= 32; h /= 2) {
    if (t < h) {
      fold(s, e, sh_s[t + h], sh_e[t + h]);
      sh_s[t] = s;
      sh_e[t] = e;
    }
    __syncthreads();
  }
}

// Entries [0, w) in lanes [0, w) of warp 0 (w <= 32): lane l folds lane
// l + offset for offset = w/2 .. last (lanes >= offset fold values no lower
// lane reads again), leaving entries [0, last) in lanes [0, last).
__device__ __forceinline__ void warp_tree(int w, int last, float& s, float& e) {
  const unsigned mask = w < 32 ? (1u << w) - 1u : 0xffffffffu;
  for (int off = w / 2; off >= last; off /= 2) {
    const float s1 = __shfl_down_sync(mask, s, off);
    const float e1 = __shfl_down_sync(mask, e, off);
    fold(s, e, s1, e1);
  }
}

// The cluster barrier in two halves (every thread of every block of the
// cluster arrives; a thread that has exited no longer counts).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void write_out(const Args& p, int row, float s, float e) {
  const int rows = gridDim.y;
  p.out[row] = s;
  p.out[rows + row] = e;
  p.out[2 * rows + row] = __fadd_rn(s, e);
}

template <int R, bool CLUSTER>
__global__ void __launch_bounds__(kThreads) comp_dot_kernel(const Args p) {
  __shared__ float sh_s[kThreads];
  __shared__ float sh_e[kThreads];
  __shared__ float part_s[kChunk * kClusterBlocks];  // a cluster's partials, in block 0
  __shared__ float part_e[kChunk * kClusterBlocks];
  __shared__ int arrived_last;
  if constexpr (CLUSTER) cluster_arrive_relaxed();  // waited for before the first remote store
  const int row = blockIdx.y;
  const int B = gridDim.x;
  const int b = blockIdx.x;
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const long long G = static_cast<long long>(B) * T;
  const long long g = static_cast<long long>(b + B * (t / kChunk)) * kChunk + t % kChunk;
  float s, e;
  if (p.in_s == nullptr) {
    const int pair = row / p.C;
    const float* a = p.a[0];
    const float* bb = p.b[0];
#pragma unroll
    for (int q = 1; q < kMaxPairs; ++q) {
      if (q == pair) {
        a = p.a[q];
        bb = p.b[q];
      }
    }
    const long long off = static_cast<long long>(row - pair * p.C) * p.n;
    fold_strided<R>(Products{a + off, bb + off, p.n}, R, g, G, s, e);
  } else {
    const long long off = static_cast<long long>(row) * p.L;
    fold_strided<R>(Partials{p.in_s + off, p.in_e + off}, R, g, G, s, e);
  }
  block_tree(sh_s, sh_e, t, T, s, e);
  const int w = T < 32 ? T : 32;  // entries left in warp 0
  if (B == 1) {
    if (t < w) {
      warp_tree(w, 1, s, e);
      if (t == 0) write_out(p, row, s, e);
    }
    return;
  }
  // lanes [0, kChunk) of block b hold entries kChunk b + lane of the
  // length-kChunk B array that the blocks leave
  if (t < w) warp_tree(w, kChunk, s, e);
  const int M = kChunk * B;
  if constexpr (CLUSTER) {
    cluster_wait();  // every block of the cluster has started
    if (t < kChunk) {
      const cg::cluster_group cl = cg::this_cluster();
      cl.map_shared_rank(part_s, 0)[kChunk * b + t] = s;
      cl.map_shared_rank(part_e, 0)[kChunk * b + t] = e;
    }
    cluster_arrive_release();
    if (b != 0) return;
    cluster_wait();  // every block's partials are in block 0
    const int W = M < 32 ? M : 32;
    if (t < W) {
      fold_strided<(kChunk * kClusterBlocks + 31) / 32>(Shared{part_s, part_e}, M / W, t, W,
                                                         s, e);
      warp_tree(W, 1, s, e);
      if (t == 0) write_out(p, row, s, e);
    }
  } else {
    const long long off = static_cast<long long>(row) * M;
    if (t < kChunk) {
      p.out_s[off + kChunk * b + t] = s;
      p.out_e[off + kChunk * b + t] = e;
    }
    if (p.R2 == 0) return;  // the next launch folds the scratch
    __syncthreads();        // the partials' stores come before thread 0's release
    if (t == 0) {
      cuda::atomic_ref<int, cuda::thread_scope_device> ticket(p.counters[row]);
      const bool last = ticket.fetch_add(1, cuda::memory_order_acq_rel) == B - 1;
      if (last) ticket.store(0, cuda::memory_order_relaxed);  // every block has its ticket
      arrived_last = last;
    }
    __syncthreads();
    if (!arrived_last) return;
    const int T2 = T < M ? T : M;
    if (t < T2) fold_strided<kLastR>(Fresh{p.out_s + off, p.out_e + off}, p.R2, t, T2, s, e);
    block_tree(sh_s, sh_e, t, T2, s, e);
    const int w2 = T2 < 32 ? T2 : 32;
    if (t < w2) {
      warp_tree(w2, 1, s, e);
      if (t == 0) write_out(p, row, s, e);
    }
  }
}

// One launch of the plan: B blocks of T threads a row, R entries a thread;
// R2 > 0 on a grid launch with a ticket.
struct Launch {
  int B, T, R, R2;
  bool cluster;
};

long long min_ll(long long x, long long y) { return x < y ? x : y; }

// The launch that folds `rows` rows of L entries (a power of two), and
// whether it is the last (ops/comp_dot_cuda.py:comp_dot_plan).
Launch plan(long long L, int rows, bool& last) {
  last = true;
  if (L <= kSingleMax) {
    const int T = static_cast<int>(min_ll(L, kThreads));
    return {1, T, static_cast<int>(L / T), 0, false};
  }
  if (L <= kClusterMax) {
    const int T = static_cast<int>(min_ll(kThreads, L / kClusterBlocks));
    return {kClusterBlocks, T, static_cast<int>(L / (static_cast<long long>(kClusterBlocks) * T)),
            0, true};
  }
  const int T = static_cast<int>(min_ll(kThreads, L / 2));
  long long B = 1;  // kGridBlocks / rows blocks a row, rounded up to a power of two
  while (B * rows < kGridBlocks) B *= 2;
  int R = static_cast<int>(min_ll(kMaxR, L / (2LL * T)));
  while (R > 1 && static_cast<long long>(R) * T * B > L) R /= 2;
  B = L / (static_cast<long long>(R) * T);
  const long long T2 = min_ll(T, kChunk * B);
  if (kChunk * B / T2 <= kLastR)
    return {static_cast<int>(B), T, R, static_cast<int>(kChunk * B / T2), false};
  last = false;
  R = static_cast<int>(min_ll(kMaxR, L / (2LL * T)));
  B = L / (static_cast<long long>(R) * T);
  return {static_cast<int>(B), T, R, 0, false};
}

template <int R, bool CLUSTER>
cudaError_t launch(const Launch& l, int rows, cudaStream_t st, const Args& p) {
  const dim3 grid(static_cast<unsigned>(l.B), static_cast<unsigned>(rows));
  if constexpr (CLUSTER) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(static_cast<unsigned>(l.T));
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(l.B);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, comp_dot_kernel<R, true>, p);
    if (err != cudaSuccess) return err;
  } else {
    comp_dot_kernel<R, false><<<grid, l.T, 0, st>>>(p);
  }
  return cudaGetLastError();
}

template <bool CLUSTER>
cudaError_t dispatch(const Launch& l, int rows, cudaStream_t st, const Args& p) {
  switch (l.R) {
    case 1: return launch<1, CLUSTER>(l, rows, st, p);
    case 2: return launch<2, CLUSTER>(l, rows, st, p);
    case 4: return launch<4, CLUSTER>(l, rows, st, p);
    case 8: return launch<8, CLUSTER>(l, rows, st, p);
    case 16: return launch<16, CLUSTER>(l, rows, st, p);
    case 32: return launch<32, CLUSTER>(l, rows, st, p);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// hi, lo and hi + lo of every row of npairs pairs (a_q, b_q), each a
// contiguous (C, n) f32 array; unused pointers may be null.  buf holds
// buf_floats floats: 3 * rows of output (rows = npairs * C; the hi row, the
// lo row, the merged row) followed by each grid launch's scratch,
// 2 * rows * kChunk * B floats.  counters holds kMaxRows int32, all 0, which the
// kernel leaves at 0.  Sets the device only when it is not current.
extern "C" int isph_comp_dots(const void* a0, const void* b0, const void* a1, const void* b1,
                              const void* a2, const void* b2, const void* a3, const void* b3,
                              int npairs, int C, long long n, void* buf, long long buf_floats,
                              void* counters, int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return err;
  if (npairs < 1 || npairs > kMaxPairs || C < 1 || n < 0 ||
      static_cast<long long>(npairs) * C > kMaxRows)
    return cudaErrorInvalidValue;
  const int rows = npairs * C;
  Args p = {{static_cast<const float*>(a0), static_cast<const float*>(a1),
             static_cast<const float*>(a2), static_cast<const float*>(a3)},
            {static_cast<const float*>(b0), static_cast<const float*>(b1),
             static_cast<const float*>(b2), static_cast<const float*>(b3)},
            nullptr, nullptr, n, 0, C, 0, static_cast<float*>(buf), nullptr, nullptr,
            static_cast<int*>(counters)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* scratch = p.out + 3LL * rows;
  const float* end = p.out + buf_floats;
  long long L = 2;
  while (L < n) L *= 2;
  for (bool last = false; !last;) {
    const Launch l = plan(L, rows, last);
    p.L = L;
    p.R2 = l.R2;
    if (!l.cluster && l.B > 1) {
      const long long part = static_cast<long long>(rows) * kChunk * l.B;
      if (scratch + 2 * part > end) return cudaErrorInvalidValue;
      p.out_s = scratch;
      p.out_e = scratch + part;
      scratch += 2 * part;
    }
    err = l.cluster ? dispatch<true>(l, rows, st, p) : dispatch<false>(l, rows, st, p);
    if (err != cudaSuccess) return err;
    p.in_s = p.out_s;
    p.in_e = p.out_e;
    L = static_cast<long long>(kChunk) * l.B;
  }
  return cudaSuccess;
}
