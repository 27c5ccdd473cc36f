// The neighbor search on Hopper (sm_90a), hand-written CUDA C++: the
// candidate search of isph_tpu_torch/ops/neighbors.py:build_neighbor_list
// after its binning, one launch a build.
//
// Replaces no Pallas kernel.  The JAX package leaves the search to XLA
// (isph_tpu/ops/neighbors.py:build_neighbor_list): every row gathers all
// Q * cap slots of its 3^D (or 5^D) cell neighborhood, sentinels included,
// tests them with ~25 elementwise passes and keeps the K smallest columns
// with top_k.  At TGV-64^3 Quintic (Q = 125, cap = 40) that is 5,000 slots a
// row, of which ~1,500 are particles and ~390 neighbors.
//
// Bound on this card: the least work is ~0.4 G distance tests on real
// candidates (~25 flops each, ~0.15 ms at the card's f32 rate) and one write
// of idx (K, N) int32, mask (K, N) bool and count (N,) int32 (535 MB at
// 64^3, 0.16 ms at 3.35 TB/s), so the writes bound it; positions and the
// bucket table are read once a cell and stay in L2.  Measured on the H100
// at 64^3 (3.8 ms): the tests take ~2.1 ms, the slot writes ~1.7 (a warp's
// 32 slots of one row are 32 rows of (K, N)), the sort no measurable time;
// writing (N, K) and transposing after took 5.1 ms.
//
// Design.  One block per cell (kWarps warps): every row of a cell shares one
// candidate union, the non-sentinel entries of the bucket table's rows of
// the cell's neighborhood (each at most cap entries, so the union is at most
// Q * cap). The block loads the union's column indices into shared memory,
// sorts them once (bitonic, ascending), then loads their positions beside
// them.  One warp a row: it tests 32 candidates at a time in column order
// and compacts the good ones (j != i, rsq < cutoff^2) in order with a ballot
// and popcount into slots 0..K-1 of its column of idx; past K it stops
// writing and goes on counting.  The row then pads slots count..K-1 with its
// last neighbor (itself when it has none).  So idx, mask, count and overflow
// are the plain version's (neighbors.py:_compact_rows), whose top_k keeps
// each row's K smallest good columns in ascending order.
//
// rsq is the plain version's bits as PyTorch computes them on this card:
// r = x_i - x_j; on a periodic axis r - L * rint(r * (1 / L)) (a CUDA
// tensor divided by a Python scalar is multiplied by the scalar's
// reciprocal, rounded in the positions' type; rint rounds half to even as
// torch.round); the squares summed over the axes in order; every operation
// rounded on its own (the intrinsics below, no contraction), and compared
// with cutoff^2 rounded to the positions' type.
//
// A union larger than the block's tile (``tile`` entries of shared memory,
// chosen by the wrapper from the mean particles a cell) goes in tiles by
// column range: a bisection on the column value finds the largest bound
// whose remaining entries fit, every bucket row being sorted (the binning's
// sort is stable); each row carries its count and last neighbor from tile
// to tile in count and idx.  The parked cell (index ncells, invalid
// particles) has rows of no neighbors; up to kParkBlocks blocks past the
// cells write them.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// warps a block: on the H100 4 built the 1M cell's list in 1.20 ms against
// 1.68 / 2.17 / 2.76 ms at 8 / 12 / 16, and 64^3's within 1.5% of the
// fastest (8); small blocks keep more cells in flight
constexpr int kWarps = 4;
constexpr int kParkBlocks = 1024;  // most blocks past the cells for the parked rows
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Args {
  const T* x;            // (dim, n) wrapped positions
  const int32_t* table;  // (ncells + 1, cap), sentinel n
  const int32_t* order;  // (n,) particles sorted by cell (stable)
  const int32_t* start;  // (ncells + 1,) each cell's first slot in order
  int32_t* idx;          // (K, n)
  uint8_t* mask;         // (K, n)
  int32_t* count;        // (n,)
  int n, K, cap, ncells, Q, tile, park_blocks;
  int ncell[3], stride[3], off_lo[3], off_n[3], periodic[3];
  T len[3], inv_len[3], cut2;
};

template <typename T>
__device__ __forceinline__ T sub_rn(T a, T b);
template <>
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
template <>
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T>
__device__ __forceinline__ T mul_rn(T a, T b);
template <>
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
template <>
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__device__ __forceinline__ T add_rn(T a, T b);
template <>
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
template <>
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ float round_even(float a) { return rintf(a); }
__device__ __forceinline__ double round_even(double a) { return rint(a); }

// the element of slot k of row i in the (K, n) outputs
__device__ __forceinline__ int64_t slot_at(int k, int i, int n, int K) {
  return static_cast<int64_t>(k) * n + i;
}

// the sum of v over the block; every thread gets it
__device__ int block_sum(int v, int* slot) {
  v = __reduce_add_sync(kFull, v);
  __syncthreads();  // the last reader of *slot is done
  if (threadIdx.x == 0) *slot = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0 && v != 0) atomicAdd(slot, v);
  __syncthreads();
  return *slot;
}

// the first position p in [lo, hi) of the sorted row with row[p] > v
__device__ __forceinline__ int bucket_upper_bound(const int32_t* __restrict__ row, int lo,
                                                  int hi, int v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) <= v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32) neighbor_search_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_sum;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = a.n, K = a.K;

  if (static_cast<int>(blockIdx.x) >= a.ncells) {
    // parked (invalid) particles: no neighbors, every slot the row itself
    const int first = __ldg(a.start + a.ncells);
    const int pb = blockIdx.x - a.ncells;
    for (int r = first + pb * kWarps + warp; r < n; r += a.park_blocks * kWarps) {
      const int i = __ldg(a.order + r);
      for (int k = lane; k < K; k += 32) {
        a.idx[slot_at(k, i, n, K)] = i;
        a.mask[slot_at(k, i, n, K)] = 0;
      }
      if (lane == 0) a.count[i] = 0;
    }
    return;
  }
  const int c = blockIdx.x;
  const int rbeg = __ldg(a.start + c), rend = __ldg(a.start + c + 1);
  if (rbeg == rend) return;

  T* pos = reinterpret_cast<T*>(smem);  // (D, tile)
  int* keys = reinterpret_cast<int*>(pos + D * a.tile);  // (tile,)
  int* qcell = keys + a.tile;  // (Q,) bucket row of each neighbor cell
  int* qlen = qcell + a.Q;     // (Q,) its entries
  int* qlo = qlen + a.Q;       // (Q,) its first entry not yet loaded
  int* qoff = qlo + a.Q;       // (Q + 1,) the tile's entries of each, then their offsets

  int cc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) cc[d] = (c / a.stride[d]) % a.ncell[d];
  int mine = 0;
  for (int q = tid; q < a.Q; q += blockDim.x) {
    int rem = q, flat = 0;
    bool in = true;
#pragma unroll
    for (int d = D - 1; d >= 0; --d) {
      int v = cc[d] + a.off_lo[d] + rem % a.off_n[d];
      rem /= a.off_n[d];
      if (a.periodic[d]) {
        v %= a.ncell[d];
        if (v < 0) v += a.ncell[d];
      } else if (v < 0 || v >= a.ncell[d]) {
        in = false;
      }
      flat += v * a.stride[d];
    }
    const int len = in ? min(__ldg(a.start + flat + 1) - __ldg(a.start + flat), a.cap) : 0;
    qcell[q] = in ? flat : 0;
    qlen[q] = len;
    qlo[q] = 0;
    mine += len;
  }
  const int total = block_sum(mine, &s_sum);

  int done = 0, prev = -1;
  for (bool first = true;; first = false) {
    const bool last = total - done <= a.tile;
    int hi = INT_MAX;
    if (!last) {
      // the largest bound hi with at most tile entries in (prev, hi]
      int lo = prev, top = n - 1;
      while (top - lo > 1) {
        const int mid = lo + ((top - lo) >> 1);
        int cnt = 0;
        for (int q = tid; q < a.Q; q += blockDim.x) {
          const int32_t* row = a.table + static_cast<int64_t>(qcell[q]) * a.cap;
          cnt += bucket_upper_bound(row, qlo[q], qlen[q], mid) - qlo[q];
        }
        if (block_sum(cnt, &s_sum) <= a.tile) {
          lo = mid;
        } else {
          top = mid;
        }
      }
      hi = lo;
    }
    for (int q = tid; q < a.Q; q += blockDim.x) {
      const int32_t* row = a.table + static_cast<int64_t>(qcell[q]) * a.cap;
      const int end = last ? qlen[q] : bucket_upper_bound(row, qlo[q], qlen[q], hi);
      qoff[q] = end - qlo[q];
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of qoff
      int carry = 0;
      for (int base = 0; base < a.Q; base += 32) {
        const int q = base + lane;
        const int v = q < a.Q ? qoff[q] : 0;
        int incl = v;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += t;
        }
        if (q < a.Q) qoff[q] = carry + incl - v;
        carry += __shfl_sync(kFull, incl, 31);
      }
      if (lane == 0) qoff[a.Q] = carry;
    }
    __syncthreads();
    const int m = qoff[a.Q];
    int P = 1;
    while (P < m) P <<= 1;
    for (int e = tid; e < P; e += blockDim.x) {
      int key = INT_MAX;
      if (e < m) {
        int lo = 0, top = a.Q;  // the last q with qoff[q] <= e
        while (top - lo > 1) {
          const int mid = (lo + top) >> 1;
          if (qoff[mid] <= e) {
            lo = mid;
          } else {
            top = mid;
          }
        }
        key = __ldg(a.table + static_cast<int64_t>(qcell[lo]) * a.cap + qlo[lo] + e - qoff[lo]);
      }
      keys[e] = key;
    }
    __syncthreads();
    for (int k = 2; k <= P; k <<= 1) {  // bitonic sort, ascending
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int t = tid; t < (P >> 1); t += blockDim.x) {
          const int l = 2 * t - (t & (j - 1));
          const int u = l + j;
          const int kl = keys[l], ku = keys[u];
          if ((kl > ku) == ((l & k) == 0)) {
            keys[l] = ku;
            keys[u] = kl;
          }
        }
        __syncthreads();
      }
    }
    for (int e = tid; e < m; e += blockDim.x) {
      const int j = keys[e];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        pos[d * a.tile + e] = __ldg(a.x + static_cast<int64_t>(d) * n + j);
      }
    }
    for (int q = tid; q < a.Q; q += blockDim.x) qlo[q] += qoff[q + 1] - qoff[q];
    __syncthreads();

    for (int r = rbeg + warp; r < rend; r += kWarps) {
      const int i = __ldg(a.order + r);
      T xi[D];
#pragma unroll
      for (int d = 0; d < D; ++d) xi[d] = __ldg(a.x + static_cast<int64_t>(d) * n + i);
      int cnt = 0, lastv = i;
      if (!first) {  // carried from the previous tile, written by this warp
        cnt = a.count[i];
        if (cnt > 0) lastv = a.idx[slot_at(min(cnt, K) - 1, i, n, K)];
      }
      for (int base = 0; base < m; base += 32) {
        const int e = base + lane;
        bool good = false;
        int j = 0;
        if (e < m) {
          j = keys[e];
          T rsq = T(0);
#pragma unroll
          for (int d = 0; d < D; ++d) {
            T r1 = sub_rn(xi[d], pos[d * a.tile + e]);
            if (a.periodic[d]) {
              r1 = sub_rn(r1, mul_rn(a.len[d], round_even(mul_rn(r1, a.inv_len[d]))));
            }
            const T sq = mul_rn(r1, r1);
            rsq = d == 0 ? sq : add_rn(rsq, sq);
          }
          good = j != i && rsq < a.cut2;
        }
        const unsigned b = __ballot_sync(kFull, good);
        if (b == 0) continue;
        const int slot = cnt + __popc(b & ((1u << lane) - 1u));
        const bool keep = good && slot < K;
        if (keep) {
          a.idx[slot_at(slot, i, n, K)] = j;
          a.mask[slot_at(slot, i, n, K)] = 1;
        }
        const unsigned kb = __ballot_sync(kFull, keep);
        if (kb != 0) lastv = __shfl_sync(kFull, j, 31 - __clz(kb));
        cnt += __popc(b);
      }
      if (last) {
        for (int k = min(cnt, K) + lane; k < K; k += 32) {
          a.idx[slot_at(k, i, n, K)] = lastv;
          a.mask[slot_at(k, i, n, K)] = 0;
        }
      }
      if (lane == 0) a.count[i] = cnt;
    }
    if (last) break;
    done += m;
    prev = hi;
    __syncthreads();  // the rows are done with keys and pos
  }
}

template <typename T>
size_t smem_bytes(int dim, int tile, int Q) {
  return static_cast<size_t>(tile) * (dim * sizeof(T) + sizeof(int)) +
         static_cast<size_t>(4 * Q + 1) * sizeof(int);
}

template <typename T, int D>
cudaError_t launch(const Args<T>& a, cudaStream_t s) {
  const size_t smem = smem_bytes<T>(D, a.tile, a.Q);
  auto kernel = neighbor_search_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned grid = static_cast<unsigned>(a.ncells) + static_cast<unsigned>(a.park_blocks);
  kernel<<<grid, kWarps * 32, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t search(int dim, const void* x, const void* table, const void* order,
                   const void* start, void* idx, void* mask, void* count, int n, int K,
                   int cap, int ncells, const int* ncell, const int* off_lo, const int* off_n,
                   const int* periodic, const double* len, const double* inv_len,
                   double cut2, int tile, cudaStream_t s) {
  Args<T> a;
  a.x = static_cast<const T*>(x);
  a.table = static_cast<const int32_t*>(table);
  a.order = static_cast<const int32_t*>(order);
  a.start = static_cast<const int32_t*>(start);
  a.idx = static_cast<int32_t*>(idx);
  a.mask = static_cast<uint8_t*>(mask);
  a.count = static_cast<int32_t*>(count);
  a.n = n;
  a.K = K;
  a.cap = cap;
  a.ncells = ncells;
  a.tile = tile;
  a.park_blocks = static_cast<int>(std::min<int64_t>(kParkBlocks, (n + kWarps - 1) / kWarps));
  a.Q = 1;
  int stride = 1;
  for (int d = 2; d >= 0; --d) {
    const bool on = d < dim;
    a.ncell[d] = on ? ncell[d] : 1;
    a.stride[d] = stride;
    stride *= a.ncell[d];
    a.off_lo[d] = on ? off_lo[d] : 0;
    a.off_n[d] = on ? off_n[d] : 1;
    a.periodic[d] = on ? periodic[d] : 0;
    a.len[d] = static_cast<T>(on ? len[d] : 1.0);
    a.inv_len[d] = static_cast<T>(on ? inv_len[d] : 1.0);
    a.Q *= a.off_n[d];
  }
  a.cut2 = static_cast<T>(cut2);
  return dim == 2 ? launch<T, 2>(a, s) : launch<T, 3>(a, s);
}

}  // namespace

// The search of one build: idx (K, n) int32, mask (K, n) bool and count (n,)
// from the wrapped positions x (dim, n), the bucket table, the particles in
// cell order and each cell's start.  dtype 0 = f32, 1 = f64; dim 2 or 3;
// the per-axis arrays hold dim entries; len, inv_len and cut2 are values of
// the positions' type.
extern "C" int isph_neighbor_search(int dtype, int dim, const void* x, const void* table,
                                    const void* order, const void* start, void* idx,
                                    void* mask, void* count, int n, int K, int cap,
                                    int ncells, const int* ncell, const int* off_lo,
                                    const int* off_n, const int* periodic, const double* len,
                                    const double* inv_len, double cut2, int tile, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((dim != 2 && dim != 3) || tile < 1 || K < 1 || cap < 1 || ncells < 1) {
    return cudaErrorInvalidValue;
  }
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return search<float>(dim, x, table, order, start, idx, mask, count, n, K, cap, ncells,
                           ncell, off_lo, off_n, periodic, len, inv_len, cut2, tile, s);
    case 1:
      return search<double>(dim, x, table, order, start, idx, mask, count, n, K, cap, ncells,
                            ncell, off_lo, off_n, periodic, len, inv_len, cut2, tile, s);
    default:
      return cudaErrorInvalidValue;
  }
}
