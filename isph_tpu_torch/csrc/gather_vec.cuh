// Vector index loads and output stores shared by take.cu and take_band.cu.
//
// A gather copies bits, so both kernels move every element as a word of its
// size: f32 and int32 as uint32_t, f64 as unsigned long long, uint8 and bool
// as uint8_t.  A thread loads V consecutive int32 indices with one vector
// load and writes its V gathered words with one 16-byte store: V = 4 for
// 4-byte words, 16 for bytes, 2 for 8-byte words.  The store is what fixes
// V: neighbouring lanes must write neighbouring 16-byte pieces.  (f64 with
// V = 4, two 16-byte stores a lane 32 bytes apart, ran 1.7-2.8x slower on
// an H100: scripts/gather_variants.py.)  With V = 1 both fall back to
// scalar accesses, for arrays whose length or base address breaks the
// alignment.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace isph_gather {

// Vector width (elements a thread covers per row) and slots in flight per
// thread for a word type; ops/spmv_cuda.py:take_band_plan mirrors both.
template <typename W>
struct Tile;
template <>
struct Tile<uint32_t> {
  static constexpr int V = 4, U = 4;
};
template <>
struct Tile<unsigned long long> {
  static constexpr int V = 2, U = 4;
};
template <>
struct Tile<uint8_t> {
  static constexpr int V = 16, U = 1;
};
constexpr int kScalarU = 16;  // loads in flight on take.cu's scalar (V = 1) path

// j[0..V) = p[0..V); p is aligned to 16 bytes when V % 4 == 0, to 8 when V == 2.
template <int V>
__device__ __forceinline__ void load_idx(int32_t (&j)[V], const int32_t* __restrict__ p) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(p) + q);
      j[4 * q] = t.x;
      j[4 * q + 1] = t.y;
      j[4 * q + 2] = t.z;
      j[4 * q + 3] = t.w;
    }
  } else if constexpr (V == 2) {
    const int2 t = __ldg(reinterpret_cast<const int2*>(p));
    j[0] = t.x;
    j[1] = t.y;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) j[v] = __ldg(p + v);
  }
}

// p[0..V) = w[0..V); p is 16-byte aligned when V * sizeof(W) % 16 == 0.
template <typename W, int V>
__device__ __forceinline__ void store_vec(W* __restrict__ p, const W (&w)[V]) {
  constexpr int kBytes = V * static_cast<int>(sizeof(W));
  if constexpr (kBytes % 16 == 0) {
    uint32_t u[kBytes / 4];
#pragma unroll
    for (int q = 0; q < kBytes / 4; ++q) {
      if constexpr (sizeof(W) == 1) {
        u[q] = static_cast<uint32_t>(w[4 * q]) | static_cast<uint32_t>(w[4 * q + 1]) << 8 |
               static_cast<uint32_t>(w[4 * q + 2]) << 16 |
               static_cast<uint32_t>(w[4 * q + 3]) << 24;
      } else if constexpr (sizeof(W) == 4) {
        u[q] = static_cast<uint32_t>(w[q]);
      } else {  // 8-byte words, little-endian halves
        u[q] = static_cast<uint32_t>(w[q / 2] >> (32 * (q % 2)));
      }
    }
#pragma unroll
    for (int q = 0; q < kBytes / 16; ++q) {
      reinterpret_cast<uint4*>(p)[q] = make_uint4(u[4 * q], u[4 * q + 1], u[4 * q + 2],
                                                  u[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = w[v];
  }
}

}  // namespace isph_gather
