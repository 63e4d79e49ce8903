// Tile shapes and helpers shared by the float32 K7a (flash_attention.cu;
// its bf16 body runs on tensor cores) and K7b (flash_attention_bwd.cu).
// Both map one head row (d = 32) onto the 32 lanes of a warp: a score is
// computed by the lane that owns a kv (or q) row of the tile, and a
// 32-wide output row by the warp, one feature per lane, with the weights
// broadcast by warp shuffles. Operands are float32 in shared memory
// whatever the input dtype; padded rows are zero.
#pragma once

#include "common.cuh"

namespace {

constexpr int kD = 32;                     // head dim
constexpr int kPad = kD + 1;               // row stride of tiles read one row per lane
constexpr int kBlock = 64;                 // rows of a q block and of a kv tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlock / kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;          // masked score, as the JAX kernel

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Copies rows [r0, r0 + kBlock) of a (rows, kD) matrix into a float32
// shared tile of row stride S, zero past `rows`. Coalesced: consecutive
// threads read consecutive elements.
template <typename T, int S>
__device__ __forceinline__ void load_tile(float (*dst)[S], const T* __restrict__ src, int r0,
                                          int rows) {
  for (int i = threadIdx.x; i < kBlock * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    dst[r][c] = r0 + r < rows ? dq::to_f32(src[(size_t)(r0 + r) * kD + c]) : 0.0f;
  }
}

// Dot product of a broadcast row `a` (every lane reads the same address)
// with the row `b` that this lane owns.
__device__ __forceinline__ float dot_row(const float* a, const float* b) {
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < kD; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

}  // namespace
