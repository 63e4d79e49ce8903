// The operands of the fused ResnetBlock kernels, shared by K2
// (fused_resnet.cu) and K5 (fused_resnet_bwd.cu): the ten parameters as the
// caller holds them, each in its own dtype through its strides, and the
// staging of a row window of x (or dy) in shared memory.
#pragma once

#include "mma.cuh"

namespace {

constexpr int kMaxCin = 32;
constexpr int kMaxCout = 16;

// Bits of `flags`.
constexpr int kFilm = 1, kRes = 2, kResBias = 4;
// Bits of `bits`: the operand is bf16 (else float32).
enum Operand { kW1, kB1, kG1, kScale, kShift, kW2, kB2, kG2, kWRes, kBRes };

struct Params {
  const void* w1; long long w1_k, w1_i, w1_o;  // (3, C_in, C_out)
  const void* b1; long long b1_o;
  const void* g1; long long g1_o;
  const void* scale; long long scale_b, scale_o;  // (B, C_out)
  const void* shift; long long shift_b, shift_o;
  const void* w2; long long w2_k, w2_i, w2_o;  // (3, C_out, C_out)
  const void* b2; long long b2_o;
  const void* g2; long long g2_o;
  const void* w_res; long long wr_i, wr_o;  // (1, C_in, C_out)
  const void* b_res; long long br_o;
  int c_in, c_out, N, flags, bits;
};

__device__ __forceinline__ float ld(const void* p, long long i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// V elements of T as one load or store of V * sizeof(T) bytes.
template <int Bytes> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<32> { struct type { uint4 a, b; }; };
template <typename T, int V>
using RawOf = typename Raw<V * sizeof(T)>::type;

// w[j] = row[j0 - 1 + j], j = 0 .. V + 1, as floats; row + j0 is aligned to
// V elements.
template <typename T, int V>
__device__ __forceinline__ void load_window(const T* row, int j0, float (&w)[V + 2]) {
  const RawOf<T, V> r = *reinterpret_cast<const RawOf<T, V>*>(row + j0);
  const T* v = reinterpret_cast<const T*>(&r);
  w[0] = dq::to_f32(row[j0 - 1]);
#pragma unroll
  for (int j = 0; j < V; ++j) w[j + 1] = dq::to_f32(v[j]);
  w[V + 1] = dq::to_f32(row[j0 + V]);
}

// SiLU v sigmoid(v) with the fast exponential and reciprocal (MUFU.EX2,
// MUFU.RCP; ~1e-6 relative): the function K5 differentiates when it
// recomputes this forward.
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

// Copies channels 0 .. CI - 1 of a row (c_in channels of N columns at
// src) over the columns [col0, col0 + XR) into xs (rows of XR elements),
// zero outside [0, N) and past c_in: 16-byte cp.async where the row is
// 16-byte aligned (N a multiple of 16 bytes of elements), plain copies
// otherwise. The caller commits and waits for the group.
template <typename T, int CI, int XR>
__device__ __forceinline__ void stage_window(T* xs, const T* src, int c_in, int N, int col0) {
  constexpr int P = 16 / sizeof(T);
  constexpr int kChunks = XR / P;
  const bool vec16 = N % P == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  for (int i = threadIdx.x; i < CI * kChunks; i += blockDim.x) {
    const int c = i / kChunks, col = col0 + (i % kChunks) * P;
    T* dst = xs + c * XR + (i % kChunks) * P;
    if (vec16) {
      const bool in = c < c_in && col >= 0 && col < N;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                   "l"(in ? src + (size_t)c * N + col : src), "r"(in ? 16 : 0));
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int pos = col + j;
        dst[j] = c < c_in && pos >= 0 && pos < N ? src[(size_t)c * N + pos] : T(0.0f);
      }
    }
  }
}

}  // namespace
