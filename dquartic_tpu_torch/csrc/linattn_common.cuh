// The weights and the slices of the pre-norm linear-attention kernels,
// shared by K1 (linear_attention.cu) and K4 (linear_attention_bwd.cu): the
// weights as the caller holds them, and a CTA's slice of a (B, C, N)
// tensor staged in shared memory or read from device memory.
#pragma once

#include "mma.cuh"

namespace {

// The op's weights as the caller holds them: w_qkv (C, 3H), w_out (H, C),
// b_out, g, g_pre (C), each float32 or bf16 (bit i of `bf16`, in this
// order), read through their strides.
struct Weights {
  const void* wqkv;
  long long wqkv_c, wqkv_h;
  const void* wout;
  long long wout_h, wout_c;
  const void* b_out;
  long long b_out_c;
  const void* g;
  long long g_c;
  const void* g_pre;
  long long g_pre_c;
  int bf16;
};

__device__ __forceinline__ float ld(const void* p, long long i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// x of this CTA's slice: staged rows in shared memory, or device memory.
template <typename T>
struct Slice {
  const char* xs;   // staged row 0 (already shifted to the source's phase)
  int row_bytes;
  const T* xg;      // x[b, 0, nbeg] in device memory
  long long N;
  bool staged;
  __device__ __forceinline__ float at(int c, int j) const {
    return dq::to_f32(staged ? reinterpret_cast<const T*>(xs + c * row_bytes)[j]
                             : xg[c * N + j]);
  }
};

// Copies `cols` elements of each of the C rows (stride N) at src into
// shared rows of stride row_bytes at dst, which has src's phase mod 16:
// 16-byte cp.async for the aligned middle, plain copies at the ends.
template <typename T>
__device__ void stage_rows(char* dst, int row_bytes, const T* src, long long N, int C,
                           int cols) {
  constexpr int kVec = 16 / sizeof(T);
  for (int c = 0; c < C; ++c) {
    const T* s = src + c * N;
    T* d = reinterpret_cast<T*>(dst + c * row_bytes);
    const int head = min(cols, (int)(((16 - (reinterpret_cast<uintptr_t>(s) & 15)) & 15) /
                                     sizeof(T)));
    const int nvec = (cols - head) / kVec;
    for (int i = threadIdx.x; i < nvec; i += blockDim.x)
      cp_async16(d + head + i * kVec, s + head + i * kVec);
    const int tail0 = head + nvec * kVec;
    for (int i = threadIdx.x; i < head + cols - tail0; i += blockDim.x) {
      const int j = i < head ? i : tail0 + i - head;
      d[j] = s[j];
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

}  // namespace
