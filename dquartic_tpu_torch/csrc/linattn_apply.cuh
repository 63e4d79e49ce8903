// The per-column apply pass of the fused pre-norm linear attention as a
// launch of its own, for K6b (linear_attention_sp.cu; K1 runs its own in
// its single cluster launch, linear_attention.cu): given the
// folded context M = W_out^T ctx^T (C x H) of each row, one thread per
// column computes q, the per-head softmax with the static shift and
// y = RMSNorm_g(M q + b_out) + x (see linear_attention.cu).
#pragma once

#include "linattn_common.cuh"

namespace {

constexpr int kApplyThreads = 128;

template <typename T, int CB>
__global__ void __launch_bounds__(kApplyThreads) linattn_apply(
    const T* __restrict__ x, const float* __restrict__ wq, const float* __restrict__ qshift,
    const float* __restrict__ g_pre, const float* __restrict__ m_in,
    const float* __restrict__ b_out, const float* __restrict__ g, T* __restrict__ y, int C,
    int N, int heads) {
  __shared__ float wqs[kMaxH * CB];
  __shared__ float ms[CB * kMaxH];
  __shared__ float qs[kMaxH];
  const int H = heads * kDimHead;
  const int b = blockIdx.y;
  const int n = blockIdx.x * kApplyThreads + threadIdx.x;
  for (int i = threadIdx.x; i < H * C; i += kApplyThreads) {
    wqs[i] = wq[i];
    ms[i] = m_in[(size_t)b * C * H + i];
  }
  for (int i = threadIdx.x; i < H; i += kApplyThreads) qs[i] = qshift[i];
  __syncthreads();
  if (n >= N) return;

  const float rs = sqrtf((float)C);
  const float dh_scale = 0.17677669529663687f;  // 32 ** -0.5
  const T* xb = x + (size_t)b * C * N + n;
  float xraw[CB], xh[CB], acc[CB];
  float ss = 0.0f;
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    xraw[c] = c < C ? dq::to_f32(xb[(size_t)c * N]) : 0.0f;
    ss += xraw[c] * xraw[c];
    acc[c] = 0.0f;
  }
  const float den = fmaxf(sqrtf(ss), 1e-12f);
#pragma unroll
  for (int c = 0; c < CB; ++c) xh[c] = c < C ? xraw[c] / den * (g_pre[c] * rs) : 0.0f;

  for (int h = 0; h < heads; ++h) {
    float e[kDimHead];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kDimHead; ++i) {
      const int d = h * kDimHead + i;
      float q = 0.0f;
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c < C) q = fmaf(wqs[d * C + c], xh[c], q);
      e[i] = exp2f(q - qs[d]);
      sum += e[i];
    }
    const float inv = 1.0f / fmaxf(sum, 1e-30f);
#pragma unroll
    for (int i = 0; i < kDimHead; ++i) {
      const int d = h * kDimHead + i;
      const float qn = dq::round_cd<T>(e[i] * inv * dh_scale);
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c < C) acc[c] = fmaf(ms[c * H + d], qn, acc[c]);
    }
  }
  float ss2 = 0.0f;
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    acc[c] = c < C ? acc[c] + b_out[c] : 0.0f;
    ss2 += acc[c] * acc[c];
  }
  const float den2 = fmaxf(sqrtf(ss2), 1e-12f);
  T* yb = y + (size_t)b * C * N + n;
#pragma unroll
  for (int c = 0; c < CB; ++c)
    if (c < C) yb[(size_t)c * N] = dq::from_f32<T>(acc[c] / den2 * g[c] * rs + xraw[c]);
}

}  // namespace
