// Phase 0 of the fused pre-norm linear attention as launches of their own,
// for the backward (K4, linear_attention_bwd.cu) and the sequence-parallel
// kernels (K6, linear_attention_sp.cu); K1 (linear_attention.cu) runs its
// own in its single cluster launch:
//   linattn_partials: per-CTA sums A = sum_n p xh^T (H, C) and s = sum_n p
//     over a chunk of N, p = exp2(W_k' xh - kshift') with log2(e)-scaled
//     weights and static shifts (see linear_attention.cu);
//   linattn_context: sums the partials in a fixed order (deterministic),
//     forms ctx = (A W_v^T head-masked) / s and M = W_out^T ctx^T (C, H);
//     the backward also takes ctx (H, 32 per head) and 1/s.
// kRoundCd rounds the matmul operands p and xh to the compute dtype, as the
// forward does; the backward keeps them in float32.
#pragma once

#include "common.cuh"

namespace {

constexpr int kMaxC = 16;
constexpr int kMaxH = 256;
constexpr int kDimHead = 32;

template <typename T, int CB, bool kRoundCd>
__global__ void __launch_bounds__(kMaxH) linattn_partials(
    const T* __restrict__ x, const float* __restrict__ wk, const float* __restrict__ kshift,
    const float* __restrict__ g_pre, float* __restrict__ part, int C, int N, int H,
    int chunk, int nsplit) {
  __shared__ float xn[CB][kMaxH];  // pre-normed tile, float32
  __shared__ float xr[CB][kMaxH];  // the same, rounded to the compute dtype
  const int d = threadIdx.x;  // row of k; the tile is H columns wide
  const int sp = blockIdx.x, b = blockIdx.y;
  const float rs = sqrtf((float)C);

  float w[CB], gp[CB], a[CB];
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    w[c] = c < C ? wk[d * C + c] : 0.0f;
    gp[c] = c < C ? g_pre[c] * rs : 0.0f;
    a[c] = 0.0f;
  }
  const float ks = kshift[d];
  float s = 0.0f;

  const T* xb = x + (size_t)b * C * N;
  const int nbeg = sp * chunk;
  const int nend = min(N, nbeg + chunk);
  for (int t0 = nbeg; t0 < nend; t0 += H) {
    const int n = t0 + d;
    if (n < nend) {
      float v[CB];
      float ss = 0.0f;
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        v[c] = c < C ? dq::to_f32(xb[(size_t)c * N + n]) : 0.0f;
        ss += v[c] * v[c];
      }
      const float den = fmaxf(sqrtf(ss), 1e-12f);
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        if (c >= C) continue;
        const float h = v[c] / den * gp[c];
        xn[c][d] = h;
        xr[c][d] = kRoundCd ? dq::round_cd<T>(h) : h;
      }
    }
    __syncthreads();
    const int cnt = min(H, nend - t0);
    for (int j = 0; j < cnt; ++j) {
      float k = 0.0f;
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c < C) k = fmaf(w[c], xn[c][j], k);
      const float p = exp2f(k - ks);
      s += p;
      const float pr = kRoundCd ? dq::round_cd<T>(p) : p;
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c < C) a[c] = fmaf(pr, xr[c][j], a[c]);
    }
    __syncthreads();
  }
  float* dst = part + (((size_t)b * nsplit + sp) * H + d) * (C + 1);
#pragma unroll
  for (int c = 0; c < CB; ++c)
    if (c < C) dst[c] = a[c];
  dst[C] = s;
}

__global__ void __launch_bounds__(kMaxH) linattn_context(
    const float* __restrict__ part, const float* __restrict__ wv,
    const float* __restrict__ wout, float* __restrict__ m_out, float* __restrict__ ctx_out,
    float* __restrict__ inv_s_out, int C, int H, int nsplit, int round_bf16) {
  __shared__ float wvs[kMaxH * kMaxC];
  __shared__ float wos[kMaxH * kMaxC];
  const int d = threadIdx.x, b = blockIdx.x;
  for (int i = d; i < H * C; i += H) {
    wvs[i] = wv[i];
    wos[i] = wout[i];
  }
  float a[kMaxC], m[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) a[c] = m[c] = 0.0f;
  float s = 0.0f;
  for (int sp = 0; sp < nsplit; ++sp) {
    const float* src = part + (((size_t)b * nsplit + sp) * H + d) * (C + 1);
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < C) a[c] += src[c];
    s += src[C];
  }
  __syncthreads();
  const float inv_s = 1.0f / fmaxf(s, 1e-30f);
  if (inv_s_out) inv_s_out[(size_t)b * H + d] = inv_s;
  const int h0 = (d / kDimHead) * kDimHead;
  for (int e = h0; e < h0 + kDimHead; ++e) {
    float ctx = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < C) ctx = fmaf(a[c], wvs[e * C + c], ctx);
    ctx *= inv_s;
    if (ctx_out) ctx_out[((size_t)b * H + d) * kDimHead + (e - h0)] = ctx;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < C) m[c] = fmaf(wos[e * C + c], ctx, m[c]);
  }
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c >= C) continue;
    const float v = round_bf16 ? __bfloat162float(__float2bfloat16(m[c])) : m[c];
    m_out[((size_t)b * C + c) * H + d] = v;
  }
}

}  // namespace
