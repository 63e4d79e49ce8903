// The per-column passes of the backward of the fused pre-norm linear
// attention, shared by K4 (linear_attention_bwd.cu, where the passes and
// their derivation are described) and K6c (linear_attention_sp.cu):
//   la_bwd_q   per column: q, qn, u, du, dq; dx_q; partials of Z, dW_q, db, dg
//   la_bwd_ctx per row: dctx, D2, dW_out from Z and ctx
//   la_bwd_k   per column: partials of T, dW_k', bmat
//   la_bwd_x   per column: dx from dx_q, D2 and T; partials of dg_pre
#pragma once

#include "linattn_phase0.cuh"

namespace {

constexpr int kThreads = 128;      // columns per tile = threads per CTA
constexpr int kPitch = kThreads + 1;  // padded row of a staged head tile
constexpr float kDhScale = 0.17677669529663687f;  // 32 ** -0.5

// Loads column n of x, returns the raw values, 1 / max(|x|, 1e-12), and the
// pre-normed xh = x / |x| * g_pre * sqrt(C) (zeros when !valid).
template <typename T, int CB>
__device__ __forceinline__ void load_col(const T* __restrict__ xb, int n, int N, int C,
                                         bool valid, const float* gp, float* xraw,
                                         float* xh, float& inv_r) {
  float ss = 0.0f;
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    xraw[c] = (valid && c < C) ? dq::to_f32(xb[(size_t)c * N + n]) : 0.0f;
    ss += xraw[c] * xraw[c];
  }
  inv_r = 1.0f / fmaxf(sqrtf(ss), 1e-12f);
#pragma unroll
  for (int c = 0; c < CB; ++c) xh[c] = xraw[c] * inv_r * gp[c];
}

// Adds the tile's outer products of one head to the CTA accumulators:
// acc1[d][c] += sum_k p1[dl][k] v1[c][k], acc2[d][c] += sum_k p2[dl][k] v2[c][k]
// (and accr[d] += sum_k p1[dl][k] when accr is given), for the rows
// d = h0 + dl. Thread (dl = tid % 32, cg = tid / 32) owns channels cg + 4 j.
template <int CB>
__device__ __forceinline__ void reduce_head(const float* p1, const float* v1, const float* p2,
                                            const float* v2, float* acc1, float* acc2,
                                            float* accr, int h0, int C) {
  const int dl = threadIdx.x & 31, cg = threadIdx.x >> 5;
  const int d = h0 + dl;
#pragma unroll
  for (int j = 0; j < CB / 4; ++j) {
    const int c = cg + 4 * j;
    if (c >= C) continue;
    float s1 = 0.0f, s2 = 0.0f;
    for (int k = 0; k < kThreads; ++k) {
      s1 = fmaf(p1[dl * kPitch + k], v1[c * kThreads + k], s1);
      s2 = fmaf(p2[dl * kPitch + k], v2[c * kThreads + k], s2);
    }
    acc1[d * C + c] += s1;
    acc2[d * C + c] += s2;
  }
  if (accr != nullptr && cg == 0) {
    float s = 0.0f;
    for (int k = 0; k < kThreads; ++k) s += p1[dl * kPitch + k];
    accr[d] += s;
  }
}

// Sums per-thread channel values red[c][tid] over the CTA in a fixed order
// into dst[c] (times scale).
__device__ __forceinline__ void reduce_channels(const float* red, float* dst, int C, float scale) {
  if ((int)threadIdx.x < C) {
    float s = 0.0f;
    for (int k = 0; k < kThreads; ++k) s += red[threadIdx.x * kThreads + k];
    dst[threadIdx.x] = s * scale;
  }
}

size_t smem_q(int H, int C, int CB) {
  return sizeof(float) * (4 * (size_t)H * C + H + 2 * 32 * kPitch + 2 * CB * kThreads);
}

// Pass 2. Partials part_q[b][sp] = Z (H x C) | dW_q (H x C, [d][c]) | db | dg.
template <typename T, int CB>
__global__ void __launch_bounds__(kThreads) la_bwd_q(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ wq,
    const float* __restrict__ m_in, const float* __restrict__ qshift,
    const float* __restrict__ b_out, const float* __restrict__ g,
    const float* __restrict__ g_pre, float* __restrict__ dxq, float* __restrict__ part_q,
    int C, int N, int heads, int chunk, int nsplit) {
  extern __shared__ float smem[];
  const int H = heads * kDimHead;
  float* wq_s = smem;                  // [d][c]
  float* m_s = wq_s + H * C;           // [c][d]
  float* acc1 = m_s + H * C;           // Z [d][c]
  float* acc2 = acc1 + H * C;          // dW_q [d][c]
  float* qs_s = acc2 + H * C;
  float* p1 = qs_s + H;                // qn of one head [32][kPitch]
  float* p2 = p1 + 32 * kPitch;        // dq of one head
  float* v1 = p2 + 32 * kPitch;        // du [CB][kThreads]
  float* v2 = v1 + CB * kThreads;      // xh [CB][kThreads]
  const int tid = threadIdx.x, sp = blockIdx.x, b = blockIdx.y;
  for (int i = tid; i < H * C; i += kThreads) {
    wq_s[i] = wq[i];
    m_s[i] = m_in[(size_t)b * C * H + i];
    acc1[i] = acc2[i] = 0.0f;
  }
  for (int i = tid; i < H; i += kThreads) qs_s[i] = qshift[i];
  const float rs = sqrtf((float)C);
  float gp[CB], gg[CB], bo[CB], db_acc[CB], dg_acc[CB];
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    gp[c] = c < C ? g_pre[c] * rs : 0.0f;
    gg[c] = c < C ? g[c] * rs : 0.0f;
    bo[c] = c < C ? b_out[c] : 0.0f;
    db_acc[c] = dg_acc[c] = 0.0f;
  }
  __syncthreads();

  const T* xb = x + (size_t)b * C * N;
  const T* dyb = dy + (size_t)b * C * N;
  const int nbeg = sp * chunk, nend = min(N, nbeg + chunk);
  for (int t0 = nbeg; t0 < nend; t0 += kThreads) {
    const int n = t0 + tid;
    const bool valid = n < nend;
    float xraw[CB], xh[CB], dyv[CB], u[CB], du[CB], dxacc[CB], inv_r;
    load_col<T, CB>(xb, n, N, C, valid, gp, xraw, xh, inv_r);
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      dyv[c] = (valid && c < C) ? dq::to_f32(dyb[(size_t)c * N + n]) : 0.0f;
      u[c] = bo[c];
      dxacc[c] = 0.0f;
    }
    // u = M qn + b
    for (int h = 0; h < heads; ++h) {
      float e[kDimHead];
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < kDimHead; ++i) {
        const int d = h * kDimHead + i;
        float q = 0.0f;
#pragma unroll
        for (int c = 0; c < CB; ++c)
          if (c < C) q = fmaf(wq_s[d * C + c], xh[c], q);
        e[i] = expf(q - qs_s[d]);
        sum += e[i];
      }
      const float inv = kDhScale / fmaxf(sum, 1e-30f);
#pragma unroll
      for (int i = 0; i < kDimHead; ++i) {
        const int d = h * kDimHead + i;
#pragma unroll
        for (int c = 0; c < CB; ++c)
          if (c < C) u[c] = fmaf(m_s[c * H + d], e[i] * inv, u[c]);
      }
    }
    // output RMSNorm backward
    float ss = 0.0f;
#pragma unroll
    for (int c = 0; c < CB; ++c) ss += u[c] * u[c];
    const float inv_n = 1.0f / fmaxf(sqrtf(ss), 1e-12f);
    float inner = 0.0f;
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      const float yh = u[c] * inv_n;
      dg_acc[c] = fmaf(dyv[c], yh, dg_acc[c]);
      inner = fmaf(dyv[c] * gg[c], yh, inner);
    }
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      du[c] = (dyv[c] * gg[c] - u[c] * inv_n * inner) * inv_n;
      db_acc[c] += du[c];
      if (c < C) {
        v1[c * kThreads + tid] = du[c];
        v2[c * kThreads + tid] = xh[c];
      }
    }
    // per head: dqn = M^T du, the head-softmax backward, dx_q, and the
    // tile's Z / dW_q outer products
    for (int h = 0; h < heads; ++h) {
      float qn[kDimHead], dqn[kDimHead];
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < kDimHead; ++i) {
        const int d = h * kDimHead + i;
        float q = 0.0f;
#pragma unroll
        for (int c = 0; c < CB; ++c)
          if (c < C) q = fmaf(wq_s[d * C + c], xh[c], q);
        qn[i] = expf(q - qs_s[d]);
        sum += qn[i];
      }
      const float inv = kDhScale / fmaxf(sum, 1e-30f);
      float tq = 0.0f;
#pragma unroll
      for (int i = 0; i < kDimHead; ++i) {
        const int d = h * kDimHead + i;
        qn[i] *= inv;
        float v = 0.0f;
#pragma unroll
        for (int c = 0; c < CB; ++c)
          if (c < C) v = fmaf(m_s[c * H + d], du[c], v);
        dqn[i] = v;
        tq = fmaf(qn[i], v, tq);
      }
      // dq = p (dqn dh^-1/2 - <dqn, qn>), p = qn dh^1/2
      const float t_scaled = tq / kDhScale;
#pragma unroll
      for (int i = 0; i < kDimHead; ++i) {
        const int d = h * kDimHead + i;
        const float dqv = valid ? qn[i] * (dqn[i] - t_scaled) : 0.0f;
#pragma unroll
        for (int c = 0; c < CB; ++c)
          if (c < C) dxacc[c] = fmaf(wq_s[d * C + c], dqv, dxacc[c]);
        p1[i * kPitch + tid] = valid ? qn[i] : 0.0f;
        p2[i * kPitch + tid] = dqv;
      }
      __syncthreads();
      reduce_head<CB>(p1, v1, p2, v2, acc1, acc2, nullptr, h * kDimHead, C);
      __syncthreads();
    }
    if (valid) {
      float* dst = dxq + (size_t)b * C * N + n;
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c < C) dst[(size_t)c * N] = dxacc[c];
    }
  }

  float* dst = part_q + ((size_t)b * nsplit + sp) * (2 * H * C + 2 * C);
  for (int i = tid; i < H * C; i += kThreads) {
    dst[i] = acc1[i];
    dst[H * C + i] = acc2[i];
  }
#pragma unroll
  for (int c = 0; c < CB; ++c)
    if (c < C) {
      v1[c * kThreads + tid] = db_acc[c];
      v2[c * kThreads + tid] = dg_acc[c];
    }
  __syncthreads();
  reduce_channels(v1, dst + 2 * H * C, C, 1.0f);
  reduce_channels(v2, dst + 2 * H * C + C, C, rs);
}

// Pass 3, one CTA per row, thread d:
//   dctx[d][i] = sum_c Z[d][c] W_out[h0 + i][c]           (head-masked)
//   D2[d][c]   = sum_i dctx[d][i] W_v[h0 + i][c]
//   dW_out[e][c] = sum_{d in head(e)} ctx[d][e - h0] Z[d][c]
__global__ void __launch_bounds__(kMaxH) la_bwd_ctx(
    const float* __restrict__ sum_q, const float* __restrict__ ctx,
    const float* __restrict__ wout, const float* __restrict__ wv, float* __restrict__ dctx,
    float* __restrict__ d2, float* __restrict__ dwo, int C, int H) {
  const int d = threadIdx.x, b = blockIdx.x;
  const int h0 = (d / kDimHead) * kDimHead;
  const float* z = sum_q + (size_t)b * (2 * H * C + 2 * C);  // Z [d][c]
  const float* cb = ctx + (size_t)b * H * kDimHead;
  float zr[kMaxC], acc[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    zr[c] = c < C ? z[d * C + c] : 0.0f;
    acc[c] = 0.0f;
  }
  for (int i = 0; i < kDimHead; ++i) {
    const int e = h0 + i;
    float v = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < C) v = fmaf(zr[c], wout[e * C + c], v);
    dctx[((size_t)b * H + d) * kDimHead + i] = v;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < C) acc[c] = fmaf(v, wv[e * C + c], acc[c]);
  }
#pragma unroll
  for (int c = 0; c < kMaxC; ++c)
    if (c < C) d2[((size_t)b * H + d) * C + c] = acc[c];
  // this thread's row e = d of dW_out
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) acc[c] = 0.0f;
  for (int dd = h0; dd < h0 + kDimHead; ++dd) {
    const float cv = cb[dd * kDimHead + (d - h0)];
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < C) acc[c] = fmaf(cv, z[dd * C + c], acc[c]);
  }
#pragma unroll
  for (int c = 0; c < kMaxC; ++c)
    if (c < C) dwo[((size_t)b * H + d) * C + c] = acc[c];
}

size_t smem_k(int H, int C, int CB) {
  return sizeof(float) * (4 * (size_t)H * C + 3 * H + 2 * 32 * kPitch + CB * kThreads);
}

// Pass 4. Partials part_k[b][sp] = T (H) | dW_k' (H x C) | bmat (H x C).
template <typename T, int CB>
__global__ void __launch_bounds__(kThreads) la_bwd_k(
    const T* __restrict__ x, const float* __restrict__ wk, const float* __restrict__ kshift,
    const float* __restrict__ inv_s, const float* __restrict__ d2_in,
    const float* __restrict__ g_pre, float* __restrict__ part_k, int C, int N, int heads,
    int chunk, int nsplit) {
  extern __shared__ float smem[];
  const int H = heads * kDimHead;
  float* wk_s = smem;                  // [d][c]
  float* d2_s = wk_s + H * C;          // [d][c]
  float* acc1 = d2_s + H * C;          // dW_k' [d][c]
  float* acc2 = acc1 + H * C;          // bmat [d][c]
  float* ks_s = acc2 + H * C;
  float* is_s = ks_s + H;
  float* acct = is_s + H;              // T
  float* p1 = acct + H;                // kn dkn of one head [32][kPitch]
  float* p2 = p1 + 32 * kPitch;        // kn
  float* v2 = p2 + 32 * kPitch;        // xh [CB][kThreads]
  const int tid = threadIdx.x, sp = blockIdx.x, b = blockIdx.y;
  for (int i = tid; i < H * C; i += kThreads) {
    wk_s[i] = wk[i];
    d2_s[i] = d2_in[(size_t)b * H * C + i];
    acc1[i] = acc2[i] = 0.0f;
  }
  for (int i = tid; i < H; i += kThreads) {
    ks_s[i] = kshift[i];
    is_s[i] = inv_s[(size_t)b * H + i];
    acct[i] = 0.0f;
  }
  const float rs = sqrtf((float)C);
  float gp[CB];
#pragma unroll
  for (int c = 0; c < CB; ++c) gp[c] = c < C ? g_pre[c] * rs : 0.0f;
  __syncthreads();

  const T* xb = x + (size_t)b * C * N;
  const int nbeg = sp * chunk, nend = min(N, nbeg + chunk);
  for (int t0 = nbeg; t0 < nend; t0 += kThreads) {
    const int n = t0 + tid;
    const bool valid = n < nend;
    float xraw[CB], xh[CB], inv_r;
    load_col<T, CB>(xb, n, N, C, valid, gp, xraw, xh, inv_r);
#pragma unroll
    for (int c = 0; c < CB; ++c)
      if (c < C) v2[c * kThreads + tid] = xh[c];
    for (int h = 0; h < heads; ++h) {
#pragma unroll 4
      for (int i = 0; i < kDimHead; ++i) {
        const int d = h * kDimHead + i;
        float k = 0.0f, dkn = 0.0f;
#pragma unroll
        for (int c = 0; c < CB; ++c)
          if (c < C) {
            k = fmaf(wk_s[d * C + c], xh[c], k);
            dkn = fmaf(d2_s[d * C + c], xh[c], dkn);
          }
        const float kn = valid ? expf(k - ks_s[d]) * is_s[d] : 0.0f;
        p1[i * kPitch + tid] = kn * dkn;
        p2[i * kPitch + tid] = kn;
      }
      __syncthreads();
      reduce_head<CB>(p1, v2, p2, v2, acc1, acc2, acct, h * kDimHead, C);
      __syncthreads();
    }
  }

  float* dst = part_k + ((size_t)b * nsplit + sp) * (H + 2 * H * C);
  for (int i = tid; i < H; i += kThreads) dst[i] = acct[i];
  for (int i = tid; i < H * C; i += kThreads) {
    dst[H + i] = acc1[i];
    dst[H + H * C + i] = acc2[i];
  }
}

// Pass 5, per column: dxh = dx_q + D2^T kn + W_k^T (kn (dkn - T)), the
// pre-RMSNorm backward, plus dy for the residual. Partials part_x[b][sp] =
// dg_pre (C).
template <typename T, int CB>
__global__ void __launch_bounds__(kThreads) la_bwd_x(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ dxq,
    const float* __restrict__ wk, const float* __restrict__ kshift,
    const float* __restrict__ inv_s, const float* __restrict__ d2_in,
    const float* __restrict__ sum_k, const float* __restrict__ g_pre, T* __restrict__ dx,
    float* __restrict__ part_x, int C, int N, int heads, int chunk, int nsplit) {
  extern __shared__ float smem[];
  const int H = heads * kDimHead;
  float* wk_s = smem;
  float* d2_s = wk_s + H * C;
  float* ks_s = d2_s + H * C;
  float* is_s = ks_s + H;
  float* t_s = is_s + H;
  float* red = t_s + H;  // [CB][kThreads]
  const int tid = threadIdx.x, sp = blockIdx.x, b = blockIdx.y;
  for (int i = tid; i < H * C; i += kThreads) {
    wk_s[i] = wk[i];
    d2_s[i] = d2_in[(size_t)b * H * C + i];
  }
  for (int i = tid; i < H; i += kThreads) {
    ks_s[i] = kshift[i];
    is_s[i] = inv_s[(size_t)b * H + i];
    t_s[i] = sum_k[(size_t)b * (H + 2 * H * C) + i];
  }
  const float rs = sqrtf((float)C);
  float gp[CB], dgp_acc[CB];
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    gp[c] = c < C ? g_pre[c] * rs : 0.0f;
    dgp_acc[c] = 0.0f;
  }
  __syncthreads();

  const int nbeg = sp * chunk, nend = min(N, nbeg + chunk);
  for (int t0 = nbeg; t0 < nend; t0 += kThreads) {
    const int n = t0 + tid;
    if (n >= nend) break;
    const size_t base = (size_t)b * C * N + n;
    float xraw[CB], xh[CB], dxn[CB], inv_r;
    load_col<T, CB>(x + (size_t)b * C * N, n, N, C, true, gp, xraw, xh, inv_r);
#pragma unroll
    for (int c = 0; c < CB; ++c) dxn[c] = c < C ? dxq[base + (size_t)c * N] : 0.0f;
    for (int d = 0; d < H; ++d) {
      float k = 0.0f, dkn = 0.0f;
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c < C) {
          k = fmaf(wk_s[d * C + c], xh[c], k);
          dkn = fmaf(d2_s[d * C + c], xh[c], dkn);
        }
      const float kn = expf(k - ks_s[d]) * is_s[d];
      const float w = kn * (dkn - t_s[d]);
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c < C) dxn[c] = fmaf(d2_s[d * C + c], kn, fmaf(wk_s[d * C + c], w, dxn[c]));
    }
    // xh = u0 g_pre sqrtC with u0 = x / |x|
    float inner = 0.0f;
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      const float u0 = xraw[c] * inv_r;
      dgp_acc[c] = fmaf(dxn[c], u0, dgp_acc[c]);
      inner = fmaf(dxn[c] * gp[c], u0, inner);
    }
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      if (c >= C) continue;
      const float u0 = xraw[c] * inv_r;
      const float v = (dxn[c] * gp[c] - u0 * inner) * inv_r +
                      dq::to_f32(dy[base + (size_t)c * N]);
      dx[base + (size_t)c * N] = dq::from_f32<T>(v);
    }
  }
#pragma unroll
  for (int c = 0; c < CB; ++c)
    if (c < C) red[c * kThreads + tid] = dgp_acc[c];
  __syncthreads();
  reduce_channels(red, part_x + ((size_t)b * nsplit + sp) * C, C, rs);
}

}  // namespace
