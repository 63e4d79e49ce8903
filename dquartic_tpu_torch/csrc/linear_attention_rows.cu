// K8 and K9: row-blocked linear attention + out-projection + RMSNorm,
// forward, without pre-norm or residual, on (B, N, C) activations read and
// written through strides (the model hands it channel-first (B, C, N)
// memory as a transposed view, so no copy is made). Per row b:
//   k = W_k x, q = W_q x                                (H, N), never stored
//   m = max_n k,  p = exp(k - m)                        per feature d
//   s = sum_n p,  A = sum_n p x^T                       (H,), (H, C)
//   ctx = (A W_v^T masked to same-head pairs) / s       (H, H)
//   M   = W_out^T ctx^T                                 (C, H)
//   q^  = softmax over each head's 32 features of q, * dh^-1/2
//   y   = RMSNorm_g(M q^ + b_out)                       per column, x's dtype
// Everything is float32 inside; only y is rounded to x's dtype, as the TPU
// kernels cast x to float32 and the result back.
//
// Replaces the TPU kernels of dquartic_tpu/ops/linear_attention.py:
//   K8 _fused_forward_single (pallas_call at :298, body _kernel_ab), whose
//      grid (B, 2, blocks) runs phase 0 over a row's blocks in order with a
//      running max, keeps the context in VMEM and runs phase 1;
//   K9 _fused_forward (pallas_calls at :1160 and :1181, bodies _kernel_a
//      and _kernel_b), the same function with the context through HBM.
//
// On Hopper the blocks of a row run in parallel, so the running max of
// phase 0 becomes per-slot partials (m, s, A) over a slice of N, merged in
// a fixed order (deterministic):
//   m = max_i m_i,  s = sum_i s_i e^(m_i - m),  A = sum_i A_i e^(m_i - m).
//   K8: one launch. A thread-block cluster of kCluster CTAs owns one row;
//       each CTA sums its slice of N (kThreads / H column groups of H
//       threads, one feature per thread), the cluster merges the partials
//       through distributed shared memory, and each CTA folds W_v and W_out
//       into M in its own shared memory and writes y for its slice.
//   K9: two launches. The same cluster kernel writes M to device memory,
//       then a per-column kernel over grid (ceil(N/128), B) writes y.
// W_v and W_out are folded as in K1 (csrc/linattn_phase0.cuh): the TPU's
// masked (H, H) contraction (_head_mask) is an MXU choice and is not
// copied. The q-softmax shifts each head by its own max, which gives the
// reference's numbers exactly; the TPU kernel shifts by the column's max
// over all heads, the same unless a whole head underflows. W_q and W_k
// arrive pre-scaled by log2(e) so every exp is exp2f.
//
// Bound: per column, four H x C float32 multiply-add passes (k and A in
// phase 0, q and M q^ in phase 1) and 2H exponentials against 2C values
// read and C written, so at C <= 16 the op is bound by float32 operations,
// not by memory traffic (see chip_smoke.py's bound_ms).
#include <cooperative_groups.h>
#include <math_constants.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;    // CTAs per row (one cluster)
constexpr int kThreads = 256;  // threads per CTA of the cluster kernel
// CTAs of K8's cluster kernel held on one SM: with 3 (<= 85 registers a thread)
// the 34 clusters of the canonical batch fit the card in one wave; at 2
// (the 102-120 registers nvcc picks for C = 12, 16) they need two. K9's
// context kernel stays under 80 registers unbounded; bounded, nvcc gave it
// more at C = 4 and it ran more than twice as slow, so it is not bounded.
constexpr int kMinBlocks = 3;
constexpr int kTile = 128;     // columns staged in shared memory per step
constexpr int kMaxC = 16;
constexpr int kMaxH = 256;
constexpr int kDimHead = 32;
constexpr int kApplyThreads = 128;  // K9's output pass

struct Strides {
  long long b, n, c;
};

// y for one column from its float32 values xv: per-head softmax of
// W_q' xv (log2(e)-scaled), y = RMSNorm_g(M q^ + b_out).
template <typename T, int CB>
__device__ __forceinline__ void apply_column(const float (&xv)[CB], const float* wqs,
                                             const float* ms, const float* b_out,
                                             const float* g, T* yp, long long sc, int C,
                                             int H) {
  const float dh_scale = 0.17677669529663687f;  // 32 ** -0.5
  float acc[CB];
#pragma unroll
  for (int c = 0; c < CB; ++c) acc[c] = 0.0f;
  for (int h0 = 0; h0 < H; h0 += kDimHead) {
    float e[kDimHead];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < kDimHead; ++i) {
      const int d = h0 + i;
      float q = 0.0f;
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c < C) q = fmaf(wqs[d * C + c], xv[c], q);
      e[i] = q;
      mx = fmaxf(mx, q);
    }
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kDimHead; ++i) {
      e[i] = exp2f(e[i] - mx);
      sum += e[i];
    }
    const float inv = dh_scale / fmaxf(sum, 1e-30f);
#pragma unroll
    for (int i = 0; i < kDimHead; ++i) {
      const int d = h0 + i;
      const float qn = e[i] * inv;
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c < C) acc[c] = fmaf(ms[c * H + d], qn, acc[c]);
    }
  }
  float ss = 0.0f;
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    acc[c] = c < C ? acc[c] + b_out[c] : 0.0f;
    ss += acc[c] * acc[c];
  }
  const float scale = sqrtf((float)C) / fmaxf(sqrtf(ss), 1e-12f);
#pragma unroll
  for (int c = 0; c < CB; ++c)
    if (c < C) yp[c * sc] = dq::from_f32<T>(acc[c] * scale * g[c]);
}

template <typename T, int CB>
__device__ __forceinline__ void load_column(const T* xp, long long sc, int C, float (&xv)[CB]) {
#pragma unroll
  for (int c = 0; c < CB; ++c) xv[c] = c < C ? dq::to_f32(xp[c * sc]) : 0.0f;
}

// Phase 0, the merge and the fold, shared by K8 and K9's first launch.
// Shared memory: partials pm, ps (kThreads floats each) and pa (kThreads
// x C), then a scratch region: the x tile in phase 0, W_q' and M after it.
// Returns with M (C x H) in ms_out (K8: this CTA's shared memory; K9: the
// row's slot in device memory, written by rank 0 only).
template <typename T, int CB>
__device__ void context_of_row(const T* __restrict__ x, Strides st, const float* __restrict__ wk,
                               const float* __restrict__ wv, const float* __restrict__ wout,
                               float* smem, float* ms_out, bool write_m, int C, int N, int H,
                               int nbeg, int nend) {
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x;
  const int groups = kThreads / H;
  const int gi = t / H, d = t % H;
  float* pm = smem;
  float* ps = pm + kThreads;
  float* pa = ps + kThreads;
  float* xs = pa + kThreads * C;

  float w[CB], a[CB];
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    w[c] = c < C ? wk[d * C + c] : 0.0f;
    a[c] = 0.0f;
  }
  float m = -CUDART_INF_F, s = 0.0f;
  const T* xb = x + (long long)blockIdx.y * st.b;
  for (int t0 = nbeg; t0 < nend; t0 += kTile) {
    const int cnt = min(kTile, nend - t0);
    for (int i = t; i < CB * kTile; i += kThreads) {
      const int c = i / kTile, j = i % kTile;
      xs[i] = (c < C && j < cnt) ? dq::to_f32(xb[(t0 + j) * st.n + c * st.c]) : 0.0f;
    }
    __syncthreads();
    for (int j = gi; j < cnt; j += groups) {
      float k = 0.0f;
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c < C) k = fmaf(w[c], xs[c * kTile + j], k);
      if (k > m) {  // a new running max: rescale what was summed
        const float r = exp2f(m - k);
        s *= r;
#pragma unroll
        for (int c = 0; c < CB; ++c) a[c] *= r;
        m = k;
      }
      const float p = exp2f(k - m);
      s += p;
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c < C) a[c] = fmaf(p, xs[c * kTile + j], a[c]);
    }
    __syncthreads();
  }
  pm[t] = m;
  ps[t] = s;
#pragma unroll
  for (int c = 0; c < CB; ++c)
    if (c < C) pa[t * C + c] = a[c];
  cluster.sync();  // every CTA's partials are visible to the cluster

  const bool merges = t < H && write_m;
  if (merges) {  // slots in a fixed order: rank, then column group
    m = -CUDART_INF_F;
    for (int r = 0; r < kCluster; ++r) {
      const float* rpm = cluster.map_shared_rank(pm, r);
      for (int gg = 0; gg < groups; ++gg) m = fmaxf(m, rpm[gg * H + d]);
    }
    s = 0.0f;
#pragma unroll
    for (int c = 0; c < CB; ++c) a[c] = 0.0f;
    for (int r = 0; r < kCluster; ++r) {
      const float* rpm = cluster.map_shared_rank(pm, r);
      const float* rps = cluster.map_shared_rank(ps, r);
      const float* rpa = cluster.map_shared_rank(pa, r);
      for (int gg = 0; gg < groups; ++gg) {
        const int slot = gg * H + d;
        const float f = exp2f(rpm[slot] - m);  // 0 for an empty slot (m_i = -inf)
        s = fmaf(rps[slot], f, s);
#pragma unroll
        for (int c = 0; c < CB; ++c)
          if (c < C) a[c] = fmaf(rpa[slot * C + c], f, a[c]);
      }
    }
  }
  cluster.sync();  // the remote reads are done: shared memory may be reused
  if (!merges) return;
  // fold: ctx[e, d] = (A_d . W_v[e]) / s for e in d's head, M[c, d] =
  // sum_e W_out[e, c] ctx[e, d]
  const float inv_s = 1.0f / fmaxf(s, 1e-30f);
  float mc[CB];
#pragma unroll
  for (int c = 0; c < CB; ++c) mc[c] = 0.0f;
  const int h0 = (d / kDimHead) * kDimHead;
  for (int e = h0; e < h0 + kDimHead; ++e) {
    float ctx = 0.0f;
#pragma unroll
    for (int c = 0; c < CB; ++c)
      if (c < C) ctx = fmaf(a[c], wv[e * C + c], ctx);
    ctx *= inv_s;
#pragma unroll
    for (int c = 0; c < CB; ++c)
      if (c < C) mc[c] = fmaf(wout[e * C + c], ctx, mc[c]);
  }
#pragma unroll
  for (int c = 0; c < CB; ++c)
    if (c < C) ms_out[c * H + d] = mc[c];
}

// K8: grid (kCluster, B), one cluster per row.
template <typename T, int CB>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, kMinBlocks)
    linattn_rows_fused(const T* __restrict__ x, T* __restrict__ y, Strides st,
                       const float* __restrict__ wq, const float* __restrict__ wk,
                       const float* __restrict__ wv, const float* __restrict__ wout,
                       const float* __restrict__ b_out, const float* __restrict__ g, int C,
                       int N, int H, int chunk) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nbeg = min(N, rank * chunk), nend = min(N, nbeg + chunk);
  float* wqs = smem + kThreads * (C + 2);  // the x tile's region, free after phase 0
  float* ms = wqs + H * C;
  context_of_row<T, CB>(x, st, wk, wv, wout, smem, ms, true, C, N, H, nbeg, nend);
  for (int i = threadIdx.x; i < H * C; i += kThreads) wqs[i] = wq[i];
  __syncthreads();
  const long long row = (long long)blockIdx.y * st.b;
  for (int n = nbeg + threadIdx.x; n < nend; n += kThreads) {
    float xv[CB];
    load_column<T, CB>(x + row + n * st.n, st.c, C, xv);
    apply_column<T, CB>(xv, wqs, ms, b_out, g, y + row + n * st.n, st.c, C, H);
  }
}

// K9, first launch: grid (kCluster, B); rank 0 of each cluster writes the
// row's M (C x H) to m_out.
template <typename T, int CB>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    linattn_rows_context(const T* __restrict__ x, Strides st, const float* __restrict__ wk,
                         const float* __restrict__ wv, const float* __restrict__ wout,
                         float* __restrict__ m_out, int C, int N, int H, int chunk) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nbeg = min(N, rank * chunk), nend = min(N, nbeg + chunk);
  context_of_row<T, CB>(x, st, wk, wv, wout, smem, m_out + (size_t)blockIdx.y * C * H,
                        rank == 0, C, N, H, nbeg, nend);
}

// K9, second launch: grid (ceil(N / 128), B), one thread per column.
template <typename T, int CB>
__global__ void __launch_bounds__(kApplyThreads)
    linattn_rows_apply(const T* __restrict__ x, T* __restrict__ y, Strides st,
                       const float* __restrict__ wq, const float* __restrict__ m_in,
                       const float* __restrict__ b_out, const float* __restrict__ g, int C,
                       int N, int H) {
  __shared__ float wqs[kMaxH * kMaxC];
  __shared__ float ms[kMaxC * kMaxH];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < H * C; i += kApplyThreads) {
    wqs[i] = wq[i];
    ms[i] = m_in[(size_t)b * C * H + i];
  }
  __syncthreads();
  const int n = blockIdx.x * kApplyThreads + threadIdx.x;
  if (n >= N) return;
  const long long off = (long long)b * st.b + (long long)n * st.n;
  float xv[CB];
  load_column<T, CB>(x + off, st.c, C, xv);
  apply_column<T, CB>(xv, wqs, ms, b_out, g, y + off, st.c, C, H);
}

size_t cluster_smem_bytes(int C, int H) {
  const int scratch = std::max(kMaxC * kTile, 2 * H * C);
  return sizeof(float) * ((size_t)kThreads * (C + 2) + scratch);
}

template <typename T, int CB>
cudaError_t run_c(const void* x, void* y, Strides st, const float* wq, const float* wk,
                  const float* wv, const float* wout, const float* b_out, const float* g,
                  float* m, int B, int C, int N, int H, int two_call, cudaStream_t s) {
  const int chunk = dq::ceil_div(N, kCluster);
  const size_t smem = cluster_smem_bytes(C, H);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (!two_call) {
    cudaError_t err = dq::allow_smem(linattn_rows_fused<T, CB>, smem);
    if (err != cudaSuccess) return err;
    linattn_rows_fused<T, CB><<<dim3(kCluster, B), kThreads, smem, s>>>(
        xt, yt, st, wq, wk, wv, wout, b_out, g, C, N, H, chunk);
    return cudaGetLastError();
  }
  cudaError_t err = dq::allow_smem(linattn_rows_context<T, CB>, smem);
  if (err != cudaSuccess) return err;
  linattn_rows_context<T, CB><<<dim3(kCluster, B), kThreads, smem, s>>>(
      xt, st, wk, wv, wout, m, C, N, H, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  linattn_rows_apply<T, CB><<<dim3(dq::ceil_div(N, kApplyThreads), B), kApplyThreads, 0, s>>>(
      xt, yt, st, wq, m, b_out, g, C, N, H);
  return cudaGetLastError();
}

// Channel loops unrolled to C rounded up to a multiple of 4, as in K1.
template <typename T>
cudaError_t run(const void* x, void* y, Strides st, const float* wq, const float* wk,
                const float* wv, const float* wout, const float* b_out, const float* g,
                float* m, int B, int C, int N, int H, int two_call, cudaStream_t s) {
#define DQ_RUN(CB) run_c<T, CB>(x, y, st, wq, wk, wv, wout, b_out, g, m, B, C, N, H, two_call, s)
  switch ((C + 3) / 4) {
    case 1: return DQ_RUN(4);
    case 2: return DQ_RUN(8);
    case 3: return DQ_RUN(12);
    default: return DQ_RUN(16);
  }
#undef DQ_RUN
}

}  // namespace

// x and y share the strides (sb, sn, sc) of a (B, N, C) tensor; wq, wk
// (log2(e)-scaled), wv and wout are float32 (H, C) rows; m is float32
// (B, C, H) scratch for the two-call form (unused by the single call).
extern "C" int dq_linear_attention_rows(const void* x, void* y, long long sb, long long sn,
                                        long long sc, const void* wq, const void* wk,
                                        const void* wv, const void* wout, const void* b_out,
                                        const void* g, void* m, int B, int C, int N, int heads,
                                        int two_call, int bf16, int device, void* stream) {
  const int H = heads * kDimHead;
  if (C < 1 || C > kMaxC || H > kMaxH || kThreads % H != 0 || N < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st{sb, sn, sc};
  float* mf = static_cast<float*>(m);
  err = bf16 ? run<__nv_bfloat16>(x, y, st, f(wq), f(wk), f(wv), f(wout), f(b_out), f(g), mf,
                                  B, C, N, H, two_call, s)
             : run<float>(x, y, st, f(wq), f(wk), f(wv), f(wout), f(b_out), f(g), mf, B, C, N,
                          H, two_call, s);
  return (int)err;
}
