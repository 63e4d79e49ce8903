// K1: fused pre-norm linear attention with residual, forward, on
// channel-first (B, C, N) activations. Per row b:
//   xh  = RMSNorm_{g_pre}(x) over C
//   p   = exp(W_k xh - kshift)                     (H, N)
//   s   = sum_n p,   A = sum_n p xh^T              (H,), (H, C)
//   ctx = (A W_v^T masked to same-head pairs) / s  (H, H)
//   M   = W_out^T ctx^T                            (C, H)
//   q   = softmax over each head's 32 rows of (W_q xh - qshift), * dh^-1/2
//   y   = RMSNorm_g(M q + b_out) + x
//
// Replaces the TPU kernel dquartic_tpu/ops/linear_attention.py:
// _fused_forward_single_t (_kernel_ab_t), the prenorm + residual +
// static-shift form that UNet1d calls. The TPU grid carries the phase-0
// sums (A, s) across sequential grid steps; on Hopper blocks run in no
// order, so the op is three kernels:
//   1. partials, grid (n_splits, B): each CTA sums (A, s) over its own
//      chunk of N. kshift/qshift are weight-norm bounds on every logit
//      (_static_shifts), so there is no running max to merge and the
//      chunks add up as plain sums;
//   2. context, grid (B): sums the partials in a fixed order (deterministic)
//      and folds W_v and W_out into M (C x H), per head 32 x 32 blocks;
//   3. apply, grid (ceil(N/128), B): one thread per column computes q, the
//      per-head softmax and y = M q with W_q and M in shared memory.
// The (H, N) q/k/v expansions never reach device memory: x is read twice
// and y written once, 3 * C * N elements per row against ~4 * H * C
// multiply-adds per column, so at C <= 16 the op is bound by memory
// traffic and launch latency. The TPU kernel's masked full-H contraction
// and log2(e) pre-scale of the MXU are kept only where they are free:
// W_q/W_k and the shifts arrive pre-scaled by log2(e) so exp is exp2f.
// Matmul operands are rounded to the compute dtype where the TPU kernel
// casts them (p and xh for A, M and q for y); everything else is float32.
#include "linattn_apply.cuh"

namespace {

template <typename T, int CB>
cudaError_t run_c(const void* x, const float* wq, const float* wk, const float* wv,
                const float* wout, const float* qshift, const float* kshift,
                const float* g_pre, const float* b_out, const float* g, float* part,
                float* m, void* y, int B, int C, int N, int heads, int nsplit, int chunk,
                cudaStream_t s) {
  const int H = heads * kDimHead;
  linattn_partials<T, CB, true><<<dim3(nsplit, B), H, 0, s>>>(
      static_cast<const T*>(x), wk, kshift, g_pre, part, C, N, H, chunk, nsplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  linattn_context<<<B, H, 0, s>>>(part, wv, wout, m, nullptr, nullptr, C, H, nsplit,
                                  sizeof(T) == 2 ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  linattn_apply<T, CB><<<dim3(dq::ceil_div(N, kApplyThreads), B), kApplyThreads, 0, s>>>(
      static_cast<const T*>(x), wq, qshift, g_pre, m, b_out, g, static_cast<T*>(y), C, N,
      heads);
  return cudaGetLastError();
}

// The channel loops are unrolled to C rounded up to a multiple of 4, so the
// level-0 width C = 4 runs 4-wide loops rather than 16-wide predicated ones.
template <typename T>
cudaError_t run(const void* x, const float* wq, const float* wk, const float* wv,
                const float* wout, const float* qshift, const float* kshift,
                const float* g_pre, const float* b_out, const float* g, float* part,
                float* m, void* y, int B, int C, int N, int heads, int nsplit, int chunk,
                cudaStream_t s) {
#define DQ_RUN(CB)                                                                       \
  run_c<T, CB>(x, wq, wk, wv, wout, qshift, kshift, g_pre, b_out, g, part, m, y, B, C, N, \
               heads, nsplit, chunk, s)
  switch ((C + 3) / 4) {
    case 1: return DQ_RUN(4);
    case 2: return DQ_RUN(8);
    case 3: return DQ_RUN(12);
    default: return DQ_RUN(16);
  }
#undef DQ_RUN
}

}  // namespace

extern "C" int dq_linear_attention(const void* x, const void* wq, const void* wk,
                                   const void* wv, const void* wout, const void* qshift,
                                   const void* kshift, const void* g_pre, const void* b_out,
                                   const void* g, void* part, void* m, void* y, int B, int C,
                                   int N, int heads, int nsplit, int chunk, int bf16,
                                   int device, void* stream) {
  if (C > kMaxC || heads * kDimHead > kMaxH) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bf16 ? run<__nv_bfloat16>(x, f(wq), f(wk), f(wv), f(wout), f(qshift), f(kshift),
                                  f(g_pre), f(b_out), f(g), static_cast<float*>(part),
                                  static_cast<float*>(m), y, B, C, N, heads, nsplit, chunk, s)
             : run<float>(x, f(wq), f(wk), f(wv), f(wout), f(qshift), f(kshift), f(g_pre),
                          f(b_out), f(g), static_cast<float*>(part), static_cast<float*>(m),
                          y, B, C, N, heads, nsplit, chunk, s);
  return (int)err;
}
