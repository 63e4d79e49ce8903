// K6a-c: the sequence-parallel fused pre-norm linear attention, channel-first
// (B, C, N_local) activations: each rank of a process group holds a slice
// of N, and the wrapper (ops/linear_attention.py) sums the cross-column
// couplings over the group with torch.distributed.all_reduce between
// launches, where the TPU version has its psums.
//
// Replaces the TPU kernels of dquartic_tpu/ops/linear_attention.py:
//   K6a _sp_stats (_kernel_sp0_t): the phase-0 partials over the local
//       slice, A = sum_n p xh^T (H, C) and s = sum_n p (H), p = exp(W_k xh -
//       kshift). Here: linattn_partials over ~1024-column chunks, then a
//       fixed-order sum of the chunks -> stats (B, H, C + 1) = [A | s].
//   K6b _fused_forward_sp_local (_kernel_sp1_t): phase 1 per local column
//       given the folded context M = W_out^T ctx^T (C, H) formed from the
//       all-reduced stats. Here: linattn_apply (linattn_apply.cuh).
//   K6c _fused_backward_sp_local (_kernel_sp_bwd_a/_b/_c): K4's passes
//       split at the two barriers of the backward:
//       a: la_bwd_q + sum of chunks -> per-rank partials of Z, dW_q, db, dg
//          (sum_q, K4's layout) and dx_q;                 [all_reduce Z]
//       b: la_bwd_ctx (dctx, D2 from the global Z) and la_bwd_k + sum of
//          chunks -> partials of T, dW_k', bmat (sum_k);   [all_reduce T]
//       c: la_bwd_x (T correction, pre-norm backward, residual) + sum of
//          chunks -> partials of dg_pre.
// The static shift (_static_shifts) bounds every logit by a function of the
// weights alone, so the partials are plain sums: ranks and chunks add up
// with no running-max merge. Every sum inside a rank is over per-CTA
// partials in a fixed order (no atomics), so each launch is deterministic.
// The TPU kernels' masked full-H contraction and padding of N to its block
// are not carried over. The device code is K4's and the forward's in
// launches of their own (linattn_phase0.cuh, linattn_apply.cuh,
// linattn_bwd.cuh), so a split run of K6 is K4, and within rounding K1,
// with the chunk sums grouped by rank.
//
// What bounds it: as K1 and K4, the per-column passes read x (and dy) once
// per pass and do ~4 H C float32 multiply-adds per column; at C <= 16 and
// N_local ~ 20000 each launch is a few microseconds of arithmetic behind
// the launch latency and the host's all_reduce between launches.
#include "linattn_apply.cuh"
#include "linattn_bwd.cuh"

namespace {

#define DQ_CHECK(expr)                    \
  do {                                    \
    cudaError_t err_ = (expr);            \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

template <typename T, int CB>
cudaError_t stats_c(const void* x, const float* wk2, const float* kshift2, const float* g_pre,
                    float* part, float* stats, int B, int C, int N, int H, int nsplit,
                    int chunk, int round, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  if (round)
    linattn_partials<T, CB, true><<<dim3(nsplit, B), H, 0, s>>>(xt, wk2, kshift2, g_pre, part,
                                                                C, N, H, chunk, nsplit);
  else
    linattn_partials<T, CB, false><<<dim3(nsplit, B), H, 0, s>>>(xt, wk2, kshift2, g_pre, part,
                                                                 C, N, H, chunk, nsplit);
  DQ_CHECK(cudaGetLastError());
  return dq::launch_sum_partials(part, stats, B, nsplit, H * (C + 1), s);
}

template <typename T, int CB>
cudaError_t apply_c(const void* x, const float* wq2, const float* qshift2, const float* g_pre,
                    const float* m, const float* b_out, const float* g, void* y, int B, int C,
                    int N, int heads, cudaStream_t s) {
  linattn_apply<T, CB><<<dim3(dq::ceil_div(N, kApplyThreads), B), kApplyThreads, 0, s>>>(
      static_cast<const T*>(x), wq2, qshift2, g_pre, m, b_out, g, static_cast<T*>(y), C, N,
      heads);
  return cudaGetLastError();
}

template <typename T, int CB>
cudaError_t bwd_a_c(const void* x, const void* dy, const float* wq, const float* m,
                    const float* qshift, const float* b_out, const float* g, const float* g_pre,
                    float* dxq, float* part_q, float* sum_q, int B, int C, int N, int heads,
                    int nsplit, int chunk, cudaStream_t s) {
  const int H = heads * kDimHead;
  const size_t sq = smem_q(H, C, CB);
  DQ_CHECK(dq::allow_smem(la_bwd_q<T, CB>, sq));
  la_bwd_q<T, CB><<<dim3(nsplit, B), kThreads, sq, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), wq, m, qshift, b_out, g, g_pre, dxq,
      part_q, C, N, heads, chunk, nsplit);
  DQ_CHECK(cudaGetLastError());
  return dq::launch_sum_partials(part_q, sum_q, B, nsplit, 2 * H * C + 2 * C, s);
}

template <typename T, int CB>
cudaError_t bwd_b_c(const void* x, const float* sum_q, const float* ctx, const float* wout,
                    const float* wv, const float* wk, const float* kshift, const float* inv_s,
                    const float* g_pre, float* dctx, float* d2, float* dwo, float* part_k,
                    float* sum_k, int B, int C, int N, int heads, int nsplit, int chunk,
                    cudaStream_t s) {
  const int H = heads * kDimHead;
  la_bwd_ctx<<<B, H, 0, s>>>(sum_q, ctx, wout, wv, dctx, d2, dwo, C, H);
  DQ_CHECK(cudaGetLastError());
  const size_t sk = smem_k(H, C, CB);
  DQ_CHECK(dq::allow_smem(la_bwd_k<T, CB>, sk));
  la_bwd_k<T, CB><<<dim3(nsplit, B), kThreads, sk, s>>>(static_cast<const T*>(x), wk, kshift,
                                                        inv_s, d2, g_pre, part_k, C, N, heads,
                                                        chunk, nsplit);
  DQ_CHECK(cudaGetLastError());
  return dq::launch_sum_partials(part_k, sum_k, B, nsplit, H + 2 * H * C, s);
}

template <typename T, int CB>
cudaError_t bwd_c_c(const void* x, const void* dy, const float* dxq, const float* wk,
                    const float* kshift, const float* inv_s, const float* d2,
                    const float* sum_k, const float* g_pre, void* dx, float* part_x,
                    float* dgpre, int B, int C, int N, int heads, int nsplit, int chunk,
                    cudaStream_t s) {
  const int H = heads * kDimHead;
  const size_t sx = sizeof(float) * (2 * (size_t)H * C + 3 * H + CB * kThreads);
  DQ_CHECK(dq::allow_smem(la_bwd_x<T, CB>, sx));
  la_bwd_x<T, CB><<<dim3(nsplit, B), kThreads, sx, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), dxq, wk, kshift, inv_s, d2, sum_k,
      g_pre, static_cast<T*>(dx), part_x, C, N, heads, chunk, nsplit);
  DQ_CHECK(cudaGetLastError());
  return dq::launch_sum_partials(part_x, dgpre, B, nsplit, C, s);
}

// Dispatch on the activation type and on C rounded up to a multiple of 4
// (the unrolled channel loops), as K1 and K4 do.
#define DQ_DISPATCH(FN, ...)                                              \
  do {                                                                    \
    const int cb = (C + 3) / 4;                                           \
    if (bf16) {                                                           \
      if (cb == 1) return (int)FN<__nv_bfloat16, 4>(__VA_ARGS__);         \
      if (cb == 2) return (int)FN<__nv_bfloat16, 8>(__VA_ARGS__);         \
      if (cb == 3) return (int)FN<__nv_bfloat16, 12>(__VA_ARGS__);        \
      return (int)FN<__nv_bfloat16, 16>(__VA_ARGS__);                     \
    }                                                                     \
    if (cb == 1) return (int)FN<float, 4>(__VA_ARGS__);                   \
    if (cb == 2) return (int)FN<float, 8>(__VA_ARGS__);                   \
    if (cb == 3) return (int)FN<float, 12>(__VA_ARGS__);                  \
    return (int)FN<float, 16>(__VA_ARGS__);                               \
  } while (0)

inline int prologue(int C, int heads, int device) {
  if (C < 1 || C > kMaxC || heads * kDimHead > kMaxH) return (int)cudaErrorInvalidValue;
  return (int)cudaSetDevice(device);
}

const float* cf(const void* p) { return static_cast<const float*>(p); }
float* f(void* p) { return static_cast<float*>(p); }

}  // namespace

// K6a. stats (B, H, C + 1) = per-row [A | s] over the local columns; part
// (B, nsplit, H, C + 1) is scratch. round: the matmul operands p and xh are
// rounded to the compute dtype (the forward, as K1); 0 keeps them float32
// (the backward's recompute, as K4).
extern "C" int dq_linear_attention_sp_stats(const void* x, const void* wk2, const void* kshift2,
                                            const void* g_pre, void* part, void* stats, int B,
                                            int C, int N, int heads, int nsplit, int chunk,
                                            int round, int bf16, int device, void* stream) {
  const int err = prologue(C, heads, device);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int H = heads * kDimHead;
  DQ_DISPATCH(stats_c, x, cf(wk2), cf(kshift2), cf(g_pre), f(part), f(stats), B, C, N, H,
              nsplit, chunk, round, s);
}

// K6b. y = RMSNorm_g(M q + b_out) + x per local column; m (B, C, H).
extern "C" int dq_linear_attention_sp_apply(const void* x, const void* wq2, const void* qshift2,
                                            const void* g_pre, const void* m, const void* b_out,
                                            const void* g, void* y, int B, int C, int N,
                                            int heads, int bf16, int device, void* stream) {
  const int err = prologue(C, heads, device);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DQ_DISPATCH(apply_c, x, cf(wq2), cf(qshift2), cf(g_pre), cf(m), cf(b_out), cf(g), y, B, C, N,
              heads, s);
}

// K6c, launch a. dxq (B, C, N) float32; sum_q (B, 2HC + 2C) = Z | dW_q | db
// | dg (K4's layout); part_q (B, nsplit, 2HC + 2C) is scratch.
extern "C" int dq_linear_attention_sp_bwd_a(const void* x, const void* dy, const void* wq,
                                            const void* m, const void* qshift, const void* b_out,
                                            const void* g, const void* g_pre, void* dxq,
                                            void* part_q, void* sum_q, int B, int C, int N,
                                            int heads, int nsplit, int chunk, int bf16,
                                            int device, void* stream) {
  const int err = prologue(C, heads, device);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DQ_DISPATCH(bwd_a_c, x, dy, cf(wq), cf(m), cf(qshift), cf(b_out), cf(g), cf(g_pre), f(dxq),
              f(part_q), f(sum_q), B, C, N, heads, nsplit, chunk, s);
}

// K6c, launch b, after the all_reduce of Z in sum_q. dctx (B, H, 32), d2 (B,
// H, C), dwo (B, H, C); sum_k (B, H + 2HC) = T | dW_k' | bmat; part_k is
// scratch.
extern "C" int dq_linear_attention_sp_bwd_b(const void* x, const void* sum_q, const void* ctx,
                                            const void* wout, const void* wv, const void* wk,
                                            const void* kshift, const void* inv_s,
                                            const void* g_pre, void* dctx, void* d2, void* dwo,
                                            void* part_k, void* sum_k, int B, int C, int N,
                                            int heads, int nsplit, int chunk, int bf16,
                                            int device, void* stream) {
  const int err = prologue(C, heads, device);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DQ_DISPATCH(bwd_b_c, x, cf(sum_q), cf(ctx), cf(wout), cf(wv), cf(wk), cf(kshift), cf(inv_s),
              cf(g_pre), f(dctx), f(d2), f(dwo), f(part_k), f(sum_k), B, C, N, heads, nsplit,
              chunk, s);
}

// K6c, launch c, after the all_reduce of T in sum_k. dx (B, C, N) in x's
// dtype; dgpre (B, C) per-row partials; part_x is scratch.
extern "C" int dq_linear_attention_sp_bwd_c(const void* x, const void* dy, const void* dxq,
                                            const void* wk, const void* kshift,
                                            const void* inv_s, const void* d2,
                                            const void* sum_k, const void* g_pre, void* dx,
                                            void* part_x, void* dgpre, int B, int C, int N,
                                            int heads, int nsplit, int chunk, int bf16,
                                            int device, void* stream) {
  const int err = prologue(C, heads, device);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DQ_DISPATCH(bwd_c_c, x, dy, cf(dxq), cf(wk), cf(kshift), cf(inv_s), cf(d2), cf(sum_k),
              cf(g_pre), dx, f(part_x), f(dgpre), B, C, N, heads, nsplit, chunk, s);
}
