// K4: backward of the fused pre-norm linear attention with residual (K1),
// channel-first (B, C, N). Forward, per row (see linear_attention.cu):
//   xh = RMSNorm_{g_pre}(x);  q, k, v = W xh;  qn = softmax_head(q) dh^-1/2
//   kn = softmax_N(k);  ctx = mask . (kn v^T);  u = W_out^T ctx^T qn + b
//   y  = x + RMSNorm_g(u)
// Backward (the derivation of dquartic_tpu/ops/linear_attention.py:707-731):
//   du   = (dy g sqrtC - yh <dy g sqrtC, yh>) / |u|         per column
//   Z    = sum_n qn du^T (H, C);  dqn = M^T du;  dq = qn (dqn - <qn, dqn> dh^1/2)
//   dctx = mask . (Z W_out^T);  dW_out = ctx^T Z;  D2 = dctx W_v
//   dkn  = D2 xh;  T = sum_n kn dkn;  dk = kn (dkn - T)
//   dxh  = W_q^T dq + D2^T kn + W_k^T (kn (dkn - T))
//   dx   = pre-RMSNorm backward of dxh + dy
// The only couplings across the sequence are the k-softmax statistics, Z
// and T.
//
// Replaces the TPU kernel dquartic_tpu/ops/linear_attention.py:
// _fused_backward_t (_kernel_bwd_a, _kernel_bwd_bc). The TPU carries
// (A, s), Z and T across sequential grid steps; Hopper blocks run in no
// order, so each coupling is a pass of per-CTA partial sums over a chunk of
// N followed by a fixed-order reduce (deterministic, no float atomics):
//   1. linattn_partials / linattn_context (linattn_phase0.cuh, the
//      forward's phase 0 in launches of its own, operands in float32): ctx, 1/s and M = W_out^T ctx^T;
//   2. la_bwd_q, per column: q, qn, u, du, dq; writes dx_q = W_q^T dq
//      (C x N, float32) and partials of Z, dW_q, db, dg;
//   3. la_bwd_ctx, per row: dctx, dW_out, D2;
//   4. la_bwd_k, per column: kn, dkn; partials of T, dW_k' = sum xh (kn dkn)
//      and bmat = sum xh kn;
//   5. la_bwd_x, per column: dxh from dx_q, D2, T, then the pre-norm
//      backward and the residual; partials of dg_pre.
// The wrapper finishes the weight gradients with torch ops on (H, C)
// tensors: dW_k = dW_k' - bmat T and dW_v = sum_b bmat_b^T dctx_b.
//
// What bounds it: every per-column pass reads x (C values) and does ~4 H C
// multiply-adds per column, ~8 k flops at C = 16; the cross-column sums
// (Z, dW_q, dW_k', bmat) are H x C outer products over N, staged one head
// (32 rows x 128 columns) at a time in shared memory and reduced by
// threads that each own (row, channel) entries, so no (H, N) tensor
// reaches device memory. Everything is float32; dx is stored in x's dtype.
#include "linattn_bwd.cuh"

namespace {

struct BwdArgs {
  const void* x;
  const void* dy;
  const float *wq, *wk, *wv, *wout, *b_out, *g, *g_pre, *qshift, *kshift, *wk2, *kshift2;
  float *part, *m, *ctx, *inv_s, *dxq, *part_q, *sum_q, *dctx, *d2, *dwo, *part_k, *sum_k,
      *part_x, *dgpre;
  void* dx;
  int B, C, N, heads, nsplit, chunk;
};

#define DQ_CHECK(expr)                   \
  do {                                   \
    cudaError_t err_ = (expr);           \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

template <typename T, int CB>
cudaError_t run_c(const BwdArgs& a, cudaStream_t s) {
  const int H = a.heads * kDimHead, C = a.C;
  const dim3 grid(a.nsplit, a.B);
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  linattn_partials<T, CB, false><<<grid, H, 0, s>>>(x, a.wk2, a.kshift2, a.g_pre, a.part, C,
                                                     a.N, H, a.chunk, a.nsplit);
  DQ_CHECK(cudaGetLastError());
  linattn_context<<<a.B, H, 0, s>>>(a.part, a.wv, a.wout, a.m, a.ctx, a.inv_s, C, H,
                                    a.nsplit, 0);
  DQ_CHECK(cudaGetLastError());

  const size_t sq = smem_q(H, C, CB);
  DQ_CHECK(dq::allow_smem(la_bwd_q<T, CB>, sq));
  la_bwd_q<T, CB><<<grid, kThreads, sq, s>>>(x, dy, a.wq, a.m, a.qshift, a.b_out, a.g,
                                             a.g_pre, a.dxq, a.part_q, C, a.N, a.heads,
                                             a.chunk, a.nsplit);
  DQ_CHECK(cudaGetLastError());
  DQ_CHECK(dq::launch_sum_partials(a.part_q, a.sum_q, a.B, a.nsplit, 2 * H * C + 2 * C, s));
  la_bwd_ctx<<<a.B, H, 0, s>>>(a.sum_q, a.ctx, a.wout, a.wv, a.dctx, a.d2, a.dwo, C, H);
  DQ_CHECK(cudaGetLastError());

  const size_t sk = smem_k(H, C, CB);
  DQ_CHECK(dq::allow_smem(la_bwd_k<T, CB>, sk));
  la_bwd_k<T, CB><<<grid, kThreads, sk, s>>>(x, a.wk, a.kshift, a.inv_s, a.d2, a.g_pre,
                                             a.part_k, C, a.N, a.heads, a.chunk, a.nsplit);
  DQ_CHECK(cudaGetLastError());
  DQ_CHECK(dq::launch_sum_partials(a.part_k, a.sum_k, a.B, a.nsplit, H + 2 * H * C, s));

  const size_t sx = sizeof(float) * (2 * (size_t)H * C + 3 * H + CB * kThreads);
  DQ_CHECK(dq::allow_smem(la_bwd_x<T, CB>, sx));
  la_bwd_x<T, CB><<<grid, kThreads, sx, s>>>(x, dy, a.dxq, a.wk, a.kshift, a.inv_s, a.d2,
                                             a.sum_k, a.g_pre, static_cast<T*>(a.dx),
                                             a.part_x, C, a.N, a.heads, a.chunk, a.nsplit);
  DQ_CHECK(cudaGetLastError());
  return dq::launch_sum_partials(a.part_x, a.dgpre, a.B, a.nsplit, C, s);
}

template <typename T>
cudaError_t run(const BwdArgs& a, cudaStream_t s) {
  switch ((a.C + 3) / 4) {
    case 1: return run_c<T, 4>(a, s);
    case 2: return run_c<T, 8>(a, s);
    case 3: return run_c<T, 12>(a, s);
    default: return run_c<T, 16>(a, s);
  }
}

}  // namespace

extern "C" int dq_linear_attention_bwd(
    const void* x, const void* dy, const void* wq, const void* wk, const void* wv,
    const void* wout, const void* b_out, const void* g, const void* g_pre, const void* qshift,
    const void* kshift, const void* wk2, const void* kshift2, void* part, void* m, void* ctx,
    void* inv_s, void* dxq, void* part_q, void* sum_q, void* dctx, void* d2, void* dwo,
    void* part_k, void* sum_k, void* part_x, void* dgpre, void* dx, int B, int C, int N,
    int heads, int nsplit, int chunk, int bf16, int device, void* stream) {
  if (C > kMaxC || heads * kDimHead > kMaxH) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  auto f = [](void* p) { return static_cast<float*>(p); };
  const BwdArgs a{x, dy, cf(wq), cf(wk), cf(wv), cf(wout), cf(b_out), cf(g), cf(g_pre),
                  cf(qshift), cf(kshift), cf(wk2), cf(kshift2), f(part), f(m), f(ctx),
                  f(inv_s), f(dxq), f(part_q), f(sum_q), f(dctx), f(d2), f(dwo), f(part_k),
                  f(sum_k), f(part_x), f(dgpre), dx, B, C, N, heads, nsplit, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bf16 ? run<__nv_bfloat16>(a, s) : run<float>(a, s);
  return (int)err;
}
