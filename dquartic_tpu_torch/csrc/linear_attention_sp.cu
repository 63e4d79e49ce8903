// K6a-c: the sequence-parallel fused pre-norm linear attention, channel-first
// (B, C, N_local) activations: each rank of a process group holds a slice
// of N, and the wrapper (ops/linear_attention.py) sums the cross-column
// couplings over the group with torch.distributed.all_reduce between
// launches, where the TPU version has its psums. The static shift
// (_static_shifts) bounds every logit by a function of the weights alone, so
// the couplings are plain sums: ranks add up with no running-max merge.
//
// Replaces the TPU kernels of dquartic_tpu/ops/linear_attention.py:
//   K6a _sp_stats (_kernel_sp0_t): the rank's phase-0 sums A = sum_n p xh^T
//       (H, C) and s = sum_n p (H), p = exp(W_k xh - kshift), written as
//       stats (B, H, C + 1) = [A | s]. One cluster launch of K1's kernel in
//       its stats mode (linear_attention.cu: p and xh rounded to bf16 and A
//       on tensor cores, as K1's phase 0; float32 x on CUDA cores), or, for
//       bf16 x with float32 operands (the backward's recompute), of K4's in
//       its stats mode (linear_attention_bwd.cu: hi/lo products, as K4's
//       pass 0). Each CTA sums its slice and rank 0 of the cluster adds the
//       CTAs' partials in rank order through distributed shared memory.
//   K6b _fused_forward_sp_local (_kernel_sp1_t): phase 1 per local column
//       from the all-reduced stats. One cluster launch of K1's kernel in its
//       apply mode (linear_attention.cu): each CTA reads the row's summed
//       [A | s], folds W_v and W_out into M = W_out^T ctx^T (C, H) with K1's
//       own code and rounding, and runs K1's apply pass over its slice (bf16
//       on tensor cores, float32 on CUDA cores).
//   K6c _fused_backward_sp_local (_kernel_sp_bwd_a/_b/_c): K4 cut at its one
//       cross-rank coupling after (A, s). With bmat = A / s from the summed
//       stats, T = rows of D2 . bmat needs no pass over the columns, so only
//       Z crosses the ranks:
//       1: K4's kernel from the summed (A, s): M, pass 1, the row's Z, db
//          and dg (Z partials merged over the cluster in rank order);
//                                                          [all_reduce Z]
//       2: K4's kernel from the summed (A, s) and Z: M, D2, T, the row's
//          dW_out and dW_v, then pass 2 (dx, dW_q, dW_k, dg_pre), dx_q
//          recomputed per column rather than stored;
//       3: K4's linattn_bwd_finish: the rows' and CTAs' partials summed in
//          a fixed order into tensors of the parameters' shapes, dtypes and
//          strides.
//       The weight gradients are the rank's partials, which the trainer
//       sums over the group: dW_out and dW_v from the rank's own bmat (its
//       A over the summed s) against the summed Z, which add up over the
//       ranks to bmat^T Z; the others are sums over the rank's columns.
// The kernels read the weights as the caller holds them (no host work on
// them), and every sum inside a rank runs in a fixed order (no atomics), so
// each launch is deterministic. A split run of K6 is K1's and K4's
// arithmetic with the sums of the slices grouped by rank.
//
// What bounds it: as K1 and K4 (see their files), the per-column passes
// read x (and dy) once per pass and do ~4 H C multiply-adds a column per
// pass; at C <= 16 and N_local ~ 20000 a launch is tens of microseconds.
#include "linattn_common.cuh"

namespace {

const float* cf(const void* p) { return static_cast<const float*>(p); }
float* f(void* p) { return static_cast<float*>(p); }

}  // namespace

// K6a. stats (B, H, C + 1) = per-row [A | s] over the local columns. Reads
// w_qkv and g_pre alone (w_bf16: bit 0 w_qkv, bit 4 g_pre). round: the
// matmul operands p and xh are rounded to the compute dtype (the forward,
// as K1); 0 keeps them float32 (the backward's recompute, as K4).
extern "C" int dq_linear_attention_sp_stats(const void* x, const void* wqkv, long long wqkv_c,
                                            long long wqkv_h, const void* g_pre,
                                            long long g_pre_c, void* stats, int B, int C, int N,
                                            int heads, int w_bf16, int round, int x_bf16,
                                            int device, void* stream) {
  if (!linattn_valid(B, C, N, heads)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Weights w{wqkv, wqkv_c, wqkv_h, nullptr, 0, 0, nullptr, 0, nullptr, 0, g_pre, g_pre_c,
                  w_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && !round) return (int)dq::linattn_bwd_stats(x, f(stats), w, B, C, N, heads, s);
  return (int)dq::linattn_stats(x, f(stats), w, B, C, N, heads, x_bf16, s);
}

// K6b. y = RMSNorm_g(M q + b_out) + x per local column of x (B, C, N), y
// in x's dtype, M folded from stats (B, H, C + 1), the all-reduced [A | s];
// the weights as dq_linear_attention takes them.
extern "C" int dq_linear_attention_sp_apply(
    const void* x, void* y, const void* stats, const void* wqkv, long long wqkv_c,
    long long wqkv_h, const void* wout, long long wout_h, long long wout_c, const void* b_out,
    long long b_out_c, const void* g, long long g_c, const void* g_pre, long long g_pre_c, int B,
    int C, int N, int heads, int w_bf16, int x_bf16, int device, void* stream) {
  if (!linattn_valid(B, C, N, heads)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Weights w{wqkv, wqkv_c, wqkv_h, wout, wout_h, wout_c, b_out, b_out_c,
                  g,    g_c,    g_pre,  g_pre_c, w_bf16};
  return (int)dq::linattn_apply(x, y, cf(stats), w, B, C, N, heads, x_bf16,
                                static_cast<cudaStream_t>(stream));
}

// K6c, launch 1, from the all-reduced stats (B, H, C + 1): z (B, H, C) the
// rank's Z; rowpart (B, 2HC + 2C) gets each row's db and dg (K4's layout).
// x, dy contiguous (B, C, N) of x's dtype; the weights as dq_linear_attention
// takes them.
extern "C" int dq_linear_attention_sp_bwd_z(
    const void* x, const void* dy, const void* wqkv, long long wqkv_c, long long wqkv_h,
    const void* wout, long long wout_h, long long wout_c, const void* b_out, long long b_out_c,
    const void* g, long long g_c, const void* g_pre, long long g_pre_c, const void* stats,
    void* z, void* rowpart, int B, int C, int N, int heads, int w_bf16, int x_bf16, int device,
    void* stream) {
  if (!linattn_valid(B, C, N, heads)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Weights w{wqkv, wqkv_c, wqkv_h, wout, wout_h, wout_c, b_out, b_out_c,
                  g,    g_c,    g_pre,  g_pre_c, w_bf16};
  return (int)dq::linattn_sp_bwd_z(x, dy, w, cf(stats), f(z), f(rowpart), B, C, N, heads, x_bf16,
                                   static_cast<cudaStream_t>(stream));
}

// K6c, launches 2 and 3, after the all_reduce of Z: dx (B, C, N) in x's
// dtype and the rank's weight gradients, as dq_linear_attention_bwd writes
// them. stats: all-reduced; stats_local: the rank's own; z: all-reduced;
// rowpart: launch 1's; ctapart: B 8 (2HC + C) float32 scratch.
extern "C" int dq_linear_attention_sp_bwd_x(
    const void* x, const void* dy, void* dx, const void* wqkv, long long wqkv_c,
    long long wqkv_h, const void* wout, long long wout_h, long long wout_c, const void* b_out,
    long long b_out_c, const void* g, long long g_c, const void* g_pre, long long g_pre_c,
    void* dwqkv, long long dwqkv_c, long long dwqkv_h, void* dwout, long long dwout_h,
    long long dwout_c, void* db_out, long long db_out_c, void* dg, long long dg_c, void* dg_pre,
    long long dg_pre_c, const void* stats, const void* stats_local, const void* z,
    void* rowpart, void* ctapart, int B, int C, int N, int heads, int w_bf16, int g_bf16,
    int x_bf16, int device, void* stream) {
  if (!linattn_valid(B, C, N, heads)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Weights w{wqkv, wqkv_c, wqkv_h, wout, wout_h, wout_c, b_out, b_out_c,
                  g,    g_c,    g_pre,  g_pre_c, w_bf16};
  const Grads gr{dwqkv, dwqkv_c, dwqkv_h, dwout, dwout_h, dwout_c, db_out, db_out_c,
                 dg,    dg_c,    dg_pre,  dg_pre_c, g_bf16};
  return (int)dq::linattn_sp_bwd_x(x, dy, dx, w, gr, cf(stats), cf(stats_local), cf(z),
                                   f(rowpart), f(ctapart), B, C, N, heads, x_bf16,
                                   static_cast<cudaStream_t>(stream));
}
