// K4: backward of the fused pre-norm linear attention with residual (K1),
// channel-first (B, C, N). Forward, per row (see linear_attention.cu):
//   xh = RMSNorm_{g_pre}(x);  q, k, v = W xh;  qn = softmax_head(q) dh^-1/2
//   kn = softmax_N(k);  ctx = mask . (kn v^T);  u = W_out^T ctx^T qn + b
//   y  = x + RMSNorm_g(u)
// Backward (the derivation of dquartic_tpu/ops/linear_attention.py:707-731):
//   du   = (dy g sqrtC - yh <dy g sqrtC, yh>) / |u|         per column
//   Z    = sum_n qn du^T (H, C);  dqn = M^T du;  dq = qn (dqn - <qn, dqn> dh^1/2)
//   dctx = mask . (Z W_out^T);  dW_out = ctx^T Z;  D2 = dctx W_v;  dW_v = dctx^T bmat
//   dkn  = D2 xh;  T = sum_n kn dkn = rows of D2 . bmat;  dk = kn (dkn - T)
//   dxh  = W_q^T dq + D2^T kn + W_k^T dk;  dx = pre-RMSNorm backward of dxh + dy
// with bmat = sum_n kn xh^T = A / s, A and s the forward's phase-0 sums. The
// only couplings across the sequence are (A, s), Z and T, and T follows
// from Z and (A, s) without a pass over the columns.
//
// Replaces the TPU kernel dquartic_tpu/ops/linear_attention.py:
// _fused_backward_t (_kernel_bwd_a, _kernel_bwd_bc), whose grid carries
// (A, s), Z and T across sequential grid steps. On Hopper the op is one
// cluster launch plus one small launch:
//   * grid (CL, B), a cluster of CL <= 8 CTAs per row, each CTA a
//     contiguous slice of N (CL from the card's cluster occupancy: the
//     fewest waves times columns a CTA); x and dy of the slice are staged
//     in shared memory once where they fit kStageBudget, else the passes
//     read them from device memory (the same code through Slice);
//   * the CTA reads w_qkv, w_out, b_out, g and g_pre in their own dtype
//     through their strides and computes the static shifts itself;
//   * pass 0 sums the CTA's (A, s); rank 0 adds the CL partials in rank
//     order through distributed shared memory and forms M; pass 1 sums Z;
//     rank 0 adds the Z partials in rank order and forms D2, T, and the
//     row's dW_out, dW_v, db and dg; pass 2 forms dx and sums dW_q, dW_k
//     and dg_pre. No (B, C, N) float32 tensor reaches device memory: pass
//     2 recomputes what pass 1 formed per column;
//   * the second launch sums the rows' partials in a fixed order and writes
//     each gradient in its parameter's shape, dtype and strides.
// The same kernel runs the sequence-parallel K6a and K6c
// (linear_attention_sp.cu) in its other modes (Mode below), each a stretch
// of the passes above between two collectives, the cross-rank sums read
// from and written to device memory.
// Every column product runs on tensor cores (mma.sync m16n8k16 / k8) in
// warp tiles of 16 columns: the projections onto features (q, k, dqn,
// dkn) and back onto channels (u, dx_q, D2^T kn, W_k^T dk) as in K1's
// apply pass, each operand split into bf16 (hi, lo) halves and multiplied
// three times (about 16 mantissa bits, far below the float32 gradient
// noise of the softmaxes), and the sums over columns (A, Z, dW_q, dW_k) as
// products whose k runs along the tile's columns, their column-major
// operands transposed in registers by movmatrix; the warps' sums add up in
// warp order, so two calls are bitwise equal. A warp fetches its next
// tile's x and dy while it computes the current one. Per column the op
// does 14 H x C multiply-add passes and 4 H exponentials; at (34, 4, 40000)
// it is bound by the float32 operations of those passes (0.25 ms at 67
// TFLOP/s). Its tiles' fragments take ~250 registers a thread, so an SM
// holds 2 CTAs (8 warps), too few to hide the latency of the dependent
// chains of mma.sync, exponentials and shuffles a head runs.
#include <cooperative_groups.h>

#include "common.cuh"
#include "linattn_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStageBudget = 48 * 1024;  // bytes of staged x and dy per CTA
constexpr float kDhScale = 0.17677669529663687f;  // 32 ** -0.5
// bf16 stride of a feature row of the weight tiles: 8 channels at C <= 8
// (kNarrow), else 16 padded to 24; either keeps ldmatrix rows on distinct
// banks
__host__ __device__ constexpr int row_stride(bool narrow) { return narrow ? 8 : 24; }

// What a launch of the cluster kernel computes. K4 is kFull. K6 (a
// sequence split over ranks) runs the kernel between its collectives, each
// mode one stretch of kFull with the cross-rank sums in device memory:
enum Mode {
  kFull,   // K4: passes 0-2; dx and the gradients' row and CTA partials
  kStats,  // K6a (float32 operands): pass 0; each row's [A | s]
  kSpZ,    // K6c launch 1: M from the summed (A, s); pass 1; the row's Z, db, dg
  kSpX,    // K6c launch 2: M, D2, T from the summed (A, s) and Z; pass 2
};

// K6's tensors: (B, H, C + 1) [A | s] per row and (B, H, C) Z, float32.
struct SpArgs {
  const float* stats;        // kSpZ, kSpX: summed over the ranks
  const float* stats_local;  // kSpX: this rank's own, for dW_out and dW_v
  float* stats_out;          // kStats: the rank's
  float* z;                  // kSpZ: the rank's (out); kSpX: summed over the ranks (in)
};

// Shared memory of a CTA (float offsets; the staged slices in bytes),
// computed on the host. Each bf16 tile holds feature rows (row_stride
// apart), its hi halves then its lo halves.
struct Plan {
  int wq, wk, mf, d2f;   // W_q, W_k, M^T and D2 tiles (H xr floats each)
  int xr;                // their row stride in bf16
  int qs, ks, is, ts;    // qshift' per head; kshift' (log2(e)-scaled), 1/s, T per feature
  int vec;               // b_out, g sqrt(C), g_pre sqrt(C) (16 each)
  int part, psum, arow;  // (H, 16) partials and sums; s; rank 0's A of the row
  int zpart, dvec, pg;   // Z partial; db, dg, dg_pre (16 each); rank 0's P and G (heads, 16, 16)
  int xs, dys;           // byte offsets of the staged x and dy (16-byte aligned)
  int row_bytes;         // byte stride of their channel rows
  int chunk, cl, staged, bytes;
};

Plan make_plan(int C, int H, int N, int elt, int cl) {
  Plan p{};
  p.cl = cl;
  p.chunk = dq::ceil_div(N, cl);
  const int heads = H / kDimHead;
  p.xr = row_stride(C <= 8);
  int off = 0;
  p.wq = off, off += H * p.xr;
  p.wk = off, off += H * p.xr;
  p.mf = off, off += H * p.xr;
  p.d2f = off, off += H * p.xr;
  p.qs = off, off += kMaxH / kDimHead;
  p.ks = off, off += H;
  p.is = off, off += H;
  p.ts = off, off += H;
  p.vec = off, off += 3 * kMaxC;
  p.part = off, off += H * kMaxC;
  p.psum = off, off += H;
  p.arow = off, off += H * kMaxC;
  p.zpart = off, off += H * kMaxC;
  p.dvec = off, off += 3 * kMaxC;
  p.pg = off, off += 2 * heads * kMaxC * kMaxC;
  off = (off + 3) & ~3;
  p.row_bytes = ((p.chunk * elt + 16 + 15) & ~15) + (int)(((long long)N * elt) % 16);
  const long long stage = 2LL * (16 + (long long)C * p.row_bytes);
  p.staged = stage <= kStageBudget;
  if (p.staged) {
    p.xs = off * 4;
    p.dys = p.xs + ((16 + C * p.row_bytes + 15) & ~15);
    p.bytes = p.dys + 16 + C * p.row_bytes;
  } else {
    p.xs = p.dys = 0;
    p.bytes = off * 4;
  }
  return p;
}

// The per-column values of a 16-column warp tile as mma accumulators:
// v[nt][e] at column jc[e >> 1] and feature (or channel) 8 nt + 2 tig + (e & 1).
using Frag4 = float[4][4];

// Features h0 .. h0 + 31 of A W^T for the tile: d[nt][e] = sum_c A[col][c]
// W[h0 + 8 nt + 2 tig + (e & 1)][c], W a feature-row tile (hi th, lo tl),
// A the tile's (hi, lo) fragments over channels (at kNarrow channels 0-7,
// m16n8k8 products; else m16n8k16).
template <bool kNarrow>
__device__ __forceinline__ void project(const __nv_bfloat16* th, const __nv_bfloat16* tl, int h0,
                                        const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                        Frag4& d) {
  constexpr int kXr = row_stride(kNarrow);
  const int lane = threadIdx.x & 31;
  const int rp = (lane & 7) + (lane >> 4) * 8, cp = ((lane >> 3) & 1) * 8;
  const int ra = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int np = 0; np < 2; ++np) {  // n-tiles 2 np, 2 np + 1
    uint32_t bh[4], bl[4];
    if constexpr (kNarrow) {
      ldmatrix_x2(bh[0], bh[1], th + (h0 + np * 16 + ra) * kXr);
      ldmatrix_x2(bl[0], bl[1], tl + (h0 + np * 16 + ra) * kXr);
    } else {
      ldmatrix_x4(bh, th + (h0 + np * 16 + rp) * kXr + cp);
      ldmatrix_x4(bl, tl + (h0 + np * 16 + rp) * kXr + cp);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float(&dd)[4] = d[2 * np + i];
      dd[0] = dd[1] = dd[2] = dd[3] = 0.0f;
      if constexpr (kNarrow)
        mma_split<true>(dd, ah, al, bh[i], 0u, bl[i], 0u);
      else
        mma_split<false>(dd, ah, al, bh[2 * i], bh[2 * i + 1], bl[2 * i], bl[2 * i + 1]);
    }
  }
}

// acc[nt][e] += sum over features h0 .. h0 + 31 of v[col][f] W[f][8 nt + 2
// tig + (e & 1)]: the tile's values of one head back onto the channels, W
// a feature-row tile read transposed.
template <int NT>
__device__ __forceinline__ void back_project(const __nv_bfloat16* th, const __nv_bfloat16* tl,
                                             int h0, const Frag4& v, float (&acc)[NT][4]) {
  constexpr int kXr = row_stride(NT == 1);
  const int lane = threadIdx.x & 31;
  const int ra = (lane & 7) + ((lane >> 3) & 1) * 8, ca = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {  // features h0 + 16 kk ..: n-tiles 2 kk, 2 kk + 1
    uint32_t ah[4], al[4];
    split_bf16(v[2 * kk][0], v[2 * kk][1], ah[0], al[0]);
    split_bf16(v[2 * kk][2], v[2 * kk][3], ah[1], al[1]);
    split_bf16(v[2 * kk + 1][0], v[2 * kk + 1][1], ah[2], al[2]);
    split_bf16(v[2 * kk + 1][2], v[2 * kk + 1][3], ah[3], al[3]);
    uint32_t bh[4], bl[4];
    if constexpr (NT == 1) {
      ldmatrix_x2_trans(bh[0], bh[1], th + (h0 + 16 * kk + ra) * kXr);
      ldmatrix_x2_trans(bl[0], bl[1], tl + (h0 + 16 * kk + ra) * kXr);
    } else {
      ldmatrix_x4_trans(bh, th + (h0 + 16 * kk + ra) * kXr + ca);
      ldmatrix_x4_trans(bl, tl + (h0 + 16 * kk + ra) * kXr + ca);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mma_bf16(acc[nt], ah[0], ah[1], ah[2], ah[3], bh[2 * nt], bh[2 * nt + 1]);
      mma_bf16(acc[nt], ah[0], ah[1], ah[2], ah[3], bl[2 * nt], bl[2 * nt + 1]);
      mma_bf16(acc[nt], al[0], al[1], al[2], al[3], bh[2 * nt], bh[2 * nt + 1]);
    }
  }
}

// The A fragments (hi, lo) of one head's values as a (32 features x 16
// columns) operand: m-tile mt holds features 16 mt .. 16 mt + 15.
__device__ __forceinline__ void feature_rows(const Frag4& v, uint32_t (&ah)[2][4],
                                             uint32_t (&al)[2][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a0..a3: (features +0 | +8) x (columns 0-7 | 8-15)
      const float* src = v[2 * mt + (i & 1)] + 2 * (i >> 1);
      uint32_t hi, lo;
      split_bf16(src[0], src[1], hi, lo);
      ah[mt][i] = movmatrix_trans(hi);
      al[mt][i] = movmatrix_trans(lo);
    }
}

// The B fragments (hi, lo) of the tile's per-column channel values as a
// (16 columns x channels) operand, from their A fragments over channels.
template <int NT>
__device__ __forceinline__ void column_rows(const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                            uint32_t (&bh)[NT][2], uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bh[nt][r] = movmatrix_trans(ah[r + 2 * nt]);
      bl[nt][r] = movmatrix_trans(al[r + 2 * nt]);
    }
}

// acc[mt][nt] += A B over the tile's 16 columns in three products: the sum
// over columns of (features x channels) outer products.
template <int NT>
__device__ __forceinline__ void contract(float (&acc)[2][NT][4], const uint32_t (&ah)[2][4],
                                         const uint32_t (&al)[2][4], const uint32_t (&bh)[NT][2],
                                         const uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mma_bf16(acc[mt][nt], ah[mt][0], ah[mt][1], ah[mt][2], ah[mt][3], bh[nt][0], bh[nt][1]);
      mma_bf16(acc[mt][nt], ah[mt][0], ah[mt][1], ah[mt][2], ah[mt][3], bl[nt][0], bl[nt][1]);
      mma_bf16(acc[mt][nt], al[mt][0], al[mt][1], al[mt][2], al[mt][3], bh[nt][0], bh[nt][1]);
    }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float gid_sum(float v) {  // over the 8 rows of a fragment
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// Stores a bf16 (hi, lo) feature row of the channels a kNarrow (8) or wide
// (16) tile holds.
template <bool kNarrow>
__device__ __forceinline__ void put_row(__nv_bfloat16* th, __nv_bfloat16* tl, int d,
                                        const float* v) {
  constexpr int kXr = row_stride(kNarrow);
#pragma unroll
  for (int c = 0; c < (kNarrow ? 8 : 16); c += 2) {
    uint32_t hi, lo;
    split_bf16(v[c], v[c + 1], hi, lo);
    *reinterpret_cast<uint32_t*>(th + d * kXr + c) = hi;
    *reinterpret_cast<uint32_t*>(tl + d * kXr + c) = lo;
  }
}

// x and dy of a warp tile's 16 columns as the fragments hold them (column
// 8 r + gid, channel 8 nt + 2 tig + e), zero past the slice: fetched one
// tile ahead of the arithmetic.
template <typename T, int NT>
struct Cols {
  float xv[2][NT][2], dyv[2][NT][2];

  __device__ __forceinline__ void fetch(const Slice<T>& xs, const Slice<T>& dys, bool with_dy,
                                        int C, int cols, int j0) {
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = nt * 8 + 2 * tig + e, j = j0 + gid + 8 * r;
          const bool ok = ch < C && j < cols;
          xv[r][nt][e] = ok ? xs.at(ch, j) : 0.0f;
          dyv[r][nt][e] = ok && with_dy ? dys.at(ch, j) : 0.0f;
        }
  }
};

// One warp tile's columns: x as the projections' A fragments (hi, lo) and
// as the columns' operand, u0 = x / |x|, 1 / |x|, and dy.
template <typename T, int NT>
struct Tile {
  int jc[2];
  float u0[2][NT][2], dyv[2][NT][2], rd[2];
  uint32_t ah[4], al[4];            // xh over channels
  uint32_t bxh[NT][2], bxl[NT][2];  // xh as the columns' operand

  __device__ __forceinline__ void load(const Cols<T, NT>& in, const float* gp, int j0) {
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
    jc[0] = j0 + gid, jc[1] = j0 + gid + 8;
    float ss[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dyv[r][nt][e] = in.dyv[r][nt][e];
          ss[r] += in.xv[r][nt][e] * in.xv[r][nt][e];
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rd[r] = 1.0f / fmaxf(sqrtf(quad_sum(ss[r])), 1e-12f);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int ch = nt * 8 + 2 * tig;
#pragma unroll
        for (int e = 0; e < 2; ++e) u0[r][nt][e] = in.xv[r][nt][e] * rd[r];
        split_bf16(u0[r][nt][0] * gp[ch], u0[r][nt][1] * gp[ch + 1], ah[r + 2 * nt],
                   al[r + 2 * nt]);
      }
      if constexpr (NT == 1) ah[r + 2] = al[r + 2] = 0u;
    }
    column_rows<NT>(ah, al, bxh, bxl);
  }
};

// The warp's tiles of a pass: body(tile) for the 16-column tiles warp,
// warp + kWarps, ... of the slice, each tile's x (and dy) fetched while the
// tile before is computed.
template <typename T, int NT, typename Body>
__device__ __forceinline__ void for_tiles(const Slice<T>& xs, const Slice<T>& dys, bool with_dy,
                                          const float* gp, int C, int cols, Body body) {
  Cols<T, NT> next;
  int j0 = (threadIdx.x >> 5) * 16;
  if (j0 < cols) next.fetch(xs, dys, with_dy, C, cols, j0);
  for (; j0 < cols; j0 += kWarps * 16) {
    const Cols<T, NT> cur = next;
    if (j0 + kWarps * 16 < cols) next.fetch(xs, dys, with_dy, C, cols, j0 + kWarps * 16);
    Tile<T, NT> tl;
    tl.load(cur, gp, j0);
    body(tl);
  }
}

// qn of head h for the tile (features h0 + 8 nt + 2 tig + (e & 1)).
template <bool kNarrow, int NT>
__device__ __forceinline__ void head_qn(const __nv_bfloat16* wqh, const __nv_bfloat16* wql,
                                        float qs, int h0, const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], Frag4& q) {
  project<kNarrow>(wqh, wql, h0, ah, al, q);
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      q[nt][e] = fast_exp2(fmaf(q[nt][e], kLog2e, -qs));
      sum[e >> 1] += q[nt][e];
    }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = kDhScale / fmaxf(quad_sum(sum[r]), 1e-30f);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) q[nt][e] *= inv[e >> 1];
}

// u = M qn + b over the tile's columns and the output RMSNorm's backward:
// du as accumulators (col, channel) and as A fragments over channels.
// Keeps each head's qn in qk when kKeep.
template <bool kNarrow, int NT, int kHeads, bool kKeep>
__device__ __forceinline__ void forward_du(const __nv_bfloat16* wqh, const __nv_bfloat16* wql,
                                           const __nv_bfloat16* mh, const __nv_bfloat16* ml,
                                           const float* qs, const float* vec, int C, int heads,
                                           const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           const float (&dyv)[2][NT][2],
                                           Frag4 (&qk)[kKeep ? kHeads : 1], float (&du)[NT][4],
                                           float (&yh)[NT][4], uint32_t (&dah)[4],
                                           uint32_t (&dal)[4]) {
  const int tig = threadIdx.x & 3;
  const float* bo = vec;
  const float* gg = vec + kMaxC;
  float u[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) u[nt][0] = u[nt][1] = u[nt][2] = u[nt][3] = 0.0f;
#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
    if (h >= heads) break;
    Frag4 q;
    head_qn<kNarrow, NT>(wqh, wql, qs[h], h * kDimHead, ah, al, q);
    back_project<NT>(mh, ml, h * kDimHead, q, u);
    if constexpr (kKeep)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) qk[h][nt][e] = q[nt][e];
  }
  float ss[2] = {0.0f, 0.0f}, inner[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ch = nt * 8 + 2 * tig + (e & 1);
      u[nt][e] = ch < C ? u[nt][e] + bo[ch] : 0.0f;
      ss[e >> 1] += u[nt][e] * u[nt][e];
    }
  float rn[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) rn[r] = 1.0f / fmaxf(sqrtf(quad_sum(ss[r])), 1e-12f);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ch = nt * 8 + 2 * tig + (e & 1);
      yh[nt][e] = u[nt][e] * rn[e >> 1];
      inner[e >> 1] += dyv[e >> 1][nt][e & 1] * gg[ch] * yh[nt][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) inner[r] = quad_sum(inner[r]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ch = nt * 8 + 2 * tig + (e & 1), r = e >> 1;
      du[nt][e] = (dyv[r][nt][e & 1] * gg[ch] - yh[nt][e] * inner[r]) * rn[r];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      split_bf16(du[nt][2 * r], du[nt][2 * r + 1], dah[r + 2 * nt], dal[r + 2 * nt]);
  }
  if constexpr (NT == 1) dah[2] = dah[3] = dal[2] = dal[3] = 0u;
}

// dqn = M^T du and dq = qn (dqn - <qn, dqn> dh^1/2) of head h for the tile.
template <bool kNarrow>
__device__ __forceinline__ void head_dq(const __nv_bfloat16* mh, const __nv_bfloat16* ml, int h0,
                                        const uint32_t (&dah)[4], const uint32_t (&dal)[4],
                                        const Frag4& q, Frag4& dq) {
  project<kNarrow>(mh, ml, h0, dah, dal, dq);  // dqn
  float tq[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) tq[e >> 1] = fmaf(q[nt][e], dq[nt][e], tq[e >> 1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) tq[r] = quad_sum(tq[r]) / kDhScale;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] = q[nt][e] * (dq[nt][e] - tq[e >> 1]);
}

// Adds the warps' (H, 16) accumulators of a sum over columns into dst in
// warp order (dst is overwritten by warp 0); acc[h][mt][nt][e] is feature
// 32 h + 16 mt + gid + 8 (e >> 1), channel 8 nt + 2 tig + (e & 1).
template <int NT, int kHeads>
__device__ __forceinline__ void warp_ordered_sum(float* dst, const float (&acc)[kHeads][2][NT][4],
                                                 int heads) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3, warp = threadIdx.x >> 5;
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        if (h >= heads) break;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int f = h * kDimHead + mt * 16 + gid + 8 * (e >> 1);
              float* p = dst + f * kMaxC + nt * 8 + 2 * tig + (e & 1);
              *p = (w ? *p : 0.0f) + acc[h][mt][nt][e];
            }
      }
    }
    __syncthreads();
  }
}

// The same for per-thread channel sums v[nt][e] (channel 8 nt + 2 tig + e),
// summed over the fragment rows first.
template <int NT>
__device__ __forceinline__ void warp_ordered_vec(float* dst, float (&v)[NT][2]) {
  const int lane = threadIdx.x & 31, tig = lane & 3, warp = threadIdx.x >> 5;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) v[nt][e] = gid_sum(v[nt][e]);
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w && lane < 4)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float* p = dst + nt * 8 + 2 * tig + e;
          *p = (w ? *p : 0.0f) + v[nt][e];
        }
    __syncthreads();
  }
}

template <typename T, bool kNarrow, int kHeads, int kMode>
__global__ void __launch_bounds__(kThreads) linattn_bwd_cluster(
    const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx, Weights w, Plan p,
    SpArgs sp, float* __restrict__ rowpart, float* __restrict__ ctapart, int C, int N,
    int heads) {
  constexpr int NT = kNarrow ? 1 : 2;  // n-tiles of 8 channels
  constexpr bool kKeep = kNarrow && kHeads == 4;  // qn of every head stays in registers
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cl = (int)cluster.num_blocks();
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, tig = lane & 3;
  const int b = blockIdx.y, H = heads * kDimHead, HC = H * C;
  const int nbeg = min(N, rank * p.chunk), cols = min(N, nbeg + p.chunk) - nbeg;
  constexpr int kXr = row_stride(kNarrow);
  auto tile = [&](int off, int half) {
    return reinterpret_cast<__nv_bfloat16*>(smem + off) + half * H * kXr;
  };
  __nv_bfloat16 *wqh = tile(p.wq, 0), *wql = tile(p.wq, 1), *wkh = tile(p.wk, 0),
                *wkl = tile(p.wk, 1), *mh = tile(p.mf, 0), *ml = tile(p.mf, 1),
                *d2h = tile(p.d2f, 0), *d2l = tile(p.d2f, 1);
  float* qs = smem + p.qs;
  float* ks = smem + p.ks;
  float* inv_s = smem + p.is;
  float* ts = smem + p.ts;
  float* vec = smem + p.vec;  // b_out, g sqrt(C), g_pre sqrt(C)
  float* gp = vec + 2 * kMaxC;
  float* part = smem + p.part;
  float* psum = smem + p.psum;
  float* arow = smem + p.arow;
  float* zpart = smem + p.zpart;
  float* dvec = smem + p.dvec;  // db, dg, dg_pre
  float* pmat = smem + p.pg;    // P_h[c'][c] = sum_{e in h} W_v[e][c'] W_out[e][c]
  float* gmat = pmat + heads * kMaxC * kMaxC;  // G_h[c'][c] = sum_{d in h} bmat[d][c'] Z[d][c]
  const float rs = sqrtf((float)C);

  // 1. stage the slices (async); meanwhile the weights and static shifts
  const long long row0 = (long long)b * C * N + nbeg;
  Slice<T> xs{reinterpret_cast<const char*>(smem) + p.xs +
                  (reinterpret_cast<uintptr_t>(x + row0) & 15),
              p.row_bytes, x + row0, N, (bool)p.staged};
  Slice<T> dys{reinterpret_cast<const char*>(smem) + p.dys +
                   (reinterpret_cast<uintptr_t>(dy + row0) & 15),
               p.row_bytes, dy + row0, N, (bool)p.staged};
  if (p.staged) {
    stage_rows<T>(const_cast<char*>(xs.xs), p.row_bytes, xs.xg, N, C, cols);
    if (kMode != kStats) stage_rows<T>(const_cast<char*>(dys.xs), p.row_bytes, dys.xg, N, C, cols);
  }
  const bool bq = w.bf16 & 1, bo = w.bf16 & 2;
  if (t < kMaxC) {
    const bool ok = t < C && kMode != kStats;  // kStats reads w_qkv and g_pre alone
    vec[t] = ok ? ld(w.b_out, t * w.b_out_c, w.bf16 & 4) : 0.0f;
    vec[kMaxC + t] = ok ? ld(w.g, t * w.g_c, w.bf16 & 8) * rs : 0.0f;
    gp[t] = t < C ? ld(w.g_pre, t * w.g_pre_c, w.bf16 & 16) * rs : 0.0f;
  }
  __syncthreads();
  float cn = 0.0f;  // sqrt(C) max |g_pre| bounds every pre-normed column's norm
  for (int c = 0; c < C; ++c) cn = fmaxf(cn, fabsf(gp[c]));
  // rows 0..H-1: W_q (not read by kStats); H..2H-1: W_k
  for (int d = (kMode == kStats ? H : 0) + t; d < 2 * H; d += kThreads) {
    float v[16], nrm = 0.0f;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      v[c] = c < C ? ld(w.wqkv, c * w.wqkv_c + d * w.wqkv_h, bq) : 0.0f;
      nrm += v[c] * v[c];
    }
    if (d < H)
      put_row<kNarrow>(wqh, wql, d, v);
    else
      put_row<kNarrow>(wkh, wkl, d - H, v);
    float bnd = sqrtf(nrm) * cn;
    if (d < H) {  // whole warps: a head is 32 rows of one warp
#pragma unroll
      for (int off = 16; off; off >>= 1) bnd = fmaxf(bnd, __shfl_xor_sync(0xffffffffu, bnd, off));
      if ((d & 31) == 0) qs[d / kDimHead] = bnd * kLog2e;
    } else {
      ks[d - H] = bnd * kLog2e;
    }
  }
  if (p.staged) asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // 2. pass 0: the slice's A = sum p xh^T and s = sum p
  if constexpr (kMode == kFull || kMode == kStats) {
    float acc[kHeads][2][NT][4] = {};
    float sv[kHeads][4][2] = {};
    for_tiles<T, NT>(xs, dys, false, gp, C, cols, [&](const Tile<T, NT>& tl) {
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        if (h >= heads) break;
        Frag4 k;
        project<kNarrow>(wkh, wkl, h * kDimHead, tl.ah, tl.al, k);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int f = h * kDimHead + nt * 8 + 2 * tig + (e & 1);
            const float pk = tl.jc[e >> 1] < cols ? fast_exp2(fmaf(k[nt][e], kLog2e, -ks[f])) : 0.0f;
            k[nt][e] = pk;
            sv[h][nt][e & 1] += pk;
          }
        uint32_t fh[2][4], fl[2][4];
        feature_rows(k, fh, fl);
        contract<NT>(acc[h], fh, fl, tl.bxh, tl.bxl);
      }
    });
    warp_ordered_sum<NT, kHeads>(part, acc, heads);
    // s: rows of the fragments, then the warps in order
#pragma unroll
    for (int h = 0; h < kHeads; ++h)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) sv[h][nt][e] = gid_sum(sv[h][nt][e]);
    for (int ww = 0; ww < kWarps; ++ww) {
      if (warp == ww && lane < 4)
#pragma unroll
        for (int h = 0; h < kHeads; ++h) {
          if (h >= heads) break;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float* q = psum + h * kDimHead + nt * 8 + 2 * tig + e;
              *q = (ww ? *q : 0.0f) + sv[h][nt][e];
            }
        }
      __syncthreads();
    }
    cluster.sync();  // #1: every CTA's (A, s) is visible to the cluster
  }

  // 3. rank 0: the row's (A, s) in rank order (K6: the sums over the ranks,
  // from device memory), P_h, M = W_out^T ctx^T
  if (rank == 0) {
    for (int d = t; d < H; d += kThreads) {
      float a[16] = {}, s = 0.0f;
      if constexpr (kMode == kFull || kMode == kStats) {
        for (int r = 0; r < cl; ++r) {
          const float* src = cluster.map_shared_rank(part, r) + d * kMaxC;
#pragma unroll
          for (int c = 0; c < 16; ++c)
            if (c < C) a[c] += src[c];
          s += cluster.map_shared_rank(psum, r)[d];
        }
      } else {
        const float* src = sp.stats + ((long long)b * H + d) * (C + 1);
#pragma unroll
        for (int c = 0; c < 16; ++c)
          if (c < C) a[c] = src[c];
        s = src[C];
      }
      if constexpr (kMode == kStats) {
        float* dst = sp.stats_out + ((long long)b * H + d) * (C + 1);
#pragma unroll
        for (int c = 0; c < 16; ++c)
          if (c < C) dst[c] = a[c];
        dst[C] = s;
      }
#pragma unroll
      for (int c = 0; c < 16; ++c) arow[d * kMaxC + c] = a[c];
      inv_s[d] = 1.0f / fmaxf(s, 1e-30f);
    }
  }
  if constexpr (kMode == kStats) {
    cluster.sync();  // the partials stay until rank 0 has read them
    return;
  }
  if (rank == 0) {
    for (int i = t; i < heads * kMaxC * kMaxC; i += kThreads) {
      const int h = i / (kMaxC * kMaxC), c1 = i / kMaxC % kMaxC, c = i % kMaxC;
      float v = 0.0f;
      if (c1 < C && c < C)
        for (int e = h * kDimHead; e < (h + 1) * kDimHead; ++e)
          v = fmaf(ld(w.wqkv, c1 * w.wqkv_c + (2 * H + e) * w.wqkv_h, bq),
                   ld(w.wout, e * w.wout_h + c * w.wout_c, bo), v);
      pmat[i] = v;
    }
    __syncthreads();
    // M[c][d] = inv_s[d] sum_c' A[d][c'] P_h[c'][c]
    for (int d = t; d < H; d += kThreads) {
      const float* pm = pmat + (d / kDimHead) * kMaxC * kMaxC;
      float m[16] = {};
      for (int c1 = 0; c1 < C; ++c1) {
        const float a = arow[d * kMaxC + c1] * inv_s[d];
#pragma unroll
        for (int c = 0; c < 16; ++c) m[c] = fmaf(a, pm[c1 * kMaxC + c], m[c]);
      }
      put_row<kNarrow>(mh, ml, d, m);
    }
  }
  cluster.sync();  // #2: M and 1/s are in rank 0's shared memory
  if (rank != 0) {
    const uint32_t* m0 = reinterpret_cast<const uint32_t*>(cluster.map_shared_rank(smem + p.mf, 0));
    uint32_t* m1 = reinterpret_cast<uint32_t*>(smem + p.mf);
    for (int i = t; i < H * kXr; i += kThreads) m1[i] = m0[i];  // hi and lo: H kXr words
    const float* s0 = cluster.map_shared_rank(inv_s, 0);
    for (int i = t; i < H; i += kThreads) inv_s[i] = s0[i];
  }
  cluster.sync();  // #3: every CTA has its copy

  // 4. pass 1: Z = sum qn du^T, db = sum du, dg = sum dy yh
  if constexpr (kMode == kFull || kMode == kSpZ) {
    float zacc[kHeads][2][NT][4] = {};
    float db[NT][2] = {}, dg[NT][2] = {};
    for_tiles<T, NT>(xs, dys, true, gp, C, cols, [&](const Tile<T, NT>& tl) {
      Frag4 qk[kKeep ? kHeads : 1];
      float du[NT][4], yh[NT][4];
      uint32_t dah[4], dal[4];
      forward_du<kNarrow, NT, kHeads, kKeep>(wqh, wql, mh, ml, qs, vec, C, heads, tl.ah, tl.al,
                                             tl.dyv, qk, du, yh, dah, dal);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          db[nt][e & 1] += du[nt][e];
          dg[nt][e & 1] = fmaf(tl.dyv[e >> 1][nt][e & 1], yh[nt][e], dg[nt][e & 1]);
        }
      uint32_t bdh[NT][2], bdl[NT][2];
      column_rows<NT>(dah, dal, bdh, bdl);
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        if (h >= heads) break;
        Frag4 q;
        if constexpr (kKeep)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) q[nt][e] = qk[h][nt][e];
        else
          head_qn<kNarrow, NT>(wqh, wql, qs[h], h * kDimHead, tl.ah, tl.al, q);
        uint32_t fh[2][4], fl[2][4];
        feature_rows(q, fh, fl);
        contract<NT>(zacc[h], fh, fl, bdh, bdl);
      }
    });
    warp_ordered_sum<NT, kHeads>(zpart, zacc, heads);
    warp_ordered_vec<NT>(dvec, db);
    warp_ordered_vec<NT>(dvec + kMaxC, dg);
    cluster.sync();  // #4: every CTA's Z, db, dg partials are visible
  }

  // 5. rank 0: Z of the row in rank order (kSpX: the sum over the ranks,
  // from device memory); G_h, D2, T; the row's dW_out, dW_v, db and dg
  // (kSpZ: the row's Z, db, dg alone, to device memory)
  float* row = rowpart + (long long)b * (2 * HC + 2 * C);
  float* zrow = part;
  if (rank == 0) {
    for (int d = t; d < H; d += kThreads)
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        float z = 0.0f;
        if (c < C) {
          if constexpr (kMode == kSpX) {
            z = sp.z[((long long)b * H + d) * C + c];
          } else {
            for (int r = 0; r < cl; ++r) z += cluster.map_shared_rank(zpart, r)[d * kMaxC + c];
            if constexpr (kMode == kSpZ) sp.z[((long long)b * H + d) * C + c] = z;
          }
        }
        zrow[d * kMaxC + c] = z;
      }
    if (kMode != kSpX && t < 2 * C) {  // db, then dg
      const int off = t < C ? t : kMaxC + t - C;
      float v = 0.0f;
      for (int r = 0; r < cl; ++r) v += cluster.map_shared_rank(dvec, r)[off];
      row[2 * HC + t] = t < C ? v : v * rs;
    }
  }
  if constexpr (kMode == kSpZ) {
    cluster.sync();  // the partials stay until rank 0 has read them
    return;
  }
  if (rank == 0) {
    __syncthreads();
    // G_h[c'][c] = sum_{d in h} bmat[d][c'] Z[d][c]; under K6 with this
    // rank's bmat (its own A over the summed s) and the summed Z, so that
    // the ranks' dW_out and dW_v add up to the gradient
    for (int i = t; i < heads * kMaxC * kMaxC; i += kThreads) {
      const int h = i / (kMaxC * kMaxC), c1 = i / kMaxC % kMaxC, c = i % kMaxC;
      float v = 0.0f;
      if (c1 < C && c < C)
        for (int d = h * kDimHead; d < (h + 1) * kDimHead; ++d) {
          const float a = kMode == kSpX ? sp.stats_local[((long long)b * H + d) * (C + 1) + c1]
                                        : arow[d * kMaxC + c1];
          v = fmaf(a * inv_s[d], zrow[d * kMaxC + c], v);
        }
      gmat[i] = v;
    }
    // D2[d][c] = sum_c' Z[d][c'] P_h[c][c'];  T[d] = D2[d] . bmat[d]
    for (int d = t; d < H; d += kThreads) {
      const float* pm = pmat + (d / kDimHead) * kMaxC * kMaxC;
      float d2[16] = {}, tt = 0.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        if (c < C)
          for (int c1 = 0; c1 < C; ++c1) d2[c] = fmaf(zrow[d * kMaxC + c1], pm[c * kMaxC + c1], d2[c]);
        tt = fmaf(d2[c], arow[d * kMaxC + c], tt);
      }
      put_row<kNarrow>(d2h, d2l, d, d2);
      ts[d] = tt * inv_s[d];
    }
    __syncthreads();
    // dW_out[e][c] = sum_c' W_v[e][c'] G_h[c'][c];  dW_v[e][c] = sum_c' W_out[e][c'] G_h[c][c']
    for (int i = t; i < HC; i += kThreads) {
      const int e = i / C, c = i % C;
      const float* gm = gmat + (e / kDimHead) * kMaxC * kMaxC;
      float o = 0.0f, v = 0.0f;
      for (int c1 = 0; c1 < C; ++c1) {
        o = fmaf(ld(w.wqkv, c1 * w.wqkv_c + (2 * H + e) * w.wqkv_h, bq), gm[c1 * kMaxC + c], o);
        v = fmaf(ld(w.wout, e * w.wout_h + c1 * w.wout_c, bo), gm[c * kMaxC + c1], v);
      }
      row[i] = o;
      row[HC + i] = v;
    }
  }
  cluster.sync();  // #5: D2 and T are in rank 0's shared memory
  if (rank != 0) {
    const uint32_t* d0 = reinterpret_cast<const uint32_t*>(cluster.map_shared_rank(smem + p.d2f, 0));
    uint32_t* d1 = reinterpret_cast<uint32_t*>(smem + p.d2f);
    for (int i = t; i < H * kXr; i += kThreads) d1[i] = d0[i];
    const float* t0 = cluster.map_shared_rank(ts, 0);
    for (int i = t; i < H; i += kThreads) ts[i] = t0[i];
  }
  cluster.sync();  // #6: every CTA has its copy; rank 0 may go on and exit

  // 6. pass 2: dx, dW_q = sum dq xh^T, dW_k = sum dk xh^T, dg_pre = sum dxh u0
  if constexpr (kMode == kFull || kMode == kSpX) {
    float qacc[kHeads][2][NT][4] = {}, kacc[kHeads][2][NT][4] = {};
    float dgp[NT][2] = {};
    for_tiles<T, NT>(xs, dys, true, gp, C, cols, [&](const Tile<T, NT>& tl) {
      Frag4 qk[kKeep ? kHeads : 1];
      float du[NT][4], yh[NT][4], dxh[NT][4] = {};
      uint32_t dah[4], dal[4];
      forward_du<kNarrow, NT, kHeads, kKeep>(wqh, wql, mh, ml, qs, vec, C, heads, tl.ah, tl.al,
                                             tl.dyv, qk, du, yh, dah, dal);
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        if (h >= heads) break;
        const int h0 = h * kDimHead;
        Frag4 q, dq;
        if constexpr (kKeep)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) q[nt][e] = qk[h][nt][e];
        else
          head_qn<kNarrow, NT>(wqh, wql, qs[h], h0, tl.ah, tl.al, q);
        head_dq<kNarrow>(mh, ml, h0, dah, dal, q, dq);
        back_project<NT>(wqh, wql, h0, dq, dxh);  // W_q^T dq
        uint32_t fh[2][4], fl[2][4];
        feature_rows(dq, fh, fl);
        contract<NT>(qacc[h], fh, fl, tl.bxh, tl.bxl);
        Frag4 kn, dk;
        project<kNarrow>(wkh, wkl, h0, tl.ah, tl.al, kn);
        project<kNarrow>(d2h, d2l, h0, tl.ah, tl.al, dk);  // dkn
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int f = h0 + nt * 8 + 2 * tig + (e & 1);
            kn[nt][e] = tl.jc[e >> 1] < cols
                            ? fast_exp2(fmaf(kn[nt][e], kLog2e, -ks[f])) * inv_s[f] : 0.0f;
            dk[nt][e] = kn[nt][e] * (dk[nt][e] - ts[f]);
          }
        back_project<NT>(d2h, d2l, h0, kn, dxh);  // D2^T kn
        back_project<NT>(wkh, wkl, h0, dk, dxh);  // W_k^T dk
        feature_rows(dk, fh, fl);
        contract<NT>(kacc[h], fh, fl, tl.bxh, tl.bxl);
      }
      // the pre-RMSNorm backward and the residual
      float inner[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = nt * 8 + 2 * tig + (e & 1);
          const float u0 = tl.u0[e >> 1][nt][e & 1];
          dgp[nt][e & 1] = fmaf(dxh[nt][e], u0, dgp[nt][e & 1]);
          inner[e >> 1] = fmaf(dxh[nt][e] * gp[ch], u0, inner[e >> 1]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) inner[r] = quad_sum(inner[r]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = nt * 8 + 2 * tig + (e & 1), r = e >> 1;
          if (ch < C && tl.jc[r] < cols) {
            const float v = (dxh[nt][e] * gp[ch] - tl.u0[r][nt][e & 1] * inner[r]) * tl.rd[r] +
                            tl.dyv[r][nt][e & 1];
            dx[row0 + (long long)ch * N + tl.jc[r]] = dq::from_f32<T>(v);
          }
        }
    });
    warp_ordered_sum<NT, kHeads>(part, qacc, heads);
    warp_ordered_sum<NT, kHeads>(zpart, kacc, heads);  // Z's partial was read before #5
    warp_ordered_vec<NT>(dvec + 2 * kMaxC, dgp);
    float* dst = ctapart + ((long long)b * cl + rank) * (2 * HC + C);
    for (int i = t; i < HC; i += kThreads) {
      const int f = (i / C) * kMaxC + i % C;
      dst[i] = part[f];
      dst[HC + i] = zpart[f];
    }
    if (t < C) dst[2 * HC + t] = dvec[2 * kMaxC + t] * rs;
  }
}

__device__ __forceinline__ void st(void* p, long long i, bool bf16, float v) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

// The second launch: each gradient entry summed over the rows (and their
// CTAs) by one warp, lane l taking the partials l, l + 32, ... and a
// butterfly adding the lanes (a fixed order), then written in its
// parameter's dtype through its strides. rowpart (B, 2HC + 2C): dW_out |
// dW_v | db | dg; ctapart (B, cl, 2HC + C): dW_q | dW_k | dg_pre, features
// major.
__global__ void __launch_bounds__(256) linattn_bwd_finish(const float* __restrict__ rowpart,
                                                          const float* __restrict__ ctapart,
                                                          Grads g, int B, int cl, int C, int H) {
  const int HC = H * C, i = (blockIdx.x * 256 + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (i >= 4 * HC + 3 * C) return;  // whole warps
  const long long lr = 2 * HC + 2 * C, lc = 2 * HC + C;
  // the entry's partials: per CTA (dW_q, dW_k, dg_pre) or per row
  const bool per_cta = i < 2 * HC || i >= 4 * HC + 2 * C;
  const float* src = per_cta ? ctapart + (i < 2 * HC ? i : i - 2 * HC - 2 * C)
                             : rowpart + (i < 3 * HC ? i - HC : i < 4 * HC ? i - 3 * HC : i - 2 * HC);
  const long long n = per_cta ? (long long)B * cl : B, step = per_cta ? lc : lr;
  float s = 0.0f;
  for (long long k = lane; k < n; k += 32) s += src[k * step];
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane != 0) return;
  const int c = i % C;
  if (i < 3 * HC) {  // w_qkv[c][j]: dW_q (j = d), dW_k (j = H + d), dW_v (j = 2H + e)
    st(g.wqkv, c * g.wqkv_c + (i / C) * g.wqkv_h, g.bf16 & 1, s);
  } else if (i < 4 * HC) {  // dW_out[e][c]
    st(g.wout, ((i - 3 * HC) / C) * g.wout_h + c * g.wout_c, g.bf16 & 2, s);
  } else if (i < 4 * HC + C) {
    st(g.b_out, c * g.b_out_c, g.bf16 & 4, s);
  } else if (i < 4 * HC + 2 * C) {
    st(g.g, c * g.g_c, g.bf16 & 8, s);
  } else {
    st(g.g_pre, c * g.g_pre_c, g.bf16 & 16, s);
  }
}

template <typename T, bool kNarrow, int kHeads, int kMode>
cudaError_t run_v(const void* x, const void* dy, void* dx, const Weights& w, const Grads& g,
                  const SpArgs& sp, float* rowpart, float* ctapart, int B, int C, int N,
                  int heads, cudaStream_t s, Plan* plan_only) {
  auto kernel = linattn_bwd_cluster<T, kNarrow, kHeads, kMode>;
  const int H = heads * kDimHead;
  Plan p;
  cudaError_t err = choose_cluster(kernel, kThreads, B, C, N, H,
                                   [&](int cl) { return make_plan(C, H, N, sizeof(T), cl); }, &p);
  if (err != cudaSuccess) return err;
  if (plan_only) {
    *plan_only = p;
    return cudaSuccess;
  }
  err = launch_cluster(kernel, p.cl, B, kThreads, p.bytes, s, static_cast<const T*>(x),
                       static_cast<const T*>(dy), static_cast<T*>(dx), w, p, sp, rowpart,
                       ctapart, C, N, heads);
  if (err != cudaSuccess || kMode == kStats || kMode == kSpZ) return err;
  const int outs = 4 * H * C + 3 * C;
  linattn_bwd_finish<<<dq::ceil_div(outs * 32, 256), 256, 0, s>>>(rowpart, ctapart, g, B, p.cl, C, H);
  return cudaGetLastError();
}

// kNarrow: C <= 8 (one n-tile of channels, k8 projections); kHeads: the
// register arrays' head count (4, or 8 for more heads).
template <typename T, int kMode>
cudaError_t run(const void* x, const void* dy, void* dx, const Weights& w, const Grads& g,
                const SpArgs& sp, float* rowpart, float* ctapart, int B, int C, int N, int heads,
                cudaStream_t s, Plan* plan_only = nullptr) {
#define DQ_RUN(NARROW, HEADS)                                                                 \
  run_v<T, NARROW, HEADS, kMode>(x, dy, dx, w, g, sp, rowpart, ctapart, B, C, N, heads, s, \
                                 plan_only)
  if (C <= 8) return heads <= 4 ? DQ_RUN(true, 4) : DQ_RUN(true, 8);
  return heads <= 4 ? DQ_RUN(false, 4) : DQ_RUN(false, 8);
#undef DQ_RUN
}

}  // namespace

// K6 on K4's kernel (see linattn_common.cuh).
cudaError_t dq::linattn_bwd_stats(const void* x, float* stats, const Weights& w, int B, int C,
                                  int N, int heads, cudaStream_t s) {
  const SpArgs sp{nullptr, nullptr, stats, nullptr};
  return run<__nv_bfloat16, kStats>(x, x, nullptr, w, Grads{}, sp, nullptr, nullptr, B, C, N,
                                    heads, s);
}

cudaError_t dq::linattn_sp_bwd_z(const void* x, const void* dy, const Weights& w,
                                 const float* stats, float* z, float* rowpart, int B, int C,
                                 int N, int heads, bool bf16, cudaStream_t s) {
  const SpArgs sp{stats, nullptr, nullptr, z};
  return bf16 ? run<__nv_bfloat16, kSpZ>(x, dy, nullptr, w, Grads{}, sp, rowpart, nullptr, B, C,
                                         N, heads, s)
              : run<float, kSpZ>(x, dy, nullptr, w, Grads{}, sp, rowpart, nullptr, B, C, N,
                                 heads, s);
}

cudaError_t dq::linattn_sp_bwd_x(const void* x, const void* dy, void* dx, const Weights& w,
                                 const Grads& g, const float* stats, const float* stats_local,
                                 const float* z, float* rowpart, float* ctapart, int B, int C,
                                 int N, int heads, bool bf16, cudaStream_t s) {
  const SpArgs sp{stats, stats_local, nullptr, const_cast<float*>(z)};
  return bf16 ? run<__nv_bfloat16, kSpX>(x, dy, dx, w, g, sp, rowpart, ctapart, B, C, N, heads,
                                         s)
              : run<float, kSpX>(x, dy, dx, w, g, sp, rowpart, ctapart, B, C, N, heads, s);
}

// x, dy, dx: contiguous (B, C, N) of x's dtype (x_bf16). The weights as in
// Weights and their gradients as in Grads, each with its strides and dtype
// bits. rowpart: B (2 H C + 2 C) float32; ctapart: B 8 (2 H C + C) float32.
extern "C" int dq_linear_attention_bwd(
    const void* x, const void* dy, void* dx, const void* wqkv, long long wqkv_c,
    long long wqkv_h, const void* wout, long long wout_h, long long wout_c, const void* b_out,
    long long b_out_c, const void* g, long long g_c, const void* g_pre, long long g_pre_c,
    void* dwqkv, long long dwqkv_c, long long dwqkv_h, void* dwout, long long dwout_h,
    long long dwout_c, void* db_out, long long db_out_c, void* dg, long long dg_c, void* dg_pre,
    long long dg_pre_c, void* rowpart, void* ctapart, int B, int C, int N, int heads,
    int w_bf16, int g_bf16, int x_bf16, int device, void* stream) {
  if (!linattn_valid(B, C, N, heads)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Weights w{wqkv, wqkv_c, wqkv_h, wout, wout_h, wout_c, b_out, b_out_c,
                  g,    g_c,    g_pre,  g_pre_c, w_bf16};
  const Grads gr{dwqkv, dwqkv_c, dwqkv_h, dwout, dwout_h, dwout_c, db_out, db_out_c,
                 dg,    dg_c,    dg_pre,  dg_pre_c, g_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* rp = static_cast<float*>(rowpart);
  float* cp = static_cast<float*>(ctapart);
  err = x_bf16 ? run<__nv_bfloat16, kFull>(x, dy, dx, w, gr, SpArgs{}, rp, cp, B, C, N, heads, s)
               : run<float, kFull>(x, dy, dx, w, gr, SpArgs{}, rp, cp, B, C, N, heads, s);
  return (int)err;
}

// The launch shape K4 takes for (B, C, N): out[0] CTAs per cluster, out[1]
// whether the slices are staged in shared memory, out[2] the dynamic shared
// memory of a CTA in bytes.
extern "C" int dq_linear_attention_bwd_plan(int B, int C, int N, int heads, int x_bf16,
                                            int device, int* out) {
  if (!linattn_valid(B, C, N, heads)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Plan p;
  err = x_bf16 ? run<__nv_bfloat16, kFull>(nullptr, nullptr, nullptr, Weights{}, Grads{}, SpArgs{},
                                           nullptr, nullptr, B, C, N, heads, nullptr, &p)
               : run<float, kFull>(nullptr, nullptr, nullptr, Weights{}, Grads{}, SpArgs{}, nullptr,
                                   nullptr, B, C, N, heads, nullptr, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.cl;
  out[1] = p.staged;
  out[2] = p.bytes;
  return 0;
}
