// K8 and K9: row-blocked linear attention + out-projection + RMSNorm,
// forward, without pre-norm or residual, on (B, N, C) activations read and
// written through strides (the model hands over channel-first (B, C, N)
// memory as a transposed view, so no copy is made). Per row b:
//   k = W_k x, q = W_q x                                (H, N), never stored
//   m = max_n k,  p = exp(k - m)                        per feature d
//   s = sum_n p,  A = sum_n p x^T                       (H,), (H, C)
//   ctx = (A W_v^T masked to same-head pairs) / s       (H, H)
//   M   = W_out^T ctx^T                                 (C, H)
//   q^  = softmax over each head's 32 features of q, * dh^-1/2
//   y   = RMSNorm_g(M q^ + b_out)                       per column, x's dtype
// Everything is float32-accurate inside; only y is rounded to x's dtype, as
// the TPU kernels cast x and every weight to float32 and the result back.
//
// Replaces the TPU kernels of dquartic_tpu/ops/linear_attention.py:
//   K8 _fused_forward_single (pallas_call at :298, body _kernel_ab), whose
//      grid (B, 2, blocks) runs phase 0 over a row's blocks in order with a
//      running max, keeps the context in VMEM and runs phase 1;
//   K9 _fused_forward (pallas_calls at :1160 and :1181, bodies _kernel_a
//      and _kernel_b), the same function with the context through HBM.
//
// K8 is one launch (linattn_rows_cluster): grid (CL, B), a thread-block
// cluster of CL CTAs per row, CL from the card's occupancy (choose_cluster),
// 256 threads a CTA, each CTA owning a contiguous slice of N:
//   1. the CTA stages its slice of x in shared memory once with cp.async
//      (channel rows for channel-first memory, one block for row-major; a
//      slice over kStageBudget, or of other strides, is read from device
//      memory by the passes instead) and meanwhile reads w_qkv, w_out,
//      b_out and g in their own dtype through their strides, scaling W_q
//      and W_k by log2(e) (every exp is an exp2): no host work on them;
//   2. phase 0 in tiles of kTile columns with a running max per tile, not
//      per column: k of the tile, each feature's max over the tile, s and A
//      rescaled once by exp(m_old - m_new) where the max grew, then p and
//      the sums; warps (bf16) or thread groups (float32) of a feature merge
//      their (m, s, A) in a fixed order;
//   3. after cluster.sync(), rank 0 merges the CL partials in rank order
//      through distributed shared memory (m = max m_i, f_i = e^(m_i - m))
//      and folds W_v and W_out into M in its shared memory; every other CTA
//      copies M after a second cluster.sync(), a third keeps rank 0 alive;
//   4. apply over the slice: q, the per-head softmax shifted by each head's
//      own max (the reference's numbers exactly), y = RMSNorm_g(M q^ + b).
// bf16 x runs every product on tensor cores at float32 accuracy (mma.cuh's
// bf16 (hi, lo) halves): x is exact in bf16, so k = W_k x and q = W_q x and
// A = P X^T take two products each (the float32 operand's two halves times
// x), and y = M q^, both operands float32, three. Nothing is rounded to
// bf16 before y, as the reference rounds nothing. float32 x runs on CUDA
// cores in float32, the weights of a thread's feature in registers in phase
// 0. exp is ex2.approx.ftz (a weight below 2^-126 of its max counts as 0).
//
// Bound: per column, four H x C multiply-add passes (k and A in phase 0,
// q and M q^ in phase 1), float32-accurate, and 2H exponentials against 2C
// values read and C written: at C <= 16 operations and the SFU bound it,
// not memory traffic (see chip_smoke.py's bound_ms and exp floor).
//
// K9 is two launches of the same kernel, with M through device memory as
// the TPU's K9 carries its context through HBM: in its context mode
// (kContext) the cluster runs steps 1-3 (only W_k, W_v and W_out read) and
// rank 0 writes the row's M (C x H, float32) to device memory; in its apply
// mode (kApply) a plain grid of independent CTAs, as many a row as spread
// evenly over the SMs in one wave (choose_grid), each reads M, stages its
// slice and runs step 4 (only W_q, b_out and g read). The mode is a
// template argument (kFused: K8), instantiated for x's two dtypes and the
// four channel widths CB.
#include <cooperative_groups.h>
#include <math_constants.h>

#include "common.cuh"
#include "linattn_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // threads per CTA of the cluster kernels
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;     // columns of a phase-0 tile
constexpr float kDhScale = 0.17677669529663687f;  // 32 ** -0.5

struct Strides {
  long long b, n, c;
};

constexpr int kStageBudget = 100 * 1024;  // bytes of a CTA's staged slice
constexpr int kXr = 24;  // row stride (bf16) of 16-channel rows: ldmatrix rows on distinct banks

// Shared-memory plan of a K8 launch (float offsets, then the staged slice
// in bytes), computed on the host for a cluster size.
struct RowsPlan {
  int wq, wk, ms, part, psum, pmax, vec, scratch;
  int xs;        // byte offset of the staged slice (16-byte aligned)
  int row_span;  // channel-first: a staged row's bytes before its phase, a multiple of 16
  int chunk;     // columns per CTA
  int cl;        // CTAs per cluster
  int staged;    // the slice fits kStageBudget
  int bytes;
};

// The kernel's modes: the whole op, one cluster launch (kFused, K8); the
// context of K9's two launches, a cluster launch whose rank 0 writes the
// row's M to device memory (kContext); their apply, a launch of independent
// CTAs that read M (kApply).
enum Mode { kFused, kContext, kApply };

// The plan of a launch in mode `mode` with `cl` CTAs a row: a region a mode
// does not use takes no room.
RowsPlan rows_plan(int mode, int C, int CB, int H, int N, int elt, int cl) {
  RowsPlan p{};
  p.cl = cl;
  p.chunk = dq::ceil_div(N, cl);
  const bool mma = elt == 2;  // bf16 runs the tensor-core passes
  const bool sums = mode != kApply, applies = mode != kContext;
  const int nb = (CB + 7) / 8 * 8;
  int off = 0;
  p.wq = off;                     // W_q' rows, log2(e)-scaled: bf16 (hi, lo) rows of 16
  if (applies) off += mma ? H * kXr : H * CB;  // channels, stride kXr, or float32 (d, CB)
  p.wk = off;                     // W_k' rows (d, CB), log2(e)-scaled
  if (sums) off += H * CB;
  p.ms = off;                     // M: bf16 (hi, lo) channel rows (nb, H + 8), or float32 (d, CB)
  if (applies) off += mma ? nb * (H + 8) : H * CB;
  p.part = off;                   // the CTA's partial A (d, CB), s and m
  if (sums) off += H * CB;
  p.psum = off;
  if (sums) off += H;
  p.pmax = off;
  if (sums) off += H;
  p.vec = off, off += 2 * CB;     // b_out, g
  p.scratch = off;                // phase-0 tile; partials of warps or groups; W_v, W_out
  const int tile = mma ? kTile * kXr / 2 : kTile * CB;
  if (sums) off += std::max(std::max(tile, (kThreads - 32) * (CB + 2)), 2 * H * CB);
  off = (off + 3) & ~3;
  p.row_span = (p.chunk * elt + 16 + 15) & ~15;
  // channel-first rows of row_span plus a phase below 16, or one row-major
  // block of chunk * C values, each after a start phase below 16
  const long long stage = 16 + (long long)C * (p.row_span + 16);
  p.staged = stage <= kStageBudget;
  p.xs = (off * 4 + 15) & ~15;
  p.bytes = p.staged ? p.xs + (int)stage : off * 4;
  return p;
}

// x of a CTA's slice: column j, channel c at p[j sn + c sc], in shared
// memory (staged) or device memory.
template <typename T>
struct RowSlice {
  const T* p;
  long long sn, sc;
  __device__ __forceinline__ float at(int c, int j) const {
    return dq::to_f32(p[j * sn + c * sc]);
  }
};

// The factor that carries a sum taken under the max mi to the max m >= mi
// (0 for an empty sum, mi = -inf).
__device__ __forceinline__ float carry(float mi, float m) {
  return mi == -CUDART_INF_F ? 0.0f : fast_exp2(mi - m);
}

// The B fragments of x for k = W_k' X over a 16-column step (channels x
// columns; kNarrow: channels 0-7 of columns 0-7, then 8-15).
template <int CB>
__device__ __forceinline__ void load_x_cols(const __nv_bfloat16* th, int ks, uint32_t (&bx)[4]) {
  const int lane = threadIdx.x & 31;
  if constexpr (CB <= 8) {
    ldmatrix_x2(bx[0], bx[1], th + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kXr);
  } else {
    const int rp = (lane & 7) + (lane >> 4) * 8, cp = ((lane >> 3) & 1) * 8;
    ldmatrix_x4(bx, th + (ks * 16 + rp) * kXr + cp);
  }
}

// k - m (log2(e)-scaled) of n-tile nt, m0 for feature f0 and m1 for f1:
// W_k' (hi, lo) times the exact x, two products; kHi: W_k''s hi half
// alone, one product (about 8 bits, enough to place a max).
template <int CB, bool kHi = false>
__device__ __forceinline__ void k_tile(float (&k)[4], const uint32_t (&wh)[4],
                                       const uint32_t (&wl)[4], const uint32_t (&bx)[4],
                                       int nt, float m0 = 0.0f, float m1 = 0.0f) {
  k[0] = k[1] = -m0;
  k[2] = k[3] = -m1;
  if constexpr (CB <= 8)
    mma_split<true, kHi, true>(k, wh, wl, bx[nt], 0u, 0u, 0u);
  else
    mma_split<false, kHi, true>(k, wh, wl, bx[2 * nt], bx[2 * nt + 1], 0u, 0u);
}

// Each feature's max of k over this warp's steps of a tile, from W_k''s hi
// half: a shift within 2^-8 |k| of the max keeps every p finite, and the
// sums are exact to any shift (softmax does not depend on it).
template <int CB, bool kFull>
__device__ __forceinline__ void tile_max(const __nv_bfloat16* th, const uint32_t (&wh)[4],
                                         const uint32_t (&wl)[4], float& t0, float& t1,
                                         int sub, int wpf, int cnt) {
  const int tig = threadIdx.x & 3;
#pragma unroll 2
  for (int ks = sub; ks * 16 < cnt; ks += wpf) {
    uint32_t bx[4];
    load_x_cols<CB>(th, ks, bx);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float k[4];
      k_tile<CB, true>(k, wh, wl, bx, nt);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kFull || ks * 16 + nt * 8 + 2 * tig + (e & 1) < cnt) {
          if (e < 2)
            t0 = fmaxf(t0, k[e]);
          else
            t1 = fmaxf(t1, k[e]);
        }
    }
  }
}

// p = exp(k - m) over this warp's steps of a tile, s += p and A += P X^T:
// P's (hi, lo) halves times the exact x, two products.
template <int CB, bool kFull>
__device__ __forceinline__ void tile_sums(const __nv_bfloat16* th, const uint32_t (&wh)[4],
                                          const uint32_t (&wl)[4], float m0, float m1,
                                          float (&acc)[(CB + 7) / 8][4], float& s0, float& s1,
                                          int sub, int wpf, int cnt) {
  constexpr int NT = (CB + 7) / 8;
  const int lane = threadIdx.x & 31, tig = lane & 3;
  const int ra = (lane & 7) + ((lane >> 3) & 1) * 8, ca = (lane >> 4) * 8;
#pragma unroll 2
  for (int ks = sub; ks * 16 < cnt; ks += wpf) {
    uint32_t bx[4];
    load_x_cols<CB>(th, ks, bx);
    float k[2][4];  // p: (columns 0-7 | 8-15) x (f0: e < 2 | f1), columns 2 tig + (e & 1)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      k_tile<CB>(k[nt], wh, wl, bx, nt, m0, m1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        k[nt][e] = fast_exp2(k[nt][e]);
        if (!kFull && ks * 16 + nt * 8 + 2 * tig + (e & 1) >= cnt) k[nt][e] = 0.0f;
      }
      s0 += k[nt][0] + k[nt][1];
      s1 += k[nt][2] + k[nt][3];
    }
    uint32_t xr[4];  // the product's B: columns x channels 0-7 (then 8-15)
    if constexpr (CB <= 8)
      ldmatrix_x2_trans(xr[0], xr[1], th + (ks * 16 + ra) * kXr);
    else
      ldmatrix_x4_trans(xr, th + (ks * 16 + ra) * kXr + ca);
    uint32_t ph[4], pl[4];
    split_bf16(k[0][0], k[0][1], ph[0], pl[0]);
    split_bf16(k[0][2], k[0][3], ph[1], pl[1]);
    split_bf16(k[1][0], k[1][1], ph[2], pl[2]);
    split_bf16(k[1][2], k[1][3], ph[3], pl[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mma_bf16(acc[nt], ph[0], ph[1], ph[2], ph[3], xr[2 * nt], xr[2 * nt + 1]);
      mma_bf16(acc[nt], pl[0], pl[1], pl[2], pl[3], xr[2 * nt], xr[2 * nt + 1]);
    }
  }
}

// Phase 0 of a slice, bf16 (tensor cores), in passes of up to kWarps
// 16-feature blocks (one pass for H <= 128, two above). In a pass of nfb
// blocks warp w takes block w mod nfb and every (kWarps / nfb)-th
// 16-column step of each tile; where nfb does not divide kWarps the warps
// past the last whole set sit out. The tile holds each column's bf16 x as
// a row of 16 channels. Per tile a warp forms k twice: for each feature's
// max over its steps (a quad max), and for p against the running max after
// s and A are rescaled to it. The warps of a feature block merge their
// (m, s, A) in order into the CTA's partial.
template <int CB>
__device__ void rows_phase0_mma(const RowSlice<__nv_bfloat16>& xsl, const float* wk_s,
                                float* scratch, float* part, float* psum, float* pmax, int C,
                                int H, int cols) {
  constexpr int NT = (CB + 7) / 8;
  constexpr int W = CB + 2;  // a merge row: A, s, m
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, gid = lane >> 2, tig = lane & 3;
  __nv_bfloat16* th = reinterpret_cast<__nv_bfloat16*>(scratch);  // (kTile, kXr)
  for (int fb0 = 0; fb0 < H / 16; fb0 += kWarps) {
    const int nfb = min(kWarps, H / 16 - fb0), wpf = kWarps / nfb;
    const int fb = fb0 + warp % nfb, sub = warp / nfb;
    const bool live = sub < wpf;
    const int f0 = fb * 16 + gid, f1 = f0 + 8;
    uint32_t wh[4], wl[4];  // A: W_k' rows f0, f1 x channels 2 tig.., 2 tig + 8..
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = i & 1 ? f1 : f0, c = 2 * tig + (i >> 1) * 8;
      const float v0 = c < CB ? wk_s[f * CB + c] : 0.0f;
      const float v1 = c + 1 < CB ? wk_s[f * CB + c + 1] : 0.0f;
      split_bf16(v0, v1, wh[i], wl[i]);
    }
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
    float s0 = 0.0f, s1 = 0.0f, m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
    for (int t0 = 0; t0 < cols; t0 += kTile) {
      const int cnt = min(kTile, cols - t0);
      __syncthreads();  // the previous tile (and pass) is done with
      if (t < kTile) {  // one column a thread; zeros past the slice
        const int j = t0 + t;
#pragma unroll
        for (int c = 0; c < (CB <= 8 ? 8 : 16); c += 2) {  // the channels the products read
          const float v0 = c < C && t < cnt ? xsl.at(c, j) : 0.0f;
          const float v1 = c + 1 < C && t < cnt ? xsl.at(c + 1, j) : 0.0f;
          *reinterpret_cast<uint32_t*>(th + t * kXr + c) = pack_bf16(v0, v1);
        }
      }
      __syncthreads();
      if (!live) continue;
      float t0m = -CUDART_INF_F, t1m = -CUDART_INF_F;
      if (cnt == kTile)
        tile_max<CB, true>(th, wh, wl, t0m, t1m, sub, wpf, cnt);
      else
        tile_max<CB, false>(th, wh, wl, t0m, t1m, sub, wpf, cnt);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the quad of a fragment row
        t0m = fmaxf(t0m, __shfl_xor_sync(0xffffffffu, t0m, off));
        t1m = fmaxf(t1m, __shfl_xor_sync(0xffffffffu, t1m, off));
      }
      if (t0m > m0) {  // a new running max of f0: rescale what was summed
        const float r = fast_exp2(m0 - t0m);
        s0 *= r;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) acc[nt][0] *= r, acc[nt][1] *= r;
        m0 = t0m;
      }
      if (t1m > m1) {
        const float r = fast_exp2(m1 - t1m);
        s1 *= r;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) acc[nt][2] *= r, acc[nt][3] *= r;
        m1 = t1m;
      }
      if (cnt == kTile)
        tile_sums<CB, true>(th, wh, wl, m0, m1, acc, s0, s1, sub, wpf, cnt);
      else
        tile_sums<CB, false>(th, wh, wl, m0, m1, acc, s0, s1, sub, wpf, cnt);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    // acc[nt][e]: feature e < 2 ? f0 : f1, channel nt * 8 + 2 tig + (e & 1)
    __syncthreads();
    // (wpf - 1, 16 nfb, W): the pass's features l0, l1 (within the tile area)
    float* gsum = scratch;
    const int l0 = f0 - fb0 * 16, l1 = l0 + 8;
    if (sub > 0 && live) {
      float* dst = gsum + (sub - 1) * nfb * 16 * W;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = nt * 8 + 2 * tig + (e & 1);
          if (ch < CB) dst[(e < 2 ? l0 : l1) * W + ch] = acc[nt][e];
        }
      if (tig == 0) {
        dst[l0 * W + CB] = s0, dst[l0 * W + CB + 1] = m0;
        dst[l1 * W + CB] = s1, dst[l1 * W + CB + 1] = m1;
      }
    }
    __syncthreads();
    if (sub == 0) {
      for (int k = 1; k < wpf; ++k) {
        const float* src = gsum + (k - 1) * nfb * 16 * W;
        const float n0 = fmaxf(m0, src[l0 * W + CB + 1]), n1 = fmaxf(m1, src[l1 * W + CB + 1]);
        const float a0 = carry(m0, n0), b0 = carry(src[l0 * W + CB + 1], n0);
        const float a1 = carry(m1, n1), b1 = carry(src[l1 * W + CB + 1], n1);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ch = nt * 8 + 2 * tig + (e & 1);
            if (ch < CB)
              acc[nt][e] = e < 2 ? fmaf(src[l0 * W + ch], b0, acc[nt][e] * a0)
                                 : fmaf(src[l1 * W + ch], b1, acc[nt][e] * a1);
          }
        s0 = fmaf(src[l0 * W + CB], b0, s0 * a0);
        s1 = fmaf(src[l1 * W + CB], b1, s1 * a1);
        m0 = n0, m1 = n1;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = nt * 8 + 2 * tig + (e & 1);
          if (ch < CB) part[(e < 2 ? f0 : f1) * CB + ch] = acc[nt][e];
        }
      if (tig == 0) psum[f0] = s0, psum[f1] = s1, pmax[f0] = m0, pmax[f1] = m1;
    }
  }
}

// Phase 0 of a slice, float32 (CUDA cores): thread (group gi, feature d),
// W_k' row d in registers, sums over the tile columns of its group with a
// running max per tile (a first pass over its columns for the tile's max,
// then s and A rescaled once and the second pass's sums); the groups merge
// their (m, s, A) in group order into the CTA's partial. Where H does not
// divide kThreads, the threads past the last whole group sit out.
template <int CB>
__device__ void rows_phase0_fma(const RowSlice<float>& xsl, const float* wk_s, float* scratch,
                                float* part, float* psum, float* pmax, int C, int H, int cols) {
  constexpr int W = CB + 2;
  const int t = threadIdx.x, d = t % H, groups = kThreads / H, gi = t / H;
  const bool live = gi < groups;
  float* tn = scratch;  // the tile, float32 (kTile, CB)
  float wk[CB], a[CB];
  load_row<CB>(wk_s + d * CB, wk);
#pragma unroll
  for (int c = 0; c < CB; ++c) a[c] = 0.0f;
  float s = 0.0f, m = -CUDART_INF_F;
  for (int t0 = 0; t0 < cols; t0 += kTile) {
    const int cnt = min(kTile, cols - t0);
    __syncthreads();  // the previous tile is done with
    if (t < cnt)
#pragma unroll
      for (int c = 0; c < CB; ++c) tn[t * CB + c] = c < C ? xsl.at(c, t0 + t) : 0.0f;
    __syncthreads();
    if (!live) continue;
    float mt = -CUDART_INF_F;
    for (int j = gi; j < cnt; j += groups) {
      float xv[CB];
      load_row<CB>(tn + j * CB, xv);
      mt = fmaxf(mt, dot<CB>(wk, xv));
    }
    if (mt > m) {  // a new running max: rescale what was summed
      const float r = fast_exp2(m - mt);
      s *= r;
#pragma unroll
      for (int c = 0; c < CB; ++c) a[c] *= r;
      m = mt;
    }
    // the tile's sums apart, then added: a long run of like terms added one
    // at a time drifts by up to n/2 ulps
    float ts = 0.0f, ta[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c) ta[c] = 0.0f;
    for (int j = gi; j < cnt; j += groups) {
      float xv[CB];
      load_row<CB>(tn + j * CB, xv);
      const float p = fast_exp2(dot<CB>(wk, xv) - m);
      ts += p;
#pragma unroll
      for (int c = 0; c < CB; ++c) ta[c] = fmaf(p, xv[c], ta[c]);
    }
    s += ts;
#pragma unroll
    for (int c = 0; c < CB; ++c) a[c] += ta[c];
  }
  __syncthreads();
  float* gsum = scratch;  // (groups - 1, H, W)
  if (gi > 0 && live) {
    float* dst = gsum + ((gi - 1) * H + d) * W;
#pragma unroll
    for (int c = 0; c < CB; ++c) dst[c] = a[c];
    dst[CB] = s, dst[CB + 1] = m;
  }
  __syncthreads();
  if (gi == 0) {
    for (int k = 1; k < groups; ++k) {
      const float* src = gsum + ((k - 1) * H + d) * W;
      const float n = fmaxf(m, src[CB + 1]), fa = carry(m, n), fb = carry(src[CB + 1], n);
#pragma unroll
      for (int c = 0; c < CB; ++c) a[c] = fmaf(src[c], fb, a[c] * fa);
      s = fmaf(src[CB], fb, s * fa);
      m = n;
    }
#pragma unroll
    for (int c = 0; c < CB; ++c) part[d * CB + c] = a[c];
    psum[d] = s, pmax[d] = m;
  }
}

// Apply, float32 (CUDA cores): one thread a column of the slice.
template <int CB>
__device__ void rows_apply_fma(const RowSlice<float>& xsl, const float* wq, const float* ms,
                               const float* b_out, const float* g, float* yb, long long yn,
                               long long yc, int C, int H, int cols) {
  const float rs = sqrtf((float)C);
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    float xv[CB], acc[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      xv[c] = c < C ? xsl.at(c, j) : 0.0f;
      acc[c] = 0.0f;
    }
    for (int h0 = 0; h0 < H; h0 += kDimHead) {
      float e[kDimHead], mx = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < kDimHead; ++i) {
        float wr[CB];
        load_row<CB>(wq + (h0 + i) * CB, wr);
        e[i] = dot<CB>(wr, xv);
        mx = fmaxf(mx, e[i]);
      }
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < kDimHead; ++i) {
        e[i] = fast_exp2(e[i] - mx);
        sum += e[i];
      }
      const float inv = __fdividef(kDhScale, fmaxf(sum, 1e-30f));
#pragma unroll
      for (int i = 0; i < kDimHead; ++i) {
        float mr[CB];
        load_row<CB>(ms + (h0 + i) * CB, mr);
        const float qn = e[i] * inv;
#pragma unroll
        for (int c = 0; c < CB; ++c) acc[c] = fmaf(mr[c], qn, acc[c]);
      }
    }
    float ss = 0.0f;
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      acc[c] = c < C ? acc[c] + b_out[c] : 0.0f;
      ss += acc[c] * acc[c];
    }
    const float scale = rs / fmaxf(sqrtf(ss), 1e-12f);
#pragma unroll
    for (int c = 0; c < CB; ++c)
      if (c < C) yb[j * yn + c * yc] = acc[c] * scale * g[c];
  }
}

// Apply, bf16 (tensor cores): warp w takes 16-column blocks w, w + 8, ....
// A thread's fragment rows are columns gid and gid + 8 and its channels
// 2 tig + {0, 1, 8, 9}; the quad holds all 16. q^T = X^T W_q'^T comes from
// two products (x exact, W_q' (hi, lo) rows in shared memory); in the
// accumulator layout a head's max and sum over its 32 features are a
// thread's values and a quad's (shuffles). Its exponentials' (hi, lo) are
// the A operand of M's product against M's (hi, lo), three products, which
// the softmax's 1 / sum then scales per column. The
// epilogue (bias, RMSNorm over the quad's channels, gain) runs on the
// accumulators, whose channels are the thread's x channels.
template <int CB>
__device__ void rows_apply_mma(const RowSlice<__nv_bfloat16>& xsl, const __nv_bfloat16* wqh,
                               const __nv_bfloat16* wql, const __nv_bfloat16* mbh,
                               const __nv_bfloat16* mbl, const float* b_out, const float* g,
                               __nv_bfloat16* yb, long long yn, long long yc, int C, int H,
                               int cols) {
  constexpr int NT = (CB + 7) / 8;
  constexpr bool kNarrow = CB <= 8;  // channels 0-7 only (see mma_split)
  const float rs = sqrtf((float)C);
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  // ldmatrix rows of W_q': 16 features x channels 0-7, 8-15 (kNarrow: 0-7 only, ra)
  const int rp = (lane & 7) + (lane >> 4) * 8, cp = ((lane >> 3) & 1) * 8;
  const int ra = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int mrow = H + 8;  // row stride (bf16) of M's channel rows
  for (int j0 = (threadIdx.x >> 5) * 16; j0 < cols; j0 += kWarps * 16) {
    const int jc[2] = {j0 + gid, j0 + gid + 8};
    uint32_t ax[4];  // A: X^T rows jc[0], jc[1] x channels 2 tig.., 2 tig + 8.. (exact)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int ch = nt * 8 + 2 * tig;
        const bool in = jc[r] < cols;
        ax[r + 2 * nt] = pack_bf16(ch < C && in ? xsl.at(ch, jc[r]) : 0.0f,
                                   ch + 1 < C && in ? xsl.at(ch + 1, jc[r]) : 0.0f);
      }
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
    for (int h0 = 0; h0 < H; h0 += kDimHead) {
      float q[4][4];  // q: features h0 + 8 nt + 2 tig + (e & 1), column jc[e >> 1]
#pragma unroll
      for (int np = 0; np < 2; ++np) {  // n-tiles 2 np, 2 np + 1
        uint32_t bh[4], bl[4];  // b0, b1 of n-tile 2 np, then 2 np + 1; kNarrow: b0 of each
        if constexpr (kNarrow) {
          ldmatrix_x2(bh[0], bh[1], wqh + (h0 + np * 16 + ra) * kXr);
          ldmatrix_x2(bl[0], bl[1], wql + (h0 + np * 16 + ra) * kXr);
        } else {
          ldmatrix_x4(bh, wqh + (h0 + np * 16 + rp) * kXr + cp);
          ldmatrix_x4(bl, wql + (h0 + np * 16 + rp) * kXr + cp);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float(&d)[4] = q[2 * np + i];
          d[0] = d[1] = d[2] = d[3] = 0.0f;
          if constexpr (kNarrow)
            mma_split<true, true>(d, ax, ax, bh[i], 0u, bl[i], 0u);
          else
            mma_split<false, true>(d, ax, ax, bh[2 * i], bh[2 * i + 1], bl[2 * i], bl[2 * i + 1]);
        }
      }
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, sum[2] = {0.0f, 0.0f}, inv[2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], q[nt][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          q[nt][e] = fast_exp2(q[nt][e] - mx[e >> 1]);
          sum[e >> 1] += q[nt][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        inv[r] = __fdividef(kDhScale, fmaxf(sum[r], 1e-30f));
      }
      // M times the head's unnormalized weights, then scaled by the softmax's inv
      float yh[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) yh[nt][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {  // features h0 + 16 kk ..: n-tiles 2 kk, 2 kk + 1
        uint32_t qh[4], ql[4];
        split_bf16(q[2 * kk][0], q[2 * kk][1], qh[0], ql[0]);
        split_bf16(q[2 * kk][2], q[2 * kk][3], qh[1], ql[1]);
        split_bf16(q[2 * kk + 1][0], q[2 * kk + 1][1], qh[2], ql[2]);
        split_bf16(q[2 * kk + 1][2], q[2 * kk + 1][3], qh[3], ql[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int at = (nt * 8 + gid) * mrow + h0 + kk * 16 + 2 * tig;
          mma_split<false>(yh[nt], qh, ql, *reinterpret_cast<const uint32_t*>(mbh + at),
                           *reinterpret_cast<const uint32_t*>(mbh + at + 8),
                           *reinterpret_cast<const uint32_t*>(mbl + at),
                           *reinterpret_cast<const uint32_t*>(mbl + at + 8));
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = fmaf(yh[nt][e], inv[e >> 1], acc[nt][e]);
    }
    // acc[nt][e]: column jc[e >> 1], channel nt * 8 + 2 tig + (e & 1)
    float s2[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = nt * 8 + 2 * tig + (e & 1);
        acc[nt][e] = ch < C ? acc[nt][e] + b_out[ch] : 0.0f;
        s2[e >> 1] += acc[nt][e] * acc[nt][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      s2[r] += __shfl_xor_sync(0xffffffffu, s2[r], 1);
      s2[r] += __shfl_xor_sync(0xffffffffu, s2[r], 2);
      s2[r] = rs / fmaxf(sqrtf(s2[r]), 1e-12f);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = nt * 8 + 2 * tig + (e & 1), r = e >> 1;
        if (ch < C && jc[r] < cols)
          yb[jc[r] * yn + ch * yc] = __float2bfloat16(acc[nt][e] * s2[r] * g[ch]);
      }
  }
}

// The kernel, in the mode kMode: kFused (K8) and kContext (K9's first
// launch) over grid (cl, B), a cluster of cl CTAs per row; kApply (K9's
// second) over grid (g, B) of independent CTAs. m_io is the rows' M, (B, C,
// H) float32, that kContext writes and kApply reads (null for kFused). CTAs
// held on one SM: bf16 at C <= 8, 3, otherwise 2, as K1.
template <typename T, int CB, int kMode>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 && CB <= 8 ? 3 : 2)
    linattn_rows_cluster(const T* __restrict__ x, T* __restrict__ y, Strides xs, Strides ys,
                         Weights w, float* __restrict__ m_io, RowsPlan p, int C, int N, int H) {
  constexpr bool kMma = sizeof(T) == 2;
  constexpr bool kSums = kMode != kApply, kApplies = kMode != kContext;
  constexpr int NB = kMma ? (CB + 7) / 8 * 8 : CB;
  extern __shared__ __align__(16) float smem[];
  const int rank = blockIdx.x, cl = gridDim.x;  // a cluster's rank and size (grid (cl, B))
  const int t = threadIdx.x, b = blockIdx.y;
  const int nbeg = min(N, rank * p.chunk), cols = min(N, nbeg + p.chunk) - nbeg;
  float* wq = smem + p.wq;
  float* wk = smem + p.wk;
  float* ms = smem + p.ms;
  float* part = smem + p.part;
  float* psum = smem + p.psum;
  float* pmax = smem + p.pmax;
  float* b_out = smem + p.vec;
  float* g = b_out + CB;
  float* scratch = smem + p.scratch;

  // 1. stage the slice (async), read the weights meanwhile
  const T* xg = x + b * xs.b + nbeg * xs.n;
  RowSlice<T> xsl{xg, xs.n, xs.c};
  const bool rows_c = xs.n == 1, rows_n = xs.c == 1 && xs.n == C;  // channel or column rows
  const bool staged = p.staged && (rows_c || rows_n);
  if (staged) {
    char* dst = reinterpret_cast<char*>(smem) + p.xs + (reinterpret_cast<uintptr_t>(xg) & 15);
    if (rows_c) {
      const int row_bytes = p.row_span + (int)((xs.c * sizeof(T)) & 15);
      stage_rows<T>(dst, row_bytes, xg, xs.c, C, cols);
      xsl = RowSlice<T>{reinterpret_cast<const T*>(dst), 1, row_bytes / (int)sizeof(T)};
    } else {
      stage_rows<T>(dst, 0, xg, 0, 1, cols * C);
      xsl = RowSlice<T>{reinterpret_cast<const T*>(dst), C, 1};
    }
  }
  if (kApplies && t < CB) {
    b_out[t] = t < C ? ld(w.b_out, t * w.b_out_c, w.bf16 & 4) : 0.0f;
    g[t] = t < C ? ld(w.g, t * w.g_c, w.bf16 & 8) : 0.0f;
  }
  const bool bq = w.bf16 & 1, bo = w.bf16 & 2;
  __nv_bfloat16* wqh = reinterpret_cast<__nv_bfloat16*>(wq);  // bf16 W_q' (hi, lo) rows
  __nv_bfloat16* wql = wqh + H * kXr;
  // rows 0..H-1: W_q (the apply's); H..2H-1: W_k (phase 0's)
  for (int d = (kApplies ? 0 : H) + t; d < (kSums ? 2 * H : H); d += kThreads) {
    float v[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c)
      v[c] = c < C ? ld(w.wqkv, c * w.wqkv_c + d * w.wqkv_h, bq) * kLog2e : 0.0f;
    if (d < H && kMma) {
#pragma unroll
      for (int c = 0; c < 16; c += 2) {
        uint32_t hi, lo;
        split_bf16(c < CB ? v[c] : 0.0f, c + 1 < CB ? v[c + 1] : 0.0f, hi, lo);
        *reinterpret_cast<uint32_t*>(wqh + d * kXr + c) = hi;
        *reinterpret_cast<uint32_t*>(wql + d * kXr + c) = lo;
      }
    } else {
      float* dst = d < H ? wq + d * CB : wk + (d - H) * CB;
#pragma unroll
      for (int c = 0; c < CB; ++c) dst[c] = v[c];
    }
  }
  if (staged) asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();  // the weights (and the staged slice) are in

  // 2. phase 0: the CTA's partial (m, s, A)
  if constexpr (kSums) {
    if constexpr (kMma)
      rows_phase0_mma<CB>(xsl, wk, scratch, part, psum, pmax, C, H, cols);
    else
      rows_phase0_fma<CB>(xsl, wk, scratch, part, psum, pmax, C, H, cols);
    cg::this_cluster().sync();  // #1: every CTA's partial is visible to the cluster
  }

  // 3. rank 0: the row's (m, s, A) merged in rank order, then M = W_out^T
  // ctx^T, to its shared memory (kFused) or to device memory (kContext);
  // kApply: M from device memory
  __nv_bfloat16* mbh = reinterpret_cast<__nv_bfloat16*>(ms);  // M's (hi, lo) channel rows
  __nv_bfloat16* mbl = mbh + NB * (H + 8);
  float* mrow = kMode == kFused ? nullptr : m_io + (long long)b * C * H;  // the row's M (C, H)
  if constexpr (kMode == kApply) {
    for (int i = t; i < (kMma ? NB : CB) * H; i += kThreads) {
      const int c = i / H, d = i % H;
      const float v = c < C ? mrow[c * H + d] : 0.0f;
      if constexpr (kMma) {
        const __nv_bfloat16 hi = __float2bfloat16(v);
        mbh[c * (H + 8) + d] = hi;
        mbl[c * (H + 8) + d] = __float2bfloat16(v - __bfloat162float(hi));
      } else {
        ms[d * CB + c] = v;
      }
    }
    __syncthreads();  // M is in
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    if (rank == 0) {
      float* wv = scratch;           // (H, CB)
      float* wo = scratch + H * CB;  // (H, CB)
      for (int i = t; i < H * CB; i += kThreads) {
        const int e = i / CB, c = i % CB;
        wv[i] = c < C ? ld(w.wqkv, c * w.wqkv_c + (2 * H + e) * w.wqkv_h, bq) : 0.0f;
        wo[i] = c < C ? ld(w.wout, e * w.wout_h + c * w.wout_c, bo) : 0.0f;
      }
      const int d = t;
      float a[CB], s = 0.0f;
      if (d < H) {
        float m = -CUDART_INF_F;
        for (int r = 0; r < cl; ++r) m = fmaxf(m, cluster.map_shared_rank(pmax, r)[d]);
#pragma unroll
        for (int c = 0; c < CB; ++c) a[c] = 0.0f;
        for (int r = 0; r < cl; ++r) {
          const float f = carry(cluster.map_shared_rank(pmax, r)[d], m);
          float pr[CB];
          load_row<CB>(cluster.map_shared_rank(part, r) + d * CB, pr);
#pragma unroll
          for (int c = 0; c < CB; ++c) a[c] = fmaf(pr[c], f, a[c]);
          s = fmaf(cluster.map_shared_rank(psum, r)[d], f, s);
        }
      }
      __syncthreads();
      if (d < H) {
        const float inv_s = 1.0f / fmaxf(s, 1e-30f);
        float mc[CB];
#pragma unroll
        for (int c = 0; c < CB; ++c) mc[c] = 0.0f;
        const int h0 = (d / kDimHead) * kDimHead;
        for (int e = h0; e < h0 + kDimHead; ++e) {
          float wr[CB];
          load_row<CB>(wv + e * CB, wr);
          const float ctx = dot<CB>(a, wr) * inv_s;
          load_row<CB>(wo + e * CB, wr);
#pragma unroll
          for (int c = 0; c < CB; ++c) mc[c] = fmaf(wr[c], ctx, mc[c]);
        }
        if constexpr (kMode == kContext) {
#pragma unroll
          for (int c = 0; c < CB; ++c)
            if (c < C) mrow[c * H + d] = mc[c];
        } else if constexpr (kMma) {
#pragma unroll
          for (int c = 0; c < NB; ++c) {
            const float v = c < CB ? mc[c] : 0.0f;
            const __nv_bfloat16 hi = __float2bfloat16(v);
            mbh[c * (H + 8) + d] = hi;
            mbl[c * (H + 8) + d] = __float2bfloat16(v - __bfloat162float(hi));
          }
        } else {
#pragma unroll
          for (int c = 0; c < CB; ++c) ms[d * CB + c] = mc[c];
        }
      }
    }
    cluster.sync();  // #2: M is in rank 0's shared memory (kContext: the partials are read)
    if constexpr (kMode == kContext) return;
    if (rank != 0) {
      const int words = kMma ? NB * (H + 8) : H * CB;
      const float* m0 = cluster.map_shared_rank(ms, 0);
      for (int i = t; i < words; i += kThreads) ms[i] = m0[i];
    }
    cluster.sync();  // #3: every CTA has its copy; rank 0 may go on and exit
  }

  // 4. apply over the slice
  T* yb = y + b * ys.b + nbeg * ys.n;
  if constexpr (kMma)
    rows_apply_mma<CB>(xsl, wqh, wql, mbh, mbl, b_out, g, yb, ys.n, ys.c, C, H, cols);
  else
    rows_apply_fma<CB>(xsl, wq, ms, b_out, g, yb, ys.n, ys.c, C, H, cols);
}

// kFused and kContext: the cluster size from the card's occupancy
// (choose_cluster); kApply: a grid of independent CTAs (choose_grid).
template <typename T, int CB, int kMode>
cudaError_t run_c(const void* x, void* y, Strides xs, Strides ys, const Weights& w, float* m,
                  int B, int C, int N, int H, cudaStream_t s) {
  auto kernel = linattn_rows_cluster<T, CB, kMode>;
  const auto make = [&](int cl) { return rows_plan(kMode, C, CB, H, N, sizeof(T), cl); };
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  RowsPlan p;
  if constexpr (kMode == kApply) {
    cudaError_t err = choose_grid(kernel, kThreads, B, C, N, H, make, &p);
    if (err == cudaSuccess) err = dq::allow_smem(kernel, p.bytes);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(p.cl, B), kThreads, p.bytes, s>>>(xt, yt, xs, ys, w, m, p, C, N, H);
    return cudaGetLastError();
  }
  const cudaError_t err = choose_cluster(kernel, kThreads, B, C, N, H, make, &p);
  if (err != cudaSuccess) return err;
  return launch_cluster(kernel, p.cl, B, kThreads, p.bytes, s, xt, yt, xs, ys, w, m, p, C, N,
                        H);
}

// Channel loops unrolled to C rounded up to a multiple of 4, as in K1.
template <typename T, int kMode>
cudaError_t run(const void* x, void* y, Strides xs, Strides ys, const Weights& w, float* m,
                int B, int C, int N, int H, cudaStream_t s) {
  switch ((C + 3) / 4) {
    case 1: return run_c<T, 4, kMode>(x, y, xs, ys, w, m, B, C, N, H, s);
    case 2: return run_c<T, 8, kMode>(x, y, xs, ys, w, m, B, C, N, H, s);
    case 3: return run_c<T, 12, kMode>(x, y, xs, ys, w, m, B, C, N, H, s);
    default: return run_c<T, 16, kMode>(x, y, xs, ys, w, m, B, C, N, H, s);
  }
}

// K8 (m null) or K9 (m the rows' M): the modes' launches in order.
template <typename T>
cudaError_t run_rows(const void* x, void* y, Strides xs, Strides ys, const Weights& w, float* m,
                     int B, int C, int N, int H, cudaStream_t s) {
  if (!m) return run<T, kFused>(x, y, xs, ys, w, m, B, C, N, H, s);
  const cudaError_t err = run<T, kContext>(x, y, xs, ys, w, m, B, C, N, H, s);
  if (err != cudaSuccess) return err;
  return run<T, kApply>(x, y, xs, ys, w, m, B, C, N, H, s);
}

int rows_entry(const void* x, void* y, long long xb, long long xn, long long xc, long long yb,
               long long yn, long long yc, const void* wqkv, long long wqkv_c, long long wqkv_h,
               const void* wout, long long wout_h, long long wout_c, const void* b_out,
               long long b_out_c, const void* g, long long g_c, float* m, int B, int C, int N,
               int heads, int w_bf16, int x_bf16, int device, void* stream) {
  if (!linattn_valid(B, C, N, heads)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Weights w{wqkv, wqkv_c, wqkv_h, wout, wout_h, wout_c, b_out, b_out_c,
                  g,    g_c,    nullptr, 0, w_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides xs{xb, xn, xc}, ys{yb, yn, yc};
  const int H = heads * kDimHead;
  err = x_bf16 ? run_rows<__nv_bfloat16>(x, y, xs, ys, w, m, B, C, N, H, s)
               : run_rows<float>(x, y, xs, ys, w, m, B, C, N, H, s);
  return (int)err;
}

}  // namespace

// K8. x (B, N, C) and y through their own strides (xb, xn, xc), (yb, yn,
// yc); w_qkv (C, 3H), w_out (H, C), b_out and g (C) float32 or bf16 (bits
// 0-3 of w_bf16), each through its strides, as dq_linear_attention takes
// them.
extern "C" int dq_linear_attention_rows_fused(
    const void* x, void* y, long long xb, long long xn, long long xc, long long yb,
    long long yn, long long yc, const void* wqkv, long long wqkv_c, long long wqkv_h,
    const void* wout, long long wout_h, long long wout_c, const void* b_out, long long b_out_c,
    const void* g, long long g_c, int B, int C, int N, int heads, int w_bf16, int x_bf16,
    int device, void* stream) {
  return rows_entry(x, y, xb, xn, xc, yb, yn, yc, wqkv, wqkv_c, wqkv_h, wout, wout_h, wout_c,
                    b_out, b_out_c, g, g_c, nullptr, B, C, N, heads, w_bf16, x_bf16, device,
                    stream);
}

// K9: the arguments of K8, and m, float32 (B, C, H) device memory for the
// rows' M between the two launches.
extern "C" int dq_linear_attention_rows(
    const void* x, void* y, long long xb, long long xn, long long xc, long long yb,
    long long yn, long long yc, const void* wqkv, long long wqkv_c, long long wqkv_h,
    const void* wout, long long wout_h, long long wout_c, const void* b_out, long long b_out_c,
    const void* g, long long g_c, void* m, int B, int C, int N, int heads, int w_bf16,
    int x_bf16, int device, void* stream) {
  if (!m) return (int)cudaErrorInvalidValue;
  return rows_entry(x, y, xb, xn, xc, yb, yn, yc, wqkv, wqkv_c, wqkv_h, wout, wout_h, wout_c,
                    b_out, b_out_c, g, g_c, static_cast<float*>(m), B, C, N, heads, w_bf16,
                    x_bf16, device, stream);
}
