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
// sums (A, s) across sequential grid steps. kshift/qshift are weight-norm
// bounds on every logit (_static_shifts), so there is no running max to
// merge and the sums over any split of N add up as plain sums.
//
// On Hopper the op is one launch: grid (CL, B), a thread-block cluster of
// CL CTAs per row (CL = 8, fewer for small N so that a CTA has at least
// kColsPerCta columns), 256 threads a CTA, each CTA owning a contiguous
// slice of N:
//   1. the CTA stages its x slice (C x N/CL, x's dtype) in shared memory
//      once with cp.async (float32 also each column's norm; the bf16 passes
//      form it where they read the column); a slice over kStageBudget is not
//      staged, and the passes below read its columns from device memory
//      instead (same kernel, no other path);
//      meanwhile it reads w_qkv, w_out, b_out, g, g_pre in their own dtype
//      through their strides, converts them to float32, scales W_q and W_k
//      by log2(e) (exp is exp2f) and computes the static shifts: the host
//      does no work on the weights;
//   2. phase 0: the CTA's partial (A, s) over its slice, normalized kTile
//      columns at a time into shared tiles; for bf16 x on tensor cores
//      (phase0_mma: k = W_k' xh, then A = P Xr^T), for float32 on CUDA cores
//      (phase0_fma); partial sums add up in a fixed order;
//   3. after cluster.sync(), rank 0 sums the CL partials in rank order
//      through distributed shared memory (deterministic), and folds W_v
//      and W_out into M (C x H) in its shared memory;
//   4. after a second cluster.sync(), every CTA copies M from rank 0; a
//      third keeps rank 0's shared memory alive until all have read it;
//   5. apply: q, the per-head softmax and y = M q over the slice; for bf16
//      x both products on tensor cores (apply_mma), for float32 one thread
//      a column on CUDA cores (apply_fma).
// Two more modes run the same kernel on a rank's slice of a sequence split
// over ranks (linear_attention_sp.cu): kStats (K6a, the cluster size from
// the card's occupancy) runs steps 1 and 2 and rank 0's sum of the
// partials, written to device memory as each row's [A | s]; kApply (K6b)
// skips step 2, and every CTA folds M in step 3 from the row's [A | s]
// summed over the ranks (read from device memory) and runs step 5: its CTAs
// share nothing, so it launches without a cluster, as many CTAs a row as
// spread the grid evenly over the SMs in one wave (choose_grid).
// The (H, N) q/k/v expansions never reach device memory: x is read once
// and y written once. Per column the op does 4 H x C multiply-add passes
// and 2 H exponentials, so at C = 4 it is bound by float32 operations and
// the SFU about equally (~0.08-0.09 ms for (34, 4, 40000)). On CUDA cores
// the issue slots of loads, conversions and exponentials come on top of
// the 4 passes (about 40 a feature and column in all). The bf16 path runs
// all 4 on tensor cores, which leaves the SFU's exponentials as its floor:
// A and y = M q are products of bf16 operands with float32 sums (p and xh
// for A, M and q for y are rounded to the compute dtype where the TPU
// kernel casts them), exactly what mma.sync computes; the projections k =
// W_k' xh and q = W_q' xh take float32 operands, so each is three bf16
// products of their (hi, lo) halves (mma_split), about 16 mantissa bits
// where the bf16 rounding of p and q that follows keeps 8; at C <= 8 each
// is an m16n8k8 over channels 0-7, half an m16n8k16. float32 x runs
// them all on CUDA cores in float32. exp is ex2.approx.ftz, exp2f's
// instruction without its denormal handling: a p or q weight below 2^-126
// of its bound counts as 0.
#include <cooperative_groups.h>

#include "common.cuh"
#include "linattn_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;          // columns normalized per phase-0 step
constexpr int kStageBudget = 100 * 1024;  // bytes of staged x and norms per CTA
constexpr int kXr = 24;  // row stride (bf16) of 16-channel rows: ldmatrix rows on distinct banks

// Shared-memory plan of a launch (float offsets, then the staged x in
// bytes), computed once on the host.
struct Plan {
  int wq, wk, qs, ks, ms, part, psum, vec, scratch, den;
  int xs;         // byte offset of the staged x (16-byte aligned)
  int row_bytes;  // byte stride of its channel rows, = N * sizeof(T) mod 16
  int chunk;      // columns per CTA
  int cl;         // CTAs per cluster
  int staged;
  int bytes;
};

// K1's cluster size: 8 CTAs a row, fewer for small N so that a CTA has at
// least kColsPerCta columns.
int k1_cluster(int N) {
  int cl = 1;
  while (cl < kMaxCluster && N / (2 * cl) >= kColsPerCta) cl *= 2;
  return cl;
}

Plan make_plan(int C, int CB, int H, int N, int elt, int cl) {
  Plan p{};
  p.cl = cl;
  p.chunk = dq::ceil_div(N, p.cl);
  // bf16 runs the tensor-core passes, whose channel rows are padded to 8
  const bool mma = elt == 2;
  const int nb = (CB + 7) / 8 * 8;
  int off = 0;
  p.wq = off;                    // W_q' rows, log2(e)-scaled: float32 (d, CB), or
  off += mma ? H * kXr : H * CB; //   bf16 (hi, lo) rows of 16 channels, stride kXr
  p.wk = off, off += H * CB;     // W_k' rows (d, CB), log2(e)-scaled
  p.qs = off, off += H;          // qshift', log2(e)-scaled
  p.ks = off, off += H;          // kshift', log2(e)-scaled
  p.ms = off;                    // M: float32 rows (d, CB), or bf16 channel rows (nb, H + 8)
  off += mma ? (nb * (H + 8) / 2 + 3) & ~3 : H * CB;
  p.part = off, off += H * CB;   // the CTA's partial A (d, CB) ...
  p.psum = off, off += H;        // ... and s
  p.vec = off, off += 4 * CB;    // b_out, g, g_pre * sqrt(C), g_pre
  p.scratch = off;               // phase-0 tiles; partials of groups or warps; W_v, W_out
  const int tiles = mma ? kTile * kXr : 2 * kTile * CB;  // bf16 (hi, lo) rows; float32 rows
  off += std::max(std::max(tiles, 2 * H * CB), (kThreads - H) * (CB + 1));
  off = (off + 3) & ~3;
  p.row_bytes = ((p.chunk * elt + 16 + 15) & ~15) + (int)(((long long)N * elt) % 16);
  // float32 keeps each column's norm; the bf16 passes recompute it
  const int dens = mma ? 0 : p.chunk;
  const long long stage = 4LL * dens + 16 + (long long)C * p.row_bytes;
  p.staged = stage <= kStageBudget;
  if (p.staged) {
    p.den = off, off += dens;
    p.xs = (off * 4 + 15) & ~15;
    p.bytes = p.xs + C * p.row_bytes;
  } else {
    p.den = p.xs = 0;
    p.bytes = off * 4;
  }
  return p;
}

template <typename T, int CB>
__device__ __forceinline__ float column_den(const Slice<T>& x, int C, int j) {
  float ss = 0.0f;
#pragma unroll
  for (int c = 0; c < CB; ++c)
    if (c < C) {
      const float v = x.at(c, j);
      ss += v * v;
    }
  return fmaxf(sqrtf(ss), 1e-12f);
}

// Phase 0 of a slice, float32 (CUDA cores): thread (group gi, feature d)
// sums p and p xh^T over the tile columns of its group; the groups' sums
// go to the CTA's partial in group order. Where H does not divide
// kThreads, the threads past the last whole group sit out.
template <typename T, int CB>
__device__ void phase0_fma(const Slice<T>& xsl, const float* den, const float* gp,
                           const float* wk_s, const float* ks_s, float* scratch, float* part,
                           float* psum, int C, int H, int cols, bool staged) {
  const int t = threadIdx.x, d = t % H, groups = kThreads / H, gi = t / H;
  const bool live = gi < groups;
  float* tn = scratch;               // pre-normed tile, float32 (kTile, CB)
  float* tr = scratch + kTile * CB;  // the same rounded to the compute dtype
  float wk[CB], a[CB];
  load_row<CB>(wk_s + d * CB, wk);
#pragma unroll
  for (int c = 0; c < CB; ++c) a[c] = 0.0f;
  const float ks = ks_s[d];
  float s = 0.0f;
  for (int t0 = 0; t0 < cols; t0 += kTile) {
    const int cnt = min(kTile, cols - t0);
    __syncthreads();  // the previous tile (and the norms) are done with
    if (t < cnt) {
      const int j = t0 + t;
      const float dn = staged ? den[j] : column_den<T, CB>(xsl, C, j);
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        const float h = c < C ? xsl.at(c, j) / dn * gp[c] : 0.0f;
        tn[t * CB + c] = h;
        tr[t * CB + c] = dq::round_cd<T>(h);
      }
    }
    __syncthreads();
    for (int j = live ? gi : cnt; j < cnt; j += groups) {
      float xv[CB];
      load_row<CB>(tn + j * CB, xv);
      const float pk = fast_exp2(dot<CB>(wk, xv, -ks));
      s += pk;
      const float pr = dq::round_cd<T>(pk);
      load_row<CB>(tr + j * CB, xv);
#pragma unroll
      for (int c = 0; c < CB; ++c) a[c] = fmaf(pr, xv[c], a[c]);
    }
  }
  __syncthreads();
  float* gsum = scratch;  // (groups - 1, H, CB + 1)
  if (gi > 0 && live) {
    float* dst = gsum + ((gi - 1) * H + d) * (CB + 1);
#pragma unroll
    for (int c = 0; c < CB; ++c) dst[c] = a[c];
    dst[CB] = s;
  }
  __syncthreads();
  if (gi == 0) {
    for (int k = 1; k < groups; ++k) {
      const float* src = gsum + ((k - 1) * H + d) * (CB + 1);
#pragma unroll
      for (int c = 0; c < CB; ++c) a[c] += src[c];
      s += src[CB];
    }
#pragma unroll
    for (int c = 0; c < CB; ++c) part[d * CB + c] = a[c];
    psum[d] = s;
  }
}

// The 16-column steps of one phase-0 tile (see phase0_mma); kFull: all
// kTile columns lie in the slice.
template <int CB, bool kFull>
__device__ __forceinline__ void phase0_steps(const __nv_bfloat16* th, const __nv_bfloat16* tl,
                                             const uint32_t (&wh)[4], const uint32_t (&wl)[4],
                                             float ks0, float ks1, float (&acc)[(CB + 7) / 8][4],
                                             float& s0, float& s1, int sub, int wpf, int cnt) {
  constexpr int NT = (CB + 7) / 8;
  constexpr bool kNarrow = CB <= 8;  // channels 0-7 only (see mma_split)
  const int lane = threadIdx.x & 31;
  // ldmatrix rows of the projection's B (channels x columns: non-transposed
  // rows of 16 channels) and of the product's B (columns x channels: .trans);
  // kNarrow loads only channels 0-7 of columns 0-7, then of columns 8-15 (ra)
  const int rp = (lane & 7) + (lane >> 4) * 8, cp = ((lane >> 3) & 1) * 8;
  const int ra = (lane & 7) + ((lane >> 3) & 1) * 8, ca = (lane >> 4) * 8;
  const int tig = lane & 3;
#pragma unroll 2
  for (int ks = sub; ks * 16 < cnt; ks += wpf) {
    // b0, b1 of columns 0-7, then of columns 8-15; kNarrow: b0 of each
    uint32_t bh[4], bl[4];
    if constexpr (kNarrow) {
      ldmatrix_x2(bh[0], bh[1], th + (ks * 16 + ra) * kXr);
      ldmatrix_x2(bl[0], bl[1], tl + (ks * 16 + ra) * kXr);
    } else {
      ldmatrix_x4(bh, th + (ks * 16 + rp) * kXr + cp);
      ldmatrix_x4(bl, tl + (ks * 16 + rp) * kXr + cp);
    }
    float k[2][4];  // k - kshift: (columns 0-7 | 8-15) x (f0: e < 2 | f1), columns 2 tig + (e & 1)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      k[nt][0] = k[nt][1] = -ks0;
      k[nt][2] = k[nt][3] = -ks1;
      if constexpr (kNarrow)
        mma_split<true>(k[nt], wh, wl, bh[nt], 0u, bl[nt], 0u);
      else
        mma_split<false>(k[nt], wh, wl, bh[2 * nt], bh[2 * nt + 1], bl[2 * nt], bl[2 * nt + 1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        k[nt][e] = fast_exp2(k[nt][e]);  // p
        if (!kFull && ks * 16 + nt * 8 + 2 * tig + (e & 1) >= cnt) k[nt][e] = 0.0f;
      }
      s0 += k[nt][0] + k[nt][1];
      s1 += k[nt][2] + k[nt][3];
    }
    uint32_t xr[4];  // the product's B: rounded columns (= hi), channels 0-7 then 8-15
    if constexpr (kNarrow)
      ldmatrix_x2_trans(xr[0], xr[1], th + (ks * 16 + ra) * kXr);
    else
      ldmatrix_x4_trans(xr, th + (ks * 16 + ra) * kXr + ca);
    const uint32_t a0 = pack_bf16(k[0][0], k[0][1]), a1 = pack_bf16(k[0][2], k[0][3]);
    const uint32_t a2 = pack_bf16(k[1][0], k[1][1]), a3 = pack_bf16(k[1][2], k[1][3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt], a0, a1, a2, a3, xr[2 * nt], xr[2 * nt + 1]);
  }
}

// Phase 0 of a slice, bf16 (tensor cores), in passes of up to kWarps
// 16-feature blocks (one pass for H <= 128, two above). In a pass of nfb
// blocks warp w takes block w mod nfb and every (kWarps / nfb)-th
// 16-column step of each tile; where nfb does not divide kWarps the warps
// past the last whole set sit out.
// The tile holds each column pre-normed and split into bf16 (hi, lo) rows
// of 16 channels. k - kshift = W_k' X comes from three bf16 products
// (mma_split, W_k' in registers), its accumulator is p's fragment after the
// exponential, and A = P Xr^T is a product of bf16 operands (p and xh
// rounded, as the TPU kernel casts them; xh's rounding is hi) with float32
// sums, as mma.sync computes it. The warps of a feature block add up in
// order.
template <int CB>
__device__ void phase0_mma(const Slice<__nv_bfloat16>& xsl, const float* gp, const float* wk_s,
                           const float* ks_s, float* scratch, float* part, float* psum, int C,
                           int H, int cols) {
  constexpr int NT = (CB + 7) / 8;  // n-tiles of 8 channels
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, gid = lane >> 2, tig = lane & 3;
  __nv_bfloat16* th = reinterpret_cast<__nv_bfloat16*>(scratch);  // (kTile, kXr)
  __nv_bfloat16* tl = th + kTile * kXr;
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
    const float ks0 = ks_s[f0], ks1 = ks_s[f1];
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
    float s0 = 0.0f, s1 = 0.0f;
    for (int t0 = 0; t0 < cols; t0 += kTile) {
      const int cnt = min(kTile, cols - t0);
      __syncthreads();  // the previous tile (and pass) is done with
      if (t < kTile) {  // one column a thread; zeros past the slice
        const int j = t0 + t;
        const float rd = t < cnt ? 1.0f / column_den<__nv_bfloat16, CB>(xsl, C, j) : 0.0f;
#pragma unroll
        for (int c = 0; c < (CB <= 8 ? 8 : 16); c += 2) {  // the channels the products read
          const float h0 = c < C && t < cnt ? xsl.at(c, j) * rd * gp[c] : 0.0f;
          const float h1 = c + 1 < C && t < cnt ? xsl.at(c + 1, j) * rd * gp[c + 1] : 0.0f;
          uint32_t hi, lo;
          split_bf16(h0, h1, hi, lo);
          *reinterpret_cast<uint32_t*>(th + t * kXr + c) = hi;
          *reinterpret_cast<uint32_t*>(tl + t * kXr + c) = lo;
        }
      }
      __syncthreads();
      if (!live) continue;
      if (cnt == kTile)  // no column past the slice: no masking
        phase0_steps<CB, true>(th, tl, wh, wl, ks0, ks1, acc, s0, s1, sub, wpf, cnt);
      else
        phase0_steps<CB, false>(th, tl, wh, wl, ks0, ks1, acc, s0, s1, sub, wpf, cnt);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the quad of a fragment row
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    // acc[nt][e]: feature e < 2 ? f0 : f1, channel nt * 8 + 2 tig + (e & 1)
    __syncthreads();
    // (wpf - 1, 16 nfb, CB + 1): the pass's features l0, l1 (within the tile area)
    float* gsum = scratch;
    const int l0 = f0 - fb0 * 16, l1 = l0 + 8;
    if (sub > 0 && live) {
      float* dst = gsum + (sub - 1) * nfb * 16 * (CB + 1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = nt * 8 + 2 * tig + (e & 1);
          if (ch < CB) dst[(e < 2 ? l0 : l1) * (CB + 1) + ch] = acc[nt][e];
        }
      if (tig == 0) dst[l0 * (CB + 1) + CB] = s0, dst[l1 * (CB + 1) + CB] = s1;
    }
    __syncthreads();
    if (sub == 0) {
      for (int k = 1; k < wpf; ++k) {
        const float* src = gsum + (k - 1) * nfb * 16 * (CB + 1);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ch = nt * 8 + 2 * tig + (e & 1);
            if (ch < CB) acc[nt][e] += src[(e < 2 ? l0 : l1) * (CB + 1) + ch];
          }
        s0 += src[l0 * (CB + 1) + CB];
        s1 += src[l1 * (CB + 1) + CB];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = nt * 8 + 2 * tig + (e & 1);
          if (ch < CB) part[(e < 2 ? f0 : f1) * CB + ch] = acc[nt][e];
        }
      if (tig == 0) psum[f0] = s0, psum[f1] = s1;
    }
  }
}

// Apply, float32 (CUDA cores): one thread per column of the slice.
template <typename T, int CB>
__device__ void apply_fma(const Slice<T>& xsl, const float* den, const float* wq,
                          const float* qs, const float* ms, const float* b_out, const float* g,
                          const float* gp, T* yb, long long N, int C, int H, int cols,
                          bool staged) {
  const float dh_scale = 0.17677669529663687f;  // 32 ** -0.5
  const float rs = sqrtf((float)C);
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    const float dn = staged ? den[j] : column_den<T, CB>(xsl, C, j);
    float xh[CB], acc[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      xh[c] = c < C ? xsl.at(c, j) / dn * gp[c] : 0.0f;
      acc[c] = 0.0f;
    }
    for (int h0 = 0; h0 < H; h0 += kDimHead) {
      float e[kDimHead];
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < kDimHead; ++i) {
        float wr[CB];
        load_row<CB>(wq + (h0 + i) * CB, wr);
        e[i] = fast_exp2(dot<CB>(wr, xh, -qs[h0 + i]));
        sum += e[i];
      }
      const float inv = 1.0f / fmaxf(sum, 1e-30f);
#pragma unroll
      for (int i = 0; i < kDimHead; ++i) {
        const float qn = dq::round_cd<T>(e[i] * inv * dh_scale);
        float mr[CB];
        load_row<CB>(ms + (h0 + i) * CB, mr);
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
    const float den2 = fmaxf(sqrtf(ss), 1e-12f);
#pragma unroll
    for (int c = 0; c < CB; ++c)
      if (c < C) yb[c * N + j] = dq::from_f32<T>(acc[c] / den2 * g[c] * rs + xsl.at(c, j));
  }
}

// Apply, bf16 (tensor cores): warp w takes 16-column blocks w, w + 8, ....
// A thread's fragment rows are columns gid and gid + 8 and its channels
// 2 tig + {0, 1, 8, 9}; the quad holds all 16, so a column's norm is a quad
// sum. q^T - qshift = Xh^T W_q'^T comes from three bf16 products (mma_split,
// W_q' (hi, lo) rows in shared memory), and its accumulators, after the
// exponential, the head's softmax sum (a quad sum) and the rounding of q,
// are the A operand of y^T = Qn^T M^T, a product of bf16 operands (M
// rounded to bf16, as the TPU kernel casts it) with float32 sums. The
// epilogue (bias, RMSNorm over the quad's channels, gain, residual) runs on
// the accumulators, whose channels are the thread's x channels.
template <int CB>
__device__ void apply_mma(const Slice<__nv_bfloat16>& xsl, const __nv_bfloat16* wqh,
                          const __nv_bfloat16* wql, const float* qs, const __nv_bfloat16* mb,
                          const float* b_out, const float* g, const float* gp,
                          __nv_bfloat16* yb, long long N, int C, int H, int cols) {
  constexpr int NT = (CB + 7) / 8;
  constexpr bool kNarrow = CB <= 8;  // channels 0-7 only (see mma_split)
  const float dh_scale = 0.17677669529663687f;  // 32 ** -0.5
  const float rs = sqrtf((float)C);
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  // ldmatrix rows of W_q': 16 features x channels 0-7, 8-15 (kNarrow: 0-7 only, ra)
  const int rp = (lane & 7) + (lane >> 4) * 8, cp = ((lane >> 3) & 1) * 8;
  const int ra = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int mrow = H + 8;  // row stride (bf16) of M's channel rows
  for (int j0 = (threadIdx.x >> 5) * 16; j0 < cols; j0 += kWarps * 16) {
    // x[i]: column jc[i >> 1], channel 2 tig + (i & 1) + 8 (i >> 2) ... as
    // x[(r, nt, e)] with r the column, nt the channel half, e the pair
    const int jc[2] = {j0 + gid, j0 + gid + 8};
    float xv[2][2][2], ss[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = nt * 8 + 2 * tig + e;
          xv[r][nt][e] = ch < C && jc[r] < cols ? xsl.at(ch, jc[r]) : 0.0f;
          ss[r] += xv[r][nt][e] * xv[r][nt][e];
        }
    uint32_t ah[4], al[4];  // A: Xh^T rows jc[0], jc[1] x channels
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ss[r] += __shfl_xor_sync(0xffffffffu, ss[r], 1);
      ss[r] += __shfl_xor_sync(0xffffffffu, ss[r], 2);
      const float rd = 1.0f / fmaxf(sqrtf(ss[r]), 1e-12f);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int ch = nt * 8 + 2 * tig;
        split_bf16(ch < CB ? xv[r][nt][0] * rd * gp[ch] : 0.0f,
                   ch + 1 < CB ? xv[r][nt][1] * rd * gp[ch + 1] : 0.0f, ah[r + 2 * nt],
                   al[r + 2 * nt]);
      }
    }
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
    for (int h0 = 0; h0 < H; h0 += kDimHead) {
      const float qsh = qs[h0];  // the q shift is constant within a head
      float q[4][4];  // q - qshift: features h0 + 8 nt + 2 tig + (e & 1), column jc[e >> 1]
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
          d[0] = d[1] = d[2] = d[3] = -qsh;
          if constexpr (kNarrow)
            mma_split<true>(d, ah, al, bh[i], 0u, bl[i], 0u);
          else
            mma_split<false>(d, ah, al, bh[2 * i], bh[2 * i + 1], bl[2 * i], bl[2 * i + 1]);
        }
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          q[nt][e] = fast_exp2(q[nt][e]);
          sum[e >> 1] += q[nt][e];
        }
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        inv[r] = dh_scale / fmaxf(sum[r], 1e-30f);
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {  // features h0 + 16 kk ..: n-tiles 2 kk, 2 kk + 1
        const uint32_t a0 = pack_bf16(q[2 * kk][0] * inv[0], q[2 * kk][1] * inv[0]);
        const uint32_t a1 = pack_bf16(q[2 * kk][2] * inv[1], q[2 * kk][3] * inv[1]);
        const uint32_t a2 = pack_bf16(q[2 * kk + 1][0] * inv[0], q[2 * kk + 1][1] * inv[0]);
        const uint32_t a3 = pack_bf16(q[2 * kk + 1][2] * inv[1], q[2 * kk + 1][3] * inv[1]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const __nv_bfloat16* row = mb + (nt * 8 + gid) * mrow + h0 + kk * 16 + 2 * tig;
          mma_bf16(acc[nt], a0, a1, a2, a3, *reinterpret_cast<const uint32_t*>(row),
                   *reinterpret_cast<const uint32_t*>(row + 8));
        }
      }
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
      s2[r] = fmaxf(sqrtf(s2[r]), 1e-12f);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = nt * 8 + 2 * tig + (e & 1), r = e >> 1;
        if (ch < C && jc[r] < cols)
          yb[ch * N + jc[r]] = __float2bfloat16(acc[nt][e] / s2[r] * g[ch] * rs +
                                                xv[r][nt][e & 1]);
      }
  }
}

// The kernel's modes: the whole op (K1); a rank's phase-0 partials of a
// sequence split over ranks, written to stats (B, H, C + 1) as each row's
// [A | s], with no apply and no y, reading only W_k and g_pre (kStats, K6a);
// the apply from the row's [A | s] summed over the ranks, read from stats,
// with no phase 0 and no W_k (kApply, K6b). The kernel takes the mode as
// an int (profiles name its instances linattn_cluster<T, CB, mode>).
enum Mode { kFull, kStats, kApply };

// CTAs held on one SM: bf16 at C <= 8, 3 (<= 80 registers a thread; the
// staged level-0 slice leaves room for 3 in shared memory), so that the 34
// rows x 8 CTAs of the canonical level 0 run in one wave; otherwise 2
// (float32's CUDA-core passes spill at 80).
template <typename T, int CB, int kMode>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 && CB <= 8 ? 3 : 2)
    linattn_cluster(const T* __restrict__ x, T* __restrict__ y, float* __restrict__ stats,
                    Weights w, Plan p, int C, int N, int H) {
  constexpr bool kMma = sizeof(T) == 2;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x, cl = gridDim.x;  // a cluster's rank and size (grid (cl, B))
  const int t = threadIdx.x, b = blockIdx.y;
  const int nbeg = min(N, rank * p.chunk), cols = min(N, nbeg + p.chunk) - nbeg;
  float* wq = smem + p.wq;
  float* wk = smem + p.wk;
  float* qs = smem + p.qs;
  float* ks = smem + p.ks;
  float* ms = smem + p.ms;  // M: float32 rows (H, CB), or bf16 channel rows (NT * 8, H + 8)
  float* part = smem + p.part;
  float* psum = smem + p.psum;
  float* b_out = smem + p.vec;
  float* g = b_out + CB;
  float* gp = g + CB;      // g_pre * sqrt(C)
  float* gpre = gp + CB;   // g_pre
  float* scratch = smem + p.scratch;
  float* den = smem + p.den;
  const float rs = sqrtf((float)C);

  // 1. stage the slice (async), read the weights meanwhile
  Slice<T> xsl;
  xsl.xg = x + (long long)b * C * N + nbeg;
  xsl.N = N;
  xsl.row_bytes = p.row_bytes;
  xsl.staged = p.staged;
  xsl.xs = reinterpret_cast<const char*>(smem) + p.xs +
           (reinterpret_cast<uintptr_t>(xsl.xg) & 15);
  if (p.staged) stage_rows<T>(const_cast<char*>(xsl.xs), p.row_bytes, xsl.xg, N, C, cols);

  const bool bq = w.bf16 & 1, bo = w.bf16 & 2;
  if (t < CB) {
    const bool ok = t < C;
    b_out[t] = ok && kMode != kStats ? ld(w.b_out, t * w.b_out_c, w.bf16 & 4) : 0.0f;
    g[t] = ok && kMode != kStats ? ld(w.g, t * w.g_c, w.bf16 & 8) : 0.0f;
    gpre[t] = ok ? ld(w.g_pre, t * w.g_pre_c, w.bf16 & 16) : 0.0f;
    gp[t] = gpre[t] * rs;
  }
  __syncthreads();
  // W_q and W_k rows, log2(e)-scaled, and the static shifts
  // (_static_shifts): a pre-normed column has norm at most sqrt(C)
  // max|g_pre|, so ||w_d|| times that bounds every logit of feature d; the
  // q shift is its head's largest bound
  float cn = 0.0f;
  for (int c = 0; c < C; ++c) cn = fmaxf(cn, fabsf(gpre[c]));
  cn *= rs;
  __nv_bfloat16* wqh = reinterpret_cast<__nv_bfloat16*>(wq);  // bf16 W_q' (hi, lo) rows
  __nv_bfloat16* wql = wqh + H * kXr;
  // rows 0..H-1: W_q; H..2H-1: W_k
  for (int d = (kMode == kStats ? H : 0) + t; d < (kMode == kApply ? H : 2 * H);
       d += kThreads) {
    float v[CB], nrm = 0.0f;
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      v[c] = c < C ? ld(w.wqkv, c * w.wqkv_c + d * w.wqkv_h, bq) : 0.0f;
      nrm += v[c] * v[c];
      v[c] *= kLog2e;
    }
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
    float bnd = sqrtf(nrm) * cn;
    if (d < H) {  // whole warps: H is a multiple of 32
#pragma unroll
      for (int off = 16; off; off >>= 1)
        bnd = fmaxf(bnd, __shfl_xor_sync(0xffffffffu, bnd, off));
      qs[d] = bnd * kLog2e;
    } else {
      ks[d - H] = bnd * kLog2e;
    }
  }
  if (p.staged) asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();  // the weights (and the staged slice) are in
  if (p.staged && !kMma)
    for (int j = t; j < cols; j += kThreads) den[j] = column_den<T, CB>(xsl, C, j);

  // 2. phase 0: the CTA's partial (A, s)
  if constexpr (kMode != kApply) {
    if constexpr (kMma)
      phase0_mma<CB>(xsl, gp, wk, ks, scratch, part, psum, C, H, cols);
    else
      phase0_fma<T, CB>(xsl, den, gp, wk, ks, scratch, part, psum, C, H, cols, p.staged);
    cluster.sync();  // #1: every CTA's partial is visible to the cluster
  }

  if constexpr (kMode == kStats) {  // rank 0: the row's (A, s) in rank order, to stats
    if (rank == 0 && t < H) {
      float a[CB], s = 0.0f;
#pragma unroll
      for (int c = 0; c < CB; ++c) a[c] = 0.0f;
      for (int r = 0; r < cl; ++r) {
        float pr[CB];
        load_row<CB>(cluster.map_shared_rank(part, r) + t * CB, pr);
#pragma unroll
        for (int c = 0; c < CB; ++c) a[c] += pr[c];
        s += cluster.map_shared_rank(psum, r)[t];
      }
      float* dst = stats + ((long long)b * H + t) * (C + 1);
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c < C) dst[c] = a[c];
      dst[C] = s;
    }
    cluster.sync();  // the partials stay until rank 0 has read them
    return;
  }

  // 3. rank 0: the row's (A, s) in rank order, then M = W_out^T ctx^T;
  // kApply: every CTA folds M itself from the row's summed (A, s) in stats,
  // so that the CTAs of a row share nothing (no cluster, no sync)
  constexpr int NB = kMma ? (CB + 7) / 8 * 8 : CB;
  __nv_bfloat16* mb = reinterpret_cast<__nv_bfloat16*>(ms);
  if (rank == 0 || kMode == kApply) {
    float* wv = scratch;           // (H, CB)
    float* wo = scratch + H * CB;  // (H, CB)
    for (int i = t; i < H * CB; i += kThreads) {
      const int e = i / CB, c = i % CB;
      wv[i] = c < C ? ld(w.wqkv, c * w.wqkv_c + (2 * H + e) * w.wqkv_h, bq) : 0.0f;
      wo[i] = c < C ? ld(w.wout, e * w.wout_h + c * w.wout_c, bo) : 0.0f;
    }
    const int d = t;
    float a[CB], s = 0.0f;
    if (d < H && kMode == kApply) {
      const float* src = stats + ((long long)b * H + d) * (C + 1);
#pragma unroll
      for (int c = 0; c < CB; ++c) a[c] = c < C ? src[c] : 0.0f;
      s = src[C];
    } else if (d < H) {
#pragma unroll
      for (int c = 0; c < CB; ++c) a[c] = 0.0f;
      for (int r = 0; r < cl; ++r) {
        float pr[CB];
        load_row<CB>(cluster.map_shared_rank(part, r) + d * CB, pr);
#pragma unroll
        for (int c = 0; c < CB; ++c) a[c] += pr[c];
        s += cluster.map_shared_rank(psum, r)[d];
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
      if constexpr (kMma) {
#pragma unroll
        for (int c = 0; c < NB; ++c) mb[c * (H + 8) + d] = __float2bfloat16(c < CB ? mc[c] : 0.0f);
      } else {
#pragma unroll
        for (int c = 0; c < CB; ++c) ms[d * CB + c] = dq::round_cd<T>(mc[c]);
      }
    }
  }
  if constexpr (kMode == kApply) {
    __syncthreads();  // M is in this CTA's shared memory
  } else {
    cluster.sync();  // #2: M is in rank 0's shared memory
    if (rank != 0) {
      const int words = kMma ? NB * (H + 8) / 2 : H * CB;
      const float* m0 = cluster.map_shared_rank(ms, 0);
      for (int i = t; i < words; i += kThreads) ms[i] = m0[i];
    }
    cluster.sync();  // #3: every CTA has its copy; rank 0 may go on and exit
  }

  // 4. apply over the slice
  T* yb = y + (long long)b * C * N + nbeg;
  if constexpr (kMma)
    apply_mma<CB>(xsl, wqh, wql, qs, mb, b_out, g, gp, yb, N, C, H, cols);
  else
    apply_fma<T, CB>(xsl, den, wq, qs, ms, b_out, g, gp, yb, N, C, H, cols, p.staged);
}

// K1: K1's cluster size. kStats (K6a): the cluster size from the card's
// occupancy, as K4 takes it (choose_cluster). kApply (K6b): a grid of
// independent CTAs (choose_grid).
template <typename T, int CB, int kMode>
cudaError_t run_c(const void* x, void* y, float* stats, const Weights& w, int B, int C, int N,
                  int H, cudaStream_t s) {
  auto kernel = linattn_cluster<T, CB, kMode>;
  const auto make = [&](int cl) { return make_plan(C, CB, H, N, sizeof(T), cl); };
  const T* xt = static_cast<const T*>(x);
  Plan p;
  if constexpr (kMode == kApply) {
    cudaError_t err = choose_grid(kernel, kThreads, B, C, N, H, make, &p);
    if (err == cudaSuccess) err = dq::allow_smem(kernel, p.bytes);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(p.cl, B), kThreads, p.bytes, s>>>(xt, static_cast<T*>(y), stats, w, p, C, N,
                                                     H);
    return cudaGetLastError();
  }
  if constexpr (kMode == kStats) {
    const cudaError_t err = choose_cluster(kernel, kThreads, B, C, N, H, make, &p);
    if (err != cudaSuccess) return err;
  } else {
    p = make_plan(C, CB, H, N, sizeof(T), k1_cluster(N));
  }
  return launch_cluster(kernel, p.cl, B, kThreads, p.bytes, s, xt, static_cast<T*>(y), stats, w,
                        p, C, N, H);
}

// The channel loops are unrolled to C rounded up to a multiple of 4, so the
// level-0 width C = 4 runs 4-wide loops rather than 16-wide predicated ones.
template <typename T, int kMode>
cudaError_t run(const void* x, void* y, float* stats, const Weights& w, int B, int C, int N,
                int H, cudaStream_t s) {
  switch ((C + 3) / 4) {
    case 1: return run_c<T, 4, kMode>(x, y, stats, w, B, C, N, H, s);
    case 2: return run_c<T, 8, kMode>(x, y, stats, w, B, C, N, H, s);
    case 3: return run_c<T, 12, kMode>(x, y, stats, w, B, C, N, H, s);
    default: return run_c<T, 16, kMode>(x, y, stats, w, B, C, N, H, s);
  }
}

}  // namespace

// K6a on K1's kernel (see linattn_common.cuh).
cudaError_t dq::linattn_stats(const void* x, float* stats, const Weights& w, int B, int C, int N,
                              int heads, bool bf16, cudaStream_t s) {
  const int H = heads * kDimHead;
  return bf16 ? run<__nv_bfloat16, kStats>(x, nullptr, stats, w, B, C, N, H, s)
              : run<float, kStats>(x, nullptr, stats, w, B, C, N, H, s);
}

// K6b on K1's kernel (see linattn_common.cuh).
cudaError_t dq::linattn_apply(const void* x, void* y, const float* stats, const Weights& w,
                              int B, int C, int N, int heads, bool bf16, cudaStream_t s) {
  const int H = heads * kDimHead;
  float* st = const_cast<float*>(stats);  // read only in kApply
  return bf16 ? run<__nv_bfloat16, kApply>(x, y, st, w, B, C, N, H, s)
              : run<float, kApply>(x, y, st, w, B, C, N, H, s);
}

// x and y: contiguous (B, C, N), bf16 or float32 (x_bf16). The weights as
// in Weights, each with its strides; `w_bf16` holds their dtype bits.
extern "C" int dq_linear_attention(const void* x, void* y, const void* wqkv, long long wqkv_c,
                                   long long wqkv_h, const void* wout, long long wout_h,
                                   long long wout_c, const void* b_out, long long b_out_c,
                                   const void* g, long long g_c, const void* g_pre,
                                   long long g_pre_c, int B, int C, int N, int heads,
                                   int w_bf16, int x_bf16, int device, void* stream) {
  if (!linattn_valid(B, C, N, heads)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Weights w{wqkv, wqkv_c, wqkv_h, wout, wout_h, wout_c, b_out, b_out_c,
                  g,    g_c,    g_pre,  g_pre_c, w_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int H = heads * kDimHead;
  err = x_bf16 ? run<__nv_bfloat16, kFull>(x, y, nullptr, w, B, C, N, H, s)
               : run<float, kFull>(x, y, nullptr, w, B, C, N, H, s);
  return (int)err;
}

// The launch shape the op takes for (C, N): out[0] CTAs per cluster,
// out[1] whether the slice is staged in shared memory, out[2] the dynamic
// shared memory of a CTA in bytes.
extern "C" int dq_linear_attention_plan(int C, int N, int heads, int x_bf16, int* out) {
  if (!linattn_valid(1, C, N, heads)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(C, (C + 3) / 4 * 4, heads * kDimHead, N, x_bf16 ? 2 : 4, k1_cluster(N));
  out[0] = p.cl;
  out[1] = p.staged;
  out[2] = p.bytes;
  return 0;
}
