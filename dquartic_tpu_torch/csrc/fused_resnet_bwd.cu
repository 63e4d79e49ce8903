// K5: backward of the fused ResnetBlock (K2) on channel-first (B, C, N):
//   h1 = conv3(x) + b1;  a1 = SiLU(RMSNorm_g1(h1) (scale + 1) + shift)
//   (a1 := 0 outside [0, N));  h2 = conv3(a1) + b2
//   out = SiLU(RMSNorm_g2(h2)) + (res_conv(x) or x)
// Given dy it returns dx and every parameter and FiLM gradient, by
// recomputing the forward from x, so autograd saves only (x, params).
//
// Replaces the TPU kernel dquartic_tpu/ops/fused_resnet.py:_backward
// (_kernel_resnet_bwd_t), with its window table (:302-323). For the own
// columns [n0, n0 + BN) of a tile:
//   x, dy   [n0 - P, n0 + BN + P)   staged (cp.async, the next tile's while
//                                   this one is computed), 0 outside [0, N)
//   a1      [n0 - 3, n0 + BN + 3)   recomputed; h1 kept on [n0 - 1, n0 + BN + 1)
//   dh2     [n0 - 2, n0 + BN + 2)   h2 recomputed, then its backward
//   dh1     [n0 - 1, n0 + BN + 1)   da1 := 0 outside [0, N); written over h1
//   dx      [n0, n0 + BN)
// The TPU grid accumulates the parameter gradients in revisited output
// blocks; here, as in K2, the design is:
//   * no host work: the kernel reads its ten operands in their own dtype
//     through their strides and rounds the conv weights to x's dtype (the
//     weights K2 uses); a missing FiLM or residual bias is a flag;
//   * the canonical (C_in, C_out) pairs are template arguments, a thread
//     owns V consecutive columns of a tile (K2's V, or one measured faster
//     here), and a few threads of warp 0 take the halo columns one each;
//   * grid (splits, B): a CTA walks a chunk of whole tiles of one row, the
//     splits as many as one wave of CTAs holds (the occupancy API);
//   * the sums over columns stay in registers over the CTA's chunk: the
//     weight gradients dW1[k] = dh1 x_k^T, dW2[k] = dh2 a1_k^T and dW_res =
//     dy x^T as tensor-core products whose k runs along 16 columns (mma.sync
//     on the (hi, lo) bf16 halves of each float32 operand; x and dy are
//     exact in bf16), each warp over its 16-column slices; the bias, gain
//     and FiLM gradients as each thread's sums over its columns. They reach
//     shared memory once per CTA, added in warp (and lane) order, and each
//     CTA writes its partial sums;
//   * a second launch sums the partials in a fixed order (rows, then
//     splits; FiLM per row) and writes each gradient in its parameter's
//     shape, dtype and strides.
// Two calls give bitwise equal gradients. At C <= 16 the block does a few
// hundred multiply-adds per column against a few bytes of x and dy: at
// 4 -> 4 it is bound by its bytes (x, dy in, dx out) with the CUDA cores'
// five convolutions close behind. Interior math is float32; dx is stored in
// x's dtype.
#include "fused_resnet.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 64;  // the wrapper's partial buffer holds this many a row

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// Shared memory of one CTA: x and dy (T) over BN + 2P columns, twice (the
// next tile's arrive while this one is computed); a1, h1 (then dh1) and dh2
// (float32) over BN + 8 (column n0 + j at index 4 + j); the weights and
// vectors; the CTA's sums.
template <typename T, int CI, int CO, int V>
struct Layout {
  static constexpr int BN = kThreads * V;
  static constexpr int P = 16 / sizeof(T);  // >= 4: x needs 4 halo columns, dy 2
  static constexpr int XR = BN + 2 * P;     // x, dy column n0 + j at index P + j
  static constexpr int AR = BN + 8;
  static constexpr int kX = 0;
  static constexpr int kDy = align16(CI * XR * sizeof(T));
  static constexpr int kBuf = kDy + align16(CO * XR * sizeof(T));  // bytes of one x, dy pair
  static constexpr int kA1 = 2 * kBuf;
  static constexpr int kH1 = kA1 + CO * AR * 4;
  static constexpr int kDh2 = kH1 + CO * AR * 4;
  static constexpr int kW1 = kDh2 + CO * AR * 4;
  static constexpr int kW2 = kW1 + 3 * CI * CO * 4;
  static constexpr int kWR = kW2 + 3 * CO * CO * 4;
  static constexpr int kVec = kWR + CI * CO * 4;
  static constexpr int kRed = kVec + 8 * CO * 4;
  static constexpr int bytes = kRed + (3 * CI * CO + 3 * CO * CO + CI * CO + 7 * CO) * 4;
};

// The partial sums of a CTA, for (c_in, c_out) channels: dW1 [k][c][o] |
// dW2 [k][c][o] | dW_res [c][o] | db1 | dg1 | db2 | dg2 | db_res | dscale |
// dshift (c_out each; the gains before their sqrt(C_out) factor).
struct Sums {
  int w1, w2, wr, vec, len;
  __host__ __device__ Sums(int ci, int co)
      : w1(0), w2(3 * ci * co), wr(3 * ci * co + 3 * co * co),
        vec(3 * ci * co + 3 * co * co + ci * co), len(vec + 7 * co) {}
};
enum Vec { kDb1, kDg1, kDb2, kDg2, kDbr, kDsc, kDsh };

// The A fragments (hi, lo) of 16 columns of rows (rows o < CO, zero past
// it): a0..a3 = (o +0 | +8) x (columns 0-7 | 8-15), two a thread; bf16
// values are their own hi halves (lo = 0).
template <typename T, int CO>
__device__ __forceinline__ void rows_a(const T* rows, int stride, int j, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = gid + 8 * (i & 1);
    const T* p = rows + o * stride + j + 8 * (i >> 1) + 2 * tig;
    if constexpr (sizeof(T) == 2) {
      ah[i] = o < CO ? *reinterpret_cast<const uint32_t*>(p) : 0u;
      al[i] = 0u;
    } else {
      const float2 v = o < CO ? *reinterpret_cast<const float2*>(p) : make_float2(0.0f, 0.0f);
      split_bf16(v.x, v.y, ah[i], al[i]);
    }
  }
}

// The B fragments (hi, lo) of columns j .. j + 15 of rows c = 8 nt + gid
// (rows < R): b0 = columns 2 tig, 2 tig + 1, b1 = the same + 8.
template <typename T, int R>
__device__ __forceinline__ void rows_b(const T* rows, int stride, int j, int nt, uint32_t (&bh)[2],
                                       uint32_t (&bl)[2]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int c = 8 * nt + gid;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const T* p = rows + c * stride + j + 8 * i + 2 * tig;
    if constexpr (sizeof(T) == 2) {  // bf16 values are their own hi halves: lo = 0
      const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
      bh[i] = c < R ? (uint32_t)q[0] | (uint32_t)q[1] << 16 : 0u;
      bl[i] = 0u;
    } else {
      split_bf16(c < R ? p[0] : 0.0f, c < R ? p[1] : 0.0f, bh[i], bl[i]);
    }
  }
}

template <typename T, int CI, int CO, int V, bool GENERIC>
struct Block {
  using L = Layout<T, CI, CO, V>;
  static constexpr int NI = (CI + 7) / 8, NO = (CO + 7) / 8;  // n-tiles of 8 channels
  static constexpr bool kBf16 = sizeof(T) == 2;
  T* xs;
  T* dys;
  float *a1s, *h1s, *dh2s, *w1s, *w2s, *wrs, *vec, *red;
  int N, n0, c_in, c_out;
  bool has_res;
  // per thread: sums over its own columns (kDb1 .. kDsh)
  float vs[7][CO];
  // per warp: the weight gradients over its 16-column slices
  float gw1[3][NI][4], gw2[3][NO][4], gwr[NI][4];

  // vec: b1, g1 sqrt(C) (scale + 1), shift, b2, g2 sqrt(C), g1 sqrt(C), scale + 1
  __device__ float b1(int o) const { return vec[o]; }
  __device__ float gfilm(int o) const { return vec[CO + o]; }
  __device__ float shift(int o) const { return vec[2 * CO + o]; }
  __device__ float b2(int o) const { return vec[3 * CO + o]; }
  __device__ float g2(int o) const { return vec[4 * CO + o]; }
  __device__ float g1(int o) const { return vec[5 * CO + o]; }
  __device__ float sc1(int o) const { return vec[6 * CO + o]; }

  // block1 at W columns from n0 + j: a1 (0 outside [0, N)), and h1 where keep
  template <int W>
  __device__ __forceinline__ void stage_a(int j, bool keep) {
    float acc[W][CO];
#pragma unroll
    for (int jj = 0; jj < W; ++jj)
#pragma unroll
      for (int o = 0; o < CO; ++o) acc[jj][o] = b1(o);
#pragma unroll 4
    for (int c = 0; c < CI; ++c) {
      float w[W + 2];
      load_window<T, W>(xs + c * L::XR, L::P + j, w);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float* wk = w1s + (k * CI + c) * CO;
#pragma unroll
        for (int o = 0; o < CO; ++o) {
          const float wv = wk[o];
#pragma unroll
          for (int jj = 0; jj < W; ++jj) acc[jj][o] = fmaf(wv, w[jj + k], acc[jj][o]);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < W; ++jj) {
      float ss = 0.0f;
#pragma unroll
      for (int o = 0; o < CO; ++o) ss = fmaf(acc[jj][o], acc[jj][o], ss);
      const float inv = rsqrtf(fmaxf(ss, 1e-24f));
      const int pos = n0 + j + jj;
      const bool inside = pos >= 0 && pos < N;
#pragma unroll
      for (int o = 0; o < CO; ++o) {
        const int idx = o * L::AR + 4 + j + jj;
        if (keep) h1s[idx] = acc[jj][o];
        a1s[idx] = inside ? silu(fmaf(acc[jj][o] * inv, gfilm(o), shift(o))) : 0.0f;
      }
    }
  }

  // block2 recomputed at W columns from n0 + j, then its backward: dh2
  template <int W>
  __device__ __forceinline__ void stage_b(int j, bool own) {
    float acc[W][CO];
#pragma unroll
    for (int jj = 0; jj < W; ++jj)
#pragma unroll
      for (int o = 0; o < CO; ++o) acc[jj][o] = b2(o);
#pragma unroll 4
    for (int c = 0; c < CO; ++c) {
      float w[W + 2];
      load_window<float, W>(a1s + c * L::AR, 4 + j, w);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float* wk = w2s + (k * CO + c) * CO;
#pragma unroll
        for (int o = 0; o < CO; ++o) {
          const float wv = wk[o];
#pragma unroll
          for (int jj = 0; jj < W; ++jj) acc[jj][o] = fmaf(wv, w[jj + k], acc[jj][o]);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < W; ++jj) {
      float ss = 0.0f;
#pragma unroll
      for (int o = 0; o < CO; ++o) ss = fmaf(acc[jj][o], acc[jj][o], ss);
      const float inv = rsqrtf(fmaxf(ss, 1e-24f));
      float y[CO], d[CO], inner = 0.0f;
#pragma unroll
      for (int o = 0; o < CO; ++o) {
        y[o] = acc[jj][o] * inv;
        const float dz = dq::to_f32(dys[o * L::XR + L::P + j + jj]) * dq::silu_grad(y[o] * g2(o));
        d[o] = dz * g2(o);
        inner = fmaf(d[o], y[o], inner);
        if (own) vs[kDg2][o] = fmaf(dz, y[o], vs[kDg2][o]);
      }
#pragma unroll
      for (int o = 0; o < CO; ++o) {
        const float dh = (d[o] - y[o] * inner) * inv;
        dh2s[o * L::AR + 4 + j + jj] = dh;
        if (own) vs[kDb2][o] += dh;
      }
    }
  }

  // da1 = conv2^T dh2 at W columns from n0 + j, then the backward of FiLM
  // and RMSNorm_g1: dh1, written over h1
  template <int W>
  __device__ __forceinline__ void stage_c(int j, bool own) {
    float da[W][CO];
#pragma unroll
    for (int jj = 0; jj < W; ++jj)
#pragma unroll
      for (int c = 0; c < CO; ++c) da[jj][c] = 0.0f;
#pragma unroll 4
    for (int o = 0; o < CO; ++o) {
      float w[W + 2];  // dh2 of o at columns n0 + j - 1 ..
      load_window<float, W>(dh2s + o * L::AR, 4 + j, w);
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int c = 0; c < CO; ++c) {
          const float wv = w2s[(k * CO + c) * CO + o];
#pragma unroll
          for (int jj = 0; jj < W; ++jj) da[jj][c] = fmaf(wv, w[jj + 2 - k], da[jj][c]);
        }
    }
#pragma unroll
    for (int jj = 0; jj < W; ++jj) {
      const int pos = n0 + j + jj;
      const bool inside = pos >= 0 && pos < N;
      float h[CO], ss = 0.0f;
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        h[c] = h1s[c * L::AR + 4 + j + jj];
        ss = fmaf(h[c], h[c], ss);
      }
      const float inv = rsqrtf(fmaxf(ss, 1e-24f));
      float d[CO], inner = 0.0f;
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        const float y = h[c] * inv, hn = y * g1(c);
        const float df = (inside ? da[jj][c] : 0.0f) * dq::silu_grad(fmaf(hn, sc1(c), shift(c)));
        const float dhn = df * sc1(c);
        d[c] = dhn * g1(c);
        inner = fmaf(d[c], y, inner);
        h[c] = y;
        if (own) {
          vs[kDsc][c] = fmaf(df, hn, vs[kDsc][c]);
          vs[kDsh][c] += df;
          vs[kDg1][c] = fmaf(dhn, y, vs[kDg1][c]);
        }
      }
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        const float dh = (d[c] - h[c] * inner) * inv;
        h1s[c * L::AR + 4 + j + jj] = dh;
        if (own) vs[kDb1][c] += dh;
      }
    }
  }

  // dx = conv1^T dh1 + the residual's backward at the thread's V columns
  __device__ __forceinline__ void stage_d(T* dxrow, int j) {
    float acc[V][CI];
#pragma unroll
    for (int jj = 0; jj < V; ++jj)
#pragma unroll
      for (int c = 0; c < CI; ++c) acc[jj][c] = 0.0f;
#pragma unroll 4
    for (int o = 0; o < CO; ++o) {
      float w[V + 2];  // dh1 of o at columns n0 + j - 1 ..
      load_window<float, V>(h1s + o * L::AR, 4 + j, w);
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int c = 0; c < CI; ++c) {
          const float wv = w1s[(k * CI + c) * CO + o];
#pragma unroll
          for (int jj = 0; jj < V; ++jj) acc[jj][c] = fmaf(wv, w[jj + 2 - k], acc[jj][c]);
        }
    }
    if (has_res) {
#pragma unroll  // whole: vs[kDbr][o] stays in registers
      for (int o = 0; o < CO; ++o) {
        float g[V];
#pragma unroll
        for (int jj = 0; jj < V; ++jj) {
          g[jj] = dq::to_f32(dys[o * L::XR + L::P + j + jj]);
          vs[kDbr][o] += g[jj];
        }
#pragma unroll
        for (int c = 0; c < CI; ++c) {
          const float wv = wrs[c * CO + o];
#pragma unroll
          for (int jj = 0; jj < V; ++jj) acc[jj][c] = fmaf(wv, g[jj], acc[jj][c]);
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < CI; ++c)
#pragma unroll
        for (int jj = 0; jj < V; ++jj) acc[jj][c] += dq::to_f32(dys[c * L::XR + L::P + j + jj]);
    }
    const int n = n0 + j;
    if (n >= N) return;
    const bool whole = N % V == 0 && n + V <= N;  // the V columns are one aligned store
#pragma unroll
    for (int c = 0; c < CI; ++c) {
      if (GENERIC && c >= c_in) break;
      RawOf<T, V> r;
      T* v = reinterpret_cast<T*>(&r);
#pragma unroll
      for (int jj = 0; jj < V; ++jj) v[jj] = dq::from_f32<T>(acc[jj][c]);
      T* dst = dxrow + (size_t)c * N + n;
      if (whole) {
        *reinterpret_cast<RawOf<T, V>*>(dst) = r;
      } else {
        for (int jj = 0; jj < V && n + jj < N; ++jj) dst[jj] = v[jj];
      }
    }
  }

  // the weight gradients of the warp's 16-column slices of the tile
  __device__ __forceinline__ void contract() {
    for (int s = threadIdx.x >> 5; s < L::BN / 16; s += kWarps) {
      const int j = 16 * s;
      uint32_t h1h[4], h1l[4], h2h[4], h2l[4];
      rows_a<float, CO>(h1s, L::AR, 4 + j, h1h, h1l);   // dh1
      rows_a<float, CO>(dh2s, L::AR, 4 + j, h2h, h2l);  // dh2
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int nt = 0; nt < NI; ++nt) {  // dW1[k] += dh1 x_k^T
          uint32_t bh[2], bl[2];
          rows_b<T, CI>(xs, L::XR, L::P + j + k - 1, nt, bh, bl);
          mma_split<false, false, kBf16>(gw1[k][nt], h1h, h1l, bh[0], bh[1], bl[0], bl[1]);
        }
#pragma unroll
        for (int nt = 0; nt < NO; ++nt) {  // dW2[k] += dh2 a1_k^T
          uint32_t bh[2], bl[2];
          rows_b<float, CO>(a1s, L::AR, 4 + j + k - 1, nt, bh, bl);
          mma_split<false>(gw2[k][nt], h2h, h2l, bh[0], bh[1], bl[0], bl[1]);
        }
      }
      if (has_res) {  // dW_res += dy x^T
        uint32_t dh[4], dl[4];
        rows_a<T, CO>(dys, L::XR, L::P + j, dh, dl);
#pragma unroll
        for (int nt = 0; nt < NI; ++nt) {
          uint32_t bh[2], bl[2];
          rows_b<T, CI>(xs, L::XR, L::P + j, nt, bh, bl);
          mma_split<false, kBf16, kBf16>(gwr[nt], dh, dl, bh[0], bh[1], bl[0], bl[1]);
        }
      }
    }
  }

  // The CTA's sums into red (laid out as Sums), in warp and lane order.
  __device__ __forceinline__ void finish(const Sums& sm) {
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3, warp = threadIdx.x >> 5;
#pragma unroll
    for (int v = 0; v < 7; ++v)
#pragma unroll
      for (int o = 0; o < CO; ++o)
#pragma unroll
        for (int off = 16; off; off >>= 1)
          vs[v][o] += __shfl_xor_sync(0xffffffffu, vs[v][o], off);
    for (int w = 0; w < kWarps; ++w) {
      if (warp == w) {
        auto add = [&](int idx, float v) { red[idx] = (w ? red[idx] : 0.0f) + v; };
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = gid + 8 * (e >> 1);
          if (o >= c_out) continue;
#pragma unroll
          for (int nt = 0; nt < NI; ++nt) {
            const int c = 8 * nt + 2 * tig + (e & 1);
            if (c >= c_in) continue;
#pragma unroll
            for (int k = 0; k < 3; ++k) add(sm.w1 + (k * c_in + c) * c_out + o, gw1[k][nt][e]);
            if (has_res) add(sm.wr + c * c_out + o, gwr[nt][e]);
          }
#pragma unroll
          for (int nt = 0; nt < NO; ++nt) {
            const int c = 8 * nt + 2 * tig + (e & 1);
            if (c >= c_out) continue;
#pragma unroll
            for (int k = 0; k < 3; ++k) add(sm.w2 + (k * c_out + c) * c_out + o, gw2[k][nt][e]);
          }
        }
        if (lane == 0)
#pragma unroll
          for (int v = 0; v < 7; ++v)
#pragma unroll
            for (int o = 0; o < CO; ++o)
              if (o < c_out) add(sm.vec + v * c_out + o, vs[v][o]);
      }
      __syncthreads();
    }
  }
};

template <typename T, int CI, int CO, int V, bool GENERIC>
// CO <= 4: 4 CTAs an SM (at most 128 registers a thread; measured faster)
__global__ void __launch_bounds__(kThreads, CO <= 4 ? 4 : 1) resnet_bwd(const T* __restrict__ x,
                                                       const T* __restrict__ dy,
                                                       T* __restrict__ dx, const Params p,
                                                       float* __restrict__ part, int tiles_per_cta,
                                                       int nsplit) {
  using L = Layout<T, CI, CO, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  Block<T, CI, CO, V, GENERIC> blk;
  blk.a1s = reinterpret_cast<float*>(smem + L::kA1);
  blk.h1s = reinterpret_cast<float*>(smem + L::kH1);
  blk.dh2s = reinterpret_cast<float*>(smem + L::kDh2);
  blk.w1s = reinterpret_cast<float*>(smem + L::kW1);
  blk.w2s = reinterpret_cast<float*>(smem + L::kW2);
  blk.wrs = reinterpret_cast<float*>(smem + L::kWR);
  blk.vec = reinterpret_cast<float*>(smem + L::kVec);
  blk.red = reinterpret_cast<float*>(smem + L::kRed);
  const int tid = threadIdx.x, sp = blockIdx.x, row = blockIdx.y;
  const int c_in = GENERIC ? p.c_in : CI, c_out = GENERIC ? p.c_out : CO, N = p.N;
  blk.N = N, blk.c_in = c_in, blk.c_out = c_out;
  blk.has_res = GENERIC ? (p.flags & kRes) != 0 : CI != CO;
#pragma unroll
  for (int v = 0; v < 7; ++v)
#pragma unroll
    for (int o = 0; o < CO; ++o) blk.vs[v][o] = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int nt = 0; nt < Block<T, CI, CO, V, GENERIC>::NI; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) blk.gw1[k][nt][e] = 0.0f;
#pragma unroll
    for (int nt = 0; nt < Block<T, CI, CO, V, GENERIC>::NO; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) blk.gw2[k][nt][e] = 0.0f;
  }
#pragma unroll
  for (int nt = 0; nt < Block<T, CI, CO, V, GENERIC>::NI; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) blk.gwr[nt][e] = 0.0f;

  // weights rounded to the activation dtype, zero past c_in / c_out
  const int bits = p.bits;
  for (int i = tid; i < 3 * CI * CO; i += kThreads) {
    const int k = i / (CI * CO), c = i / CO % CI, o = i % CO;
    blk.w1s[i] = c < c_in && o < c_out ? dq::round_cd<T>(ld(p.w1, k * p.w1_k + c * p.w1_i +
                                                                   o * p.w1_o, bits >> kW1 & 1))
                                       : 0.0f;
  }
  for (int i = tid; i < 3 * CO * CO; i += kThreads) {
    const int k = i / (CO * CO), c = i / CO % CO, o = i % CO;
    blk.w2s[i] = c < c_out && o < c_out ? dq::round_cd<T>(ld(p.w2, k * p.w2_k + c * p.w2_i +
                                                                    o * p.w2_o, bits >> kW2 & 1))
                                        : 0.0f;
  }
  if (blk.has_res)
    for (int i = tid; i < CI * CO; i += kThreads) {
      const int c = i / CO, o = i % CO;
      blk.wrs[i] = c < c_in && o < c_out
                       ? dq::round_cd<T>(ld(p.w_res, c * p.wr_i + o * p.wr_o, bits >> kWRes & 1))
                       : 0.0f;
    }
  if (tid < CO) {
    const int o = tid;
    const bool on = o < c_out, film = (p.flags & kFilm) != 0;
    const float rs = sqrtf((float)c_out);
    const float scale = on && film ? ld(p.scale, row * p.scale_b + o * p.scale_o,
                                        bits >> kScale & 1) : 0.0f;
    const float g1 = on ? ld(p.g1, o * p.g1_o, bits >> kG1 & 1) * rs : 0.0f;
    float* vec = blk.vec;
    vec[o] = on ? ld(p.b1, o * p.b1_o, bits >> kB1 & 1) : 0.0f;
    vec[CO + o] = g1 * (scale + 1.0f);
    vec[2 * CO + o] =
        on && film ? ld(p.shift, row * p.shift_b + o * p.shift_o, bits >> kShift & 1) : 0.0f;
    vec[3 * CO + o] = on ? ld(p.b2, o * p.b2_o, bits >> kB2 & 1) : 0.0f;
    vec[4 * CO + o] = on ? ld(p.g2, o * p.g2_o, bits >> kG2 & 1) * rs : 0.0f;
    vec[5 * CO + o] = g1;
    vec[6 * CO + o] = scale + 1.0f;
  }

  const T* xrow = x + (size_t)row * c_in * N;
  const T* dyrow = dy + (size_t)row * c_out * N;
  T* dxrow = dx + (size_t)row * c_in * N;
  const int tiles = (N + L::BN - 1) / L::BN;
  const int t0 = sp * tiles_per_cta, t_end = min(tiles, t0 + tiles_per_cta);
  const int j0 = V * tid;
  // halo columns, one a thread of warp 0: a1 at n0 - 3 .. n0 - 1 and
  // n0 + BN .. n0 + BN + 2; dh2 at n0 - 2, n0 - 1, n0 + BN, n0 + BN + 1;
  // dh1 at n0 - 1 and n0 + BN
  const int ha = tid < 3 ? tid - 3 : L::BN + tid - 3;
  const int hb = tid < 2 ? tid - 2 : L::BN + tid - 2;
  const int hc = tid < 1 ? -1 : L::BN;
  auto stage = [&](int t) {  // x and dy of tile t into buffer t % 2
    T* xs = reinterpret_cast<T*>(smem + (t & 1) * L::kBuf + L::kX);
    T* dys = reinterpret_cast<T*>(smem + (t & 1) * L::kBuf + L::kDy);
    stage_window<T, CI, L::XR>(xs, xrow, c_in, N, t * L::BN - L::P);
    stage_window<T, CO, L::XR>(dys, dyrow, c_out, N, t * L::BN - L::P);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  stage(t0);
  for (int t = t0; t < t_end; ++t) {
    const int n0 = t * L::BN;
    blk.n0 = n0;
    __syncthreads();  // tile t - 1 is done with the buffer tile t + 1 takes
    if (t + 1 < t_end) {
      stage(t + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    blk.xs = reinterpret_cast<T*>(smem + (t & 1) * L::kBuf + L::kX);
    blk.dys = reinterpret_cast<T*>(smem + (t & 1) * L::kBuf + L::kDy);
    __syncthreads();
    blk.template stage_a<V>(j0, true);
    if (tid < 6) blk.template stage_a<1>(ha, ha == -1 || ha == L::BN);
    __syncthreads();
    blk.template stage_b<V>(j0, true);
    if (tid < 4) blk.template stage_b<1>(hb, false);
    __syncthreads();
    blk.template stage_c<V>(j0, true);
    if (tid < 2) blk.template stage_c<1>(hc, false);
    __syncthreads();
    blk.stage_d(dxrow, j0);
    blk.contract();
  }
  const Sums sm(c_in, c_out);
  blk.finish(sm);
  float* dst = part + ((size_t)row * nsplit + sp) * sm.len;
  for (int i = tid; i < sm.len; i += kThreads) dst[i] = blk.red[i];
}

__device__ __forceinline__ void st(const void* p, long long i, bool bf16, float v) {
  if (bf16)
    static_cast<__nv_bfloat16*>(const_cast<void*>(p))[i] = __float2bfloat16(v);
  else
    static_cast<float*>(const_cast<void*>(p))[i] = v;
}

// The second launch: each gradient summed over the CTAs' partials by one
// warp (lane l taking the partials l, l + 32, ..., a butterfly adding the
// lanes: a fixed order; rows, then splits; the FiLM gradients per row, over
// its splits) and written in its parameter's dtype through its strides. g:
// the gradients as Params lays out the parameters, `bits` their dtypes.
__global__ void __launch_bounds__(256) resnet_bwd_finish(const float* __restrict__ part,
                                                         const Params g, int B, int nsplit) {
  const int ci = g.c_in, co = g.c_out, lane = threadIdx.x & 31;
  const int i = (blockIdx.x * 256 + threadIdx.x) >> 5;  // whole warps
  const Sums sm(ci, co);
  const bool film = g.flags & kFilm, res = g.flags & kRes, rbias = g.flags & kResBias;
  const bool global = i < sm.vec + 5 * co;  // summed over every row and split
  if (global ? (i >= sm.wr && i < sm.vec && !res) || (i >= sm.vec + kDbr * co && !rbias)
             : !film || i >= sm.vec + 5 * co + 2 * B * co)
    return;
  const int r = i - sm.vec - 5 * co, which = r / (B * co), b = r / co % B;
  const float* src = global ? part + i
                            : part + (size_t)b * nsplit * sm.len + sm.vec +
                                  (which ? kDsh : kDsc) * co + r % co;
  const int n = global ? B * nsplit : nsplit;
  float s = 0.0f;
  for (int k = lane; k < n; k += 32) s += src[(size_t)k * sm.len];
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane != 0) return;
  const float rs = sqrtf((float)co);
  if (!global) {  // dscale, dshift of row b
    const int o = r % co;
    if (which)
      st(g.shift, b * g.shift_b + o * g.shift_o, g.bits >> kShift & 1, s);
    else
      st(g.scale, b * g.scale_b + o * g.scale_o, g.bits >> kScale & 1, s);
  } else if (i < sm.w2) {
    const int k = i / (ci * co), c = i / co % ci, o = i % co;
    st(g.w1, k * g.w1_k + c * g.w1_i + o * g.w1_o, g.bits >> kW1 & 1, s);
  } else if (i < sm.wr) {
    const int q = i - sm.w2, k = q / (co * co), c = q / co % co, o = q % co;
    st(g.w2, k * g.w2_k + c * g.w2_i + o * g.w2_o, g.bits >> kW2 & 1, s);
  } else if (i < sm.vec) {
    const int q = i - sm.wr, c = q / co, o = q % co;
    st(g.w_res, c * g.wr_i + o * g.wr_o, g.bits >> kWRes & 1, s);
  } else {
    const int v = (i - sm.vec) / co, o = (i - sm.vec) % co;
    switch (v) {
      case kDb1: st(g.b1, o * g.b1_o, g.bits >> kB1 & 1, s); break;
      case kDg1: st(g.g1, o * g.g1_o, g.bits >> kG1 & 1, s * rs); break;
      case kDb2: st(g.b2, o * g.b2_o, g.bits >> kB2 & 1, s); break;
      case kDg2: st(g.g2, o * g.g2_o, g.bits >> kG2 & 1, s * rs); break;
      default: st(g.b_res, o * g.br_o, g.bits >> kBRes & 1, s); break;
    }
  }
}

int sm_count(int device) {
  static int counts[64] = {};
  if (device < 0 || device >= 64) return 132;
  if (counts[device] == 0) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || v < 1)
      v = 132;
    counts[device] = v;
  }
  return counts[device];
}

template <typename T, int CI, int CO, int V, bool GENERIC = false>
cudaError_t launch(const void* x, const void* dy, void* dx, const Params& p, const Params& g,
                   float* part, int B, int device, cudaStream_t s) {
  using L = Layout<T, CI, CO, V>;
  auto kernel = resnet_bwd<T, CI, CO, V, GENERIC>;
  static const cudaError_t attr = dq::allow_smem(kernel, L::bytes);  // once
  if (attr != cudaSuccess) return attr;
  static const int per_sm = [&] {  // CTAs an SM holds (registers, shared memory)
    int n = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, L::bytes) ==
                   cudaSuccess && n > 0 ? n : 1;
  }();
  // the splits: as many as one wave of CTAs holds, in whole tiles
  const int tiles = dq::ceil_div(p.N, L::BN);
  const int want = std::min(std::min(kMaxSplits, dq::ceil_div(p.N, 128)),
                            std::max(1, per_sm * sm_count(device) / B));
  const int per = dq::ceil_div(tiles, want), nsplit = dq::ceil_div(tiles, per);
  kernel<<<dim3(nsplit, B), kThreads, L::bytes, s>>>(static_cast<const T*>(x),
                                                     static_cast<const T*>(dy),
                                                     static_cast<T*>(dx), p, part, per, nsplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Sums sm(p.c_in, p.c_out);
  resnet_bwd_finish<<<dq::ceil_div(32 * (sm.vec + 5 * p.c_out + 2 * B * p.c_out), 256), 256, 0,
                      s>>>(
      part, g, B, nsplit);
  return cudaGetLastError();
}

// The canonical pairs of K2 (fused_resnet.cu), each with K2's V but where
// another V measured faster for this kernel at 34 rows on an H100 (8 -> 8,
// 16 -> 8 and 20 -> 12: 2; 28 -> 16: 1); any other pair runs the
// zero-padded (32, 16) instantiation.
template <typename T>
cudaError_t run(const void* x, const void* dy, void* dx, const Params& p, const Params& g,
                float* part, int B, int device, cudaStream_t s) {
#define DQ_RUN(...) launch<T, __VA_ARGS__>(x, dy, dx, p, g, part, B, device, s)
  const bool res = (p.flags & kRes) != 0;
  switch (res == (p.c_in != p.c_out) ? p.c_in * 100 + p.c_out : 0) {
    case 404: return DQ_RUN(4, 4, 4);
    case 804: return DQ_RUN(8, 4, 4);
    case 1208: return DQ_RUN(12, 8, 4);
    case 808: return DQ_RUN(8, 8, 2);
    case 1608: return DQ_RUN(16, 8, 2);
    case 2012: return DQ_RUN(20, 12, 2);
    case 1212: return DQ_RUN(12, 12, 2);
    case 2412: return DQ_RUN(24, 12, 2);
    case 2816: return DQ_RUN(28, 16, 1);
    case 1616: return DQ_RUN(16, 16, 1);
    case 3216: return DQ_RUN(32, 16, 1);
    default: return DQ_RUN(kMaxCin, kMaxCout, 1, true);
  }
#undef DQ_RUN
}

}  // namespace

// x, dy (B, C_in / C_out, N) and dx (B, C_in, N) contiguous, bf16 (x_bf16)
// or float32; the parameters as in K2's dq_fused_resnet, each with its
// strides, `bits` their dtypes, `flags` FiLM, residual conv and residual
// bias; their gradients likewise (`gbits`), where the parameter is given;
// part: B * min(64, ceil(N / 128)) * (3 C_in C_out + 3 C_out^2 + C_in C_out
// + 7 C_out) float32.
extern "C" int dq_fused_resnet_bwd(
    const void* x, const void* dy, void* dx, const void* w1, long long w1_k, long long w1_i,
    long long w1_o, const void* b1, long long b1_o, const void* g1, long long g1_o,
    const void* scale, long long scale_b, long long scale_o, const void* shift,
    long long shift_b, long long shift_o, const void* w2, long long w2_k, long long w2_i,
    long long w2_o, const void* b2, long long b2_o, const void* g2, long long g2_o,
    const void* w_res, long long wr_i, long long wr_o, const void* b_res, long long br_o,
    void* gw1, long long gw1_k, long long gw1_i, long long gw1_o, void* gb1, long long gb1_o,
    void* gg1, long long gg1_o, void* gscale, long long gscale_b, long long gscale_o,
    void* gshift, long long gshift_b, long long gshift_o, void* gw2, long long gw2_k,
    long long gw2_i, long long gw2_o, void* gb2, long long gb2_o, void* gg2, long long gg2_o,
    void* gw_res, long long gwr_i, long long gwr_o, void* gb_res, long long gbr_o, void* part,
    int B, int c_in, int c_out, int N, int flags, int bits, int gbits, int x_bf16, int device,
    void* stream) {
  if (B < 1 || B > 65535 || N < 1 || c_in < 1 || c_out < 1 || c_in > kMaxCin ||
      c_out > kMaxCout || (!(flags & kRes) && c_in != c_out))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Params p{w1,    w1_k,    w1_i,    w1_o,  b1,      b1_o,    g1,    g1_o,
                 scale, scale_b, scale_o, shift, shift_b, shift_o, w2,    w2_k,
                 w2_i,  w2_o,    b2,      b2_o,  g2,      g2_o,    w_res, wr_i,
                 wr_o,  b_res,   br_o,    c_in,  c_out,   N,       flags, bits};
  const Params g{gw1,    gw1_k,    gw1_i,    gw1_o,  gb1,      gb1_o,    gg1,    gg1_o,
                 gscale, gscale_b, gscale_o, gshift, gshift_b, gshift_o, gw2,    gw2_k,
                 gw2_i,  gw2_o,    gb2,      gb2_o,  gg2,      gg2_o,    gw_res, gwr_i,
                 gwr_o,  gb_res,   gbr_o,    c_in,   c_out,    N,        flags,  gbits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  err = x_bf16 ? run<__nv_bfloat16>(x, dy, dx, p, g, pt, B, device, s)
               : run<float>(x, dy, dx, p, g, pt, B, device, s);
  return (int)err;
}
