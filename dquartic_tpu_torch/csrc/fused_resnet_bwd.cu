// K5: backward of the fused ResnetBlock (K2) on channel-first (B, C, N):
//   h1 = conv3(x) + b1;  a1 = SiLU(RMSNorm_g1(h1) (scale + 1) + shift)
//   (a1 := 0 outside [0, N));  h2 = conv3(a1) + b2
//   out = SiLU(RMSNorm_g2(h2)) + (res_conv(x) or x)
// Given dy it returns dx and every parameter and FiLM gradient, by
// recomputing the forward from x, so autograd saves only (x, params).
//
// Replaces the TPU kernel dquartic_tpu/ops/fused_resnet.py:_backward
// (_kernel_resnet_bwd_t), with its window table (:302-323). Per tile of
// kTN output columns [n0, n0 + kTN) of one row:
//   x       [n0 - 4, n0 + kTN + 4)   staged in shared memory, 0 outside [0, N)
//   h1, a1  [n0 - 3, n0 + kTN + 3)   recomputed
//   h2, dy  [n0 - 2, n0 + kTN + 2)   recomputed / staged
//   dh1     [n0 - 1, n0 + kTN + 1)   da1 := 0 outside [0, N)
//   dx      [n0, n0 + kTN)
// Every weight, bias, gain, and FiLM gradient sums over the tile's own
// columns only, so each position counts once. The TPU grid accumulates
// into revisited output blocks; Hopper blocks run in no order, so a CTA
// walks a chunk of ~1024 columns of one row tile by tile, each thread owns
// fixed entries of the CTA's gradient accumulators in shared memory, the
// CTA writes them once as partials, and a second pass sums the partials in
// a fixed order (deterministic, no float atomics). The wrapper sums rows.
// The TPU kernel's row stacking and kron block-diagonal weights only fill
// sublanes and were not ported.
//
// What bounds it: at C <= 16 the block is a few hundred multiply-adds per
// column against a few bytes of x and dy, so it is bound by memory traffic
// and the staged reductions, not arithmetic. The conv weights arrive
// rounded to the activation dtype, the same values K2 uses; all math is
// float32, dx is stored in x's dtype, the parameter gradients in float32.
#include "common.cuh"

namespace {

constexpr int kTN = 128;  // output columns per tile = threads per CTA
constexpr int kMaxCin = 32;
constexpr int kMaxCout = 16;
constexpr int kPX = kTN + 8, kPH = kTN + 6, kPY = kTN + 4, kPA = kTN + 2;

// Shared-memory layout, in floats.
struct Layout {
  int xs, dys, a1s, h1s, dh2s, dh1s, st, w1s, w2s, wrs, vec, acc, total;
  __host__ __device__ Layout(int ci, int co, int plen) {
    int o = 0;
    xs = o;   o += ci * kPX;
    dys = o;  o += co * kPY;
    a1s = o;  o += co * kPH;
    h1s = o;  o += co * kPH;
    dh2s = o; o += co * kPY;
    dh1s = o; o += co * kPA;
    st = o;   o += 4 * co * kTN;  // own-column terms of dg2, dg1, dscale, dshift
    w1s = o;  o += 3 * ci * co;
    w2s = o;  o += 3 * co * co;
    wrs = o;  o += ci * co;
    vec = o;  o += 6 * co;        // b1, g1, scale + 1, shift, b2, g2
    acc = o;  o += plen;
    total = o;
  }
};

template <typename T, int CO>
__global__ void __launch_bounds__(kTN) resnet_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ g1,
    const float* __restrict__ scale, const float* __restrict__ shift,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ g2, const float* __restrict__ w_res, float* __restrict__ part,
    T* __restrict__ dx, int ci, int co, int N, int chunk, int nsplit, int film, int has_res) {
  extern __shared__ float smem[];
  const int n_w1 = 3 * ci * co, n_w2 = 3 * co * co, n_wr = ci * co;
  const int plen = n_w1 + n_w2 + n_wr + 7 * co;
  const Layout L(ci, co, plen);
  float* xs = smem + L.xs;
  float* dys = smem + L.dys;
  float* a1s = smem + L.a1s;
  float* h1s = smem + L.h1s;
  float* dh2s = smem + L.dh2s;
  float* dh1s = smem + L.dh1s;
  float* st = smem + L.st;
  float* w1s = smem + L.w1s;
  float* w2s = smem + L.w2s;
  float* wrs = smem + L.wrs;
  float* vec = smem + L.vec;
  float* acc = smem + L.acc;

  const int tid = threadIdx.x, sp = blockIdx.x, row = blockIdx.y;
  for (int i = tid; i < n_w1; i += kTN) w1s[i] = w1[i];
  for (int i = tid; i < n_w2; i += kTN) w2s[i] = w2[i];
  for (int i = tid; i < n_wr; i += kTN) wrs[i] = has_res ? w_res[i] : 0.0f;
  for (int i = tid; i < plen; i += kTN) acc[i] = 0.0f;
  if (tid < co) {
    vec[0 * co + tid] = b1[tid];
    vec[1 * co + tid] = g1[tid];
    vec[2 * co + tid] = film ? scale[row * co + tid] + 1.0f : 1.0f;
    vec[3 * co + tid] = film ? shift[row * co + tid] : 0.0f;
    vec[4 * co + tid] = b2[tid];
    vec[5 * co + tid] = g2[tid];
  }
  const float rs = sqrtf((float)co);
  const T* xrow = x + (size_t)row * ci * N;
  const T* dyrow = dy + (size_t)row * co * N;
  const int nbeg = sp * chunk, nend = min(N, nbeg + chunk);

  for (int n0 = nbeg; n0 < nend; n0 += kTN) {
    const int ncols = min(kTN, nend - n0);  // own columns of this tile
    __syncthreads();  // previous tile's readers are done
    for (int i = tid; i < ci * kPX; i += kTN) {
      const int c = i / kPX, j = i % kPX, pos = n0 - 4 + j;
      xs[i] = (pos >= 0 && pos < N) ? dq::to_f32(xrow[(size_t)c * N + pos]) : 0.0f;
    }
    for (int i = tid; i < co * kPY; i += kTN) {
      const int c = i / kPY, j = i % kPY, pos = n0 - 2 + j;
      dys[i] = (pos >= 0 && pos < N) ? dq::to_f32(dyrow[(size_t)c * N + pos]) : 0.0f;
    }
    __syncthreads();

    // block1 recompute over [n0 - 3, n0 + kTN + 3)
    for (int j = tid; j < kPH; j += kTN) {
      float h[CO];
#pragma unroll
      for (int o = 0; o < CO; ++o) h[o] = o < co ? vec[o] : 0.0f;
      for (int k = 0; k < 3; ++k)
        for (int c = 0; c < ci; ++c) {
          const float xv = xs[c * kPX + j + k];
          const float* wk = &w1s[(k * ci + c) * co];
#pragma unroll
          for (int o = 0; o < CO; ++o)
            if (o < co) h[o] = fmaf(wk[o], xv, h[o]);
        }
      float ss = 0.0f;
#pragma unroll
      for (int o = 0; o < CO; ++o) ss += h[o] * h[o];
      const float inv_n = 1.0f / fmaxf(sqrtf(ss), 1e-12f);
      const int pos = n0 - 3 + j;
      const bool inside = pos >= 0 && pos < N;
#pragma unroll
      for (int o = 0; o < CO; ++o) {
        if (o >= co) continue;
        const float f = h[o] * inv_n * vec[co + o] * rs * vec[2 * co + o] + vec[3 * co + o];
        h1s[o * kPH + j] = h[o];
        a1s[o * kPH + j] = inside ? dq::silu(f) : 0.0f;
      }
    }
    __syncthreads();

    // block2 recompute and backward over [n0 - 2, n0 + kTN + 2)
    for (int j = tid; j < kPY; j += kTN) {
      float h[CO];
#pragma unroll
      for (int o = 0; o < CO; ++o) h[o] = o < co ? vec[4 * co + o] : 0.0f;
      for (int k = 0; k < 3; ++k)
        for (int c = 0; c < co; ++c) {
          const float av = a1s[c * kPH + j + k];
          const float* wk = &w2s[(k * co + c) * co];
#pragma unroll
          for (int o = 0; o < CO; ++o)
            if (o < co) h[o] = fmaf(wk[o], av, h[o]);
        }
      float ss = 0.0f;
#pragma unroll
      for (int o = 0; o < CO; ++o) ss += h[o] * h[o];
      const float inv_n = 1.0f / fmaxf(sqrtf(ss), 1e-12f);
      float dh2n[CO], u2[CO];
      float xdu = 0.0f;
#pragma unroll
      for (int o = 0; o < CO; ++o) {
        if (o < co) {
          const float h2n = h[o] * inv_n * vec[5 * co + o] * rs;
          dh2n[o] = dys[o * kPY + j] * dq::silu_grad(h2n);
          u2[o] = dh2n[o] * vec[5 * co + o] * rs;
        } else {
          dh2n[o] = u2[o] = 0.0f;
        }
        xdu = fmaf(h[o], u2[o], xdu);
      }
      const bool own = j >= 2 && j < 2 + ncols;
#pragma unroll
      for (int o = 0; o < CO; ++o) {
        if (o >= co) continue;
        dh2s[o * kPY + j] = (u2[o] - h[o] * xdu * inv_n * inv_n) * inv_n;
        if (own) st[(0 * co + o) * kTN + j - 2] = dh2n[o] * h[o] * inv_n;
      }
    }
    __syncthreads();

    // da1 and the backward through FiLM + block1 over [n0 - 1, n0 + kTN + 1)
    for (int j = tid; j < kPA; j += kTN) {
      const int pos = n0 - 1 + j;
      const bool inside = pos >= 0 && pos < N;
      float da[CO], h[CO];
#pragma unroll
      for (int o = 0; o < CO; ++o) {
        da[o] = 0.0f;
        h[o] = o < co ? h1s[o * kPH + j + 2] : 0.0f;
      }
      if (inside)
        for (int k = 0; k < 3; ++k)
          for (int o2 = 0; o2 < co; ++o2) {
            const float g = dh2s[o2 * kPY + j + 2 - k];
            const float* wk = &w2s[k * co * co + o2];  // w2[k][c][o2] over c
#pragma unroll
            for (int c = 0; c < CO; ++c)
              if (c < co) da[c] = fmaf(wk[c * co], g, da[c]);
          }
      float ss = 0.0f;
#pragma unroll
      for (int o = 0; o < CO; ++o) ss += h[o] * h[o];
      const float inv_n = 1.0f / fmaxf(sqrtf(ss), 1e-12f);
      float dh1n[CO], u1[CO];
      float xdu = 0.0f;
      const bool own = j >= 1 && j < 1 + ncols;
#pragma unroll
      for (int o = 0; o < CO; ++o) {
        if (o < co) {
          const float h1n = h[o] * inv_n * vec[co + o] * rs;
          const float f = h1n * vec[2 * co + o] + vec[3 * co + o];
          const float dA = da[o] * dq::silu_grad(f);
          dh1n[o] = dA * vec[2 * co + o];
          u1[o] = dh1n[o] * vec[co + o] * rs;
          if (own) {
            st[(1 * co + o) * kTN + j - 1] = dh1n[o] * h[o] * inv_n;
            st[(2 * co + o) * kTN + j - 1] = dA * h1n;
            st[(3 * co + o) * kTN + j - 1] = dA;
          }
        } else {
          dh1n[o] = u1[o] = 0.0f;
        }
        xdu = fmaf(h[o], u1[o], xdu);
      }
#pragma unroll
      for (int o = 0; o < CO; ++o)
        if (o < co) dh1s[o * kPA + j] = (u1[o] - h[o] * xdu * inv_n * inv_n) * inv_n;
    }
    __syncthreads();

    // dx over the own columns
    if (tid < ncols) {
      const int jj = tid;
      T* dxrow = dx + (size_t)row * ci * N + n0 + jj;
      float g[CO];
      for (int c = 0; c < ci; ++c) {
        float v = 0.0f;
        for (int k = 0; k < 3; ++k) {
          const float* wk = &w1s[(k * ci + c) * co];
#pragma unroll
          for (int o = 0; o < CO; ++o)
            if (o < co) v = fmaf(wk[o], dh1s[o * kPA + jj + 2 - k], v);
        }
        if (has_res) {
#pragma unroll
          for (int o = 0; o < CO; ++o) g[o] = o < co ? dys[o * kPY + jj + 2] : 0.0f;
#pragma unroll
          for (int o = 0; o < CO; ++o)
            if (o < co) v = fmaf(wrs[c * co + o], g[o], v);
        } else {
          v += dys[c * kPY + jj + 2];
        }
        dxrow[(size_t)c * N] = dq::from_f32<T>(v);
      }
    }

    // parameter gradients over the own columns; thread-owned entries
    for (int e = tid; e < plen; e += kTN) {
      float s = 0.0f;
      if (e < n_w1) {  // dw1[k][c][o] = sum dh1[o][pos] x[c][pos + k - 1]
        const int o = e % co, c = (e / co) % ci, k = e / (co * ci);
        const float* a = &dh1s[o * kPA + 1];
        const float* b = &xs[c * kPX + k + 3];
        for (int jj = 0; jj < ncols; ++jj) s = fmaf(a[jj], b[jj], s);
      } else if (e < n_w1 + n_w2) {  // dw2[k][c][o] = sum dh2[o][pos] a1[c][pos + k - 1]
        const int r = e - n_w1;
        const int o = r % co, c = (r / co) % co, k = r / (co * co);
        const float* a = &dh2s[o * kPY + 2];
        const float* b = &a1s[c * kPH + k + 2];
        for (int jj = 0; jj < ncols; ++jj) s = fmaf(a[jj], b[jj], s);
      } else if (e < n_w1 + n_w2 + n_wr) {  // dw_res[c][o] = sum dy[o][pos] x[c][pos]
        if (!has_res) continue;
        const int r = e - n_w1 - n_w2;
        const int o = r % co, c = r / co;
        const float* a = &dys[o * kPY + 2];
        const float* b = &xs[c * kPX + 4];
        for (int jj = 0; jj < ncols; ++jj) s = fmaf(a[jj], b[jj], s);
      } else {  // b1, g1, b2, g2, b_res, scale, shift
        const int r = e - n_w1 - n_w2 - n_wr;
        const int which = r / co, o = r % co;
        const float* a;
        switch (which) {
          case 0: a = &dh1s[o * kPA + 1]; break;
          case 1: a = &st[(1 * co + o) * kTN]; break;
          case 2: a = &dh2s[o * kPY + 2]; break;
          case 3: a = &st[(0 * co + o) * kTN]; break;
          case 4: a = &dys[o * kPY + 2]; break;
          case 5: a = &st[(2 * co + o) * kTN]; break;
          default: a = &st[(3 * co + o) * kTN]; break;
        }
        if (which == 4 && !has_res) continue;
        if (which >= 5 && !film) continue;
        for (int jj = 0; jj < ncols; ++jj) s += a[jj];
        if (which == 1 || which == 3) s *= rs;
      }
      acc[e] += s;
    }
  }

  __syncthreads();
  float* dst = part + ((size_t)row * nsplit + sp) * plen;
  for (int i = tid; i < plen; i += kTN) dst[i] = acc[i];
}

template <typename T, int CO>
cudaError_t launch(const void* x, const void* dy, const float* const* f, float* part,
                   float* sums, void* dx, int B, int ci, int co, int N, int nsplit, int chunk,
                   int film, int has_res, cudaStream_t s) {
  const int plen = 3 * ci * co + 3 * co * co + ci * co + 7 * co;
  const size_t bytes = sizeof(float) * (size_t)Layout(ci, co, plen).total;
  cudaError_t err = dq::allow_smem(resnet_bwd_kernel<T, CO>, bytes);
  if (err != cudaSuccess) return err;
  resnet_bwd_kernel<T, CO><<<dim3(nsplit, B), kTN, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), f[0], f[1], f[2], f[3], f[4], f[5],
      f[6], f[7], f[8], part, static_cast<T*>(dx), ci, co, N, chunk, nsplit, film, has_res);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return dq::launch_sum_partials(part, sums, B, nsplit, plen, s);
}

// The output-channel loops are unrolled to C_out rounded up to a multiple
// of 4, as in K2.
template <typename T>
cudaError_t run(const void* x, const void* dy, const float* const* f, float* part, float* sums,
                void* dx, int B, int ci, int co, int N, int nsplit, int chunk, int film,
                int has_res, cudaStream_t s) {
#define DQ_RUN(CO) \
  launch<T, CO>(x, dy, f, part, sums, dx, B, ci, co, N, nsplit, chunk, film, has_res, s)
  switch ((co + 3) / 4) {
    case 1: return DQ_RUN(4);
    case 2: return DQ_RUN(8);
    case 3: return DQ_RUN(12);
    default: return DQ_RUN(16);
  }
#undef DQ_RUN
}

}  // namespace

extern "C" int dq_fused_resnet_bwd(const void* x, const void* dy, const void* w1,
                                   const void* b1, const void* g1, const void* scale,
                                   const void* shift, const void* w2, const void* b2,
                                   const void* g2, const void* w_res, const void* b_res,
                                   void* part, void* sums, void* dx, int B, int c_in, int c_out,
                                   int N, int nsplit, int chunk, int film, int has_res,
                                   int bf16, int device, void* stream) {
  (void)b_res;  // the residual bias does not enter any gradient
  if (c_in > kMaxCin || c_out > kMaxCout) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(w1),    static_cast<const float*>(b1),
                      static_cast<const float*>(g1),    static_cast<const float*>(scale),
                      static_cast<const float*>(shift), static_cast<const float*>(w2),
                      static_cast<const float*>(b2),    static_cast<const float*>(g2),
                      static_cast<const float*>(w_res)};
  float* p = static_cast<float*>(part);
  float* sm = static_cast<float*>(sums);
  err = bf16 ? run<__nv_bfloat16>(x, dy, f, p, sm, dx, B, c_in, c_out, N, nsplit, chunk, film,
                                  has_res, s)
             : run<float>(x, dy, f, p, sm, dx, B, c_in, c_out, N, nsplit, chunk, film, has_res,
                          s);
  return (int)err;
}
