// K2: fused ResnetBlock forward on channel-first (B, C, N) activations:
//   h  = SiLU(FiLM(RMSNorm_g1(conv3(x) + b1)))   (h := 0 outside [0, N))
//   h2 = SiLU(RMSNorm_g2(conv3(h) + b2))
//   out = h2 + (res_conv(x) or x)
//
// Replaces the TPU kernel dquartic_tpu/ops/fused_resnet.py:_forward
// (_kernel_resnet_t). With C_in <= 32 and C_out <= 16 channels the block
// does ~0.1-1 kFLOP per column per row against 2-4 bytes per channel of
// input and output, so it is bound by device-memory traffic and launch
// count, not arithmetic. The design reads x once and writes out once:
//   * grid (ceil(N/128), B); a CTA of 128 threads owns 128 output columns
//     of one row and stages x over [n0-2, n0+130) (the two conv3 halos),
//     zero outside [0, N), in shared memory;
//   * conv1 + RMSNorm + FiLM + SiLU runs for the 130 columns conv2 needs
//     and is kept in shared memory, never in device memory;
//   * conv2 + RMSNorm + SiLU + residual runs one thread per output column,
//     so loads and stores along N are coalesced;
//   * weights (at most 3*32*16 floats per conv) sit in shared memory.
// The TPU kernel's row stacking, block-diagonal kron weights and
// indicator-matrix norms existed only to fill TPU sublanes; there is no
// counterpart here. Interior math is float32; the output is stored in x's
// dtype.
#include "common.cuh"

namespace {

constexpr int kBlockN = 128;
constexpr int kMaxCin = 32;
constexpr int kMaxCout = 16;

template <typename T, int CO>
__global__ void __launch_bounds__(kBlockN) fused_resnet_kernel(
    const T* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ g1, const float* __restrict__ scale,
    const float* __restrict__ shift, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ g2,
    const float* __restrict__ w_res, const float* __restrict__ b_res, T* __restrict__ out,
    int c_in, int c_out, int N, int film, int has_res) {
  __shared__ float xs[kMaxCin][kBlockN + 4];
  __shared__ float hs[CO][kBlockN + 2];
  __shared__ float w1s[3 * kMaxCin * CO];
  __shared__ float w2s[3 * CO * CO];
  __shared__ float wrs[kMaxCin * CO];
  __shared__ float vec[7][CO];  // b1, g1, scale+1, shift, b2, g2, b_res

  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int n0 = blockIdx.x * kBlockN;

  for (int i = tid; i < 3 * c_in * c_out; i += kBlockN) w1s[i] = w1[i];
  for (int i = tid; i < 3 * c_out * c_out; i += kBlockN) w2s[i] = w2[i];
  if (has_res)
    for (int i = tid; i < c_in * c_out; i += kBlockN) wrs[i] = w_res[i];
  if (tid < c_out) {
    vec[0][tid] = b1[tid];
    vec[1][tid] = g1[tid];
    vec[2][tid] = film ? scale[row * c_out + tid] + 1.0f : 1.0f;
    vec[3][tid] = film ? shift[row * c_out + tid] : 0.0f;
    vec[4][tid] = b2[tid];
    vec[5][tid] = g2[tid];
    vec[6][tid] = has_res ? b_res[tid] : 0.0f;
  }
  const T* xrow = x + (size_t)row * c_in * N;
  for (int i = tid; i < c_in * (kBlockN + 4); i += kBlockN) {
    const int c = i / (kBlockN + 4), j = i % (kBlockN + 4);
    const int pos = n0 - 2 + j;
    xs[c][j] = (pos >= 0 && pos < N) ? dq::to_f32(xrow[(size_t)c * N + pos]) : 0.0f;
  }
  __syncthreads();

  const float rs = sqrtf((float)c_out);
  // block1 over the 130 columns at positions n0-1 .. n0+128
  for (int j = tid; j < kBlockN + 2; j += kBlockN) {
    float h[CO];
#pragma unroll
    for (int co = 0; co < CO; ++co) h[co] = co < c_out ? vec[0][co] : 0.0f;
    for (int k = 0; k < 3; ++k) {
      for (int ci = 0; ci < c_in; ++ci) {
        const float xv = xs[ci][j + k];
        const float* wk = &w1s[(k * c_in + ci) * c_out];
#pragma unroll
        for (int co = 0; co < CO; ++co)
          if (co < c_out) h[co] = fmaf(wk[co], xv, h[co]);
      }
    }
    float ss = 0.0f;
#pragma unroll
    for (int co = 0; co < CO; ++co) ss += h[co] * h[co];
    const float den = fmaxf(sqrtf(ss), 1e-12f);
    const int pos = n0 - 1 + j;
    const bool inside = pos >= 0 && pos < N;
#pragma unroll
    for (int co = 0; co < CO; ++co) {
      if (co >= c_out) continue;
      float v = h[co] / den * vec[1][co] * rs;
      v = v * vec[2][co] + vec[3][co];
      // conv2 reads a zero-padded block1 output: positions outside [0, N)
      // must be exactly 0, not the bias/norm of a padded column
      hs[co][j] = inside ? dq::silu(v) : 0.0f;
    }
  }
  __syncthreads();

  const int j = tid;
  const int n = n0 + j;
  if (n >= N) return;
  float h2[CO];
#pragma unroll
  for (int co = 0; co < CO; ++co) h2[co] = co < c_out ? vec[4][co] : 0.0f;
  for (int k = 0; k < 3; ++k) {
    for (int c = 0; c < c_out; ++c) {
      const float hv = hs[c][j + k];
      const float* wk = &w2s[(k * c_out + c) * c_out];
#pragma unroll
      for (int co = 0; co < CO; ++co)
        if (co < c_out) h2[co] = fmaf(wk[co], hv, h2[co]);
    }
  }
  float ss = 0.0f;
#pragma unroll
  for (int co = 0; co < CO; ++co) ss += h2[co] * h2[co];
  const float den = fmaxf(sqrtf(ss), 1e-12f);
  T* orow = out + (size_t)row * c_out * N;
#pragma unroll
  for (int co = 0; co < CO; ++co) {
    if (co >= c_out) continue;
    const float v = dq::silu(h2[co] / den * vec[5][co] * rs);
    float r;
    if (has_res) {
      r = vec[6][co];
      for (int ci = 0; ci < c_in; ++ci) r = fmaf(wrs[ci * c_out + co], xs[ci][j + 2], r);
    } else {
      r = xs[co][j + 2];
    }
    orow[(size_t)co * N + n] = dq::from_f32<T>(v + r);
  }
}

template <typename T, int CO>
cudaError_t launch(const void* x, const float* const* f, void* out, int B, int c_in, int c_out,
                   int N, int film, int has_res, cudaStream_t s) {
  dim3 grid(dq::ceil_div(N, kBlockN), B);
  fused_resnet_kernel<T, CO><<<grid, kBlockN, 0, s>>>(
      static_cast<const T*>(x), f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9],
      static_cast<T*>(out), c_in, c_out, N, film, has_res);
  return cudaGetLastError();
}

// The output-channel loops are unrolled to C_out rounded up to a multiple
// of 4, so the level-0 width C_out = 4 runs 4-wide loops.
template <typename T>
cudaError_t run(const void* x, const float* const* f, void* out, int B, int c_in, int c_out,
                int N, int film, int has_res, cudaStream_t s) {
  switch ((c_out + 3) / 4) {
    case 1: return launch<T, 4>(x, f, out, B, c_in, c_out, N, film, has_res, s);
    case 2: return launch<T, 8>(x, f, out, B, c_in, c_out, N, film, has_res, s);
    case 3: return launch<T, 12>(x, f, out, B, c_in, c_out, N, film, has_res, s);
    default: return launch<T, 16>(x, f, out, B, c_in, c_out, N, film, has_res, s);
  }
}

}  // namespace

extern "C" int dq_fused_resnet(const void* x, const void* w1, const void* b1, const void* g1,
                               const void* scale, const void* shift, const void* w2,
                               const void* b2, const void* g2, const void* w_res,
                               const void* b_res, void* out, int B, int c_in, int c_out, int N,
                               int film, int has_res, int bf16, int device, void* stream) {
  if (c_in > kMaxCin || c_out > kMaxCout) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(w1), static_cast<const float*>(b1),
                      static_cast<const float*>(g1), static_cast<const float*>(scale),
                      static_cast<const float*>(shift), static_cast<const float*>(w2),
                      static_cast<const float*>(b2), static_cast<const float*>(g2),
                      static_cast<const float*>(w_res), static_cast<const float*>(b_res)};
  err = bf16 ? run<__nv_bfloat16>(x, f, out, B, c_in, c_out, N, film, has_res, s)
             : run<float>(x, f, out, B, c_in, c_out, N, film, has_res, s);
  return (int)err;
}
