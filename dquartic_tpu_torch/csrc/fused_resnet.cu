// K2: fused ResnetBlock forward on channel-first (B, C, N) activations:
//   h  = SiLU(FiLM(RMSNorm_g1(conv3(x) + b1)))   (h := 0 outside [0, N))
//   h2 = SiLU(RMSNorm_g2(conv3(h) + b2))
//   out = h2 + (res_conv(x) or x)
//
// Replaces the TPU kernel dquartic_tpu/ops/fused_resnet.py:_forward
// (_kernel_resnet_t). With C_in <= 32 and C_out <= 16 channels the block
// does 100-3000 multiply-adds per column against 2-4 bytes per channel of
// input and output: at level 0 (4 -> 4, N = 40000) it is bound by its
// bytes (6.5 us at 3.35 TB/s for 34 rows) with the float32 pipes and the
// SFU (two SiLUs a channel) close behind; the wide levels (20..32 -> 12..16
// channels) by their float32 multiply-adds. The design:
//   * no host work: the kernel reads w1, b1, g1, scale, shift, w2, b2, g2,
//     w_res and b_res in their own dtype (float32 or bf16, one bit each in
//     `bits`) through their strides, so the module's permuted views of the
//     torch conv weights need no copy, and rounds the conv weights to the
//     activation dtype itself, as K5 (fused_resnet_bwd.cu) receives them; a
//     missing FiLM or residual bias is a flag;
//   * the channel counts of the canonical model's eleven (C_in, C_out) pairs
//     are template arguments, so the conv loops unroll over channels and
//     each weight, read once from shared memory by a broadcast, feeds V
//     columns; any other pair runs the (32, 16) instantiation, zero-padded;
//   * grid (ceil(N / BN), B); a CTA of 128 threads owns BN = 128 V columns
//     of one row, each thread V consecutive ones (V = 4 at the wide-N
//     levels, down to 1 at N = 625, so that every shape has a few CTAs an
//     SM); x over [n0 - P, n0 + BN + P) arrives in shared memory by 16-byte
//     cp.async copies (P = 16 bytes of elements; plain loads where a row is
//     not 16-byte aligned, N % P != 0), zero outside [0, N);
//   * block1 (conv, norm, FiLM, SiLU) runs for the CTA's columns and, by
//     two whole warps, the two halo columns n0 - 1 and n0 + BN that conv2
//     reads, into a float32 shared tile, never device memory; block2 and
//     the residual run per thread on its V columns, and out is stored V
//     elements at a time (8 bytes at V = 4 in bf16, 16 in float32).
// Interior math is float32; the output is stored in x's dtype. The TPU
// kernel's row stacking, block-diagonal kron weights and indicator-matrix
// norms existed only to fill TPU sublanes; there is no counterpart here.
#include "fused_resnet.cuh"

namespace {

constexpr int kThreads = 128;

// Shared memory of one CTA: x (T) over BN + 2P columns, h (float32) over
// BN + 8 (h column n0 + j at index 4 + j), the weights and the vectors.
template <typename T, int CI, int CO, int V>
struct Tile {
  static constexpr int BN = kThreads * V;
  static constexpr int P = 16 / sizeof(T);  // elements of a 16-byte chunk
  static constexpr int XR = BN + 2 * P;     // x column n0 + j at index P + j
  static constexpr int HR = BN + 8;
  static constexpr int kX = 0;
  static constexpr int kH = (CI * XR * sizeof(T) + 15) / 16 * 16;
  static constexpr int kW1 = kH + CO * HR * 4;
  static constexpr int kW2 = kW1 + 3 * CI * CO * 4;
  static constexpr int kWR = kW2 + 3 * CO * CO * 4;
  static constexpr int kVec = kWR + CI * CO * 4;
  static constexpr int bytes = kVec + 6 * CO * 4;
};

// block1 at V consecutive columns from x column index xj (the first's):
// conv3 + b1, RMSNorm, FiLM, SiLU, into h (float32) at index hj, 0 outside
// [0, N).
template <typename T, int CI, int CO, int V>
__device__ __forceinline__ void block1(const T* xs, int XR, const float* w1s, const float* vec,
                                       float* hs, int HR, int xj, int hj, int pos, int N) {
  float acc[V][CO];
#pragma unroll
  for (int j = 0; j < V; ++j)
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[j][o] = vec[o];
#pragma unroll 4
  for (int c = 0; c < CI; ++c) {
    float w[V + 2];
    load_window<T, V>(xs + c * XR, xj, w);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float* wk = w1s + (k * CI + c) * CO;
#pragma unroll
      for (int o = 0; o < CO; ++o) {
        const float wv = wk[o];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j][o] = fmaf(wv, w[j + k], acc[j][o]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float ss = 0.0f;
#pragma unroll
    for (int o = 0; o < CO; ++o) ss = fmaf(acc[j][o], acc[j][o], ss);
    const float inv = rsqrtf(fmaxf(ss, 1e-24f));  // 1 / max(||h||, 1e-12)
    const bool inside = pos + j >= 0 && pos + j < N;
#pragma unroll
    for (int o = 0; o < CO; ++o) {
      // RMSNorm and FiLM: g1 sqrt(C_out) (scale + 1) in vec[1], shift in vec[2]
      const float v = fmaf(acc[j][o] * inv, vec[CO + o], vec[2 * CO + o]);
      acc[j][o] = inside ? silu(v) : 0.0f;
    }
  }
#pragma unroll
  for (int o = 0; o < CO; ++o) {
    RawOf<float, V> r;
    float* v = reinterpret_cast<float*>(&r);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = acc[j][o];
    *reinterpret_cast<RawOf<float, V>*>(hs + o * HR + hj) = r;
  }
}

// block1 at one halo column (x column index xj) by a whole warp: the lanes
// split the 3 C_in taps, a butterfly sums them (a fixed order), lane 0
// finishes the column into h.
template <typename T, int CI, int CO>
__device__ __forceinline__ void block1_halo(const T* xs, int XR, const float* w1s,
                                            const float* vec, float* hs, int HR, int xj, int hj,
                                            int pos, int N) {
  const int lane = threadIdx.x & 31;
  float acc[CO];
#pragma unroll
  for (int o = 0; o < CO; ++o) acc[o] = 0.0f;
  for (int t = lane; t < 3 * CI; t += 32) {  // t = k * CI + c
    const int k = t / CI, c = t % CI;
    const float xv = dq::to_f32(xs[c * XR + xj + k - 1]);
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[o] = fmaf(w1s[t * CO + o], xv, acc[o]);
  }
#pragma unroll
  for (int o = 0; o < CO; ++o)
#pragma unroll
    for (int off = 16; off; off >>= 1) acc[o] += __shfl_xor_sync(0xffffffffu, acc[o], off);
  if (lane != 0) return;
  float ss = 0.0f;
#pragma unroll
  for (int o = 0; o < CO; ++o) {
    acc[o] += vec[o];
    ss = fmaf(acc[o], acc[o], ss);
  }
  const float inv = rsqrtf(fmaxf(ss, 1e-24f));
  const bool inside = pos >= 0 && pos < N;
#pragma unroll
  for (int o = 0; o < CO; ++o)
    hs[o * HR + hj] = inside ? silu(fmaf(acc[o] * inv, vec[CO + o], vec[2 * CO + o])) : 0.0f;
}

template <typename T, int CI, int CO, int V, bool GENERIC>
__global__ void __launch_bounds__(kThreads) resnet_fwd(const T* __restrict__ x,
                                                       T* __restrict__ out, const Params p) {
  using L = Tile<T, CI, CO, V>;
  constexpr int BN = L::BN, P = L::P, XR = L::XR, HR = L::HR;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem + L::kX);
  float* hs = reinterpret_cast<float*>(smem + L::kH);
  float* w1s = reinterpret_cast<float*>(smem + L::kW1);
  float* w2s = reinterpret_cast<float*>(smem + L::kW2);
  float* wrs = reinterpret_cast<float*>(smem + L::kWR);
  // b1, g1 sqrt(C_out) (scale + 1), shift, b2, g2 sqrt(C_out), b_res
  float* vec = reinterpret_cast<float*>(smem + L::kVec);

  const int tid = threadIdx.x, row = blockIdx.y, n0 = blockIdx.x * BN;
  const int c_in = GENERIC ? p.c_in : CI, c_out = GENERIC ? p.c_out : CO, N = p.N;
  const bool has_res = GENERIC ? (p.flags & kRes) != 0 : CI != CO;

  // x over [n0 - P, n0 + BN + P): 16-byte copies, zero outside [0, N)
  stage_window<T, CI, XR>(xs, x + (size_t)row * c_in * N, c_in, N, n0 - P);
  asm volatile("cp.async.commit_group;\n" ::);

  // weights rounded to the activation dtype, zero past c_in / c_out
  const int bits = p.bits;
  for (int i = tid; i < 3 * CI * CO; i += kThreads) {
    const int k = i / (CI * CO), c = i / CO % CI, o = i % CO;
    w1s[i] = c < c_in && o < c_out
                 ? dq::round_cd<T>(ld(p.w1, k * p.w1_k + c * p.w1_i + o * p.w1_o, bits >> kW1 & 1))
                 : 0.0f;
  }
  for (int i = tid; i < 3 * CO * CO; i += kThreads) {
    const int k = i / (CO * CO), c = i / CO % CO, o = i % CO;
    w2s[i] = c < c_out && o < c_out
                 ? dq::round_cd<T>(ld(p.w2, k * p.w2_k + c * p.w2_i + o * p.w2_o, bits >> kW2 & 1))
                 : 0.0f;
  }
  if (has_res)
    for (int i = tid; i < CI * CO; i += kThreads) {
      const int c = i / CO, o = i % CO;
      wrs[i] = c < c_in && o < c_out
                   ? dq::round_cd<T>(ld(p.w_res, c * p.wr_i + o * p.wr_o, bits >> kWRes & 1))
                   : 0.0f;
    }
  if (tid < CO) {
    const int o = tid;
    const bool on = o < c_out, film = (p.flags & kFilm) != 0;
    const float rs = sqrtf((float)c_out);
    const float scale = on && film ? ld(p.scale, row * p.scale_b + o * p.scale_o,
                                        bits >> kScale & 1) : 0.0f;
    vec[o] = on ? ld(p.b1, o * p.b1_o, bits >> kB1 & 1) : 0.0f;
    vec[CO + o] = on ? ld(p.g1, o * p.g1_o, bits >> kG1 & 1) * rs * (scale + 1.0f) : 0.0f;
    vec[2 * CO + o] =
        on && film ? ld(p.shift, row * p.shift_b + o * p.shift_o, bits >> kShift & 1) : 0.0f;
    vec[3 * CO + o] = on ? ld(p.b2, o * p.b2_o, bits >> kB2 & 1) : 0.0f;
    vec[4 * CO + o] = on ? ld(p.g2, o * p.g2_o, bits >> kG2 & 1) * rs : 0.0f;
    vec[5 * CO + o] =
        on && has_res && (p.flags & kResBias) ? ld(p.b_res, o * p.br_o, bits >> kBRes & 1) : 0.0f;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // block1 over the thread's V columns; then warp 0 the halo column n0 - 1
  // and warp 1 the halo column n0 + BN
  const int j0 = V * tid;
  block1<T, CI, CO, V>(xs, XR, w1s, vec, hs, HR, P + j0, 4 + j0, n0 + j0, N);
  if (tid < 64) {
    const int j = tid < 32 ? -1 : BN;
    block1_halo<T, CI, CO>(xs, XR, w1s, vec, hs, HR, P + j, 4 + j, n0 + j, N);
  }
  __syncthreads();

  // block2 + residual on the thread's V columns
  float acc[V][CO];
#pragma unroll
  for (int j = 0; j < V; ++j)
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[j][o] = vec[3 * CO + o];
#pragma unroll 4
  for (int c = 0; c < CO; ++c) {
    float w[V + 2];
    load_window<float, V>(hs + c * HR, 4 + j0, w);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float* wk = w2s + (k * CO + c) * CO;
#pragma unroll
      for (int o = 0; o < CO; ++o) {
        const float wv = wk[o];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j][o] = fmaf(wv, w[j + k], acc[j][o]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float ss = 0.0f;
#pragma unroll
    for (int o = 0; o < CO; ++o) ss = fmaf(acc[j][o], acc[j][o], ss);
    const float inv = rsqrtf(fmaxf(ss, 1e-24f));
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[j][o] = silu(acc[j][o] * inv * vec[4 * CO + o]);
  }
  if (has_res) {  // + b_res + w_res x, into the accumulators
#pragma unroll
    for (int j = 0; j < V; ++j)
#pragma unroll
      for (int o = 0; o < CO; ++o) acc[j][o] += vec[5 * CO + o];
#pragma unroll 4
    for (int c = 0; c < CI; ++c) {
      float xv[V];
#pragma unroll
      for (int j = 0; j < V; ++j) xv[j] = dq::to_f32(xs[c * XR + P + j0 + j]);
#pragma unroll
      for (int o = 0; o < CO; ++o) {
        const float wv = wrs[c * CO + o];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j][o] = fmaf(wv, xv[j], acc[j][o]);
      }
    }
  } else {
#pragma unroll
    for (int o = 0; o < CO; ++o)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j][o] += dq::to_f32(xs[o * XR + P + j0 + j]);
  }

  const int n = n0 + j0;
  if (n >= N) return;
  T* orow = out + (size_t)row * c_out * N + n;
  const bool whole = N % V == 0 && n + V <= N;  // the V columns are one aligned store
#pragma unroll
  for (int o = 0; o < CO; ++o) {
    if (GENERIC && o >= c_out) break;
    RawOf<T, V> r;
    T* v = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = dq::from_f32<T>(acc[j][o]);
    T* dst = orow + (size_t)o * N;
    if (whole) {
      *reinterpret_cast<RawOf<T, V>*>(dst) = r;
    } else {
      for (int j = 0; j < V && n + j < N; ++j) dst[j] = v[j];
    }
  }
}

template <typename T, int CI, int CO, int V, bool GENERIC = false>
cudaError_t launch(const void* x, void* out, const Params& p, int B, cudaStream_t s) {
  using L = Tile<T, CI, CO, V>;
  auto kernel = resnet_fwd<T, CI, CO, V, GENERIC>;
  static const cudaError_t attr = dq::allow_smem(kernel, L::bytes);  // once
  if (attr != cudaSuccess) return attr;
  dim3 grid(dq::ceil_div(p.N, L::BN), B);
  kernel<<<grid, kThreads, L::bytes, s>>>(static_cast<const T*>(x), static_cast<T*>(out), p);
  return cudaGetLastError();
}

// The canonical UNet1d's (C_in, C_out) pairs (dim 4, dim_mults 1,2,2,3,3,4,4),
// each with the V columns a thread that measured fastest at its m/z
// lengths at 34 rows (chip_smoke.py phase 2 times each shape); any other
// pair runs the zero-padded (32, 16) instantiation.
template <typename T>
cudaError_t run(const void* x, void* out, const Params& p, int B, cudaStream_t s) {
  const bool res = (p.flags & kRes) != 0;
  switch (res == (p.c_in != p.c_out) ? p.c_in * 100 + p.c_out : 0) {
    case 404: return launch<T, 4, 4, 4>(x, out, p, B, s);       // N 40000, 20000
    case 804: return launch<T, 8, 4, 4>(x, out, p, B, s);       // 40000
    case 1208: return launch<T, 12, 8, 4>(x, out, p, B, s);     // 20000
    case 808: return launch<T, 8, 8, 4>(x, out, p, B, s);       // 10000, 5000
    case 1608: return launch<T, 16, 8, 4>(x, out, p, B, s);     // 10000
    case 2012: return launch<T, 20, 12, 4>(x, out, p, B, s);    // 5000
    case 1212: return launch<T, 12, 12, 2>(x, out, p, B, s);    // 2500, 1250
    case 2412: return launch<T, 24, 12, 2>(x, out, p, B, s);    // 2500
    case 2816: return launch<T, 28, 16, 2>(x, out, p, B, s);    // 1250
    case 1616: return launch<T, 16, 16, 1>(x, out, p, B, s);    // 625
    case 3216: return launch<T, 32, 16, 1>(x, out, p, B, s);    // 625
    default: return launch<T, kMaxCin, kMaxCout, 1, true>(x, out, p, B, s);
  }
}

}  // namespace

// x (B, C_in, N) and out (B, C_out, N) contiguous, bf16 (x_bf16) or float32;
// the parameters as in Params, each with its strides, `bits` their dtypes,
// `flags` FiLM, residual conv and residual bias.
extern "C" int dq_fused_resnet(
    const void* x, void* out, const void* w1, long long w1_k, long long w1_i, long long w1_o,
    const void* b1, long long b1_o, const void* g1, long long g1_o, const void* scale,
    long long scale_b, long long scale_o, const void* shift, long long shift_b,
    long long shift_o, const void* w2, long long w2_k, long long w2_i, long long w2_o,
    const void* b2, long long b2_o, const void* g2, long long g2_o, const void* w_res,
    long long wr_i, long long wr_o, const void* b_res, long long br_o, int B, int c_in,
    int c_out, int N, int flags, int bits, int x_bf16, int device, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || c_in < 1 || c_out < 1 || c_in > kMaxCin ||
      c_out > kMaxCout || (!(flags & kRes) && c_in != c_out))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Params p{w1,    w1_k,    w1_i,    w1_o,  b1,     b1_o,    g1,    g1_o,
                 scale, scale_b, scale_o, shift, shift_b, shift_o, w2,    w2_k,
                 w2_i,  w2_o,    b2,      b2_o,  g2,      g2_o,    w_res, wr_i,
                 wr_o,  b_res,   br_o,    c_in,  c_out,   N,       flags, bits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = x_bf16 ? run<__nv_bfloat16>(x, out, p, B, s) : run<float>(x, out, p, B, s);
  return (int)err;
}
