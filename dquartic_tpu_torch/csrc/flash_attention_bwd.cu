// K7b: flash attention backward over (b, h, n, d = 32) from the saved
// (q, k, v, o, lse), o in float32 (see flash_attention.cu on why), and the
// cotangent dO:
//   P  = exp(q k^T scale - lse),   D = rowsum(dO o o),
//   dS = P o (dO v^T - D),
//   dq = dS k scale,  dk = dS^T q scale,  dv = P^T dO.
//
// Replaces the TPU kernels dquartic_tpu/ops/flash_attention.py:
// _flash_backward (_flash_bwd_dq_kernel, _flash_bwd_dkv_kernel), the same
// two-kernel scheme: P is rebuilt tile by tile from lse, so the (n, m)
// matrix never reaches device memory.
//   1. dq, grid (q blocks, b*h): a CTA owns 64 q rows (8 per warp), first
//      forms D for them (JAX forms D in XLA; here it is written to a
//      float32 scratch for kernel 2), then streams 64-row K and V tiles;
//      for a row, lane j holds P and dS of kv rows j and j + 32, and lane c
//      accumulates feature c of dS k with dS broadcast by shuffles.
//   2. dk and dv, grid (kv blocks, b*h): a CTA owns 64 kv rows and streams
//      64-row q, dO, lse and D tiles the same way, the lane mapping turned
//      around (lane i holds P and dS of q rows i and i + 32).
// Each output element is summed by one thread in a fixed order: no
// atomics, so two identical calls give bitwise equal gradients. Operands
// are float32 (bf16 inputs widened on load); dq, dk, dv are rounded once
// to the input dtype. Padded rows of a tile are zero and their P is
// masked to 0, so ragged n and m need nothing else.
//
// What bounds it on the H100: at the UNet's shapes (b*h = 4, n = m = 34)
// each kernel runs 4 CTAs on 132 SMs, one tile each: launch-bound. At long
// sequences both kernels are bound by CUDA-core FMAs and shuffles (each
// rebuilds the scores once: 2.5x the forward's products); tensor cores
// (mma.sync/wgmma) are later work.
#include "flash_attention.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ lse, const T* __restrict__ dout,
    float* __restrict__ d_out, T* __restrict__ gq, int n, int m, float scale,
    float scale_log2) {
  __shared__ float qs[kBlock][kD];    // broadcast
  __shared__ float dos[kBlock][kD];   // broadcast
  __shared__ float ks[kBlock][kPad];  // one row per lane, then one column per lane
  __shared__ float vs[kBlock][kPad];  // one row per lane
  const int bh = blockIdx.y, q0 = blockIdx.x * kBlock;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t qoff = (size_t)bh * n * kD;
  const T* kb = k + (size_t)bh * m * kD;
  const T* vb = v + (size_t)bh * m * kD;
  load_tile<T, kD>(qs, q + qoff, q0, n);
  load_tile<T, kD>(dos, dout + qoff, q0, n);
  __syncthreads();

  float lse2[kRowsPerWarp], dd[kRowsPerWarp], acc[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr, row = q0 + r;
    acc[rr] = 0.0f;
    lse2[rr] = dd[rr] = 0.0f;
    if (row >= n) continue;
    lse2[rr] = lse[(size_t)bh * n + row] * kLog2e;
    dd[rr] = warp_sum(dos[r][lane] * o[qoff + (size_t)row * kD + lane]);
    if (lane == 0) d_out[(size_t)bh * n + row] = dd[rr];
  }

  for (int j0 = 0; j0 < m; j0 += kBlock) {
    __syncthreads();
    load_tile<T, kPad>(ks, kb, j0, m);
    load_tile<T, kPad>(vs, vb, j0, m);
    __syncthreads();
    const bool ok0 = j0 + lane < m, ok1 = j0 + 32 + lane < m;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      if (q0 + r >= n) break;
      const float p0 = ok0 ? exp2f(dot_row(qs[r], ks[lane]) * scale_log2 - lse2[rr]) : 0.0f;
      const float p1 =
          ok1 ? exp2f(dot_row(qs[r], ks[lane + 32]) * scale_log2 - lse2[rr]) : 0.0f;
      const float ds0 = p0 * (dot_row(dos[r], vs[lane]) - dd[rr]);
      const float ds1 = p1 * (dot_row(dos[r], vs[lane + 32]) - dd[rr]);
      float a = acc[rr];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        a = fmaf(__shfl_sync(kFull, ds0, j), ks[j][lane], a);
        a = fmaf(__shfl_sync(kFull, ds1, j), ks[j + 32][lane], a);
      }
      acc[rr] = a;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    if (row >= n) break;
    gq[qoff + (size_t)row * kD + lane] = dq::from_f32<T>(acc[rr] * scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ lse, const T* __restrict__ dout, const float* __restrict__ d_in,
    T* __restrict__ gk, T* __restrict__ gv, int n, int m, float scale, float scale_log2) {
  __shared__ float kbs[kBlock][kD];   // broadcast
  __shared__ float vbs[kBlock][kD];   // broadcast
  __shared__ float qs[kBlock][kPad];  // one row per lane, then one column per lane
  __shared__ float dos[kBlock][kPad];
  __shared__ float lse2s[kBlock], dds[kBlock];
  const int bh = blockIdx.y, j0 = blockIdx.x * kBlock;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t koff = (size_t)bh * m * kD;
  const T* qb = q + (size_t)bh * n * kD;
  const T* db = dout + (size_t)bh * n * kD;
  load_tile<T, kD>(kbs, k + koff, j0, m);
  load_tile<T, kD>(vbs, v + koff, j0, m);

  float dk_acc[kRowsPerWarp], dv_acc[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) dk_acc[rr] = dv_acc[rr] = 0.0f;

  for (int i0 = 0; i0 < n; i0 += kBlock) {
    __syncthreads();
    load_tile<T, kPad>(qs, qb, i0, n);
    load_tile<T, kPad>(dos, db, i0, n);
    for (int i = threadIdx.x; i < kBlock; i += kThreads) {
      const bool ok = i0 + i < n;
      lse2s[i] = ok ? lse[(size_t)bh * n + i0 + i] * kLog2e : 0.0f;
      dds[i] = ok ? d_in[(size_t)bh * n + i0 + i] : 0.0f;
    }
    __syncthreads();
    const bool ok0 = i0 + lane < n, ok1 = i0 + 32 + lane < n;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int jr = warp * kRowsPerWarp + rr;
      if (j0 + jr >= m) break;
      const float p0 = ok0 ? exp2f(dot_row(kbs[jr], qs[lane]) * scale_log2 - lse2s[lane]) : 0.0f;
      const float p1 =
          ok1 ? exp2f(dot_row(kbs[jr], qs[lane + 32]) * scale_log2 - lse2s[lane + 32]) : 0.0f;
      const float ds0 = p0 * (dot_row(vbs[jr], dos[lane]) - dds[lane]);
      const float ds1 = p1 * (dot_row(vbs[jr], dos[lane + 32]) - dds[lane + 32]);
      float a = dk_acc[rr], b = dv_acc[rr];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        a = fmaf(__shfl_sync(kFull, ds0, i), qs[i][lane], a);
        b = fmaf(__shfl_sync(kFull, p0, i), dos[i][lane], b);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        a = fmaf(__shfl_sync(kFull, ds1, i), qs[i + 32][lane], a);
        b = fmaf(__shfl_sync(kFull, p1, i), dos[i + 32][lane], b);
      }
      dk_acc[rr] = a;
      dv_acc[rr] = b;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = j0 + warp * kRowsPerWarp + rr;
    if (row >= m) break;
    gk[koff + (size_t)row * kD + lane] = dq::from_f32<T>(dk_acc[rr] * scale);
    gv[koff + (size_t)row * kD + lane] = dq::from_f32<T>(dv_acc[rr]);
  }
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, const float* o, const float* lse,
                const void* dout, float* d, void* gq, void* gk, void* gv, int bh, int n, int m,
                float scale, cudaStream_t s) {
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  flash_bwd_dq<T><<<dim3(dq::ceil_div(n, kBlock), bh), kThreads, 0, s>>>(
      c(q), c(k), c(v), o, lse, c(dout), d, static_cast<T*>(gq), n, m, scale,
      scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv<T><<<dim3(dq::ceil_div(m, kBlock), bh), kThreads, 0, s>>>(
      c(q), c(k), c(v), lse, c(dout), d, static_cast<T*>(gk), static_cast<T*>(gv), n, m,
      scale, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dq_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* o, const void* lse, const void* dout,
                                      void* d_scratch, void* gq, void* gk, void* gv, int bh,
                                      int n, int m, float scale, int bf16, int device,
                                      void* stream) {
  if (bh < 1 || bh > 65535 || n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* o32 = static_cast<const float*>(o);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(d_scratch);
  err = bf16 ? run<__nv_bfloat16>(q, k, v, o32, l, dout, d, gq, gk, gv, bh, n, m, scale, s)
             : run<float>(q, k, v, o32, l, dout, d, gq, gk, gv, bh, n, m, scale, s);
  return (int)err;
}
