// K7a: flash attention forward over (b, h, n, d = 32), writing the output
// and the per-row logsumexp lse = m + log l (float32), and for bf16 inputs
// optionally the output in float32 as well (out32), before its rounding.
//
// Replaces the TPU kernel dquartic_tpu/ops/flash_attention.py:
// _flash_forward (_flash_kernel). There one grid step holds a whole
// (b*h) kv sequence in VMEM, d padded to 128 lanes, and loops over kv
// blocks in order. Here one CTA takes one (b*h, 64-row q block): it
// streams 64-row K and V tiles through shared memory and keeps the running
// max, sum and accumulator of each of its rows in registers (online
// softmax). No padding of d: with d = 32 a head row is one warp, so each
// of the 8 warps owns 8 q rows; for a row, lane j computes the scores of
// kv rows j and j + 32 of the tile, the warp reduces max and sum by
// shuffles, and lane c accumulates feature c of P V with the weights
// broadcast by shuffles. Scores are float32 on float32 (or bf16-valued)
// operands, pre-scaled by scale * log2(e) so exp is exp2f; ragged n and m
// are masked here (-1e30 for scores past m, rows past n not written), and
// l is clamped at 1e-30, as the JAX kernel does.
//
// out32 is what K7b forms D = rowsum(dO o O) from. The JAX kernel forms D
// from the output rounded to bf16; its rounding error is the same for every
// kv row of a query row, so it breaks sum_j dS_ij = 0, and with it the
// invariance of softmax to a shift shared by all keys: the gradients of
// parameters that shift every key alike (biases, norm gains upstream of a
// cross attention's keys) pick up an error that does not cancel. The
// float32 output costs n * 32 floats per head.
//
// What bounds it on the H100: at the UNet's shapes (b*h = 4, n = m = 34 or
// 340) the grid is 4 or 24 CTAs on 132 SMs and one tile, so the launch and
// the wrapper's host work set the time; one launch against the plain
// version's several makes it the faster of the two there. At long
// sequences it is bound by CUDA-core FMAs and the shared-memory pipe (a
// load or a shuffle per FMA; no tensor cores: mma.sync/wgmma are later
// work), and from n = m of about 2048 the plain version's tensor-core
// products beat it although they write the (n, m) scores to device memory.
#include "flash_attention.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ out32, float* __restrict__ lse, int n, int m,
    float scale_log2) {
  __shared__ float qs[kBlock][kD];    // read broadcast
  __shared__ float ks[kBlock][kPad];  // read one row per lane
  __shared__ float vs[kBlock][kD];    // read one column per lane
  const int bh = blockIdx.y, q0 = blockIdx.x * kBlock;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* kb = k + (size_t)bh * m * kD;
  const T* vb = v + (size_t)bh * m * kD;
  load_tile<T, kD>(qs, q + (size_t)bh * n * kD, q0, n);

  float m_i[kRowsPerWarp], l_i[kRowsPerWarp], acc[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m_i[rr] = kNegInf;
    l_i[rr] = 0.0f;
    acc[rr] = 0.0f;
  }

  for (int j0 = 0; j0 < m; j0 += kBlock) {
    __syncthreads();  // the previous tile has been read by every warp
    load_tile<T, kPad>(ks, kb, j0, m);
    load_tile<T, kD>(vs, vb, j0, m);
    __syncthreads();
    const bool ok0 = j0 + lane < m, ok1 = j0 + 32 + lane < m;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      if (q0 + r >= n) break;  // warp-uniform; later rows are past n too
      const float s0 = ok0 ? dot_row(qs[r], ks[lane]) * scale_log2 : kNegInf;
      const float s1 = ok1 ? dot_row(qs[r], ks[lane + 32]) * scale_log2 : kNegInf;
      const float m_new = fmaxf(m_i[rr], warp_max(fmaxf(s0, s1)));
      const float p0 = exp2f(s0 - m_new), p1 = exp2f(s1 - m_new);
      const float alpha = exp2f(m_i[rr] - m_new);
      l_i[rr] = l_i[rr] * alpha + warp_sum(p0 + p1);
      float a = acc[rr] * alpha;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        a = fmaf(__shfl_sync(kFull, p0, j), vs[j][lane], a);
        a = fmaf(__shfl_sync(kFull, p1, j), vs[j + 32][lane], a);
      }
      acc[rr] = a;
      m_i[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    if (row >= n) break;
    const float l = fmaxf(l_i[rr], 1e-30f);
    const size_t o = ((size_t)bh * n + row) * kD + lane;
    out[o] = dq::from_f32<T>(acc[rr] / l);
    if (out32) out32[o] = acc[rr] / l;
    if (lane == 0) lse[(size_t)bh * n + row] = m_i[rr] * kLn2 + logf(l);
  }
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, void* out, float* out32, float* lse,
                int bh, int n, int m, float scale, cudaStream_t s) {
  flash_fwd<T><<<dim3(dq::ceil_div(n, kBlock), bh), kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), out32, lse, n, m, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// out32 may be null.
extern "C" int dq_flash_attention(const void* q, const void* k, const void* v, void* out,
                                  void* out32, void* lse, int bh, int n, int m, float scale,
                                  int bf16, int device, void* stream) {
  if (bh < 1 || bh > 65535 || n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* o32 = static_cast<float*>(out32);
  err = bf16 ? run<__nv_bfloat16>(q, k, v, out, o32, l, bh, n, m, scale, s)
             : run<float>(q, k, v, out, o32, l, bh, n, m, scale, s);
  return (int)err;
}
