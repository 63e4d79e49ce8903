// K7a: flash attention forward over (b, h, n, d = 32), writing the output
// and, where autograd will need them, each row's statistics (m, l)
// (float32 pairs: m the largest scaled score in log2 units, l the sum of
// exp2(score - m)) and, for bf16 inputs, the output in float32 (out32),
// before its rounding. stats and out32 may be null.
//
// Replaces the TPU kernel dquartic_tpu/ops/flash_attention.py:
// _flash_forward (_flash_kernel). There one grid step holds a whole
// (b*h) kv sequence in VMEM, d padded to 128 lanes, and loops over kv
// blocks in order with a running max, sum and accumulator (online
// softmax). Here a CTA takes one (b*h, q block) and streams the kv tiles
// through shared memory; ragged n and m are masked here (-1e30 for scores
// past m, rows past n not written) and l is clamped at 1e-30, as the JAX
// kernel does. The JAX kernel's second result, lse = m ln 2 + log l, is
// formed from stats by the caller that wants it (ops/flash_attention.py
// lse_of).
//
// stats is what K7b rebuilds P from: P = exp2(score - m) / l, with each
// score formed as it is formed here, so P is this kernel's softmax to
// float32's rounding however large the scores are. lse cannot carry that:
// at |m| ~ 1e8 float32's spacing is 8 or more, so m ln 2 + log l loses
// log l and several units of m, and P rebuilt from it is off by factors
// of 2^k (the fault that made the full UNet1d's training diverge). The
// scaled score is one rounded product (__fmul_rn), never contracted into
// a later subtraction, so K7b forms it bitwise alike.
//
// bf16 (flash_fwd_mma), FA2-style on tensor cores, mma.sync m16n8k16 with
// float32 accumulators:
//   * each warp owns 16 q rows; a CTA has 1 to 4 warps, as many as n needs
//     (grid (ceil(n / (16 warps)), b*h)), so at the UNet's n = 34 a head is
//     one CTA of 3 warps;
//   * the Q fragments are loaded once with ldmatrix and kept in registers;
//     K and V tiles of 64 x 32 are double-buffered through shared memory
//     with cp.async (rows past m zero-filled), rows padded to 40 elements
//     so the ldmatrix rows fall on distinct banks;
//   * S = Q K^T is 8 n-tiles x 2 k-steps over d = 32, on K fragments from
//     ldmatrix (Q the A operand, K the B operand: K7b forms its scores in
//     the same way); the online softmax runs on the accumulator fragments,
//     row max and row sum by shuffles within the quad that holds a row,
//     exp2f of scores pre-scaled by scale * log2(e);
//   * P goes from the S accumulators into the A operand of P V in
//     registers, no shared-memory round trip; V fragments come from
//     ldmatrix.trans. P is split into a bf16 high part and a bf16 low part
//     (P - hi), two products each: a single bf16 rounding of P would put an
//     error of ~2^-9 of P into out32, shared by every key of a row, and
//     that is the very error that K7b's D = rowsum(dO o out32) must not
//     carry (see below). With the split out32 is float32-accurate.
// float32 (flash_fwd_f32): the CUDA-core body, one 64-row CTA per
// (b*h, q block), d = 32 on one warp's lanes, scores and P V by shuffles;
// TF32 tensor cores would not hold the float32 tolerance.
//
// out32 is what K7b forms D = rowsum(dO o O) from. The JAX kernel forms D
// from the output rounded to bf16; its rounding error is the same for every
// kv row of a query row, so it breaks sum_j dS_ij = 0, and with it the
// invariance of softmax to a shift shared by all keys: the gradients of
// parameters that shift every key alike (biases, norm gains upstream of a
// cross attention's keys) pick up an error that does not cancel.
//
// What bounds it on the H100: at long sequences the exponentials, one per
// score, at the SFU's 16 per clock per SM (~0.29 ms for n = m = 16384 at
// b*h = 4); the tensor-core products (2 n m d for S, 4 n m d for the split
// P V) are a few percent of the bf16 peak's time for that. At the UNet's
// n = m = 34 or 340 one or a few tiles: the launch and the wrapper set the
// time.
#include "flash_attention.cuh"

namespace {

// ---------------------------------------------------------------- float32

__global__ void __launch_bounds__(kThreads) flash_fwd_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float2* __restrict__ stats, int n, int m, float scale_log2) {
  __shared__ float qs[kBlock][kD];    // read broadcast
  __shared__ float ks[kBlock][kPad];  // read one row per lane
  __shared__ float vs[kBlock][kD];    // read one column per lane
  const int bh = blockIdx.y, q0 = blockIdx.x * kBlock;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* kb = k + (size_t)bh * m * kD;
  const float* vb = v + (size_t)bh * m * kD;
  load_tile<float, kD>(qs, q + (size_t)bh * n * kD, q0, n);

  float m_i[kRowsPerWarp], l_i[kRowsPerWarp], acc[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m_i[rr] = kNegInf;
    l_i[rr] = 0.0f;
    acc[rr] = 0.0f;
  }

  for (int j0 = 0; j0 < m; j0 += kBlock) {
    __syncthreads();  // the previous tile has been read by every warp
    load_tile<float, kPad>(ks, kb, j0, m);
    load_tile<float, kD>(vs, vb, j0, m);
    __syncthreads();
    const bool ok0 = j0 + lane < m, ok1 = j0 + 32 + lane < m;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      if (q0 + r >= n) break;  // warp-uniform; later rows are past n too
      const float s0 = ok0 ? __fmul_rn(dot_row(qs[r], ks[lane]), scale_log2) : kNegInf;
      const float s1 = ok1 ? __fmul_rn(dot_row(qs[r], ks[lane + 32]), scale_log2) : kNegInf;
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
    out[((size_t)bh * n + row) * kD + lane] = acc[rr] / l;
    if (stats && lane == 0) stats[(size_t)bh * n + row] = make_float2(m_i[rr], l);
  }
}

// ------------------------------------------------------------ bf16, mma

constexpr int kMmaWarps = 4;               // at most; fewer for short n
constexpr int kMmaRows = 16;               // q rows of a warp
constexpr int kKv = 64;                    // kv rows of a tile
constexpr int kRow = kD + 8;               // smem row stride (elements): 80 bytes
constexpr int kChunks = kD * 2 / 16;       // 16-byte chunks of a row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d (16 x 8, float32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (lo, hi) of a pair: hi the bf16 rounding of (a, b) (a in the low half),
// lo the bf16 rounding of what hi misses.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = pack_bf16(h);
  lo = pack_bf16(__floats2bfloat162_rn(a - __low2float(h), b - __high2float(h)));
}

// Copies rows [r0, r0 + rows) of a (total, 32) bf16 matrix into a shared
// tile of row stride kRow, zero-filling rows past `total`.
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int r0, int rows, int total) {
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r0 + r < total;
    cp_async16(dst + r * kRow + c, src + (size_t)(ok ? r0 + r : 0) * kD + c, ok);
  }
}

__global__ void __launch_bounds__(kMmaWarps * 32) flash_fwd_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ out32, float2* __restrict__ stats, int n, int m, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 qs[kMmaWarps * kMmaRows * kRow];
  __shared__ __align__(16) __nv_bfloat16 ks[2][kKv * kRow];
  __shared__ __align__(16) __nv_bfloat16 vs[2][kKv * kRow];
  const int warps = blockDim.x >> 5;
  const int bh = blockIdx.y, q0 = blockIdx.x * warps * kMmaRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // row group and column pair of a fragment
  const __nv_bfloat16* kb = k + (size_t)bh * m * kD;
  const __nv_bfloat16* vb = v + (size_t)bh * m * kD;
  const int tiles = (m + kKv - 1) / kKv;

  load_rows_async(qs, q + (size_t)bh * n * kD, q0, warps * kMmaRows, n);
  load_rows_async(ks[0], kb, 0, kKv, m);
  load_rows_async(vs[0], vb, 0, kKv, m);
  cp_async_commit();

  uint32_t qa[2][4];  // A fragments of the warp's 16 q rows, k-steps 0-15, 16-31
  float o[4][4];      // O accumulators: 4 n-tiles of 8 features
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.0f, 0.0f};  // rows gid, gid + 8
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[f][e] = 0.0f;

  for (int t = 0; t < tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < tiles) {  // the next tile streams in while this one computes
      load_rows_async(ks[st ^ 1], kb, (t + 1) * kKv, kKv, m);
      load_rows_async(vs[st ^ 1], vb, (t + 1) * kKv, kKv, m);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int r = warp * kMmaRows + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(qa[kk], qs + r * kRow + kk * 16 + (lane >> 4) * 8);
      }
    }

    // S = Q K^T: 8 n-tiles of 8 kv rows
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t kf[4];  // b0, b1 of k-step 0, then of k-step 1
      ldmatrix_x4(kf, ks[st] + (nt * 8 + (lane & 7)) * kRow + (lane >> 3) * 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
      mma_bf16(s[nt], qa[0][0], qa[0][1], qa[0][2], qa[0][3], kf[0], kf[1]);
      mma_bf16(s[nt], qa[1][0], qa[1][1], qa[1][2], qa[1][3], kf[2], kf[3]);
    }

    // online softmax on the fragments: element e of n-tile nt is row
    // gid + 8 (e >> 1), kv column t * 64 + nt * 8 + 2 tig + (e & 1)
    const int j0 = t * kKv;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j0 + nt * 8 + 2 * tig + (e & 1);
        const float sv = col < m ? __fmul_rn(s[nt][e], scale_log2) : kNegInf;
        s[nt][e] = sv;
        mx[e >> 1] = fmaxf(mx[e >> 1], sv);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 lanes of a quad hold one row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];  // this lane's share of the row sum
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_r[e >> 1]);
        s[nt][e] = p;
        l_r[e >> 1] += p;
      }
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[f][e] *= alpha[e >> 1];

    // O += P V: 4 k-steps of 16 kv rows; P's A fragment from two S n-tiles
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int fh = 0; fh < 2; ++fh) {  // features 16 fh .. 16 fh + 15
        uint32_t vf[4];  // b0, b1 of n-tile 2 fh, then of n-tile 2 fh + 1
        const int r = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(vf, vs[st] + r * kRow + fh * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float(&acc)[4] = o[2 * fh + h];
          mma_bf16(acc, hi[0], hi[1], hi[2], hi[3], vf[2 * h], vf[2 * h + 1]);
          mma_bf16(acc, lo[0], lo[1], lo[2], lo[3], vf[2 * h], vf[2 * h + 1]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(kFull, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(kFull, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * kMmaRows + gid + 8 * r;
    if (row >= n) continue;
    const float l = fmaxf(l_r[r], 1e-30f);
    const size_t base = ((size_t)bh * n + row) * kD;
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int c = f * 8 + 2 * tig;
      const float a = o[f][2 * r] / l, b = o[f][2 * r + 1] / l;
      *reinterpret_cast<__nv_bfloat162*>(out + base + c) = __floats2bfloat162_rn(a, b);
      if (out32) *reinterpret_cast<float2*>(out32 + base + c) = make_float2(a, b);
    }
    if (stats && tig == 0) stats[(size_t)bh * n + row] = make_float2(m_r[r], l);
  }
}

}  // namespace

// out32 and stats ((m, l) float32 pairs a row) may be null; bf16 q, k, v
// and out must be 16-byte aligned.
extern "C" int dq_flash_attention(const void* q, const void* k, const void* v, void* out,
                                  void* out32, void* stats, int bh, int n, int m, float scale,
                                  int bf16, int device, void* stream) {
  if (bh < 1 || bh > 65535 || n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* st = static_cast<float2*>(stats);
  const float scale_log2 = scale * kLog2e;
  if (bf16) {
    const int warps = std::min(kMmaWarps, dq::ceil_div(n, kMmaRows));
    flash_fwd_mma<<<dim3(dq::ceil_div(n, warps * kMmaRows), bh), warps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(out32), st, n, m, scale_log2);
  } else {
    flash_fwd_f32<<<dim3(dq::ceil_div(n, kBlock), bh), kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), st, n, m, scale_log2);
  }
  return (int)cudaGetLastError();
}
