// K7b: flash attention backward over (b, h, n, d = 32) from the saved
// (q, k, v, o) and the rows' statistics (m, l) that K7a wrote, o in
// float32 (see flash_attention.cu on why), and the cotangent dO:
//   P  = exp2(s - m) / l,  s = (q k^T) * (scale log2 e),   D = rowsum(dO o o),
//   dS = P o (dO v^T - D),
//   dq = dS k scale,  dk = dS^T q scale,  dv = P^T dO,
// each output rounded once to its input's dtype.
//
// Replaces the TPU kernels dquartic_tpu/ops/flash_attention.py:
// _flash_backward (_flash_bwd_dq_kernel, _flash_bwd_dkv_kernel): P is
// rebuilt tile by tile, so the (n, m) matrix never reaches device memory,
// and D is formed here from dO and o (JAX forms it in XLA).
//
// P is K7a's softmax to float32's rounding at any size of the scores:
// every score is formed as K7a forms it (the same products in the same
// order, Q the A operand of the bf16 mma, one rounded product for the
// scale), so exp2(s - m) is bitwise K7a's, its largest entry of a row
// exp2(0) = 1, and the row sums to l / l. Rebuilt from lse instead
// (exp2(s log2e - lse log2e), the JAX kernel's form), P is off by factors
// of 2^k once |m| nears 1e8, where float32's spacing is 8 or more: the
// full UNet1d's transformer reaches such logits in training, and its
// gradient norm grew 37 -> 4.9e6 -> inf.
//
// One launch a call where n, m <= kOneLaunch (the UNet's RT axis: 34 in the
// canonical model, 340 in production): a thread-block cluster per (b*h) of
// ceil(m / 64) CTAs, each owning 64 kv rows. A CTA stages q, dO, m, 1 / l
// and D of all n rows in shared memory, keeps dk and dv of its rows in
// registers and writes its partial dq (n x 32, float32) to its shared
// memory; after cluster.sync() each rank sums its share of the dq rows over
// the ranks in rank order through distributed shared memory. Past
// kOneLaunch, two launches: dq over q blocks, then dk and dv over kv
// blocks, each staging the other side in chunks of kSplitChunk rows. Every
// output element is summed in a fixed order, with no atomics: two identical
// calls give bitwise equal gradients. Rows past n or m are zero-filled in
// shared memory and their P is masked to 0.
//
// bf16 runs on tensor cores, mma.sync m16n8k16 with float32 accumulators,
// fragments from ldmatrix, as K7a does. Each warp owns 16 kv rows (of q
// rows in the dq launch): S = Q K^T and dP = dO V^T take one product each
// per 16 q rows (bf16 q, k, v and dO are exact), with the warp's K and V
// fragments kept in registers. P and dS are float32 and enter
// dv = P^T dO, dk = dS^T q and dq = dS k as (hi, lo) bf16 halves, two
// products each: rounding them to bf16 once would put an error of 2^-9
// into every gradient; in the kv kernels movmatrix turns each 8 x 8 block
// of the halves into the transposed A fragments. For dq the cluster kernel
// writes the tile's dS^T halves to shared memory, and each warp forms 16 q
// rows of the tile's dq over the CTA's 64 kv rows (an ldmatrix.trans turns
// dS^T into dS's A fragments). float32 stays on CUDA cores (TF32 would not
// hold the float32 tolerance): the lane that owns a q (kv) row computes its
// scores (the products in feature order, as K7a's), and a row's 32
// features are a warp's lanes, with the weights broadcast by shuffles; its
// cluster kernel forms dq from the tile's dS in shared memory the same way.
//
// What bounds it on the H100: at the UNet's shapes (b*h = 4, n = m = 34)
// a call is one launch of 4 CTAs: launch-bound. At long sequences the
// exponentials (one per score, at the SFU's 16 a clock per SM) and the
// ten products of 16 x 8 x 16 a score tile.
#include <cooperative_groups.h>

#include "flash_attention.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kOneLaunch = 512;     // n and m up to which a call is one cluster launch
constexpr int kMaxClusterCtas = kOneLaunch / kBlock;
constexpr int kMmaWarps = 4;        // warps of a tensor-core CTA, 16 rows each
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kRow = kD + 8;        // shared row stride (bf16) of q, dO, k, v: 80 bytes
constexpr int kDsRow = kBlock + 8;  // shared row stride (bf16) of the dS^T tile
constexpr int kDsPad = kBlock + 1;  // float32: row stride of the dS tile
constexpr int kSplitChunk = 256;    // rows of the other side a CTA stages at once past kOneLaunch

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Copies rows [r0, r0 + rows) of a (total, 32) bf16 matrix into shared rows
// of stride kRow, zero-filling rows past `total`.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int r0, int rows,
                                           int total) {
  for (int i = threadIdx.x; i < rows * 4; i += blockDim.x) {
    const int r = i >> 2, c = (i & 3) * 8;
    const bool ok = r0 + r < total;
    cp_async16_zfill(dst + r * kRow + c, src + (size_t)(ok ? r0 + r : 0) * kD + c, ok);
  }
}

// D = rowsum(dO o o) of one row, the products added in feature order.
__device__ __forceinline__ float row_d(const bf16* dout, const float* o) {
  float d = 0.0f;
#pragma unroll
  for (int c = 0; c < kD; c += 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(dout + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float4 a = *reinterpret_cast<const float4*>(o + c);
    const float4 b = *reinterpret_cast<const float4*>(o + c + 4);
    const float oc[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      d = fmaf(f.x, oc[2 * i], d);
      d = fmaf(f.y, oc[2 * i + 1], d);
    }
  }
  return d;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The cluster's dq: once every CTA holds its partial dq (n x kD float32 at
// dqs, over its kv rows), rank r sums rows [r per, (r + 1) per) over the
// ranks in rank order through distributed shared memory and writes them
// times scale, rounded once to gq's dtype.
template <typename T>
__device__ void sum_dq(float* dqs, T* gq, int n, float scale) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every partial is in
  const int cl = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int per = (n + cl - 1) / cl;
  const int e1 = min(n, (rank + 1) * per) * kD;
  float* src[kMaxClusterCtas];
  for (int r = 0; r < cl; ++r) src[r] = cluster.map_shared_rank(dqs, r);
  for (int e = min(n, rank * per) * kD + 2 * threadIdx.x; e < e1; e += 2 * blockDim.x) {
    float a = 0.0f, b = 0.0f;
    for (int r = 0; r < cl; ++r) {
      const float2 v = *reinterpret_cast<const float2*>(src[r] + e);
      a += v.x;
      b += v.y;
    }
    store2(gq + e, a * scale, b * scale);
  }
  cluster.sync();  // the other ranks are done reading this CTA's partial
}

// ------------------------------------------------------------ bf16, mma

// Shared bytes of flash_bwd_kv_mma staging `chunk` q rows (kCluster: all n
// rows, chunk = n rounded up to kBlock).
constexpr int kv_mma_smem(int chunk, bool cluster) {
  return chunk * (2 * kRow * 2 + 3 * 4) + 2 * kBlock * kRow * 2 +
         (cluster ? 2 * kBlock * kDsRow * 2 + chunk * kD * 4 : 0);
}

// m and 1 / l of a row from its statistics.
__device__ __forceinline__ void row_stats(const float2* stats, size_t i, float& m2, float& rl) {
  const float2 st = stats[i];
  m2 = st.x;
  rl = 1.0f / st.y;
}

// dk and dv of 64 kv rows, grid (ceil(m / 64), b*h); kCluster: a cluster of
// ceil(m / 64) CTAs a head (n <= kOneLaunch), which also forms dq.
template <bool kCluster>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_kv_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ o, const float2* __restrict__ stats,
    const bf16* __restrict__ dout, bf16* __restrict__ gq, bf16* __restrict__ gk,
    bf16* __restrict__ gv, int n, int m, int chunk, float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);                // (chunk, kRow)
  bf16* dos = qs + chunk * kRow;                           // (chunk, kRow)
  float* m2s = reinterpret_cast<float*>(dos + chunk * kRow);  // m of the rows
  float* rls = m2s + chunk;                                // 1 / l of the rows
  float* dds = rls + chunk;                                // D of the rows
  bf16* ks = reinterpret_cast<bf16*>(dds + chunk);         // (kBlock, kRow): the CTA's k rows
  bf16* vs = ks + kBlock * kRow;                           // and v rows
  bf16* dsh = vs + kBlock * kRow;                          // kCluster: dS^T (hi, lo) of a tile,
  bf16* dsl = dsh + kBlock * kDsRow;                       //   (kBlock kv, kDsRow)
  float* dqs = reinterpret_cast<float*>(dsl + kBlock * kDsRow);  // kCluster: partial dq (n, kD)
  const int bh = blockIdx.y, j0 = blockIdx.x * kBlock;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // row group and column pair of a fragment
  const size_t qoff = (size_t)bh * n * kD, koff = (size_t)bh * m * kD;
  stage_rows(ks, k + koff, j0, kBlock, m);
  stage_rows(vs, v + koff, j0, kBlock, m);
  cp_async_commit();

  const bool live = j0 + warp * 16 < m;  // the warp holds a kv row below m
  // B fragments of the warp's k and v rows, as K7a takes K's: n-tile j
  // holds kv rows 16 warp + 8 j .. + 7, b0, b1 of d 0-15, then of d 16-31
  uint32_t kb[2][4], vb[2][4];
  float dk[4][4], dv[4][4];     // 4 n-tiles of 8 features
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[f][e] = dv[f][e] = 0.0f;

  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int rows = min(chunk, n - c0), padded = (rows + 15) / 16 * 16;
    if (c0 > 0) __syncthreads();  // every warp is done with the previous chunk
    stage_rows(qs, q + qoff, c0, padded, n);
    stage_rows(dos, dout + qoff, c0, padded, n);
    cp_async_commit();
    for (int r = threadIdx.x; r < rows; r += kMmaThreads) {  // meanwhile m, 1 / l and D, a row a thread
      const size_t i = qoff / kD + c0 + r;
      row_stats(stats, i, m2s[r], rls[r]);
      dds[r] = row_d(dout + i * kD, o + i * kD);
    }
    cp_async_wait_all();
    __syncthreads();
    if (c0 == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = warp * 16 + j * 8 + (lane & 7);
        ldmatrix_x4(kb[j], ks + r * kRow + (lane >> 3) * 8);
        ldmatrix_x4(vb[j], vs + r * kRow + (lane >> 3) * 8);
      }
    }

    for (int t0 = 0; t0 < rows; t0 += kBlock) {
      const int cnt = min(kBlock, rows - t0);
      // S and dP, then P and dS, as K7a forms S: m-tile mt holds q rows
      // t0 + 16 mt + gid + 8 (e >> 1), n-tile j kv rows
      // j0 + 16 warp + 8 j + 2 tig + (e & 1)
      float s[4][2][4], dp[4][2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = dp[mt][j][e] = 0.0f;
        if (!live || mt * 16 >= cnt) continue;
        uint32_t qa[2][4], da[2][4];  // A fragments of the 16 q and dO rows, d 0-15, 16-31
        const int r = t0 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          ldmatrix_x4(qa[kk], qs + r * kRow + kk * 16 + (lane >> 4) * 8);
          ldmatrix_x4(da[kk], dos + r * kRow + kk * 16 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_bf16(s[mt][j], qa[0][0], qa[0][1], qa[0][2], qa[0][3], kb[j][0], kb[j][1]);
          mma_bf16(s[mt][j], qa[1][0], qa[1][1], qa[1][2], qa[1][3], kb[j][2], kb[j][3]);
          mma_bf16(dp[mt][j], da[0][0], da[0][1], da[0][2], da[0][3], vb[j][0], vb[j][1]);
          mma_bf16(dp[mt][j], da[1][0], da[1][1], da[1][2], da[1][3], vb[j][2], vb[j][3]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = t0 + mt * 16 + gid + 8 * (e >> 1);
            const bool ok = i < rows && j0 + warp * 16 + j * 8 + 2 * tig + (e & 1) < m;
            const float p =
                ok ? exp2f(__fmul_rn(s[mt][j][e], scale_log2) - m2s[i]) * rls[i] : 0.0f;
            s[mt][j][e] = p;
            dp[mt][j][e] = ok ? p * (dp[mt][j][e] - dds[i]) : 0.0f;
          }

      // dv += P^T dO, dk += dS^T q: k-steps of 16 q rows (m-tile mt). The A
      // fragment i of P^T (kv rows + 8 (i & 1), q columns + 8 (i >> 1)) is
      // the transpose of S's block (q rows + 8 (i >> 1), kv rows + 8 (i & 1)),
      // as (hi, lo) halves
      if (live) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (mt * 16 >= cnt) continue;
          uint32_t ph[4], pl[4], sh[4], sl[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = i & 1, e = (i >> 1) * 2;
            uint32_t hi, lo;
            split_bf16(s[mt][j][e], s[mt][j][e + 1], hi, lo);
            ph[i] = movmatrix_trans(hi);
            pl[i] = movmatrix_trans(lo);
            split_bf16(dp[mt][j][e], dp[mt][j][e + 1], hi, lo);
            sh[i] = movmatrix_trans(hi);
            sl[i] = movmatrix_trans(lo);
          }
#pragma unroll
          for (int fh = 0; fh < 2; ++fh) {  // features 16 fh .. 16 fh + 15
            uint32_t bo[4], bq[4];  // b0, b1 of n-tile 2 fh, then of n-tile 2 fh + 1
            const int r = t0 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
            ldmatrix_x4_trans(bo, dos + r * kRow + fh * 16 + (lane >> 4) * 8);
            ldmatrix_x4_trans(bq, qs + r * kRow + fh * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float(&a)[4] = dv[2 * fh + h];
              float(&b)[4] = dk[2 * fh + h];
              mma_bf16(a, ph[0], ph[1], ph[2], ph[3], bo[2 * h], bo[2 * h + 1]);
              mma_bf16(a, pl[0], pl[1], pl[2], pl[3], bo[2 * h], bo[2 * h + 1]);
              mma_bf16(b, sh[0], sh[1], sh[2], sh[3], bq[2 * h], bq[2 * h + 1]);
              mma_bf16(b, sl[0], sl[1], sl[2], sl[3], bq[2 * h], bq[2 * h + 1]);
            }
          }
          if constexpr (kCluster) {  // the block's dS^T (hi, lo), kv rows x q columns
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int at =
                  (warp * 16 + gid + 8 * (i & 1)) * kDsRow + mt * 16 + 8 * (i >> 1) + 2 * tig;
              *reinterpret_cast<uint32_t*>(dsh + at) = sh[i];
              *reinterpret_cast<uint32_t*>(dsl + at) = sl[i];
            }
          }
        }
      }

      if constexpr (kCluster) {
        __syncthreads();
        // dq of the tile's q rows, 16 a warp: dS (q x kv) k (kv x d) over
        // the CTA's kv rows below m; dS's A fragments by ldmatrix.trans of
        // dS^T (matrix i: kv rows + 8 (i >> 1), q columns + 8 (i & 1))
        for (int qb = warp; qb * 16 < cnt; qb += kMmaWarps) {
          float acc[4][4];
#pragma unroll
          for (int f = 0; f < 4; ++f)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[f][e] = 0.0f;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if (j0 + kk * 16 >= m) break;
            const int mi = lane >> 3;
            const int at = (kk * 16 + (mi >> 1) * 8 + (lane & 7)) * kDsRow + qb * 16 + (mi & 1) * 8;
            uint32_t ah[4], al[4];
            ldmatrix_x4_trans(ah, dsh + at);
            ldmatrix_x4_trans(al, dsl + at);
#pragma unroll
            for (int fh = 0; fh < 2; ++fh) {
              uint32_t bk[4];
              const int r = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
              ldmatrix_x4_trans(bk, ks + r * kRow + fh * 16 + (lane >> 4) * 8);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float(&a)[4] = acc[2 * fh + h];
                mma_bf16(a, ah[0], ah[1], ah[2], ah[3], bk[2 * h], bk[2 * h + 1]);
                mma_bf16(a, al[0], al[1], al[2], al[3], bk[2 * h], bk[2 * h + 1]);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = c0 + t0 + qb * 16 + gid + 8 * r;
#pragma unroll
            for (int f = 0; f < 4; ++f)
              store2(dqs + row * kD + f * 8 + 2 * tig, acc[f][2 * r], acc[f][2 * r + 1]);
          }
        }
        __syncthreads();  // the dS tile may be written again
      }
    }
  }

  if (live) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = j0 + warp * 16 + gid + 8 * r;
      if (row >= m) continue;
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const size_t at = koff + (size_t)row * kD + f * 8 + 2 * tig;
        store2(gk + at, dk[f][2 * r] * scale, dk[f][2 * r + 1] * scale);
        store2(gv + at, dv[f][2 * r], dv[f][2 * r + 1]);
      }
    }
  }
  if constexpr (kCluster) sum_dq(dqs, gq + qoff, n, scale);
}

// Shared bytes of flash_bwd_q_mma.
constexpr int kQMmaSmem = (2 * kBlock + 2 * kSplitChunk) * kRow * 2;

// dq of 64 q rows, grid (ceil(n / 64), b*h), past kOneLaunch: each warp owns
// 16 q rows, its q and dO fragments in registers, and streams k and v in
// chunks of kSplitChunk rows; S is formed as K7a forms it.
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_q_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ o, const float2* __restrict__ stats,
    const bf16* __restrict__ dout, bf16* __restrict__ gq, int n, int m, float scale,
    float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // (kBlock, kRow)
  bf16* dos = qs + kBlock * kRow;            // (kBlock, kRow)
  bf16* ks = dos + kBlock * kRow;            // (kSplitChunk, kRow)
  bf16* vs = ks + kSplitChunk * kRow;        // (kSplitChunk, kRow)
  const int bh = blockIdx.y, i0 = blockIdx.x * kBlock;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t qoff = (size_t)bh * n * kD, koff = (size_t)bh * m * kD;
  stage_rows(qs, q + qoff, i0, kBlock, n);
  stage_rows(dos, dout + qoff, i0, kBlock, n);
  cp_async_commit();
  float m2[2], rl[2], dd[2];  // m, 1 / l and D of the fragment rows gid, gid + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + warp * 16 + gid + 8 * r;
    const size_t at = (size_t)bh * n + (i < n ? i : 0);
    row_stats(stats, at, m2[r], rl[r]);
    dd[r] = row_d(dout + at * kD, o + at * kD);
  }
  const bool live = i0 + warp * 16 < n;
  uint32_t qa[2][4], da[2][4];  // A fragments of the warp's q and dO rows
  float acc[4][4];
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.0f;

  for (int c0 = 0; c0 < m; c0 += kSplitChunk) {
    const int rows = min(kSplitChunk, m - c0), padded = (rows + 15) / 16 * 16;
    if (c0 > 0) __syncthreads();  // every warp is done with the previous chunk
    stage_rows(ks, k + koff, c0, padded, m);
    stage_rows(vs, v + koff, c0, padded, m);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (c0 == 0) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(qa[kk], qs + r * kRow + kk * 16 + (lane >> 4) * 8);
        ldmatrix_x4(da[kk], dos + r * kRow + kk * 16 + (lane >> 4) * 8);
      }
    }
    if (!live) continue;
    for (int t0 = 0; t0 < rows; t0 += kBlock) {
      const int cnt = min(kBlock, rows - t0);
      // S and dP, then P and dS: q rows gid, gid + 8 (e >> 1), kv columns
      // c0 + t0 + 8 nt + 2 tig + (e & 1)
      float s[8][4], dp[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
        if (nt * 8 >= cnt) continue;
        uint32_t bk[4], bv[4];
        const int r = t0 + nt * 8 + (lane & 7);
        ldmatrix_x4(bk, ks + r * kRow + (lane >> 3) * 8);
        ldmatrix_x4(bv, vs + r * kRow + (lane >> 3) * 8);
        mma_bf16(s[nt], qa[0][0], qa[0][1], qa[0][2], qa[0][3], bk[0], bk[1]);
        mma_bf16(s[nt], qa[1][0], qa[1][1], qa[1][2], qa[1][3], bk[2], bk[3]);
        mma_bf16(dp[nt], da[0][0], da[0][1], da[0][2], da[0][3], bv[0], bv[1]);
        mma_bf16(dp[nt], da[1][0], da[1][1], da[1][2], da[1][3], bv[2], bv[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool ok = t0 + nt * 8 + 2 * tig + (e & 1) < rows &&
                          i0 + warp * 16 + gid + 8 * r < n;
          const float p = ok ? exp2f(__fmul_rn(s[nt][e], scale_log2) - m2[r]) * rl[r] : 0.0f;
          dp[nt][e] = ok ? p * (dp[nt][e] - dd[r]) : 0.0f;
        }
      // dq += dS k: k-steps of 16 kv rows, dS as (hi, lo) halves
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk * 16 >= cnt) continue;
        uint32_t sh[4], sl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int nt = 2 * kk + (i >> 1), e = (i & 1) * 2;
          split_bf16(dp[nt][e], dp[nt][e + 1], sh[i], sl[i]);
        }
#pragma unroll
        for (int fh = 0; fh < 2; ++fh) {
          uint32_t bk[4];
          const int r = t0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldmatrix_x4_trans(bk, ks + r * kRow + fh * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float(&a)[4] = acc[2 * fh + h];
            mma_bf16(a, sh[0], sh[1], sh[2], sh[3], bk[2 * h], bk[2 * h + 1]);
            mma_bf16(a, sl[0], sl[1], sl[2], sl[3], bk[2 * h], bk[2 * h + 1]);
          }
        }
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i0 + warp * 16 + gid + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int f = 0; f < 4; ++f)
      store2(gq + qoff + (size_t)row * kD + f * 8 + 2 * tig, acc[f][2 * r] * scale,
             acc[f][2 * r + 1] * scale);
  }
}

// --------------------------------------------------------------- float32

// dq, grid (q blocks, b*h), past kOneLaunch: a CTA owns 64 q rows (8 per
// warp), forms D for them, then streams 64-row k and v tiles; for a row,
// lane j holds P and dS of kv rows j and j + 32, and lane c accumulates
// feature c of dS k with dS broadcast by shuffles.
__global__ void __launch_bounds__(kThreads) flash_bwd_q_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float2* __restrict__ stats,
    const float* __restrict__ dout, float* __restrict__ gq, int n, int m, float scale,
    float scale_log2) {
  __shared__ float qs[kBlock][kD];    // broadcast
  __shared__ float dos[kBlock][kD];   // broadcast
  __shared__ float ks[kBlock][kPad];  // one row per lane, then one column per lane
  __shared__ float vs[kBlock][kPad];  // one row per lane
  const int bh = blockIdx.y, q0 = blockIdx.x * kBlock;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t qoff = (size_t)bh * n * kD;
  const float* kb = k + (size_t)bh * m * kD;
  const float* vb = v + (size_t)bh * m * kD;
  load_tile<float, kD>(qs, q + qoff, q0, n);
  load_tile<float, kD>(dos, dout + qoff, q0, n);
  __syncthreads();

  float m2[kRowsPerWarp], rl[kRowsPerWarp], dd[kRowsPerWarp], acc[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr, row = q0 + r;
    acc[rr] = 0.0f;
    m2[rr] = rl[rr] = dd[rr] = 0.0f;
    if (row >= n) continue;
    row_stats(stats, (size_t)bh * n + row, m2[rr], rl[rr]);
    dd[rr] = warp_sum(dos[r][lane] * o[qoff + (size_t)row * kD + lane]);
  }

  for (int j0 = 0; j0 < m; j0 += kBlock) {
    __syncthreads();
    load_tile<float, kPad>(ks, kb, j0, m);
    load_tile<float, kPad>(vs, vb, j0, m);
    __syncthreads();
    const bool ok0 = j0 + lane < m, ok1 = j0 + 32 + lane < m;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      if (q0 + r >= n) break;
      const float p0 =
          ok0 ? exp2f(__fmul_rn(dot_row(qs[r], ks[lane]), scale_log2) - m2[rr]) * rl[rr] : 0.0f;
      const float p1 =
          ok1 ? exp2f(__fmul_rn(dot_row(qs[r], ks[lane + 32]), scale_log2) - m2[rr]) * rl[rr]
              : 0.0f;
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
    gq[qoff + (size_t)row * kD + lane] = acc[rr] * scale;
  }
}

// Dynamic shared bytes of flash_bwd_kv_f32<true>: the dS tile and the
// partial dq of n rows.
inline int kv_f32_smem(int n) { return (kBlock * kDsPad + n * kD) * 4; }

// dk and dv, grid (kv blocks, b*h): a CTA owns 64 kv rows and streams
// 64-row q and dO tiles, staging m, 1 / l and D of each; lane i holds P and
// dS of q rows i and i + 32 (its scores' products in feature order, as K7a
// forms them: fmaf(k, q, s) is fmaf(q, k, s)). kCluster: a cluster of ceil(m / 64) CTAs a head
// (n <= kOneLaunch), which also forms dq: each tile's dS to shared memory,
// then lane c of the warp that owns q row i sums dS[i, :] k[:, c] over the
// CTA's kv rows, in order, into its partial dq.
template <bool kCluster>
__global__ void __launch_bounds__(kThreads) flash_bwd_kv_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float2* __restrict__ stats,
    const float* __restrict__ dout, float* __restrict__ gq, float* __restrict__ gk,
    float* __restrict__ gv, int n, int m, float scale, float scale_log2) {
  __shared__ float kbs[kBlock][kD];   // broadcast
  __shared__ float vbs[kBlock][kD];   // broadcast
  __shared__ float qs[kBlock][kPad];  // one row per lane, then one column per lane
  __shared__ float dos[kBlock][kPad];
  __shared__ float m2s[kBlock], rls[kBlock], dds[kBlock];
  extern __shared__ float dyn[];      // kCluster: dS (kBlock q, kDsPad), partial dq (n, kD)
  float* dsm = dyn;
  float* dqs = dyn + kBlock * kDsPad;
  const int bh = blockIdx.y, j0 = blockIdx.x * kBlock;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t qoff = (size_t)bh * n * kD, koff = (size_t)bh * m * kD;
  const float* qb = q + qoff;
  const float* db = dout + qoff;
  load_tile<float, kD>(kbs, k + koff, j0, m);
  load_tile<float, kD>(vbs, v + koff, j0, m);

  float dk_acc[kRowsPerWarp], dv_acc[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) dk_acc[rr] = dv_acc[rr] = 0.0f;

  for (int i0 = 0; i0 < n; i0 += kBlock) {
    __syncthreads();
    load_tile<float, kPad>(qs, qb, i0, n);
    load_tile<float, kPad>(dos, db, i0, n);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {  // m, 1 / l and D of the tile's rows, a warp a row
      const int r = warp * kRowsPerWarp + rr, i = i0 + r;
      const float dd = i < n ? warp_sum(db[(size_t)i * kD + lane] * o[qoff + (size_t)i * kD + lane])
                             : 0.0f;
      if (lane == 0) {
        m2s[r] = rls[r] = 0.0f;
        if (i < n) row_stats(stats, (size_t)bh * n + i, m2s[r], rls[r]);
        dds[r] = dd;
      }
    }
    __syncthreads();
    const bool ok0 = i0 + lane < n, ok1 = i0 + 32 + lane < n;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int jr = warp * kRowsPerWarp + rr;
      if (j0 + jr >= m) break;
      const float p0 =
          ok0 ? exp2f(__fmul_rn(dot_row(kbs[jr], qs[lane]), scale_log2) - m2s[lane]) * rls[lane]
              : 0.0f;
      const float p1 = ok1 ? exp2f(__fmul_rn(dot_row(kbs[jr], qs[lane + 32]), scale_log2) -
                                   m2s[lane + 32]) * rls[lane + 32]
                           : 0.0f;
      const float ds0 = p0 * (dot_row(vbs[jr], dos[lane]) - dds[lane]);
      const float ds1 = p1 * (dot_row(vbs[jr], dos[lane + 32]) - dds[lane + 32]);
      if constexpr (kCluster) {
        dsm[lane * kDsPad + jr] = ds0;
        dsm[(lane + 32) * kDsPad + jr] = ds1;
      }
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
    if constexpr (kCluster) {
      __syncthreads();  // the tile's dS is in
      const int jn = min(kBlock, m - j0);
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp * kRowsPerWarp + rr;
        if (i0 + r >= n) break;
        float a = 0.0f;
        for (int j = 0; j < jn; ++j) a = fmaf(dsm[r * kDsPad + j], kbs[j][lane], a);
        dqs[(i0 + r) * kD + lane] = a;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = j0 + warp * kRowsPerWarp + rr;
    if (row >= m) break;
    gk[koff + (size_t)row * kD + lane] = dk_acc[rr] * scale;
    gv[koff + (size_t)row * kD + lane] = dv_acc[rr];
  }
  if constexpr (kCluster) sum_dq(dqs, gq + qoff, n, scale);
}

cudaError_t run_bf16(const bf16* q, const bf16* k, const bf16* v, const float* o,
                     const float2* stats, const bf16* dout, bf16* gq, bf16* gk, bf16* gv, int bh,
                     int n, int m, float scale, int cluster, cudaStream_t s) {
  const float sl2 = scale * kLog2e;
  if (cluster) {
    const int chunk = dq::ceil_div(n, kBlock) * kBlock;
    return dq::launch_cluster(flash_bwd_kv_mma<true>, cluster, bh, kMmaThreads,
                          kv_mma_smem(chunk, true), s, q, k, v, o, stats, dout, gq, gk, gv, n, m,
                          chunk, scale, sl2);
  }
  cudaError_t err = dq::allow_smem(flash_bwd_q_mma, kQMmaSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_q_mma<<<dim3(dq::ceil_div(n, kBlock), bh), kMmaThreads, kQMmaSmem, s>>>(
      q, k, v, o, stats, dout, gq, n, m, scale, sl2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int smem = kv_mma_smem(kSplitChunk, false);
  err = dq::allow_smem(flash_bwd_kv_mma<false>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_kv_mma<false><<<dim3(dq::ceil_div(m, kBlock), bh), kMmaThreads, smem, s>>>(
      q, k, v, o, stats, dout, gq, gk, gv, n, m, kSplitChunk, scale, sl2);
  return cudaGetLastError();
}

cudaError_t run_f32(const float* q, const float* k, const float* v, const float* o,
                    const float2* stats, const float* dout, float* gq, float* gk, float* gv, int bh,
                    int n, int m, float scale, int cluster, cudaStream_t s) {
  const float sl2 = scale * kLog2e;
  if (cluster) {  // the static and the dynamic shared memory may pass 48 KB together
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_kv_f32<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_f32_smem(n));
    if (err != cudaSuccess) return err;
    return dq::launch_cluster(flash_bwd_kv_f32<true>, cluster, bh, kThreads, kv_f32_smem(n), s, q,
                          k, v, o, stats, dout, gq, gk, gv, n, m, scale, sl2);
  }
  flash_bwd_q_f32<<<dim3(dq::ceil_div(n, kBlock), bh), kThreads, 0, s>>>(q, k, v, o, stats, dout,
                                                                         gq, n, m, scale, sl2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_kv_f32<false><<<dim3(dq::ceil_div(m, kBlock), bh), kThreads, 0, s>>>(
      q, k, v, o, stats, dout, gq, gk, gv, n, m, scale, sl2);
  return cudaGetLastError();
}

}  // namespace

// o float32, stats (m, l) float32 pairs a row; q, k, v, dO and the
// gradients float32 or bf16 (bf16), bf16 ones 16-byte aligned. cluster: the
// CTAs of the one cluster launch (ceil(m / 64), with n and m at most
// kOneLaunch), or 0 for the two launches; ops/flash_attention.py
// flash_backward_plan chooses it.
extern "C" int dq_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* o, const void* stats, const void* dout,
                                      void* gq, void* gk, void* gv, int bh, int n, int m,
                                      float scale, int bf16_in, int cluster, int device,
                                      void* stream) {
  if (bh < 1 || bh > 65535 || n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  if (cluster && (cluster != dq::ceil_div(m, kBlock) || n > kOneLaunch || m > kOneLaunch))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* o32 = static_cast<const float*>(o);
  const float2* st = static_cast<const float2*>(stats);
  if (bf16_in) {
    auto c = [](const void* p) { return static_cast<const bf16*>(p); };
    auto w = [](void* p) { return static_cast<bf16*>(p); };
    err = run_bf16(c(q), c(k), c(v), o32, st, c(dout), w(gq), w(gk), w(gv), bh, n, m, scale,
                   cluster, s);
  } else {
    auto c = [](const void* p) { return static_cast<const float*>(p); };
    auto w = [](void* p) { return static_cast<float*>(p); };
    err = run_f32(c(q), c(k), c(v), o32, st, c(dout), w(gq), w(gk), w(gv), bh, n, m, scale,
                  cluster, s);
  }
  return (int)err;
}
