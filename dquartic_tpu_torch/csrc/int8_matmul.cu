// K3: int8 weight-streaming matmul, out = (x @ w_q) * scale[col].
//
// Replaces the TPU kernel dquartic_tpu/ops/int8_matmul.py:int8_matmul
// (_matmul_kernel). At the main path's shape (M = b*rt = 34, K = 30000,
// N = 10000) one call reads 300 MB of int8 weights and only ~2 MB of
// everything else, so it is bound by device-memory bandwidth (>= 0.09 ms at
// 3.35 TB/s). At the production shape (M = 340, K = 22512, N = 7504) the
// 115 GFLOP of products bound it instead (0.116 ms at 989 TFLOP/s bf16).
//
// bf16 x: tensor cores (int8_matmul_mma). The weights are read in their
// stored (K, N) row-major layout; no packing.
//   * The weight columns take the 16-row side of mma.sync m16n8k16 and the
//     rows of x its 8-column side ("swap A/B"), so M = 34 fills 5 n8 tiles.
//     A warp owns 32 weight columns (two m16 tiles), a CTA of 8 warps 256,
//     and up to 64 rows of x (8 n8 tiles): up to 64 rows the weights are
//     read from device memory once a call. Above 64 rows the rows go in
//     blocks of up to 64 (grid.x), and each block streams the weights again;
//     the blocks of one weight tile are adjacent in launch order, so they run
//     together and the repeats can come from L2.
//   * A 4-stage ring of cp.async copies brings 64 x 256 int8 weight tiles
//     and the matching 64-wide slice of x into shared memory while the tile
//     before is multiplied. Weight rows are padded to 272 bytes and x rows to
//     144, so neither the 32-bit weight reads nor ldmatrix of x conflict.
//   * int8 -> bf16 in registers, no I2F: a thread reads one 32-bit word
//     (4 columns) from rows k and k+1; each byte, its sign bit flipped, goes
//     under 0x4B00_0000 by a byte permute (the float 2^23 + b + 128), one
//     subtraction leaves b exactly, and since b is exact in bf16 the high
//     halves of the rows' two floats form the bf16x2 A fragment. The four
//     columns of a word feed two m16 tiles; the accumulators then hold four
//     consecutive output columns per x row, stored as one float4.
//   * int8 values and bf16 x are exact in bf16, so the products are the
//     TPU kernel's bf16 x bf16 -> f32 products; only the summation order
//     differs.
//   * Split K keeps a full wave of CTAs (2 per SM) streaming; partial sums
//     go to a float32 (ksplit, M, N) scratch and int8_matmul_reduce sums
//     them in split order and applies the scale once: deterministic, no
//     float atomics.
//   * Edges: rows of K past a split and columns past N are zero-filled by
//     the copies. Where N is not a multiple of 16, or K of 8, the rows are
//     not 16-byte aligned and that operand is staged by plain loads instead.
//
// float32 x: CUDA cores (int8_matmul_partial): TF32 would not hold the
// float32 path's 1e-5 tolerance. CTAs tile N by 128 columns and split K;
// each K step stages a 32 x 128 int8 weight tile and the matching x slice
// in shared memory, a warp owns R rows of x and a lane 4 columns.
#include "common.cuh"

namespace {

// ------------------------------------------------------------------ //
// float32 x: CUDA cores                                               //
// ------------------------------------------------------------------ //

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBlockN = 128;  // 32 lanes x 4 columns
constexpr int kBlockK = 32;

template <int R>
__global__ void __launch_bounds__(kThreads) int8_matmul_partial(
    const float* __restrict__ x, const int8_t* __restrict__ w, float* __restrict__ part,
    int M, int K, int N, int kchunk) {
  constexpr int kRows = R * kWarps;
  __shared__ __align__(16) int8_t ws[kBlockK][kBlockN];
  __shared__ float xs[kRows][kBlockK];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kBlockN;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * kRows;
  const int mc = min(kRows, M - m0);
  const int kbeg = split * kchunk;
  const int kend = min(K, kbeg + kchunk);
  const bool vec = (N % 16) == 0 && (reinterpret_cast<uintptr_t>(w) % 16) == 0;

  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kBlockK) {
    {  // 32 rows x 128 bytes of weights: one 16-byte chunk per thread
      const int kk = tid >> 3, chunk = tid & 7;
      const int k = k0 + kk, col = n0 + chunk * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (k < kend) {
        const int8_t* src = w + (size_t)k * N + col;
        if (vec && col + 16 <= N) {
          v = __ldcs(reinterpret_cast<const int4*>(src));  // streamed once
        } else {
          int8_t* b = reinterpret_cast<int8_t*>(&v);
          for (int i = 0; i < 16; ++i) b[i] = (col + i < N) ? src[i] : 0;
        }
      }
      *reinterpret_cast<int4*>(&ws[kk][chunk * 16]) = v;
    }
    for (int i = tid; i < kRows * kBlockK; i += kThreads) {
      const int m = i / kBlockK, kk = i % kBlockK, k = k0 + kk;
      xs[m][kk] = (m < mc && k < kend) ? x[(size_t)(m0 + m) * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      const char4 q = *reinterpret_cast<const char4*>(&ws[kk][lane * 4]);
      const float w0 = q.x, w1 = q.y, w2 = q.z, w3 = q.w;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xv = xs[warp + kWarps * r][kk];  // broadcast
        acc[r][0] = fmaf(xv, w0, acc[r][0]);
        acc[r][1] = fmaf(xv, w1, acc[r][1]);
        acc[r][2] = fmaf(xv, w2, acc[r][2]);
        acc[r][3] = fmaf(xv, w3, acc[r][3]);
      }
    }
    __syncthreads();
  }

  const int col = n0 + lane * 4;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int m = warp + kWarps * r;
    if (m >= mc) continue;
    float* dst = part + ((size_t)split * M + m0 + m) * N + col;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < N) dst[j] = acc[r][j];
  }
}

template <int R>
cudaError_t launch_partial(const void* x, const void* w, void* part, int M, int K, int N,
                           int ksplit, int kchunk, cudaStream_t stream) {
  dim3 grid(dq::ceil_div(N, kBlockN), ksplit, dq::ceil_div(M, R * kWarps));
  int8_matmul_partial<R><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w), static_cast<float*>(part),
      M, K, N, kchunk);
  return cudaGetLastError();
}

cudaError_t run_f32(const void* x, const void* w, void* part, int M, int K, int N, int ksplit,
                    int kchunk, cudaStream_t s) {
  // R rows per warp: the fewest that cover M in one chunk, at most 8
  switch (std::min(8, dq::ceil_div(M, kWarps))) {
    case 1: return launch_partial<1>(x, w, part, M, K, N, ksplit, kchunk, s);
    case 2: return launch_partial<2>(x, w, part, M, K, N, ksplit, kchunk, s);
    case 3: return launch_partial<3>(x, w, part, M, K, N, ksplit, kchunk, s);
    case 4: return launch_partial<4>(x, w, part, M, K, N, ksplit, kchunk, s);
    case 5: return launch_partial<5>(x, w, part, M, K, N, ksplit, kchunk, s);
    case 6: return launch_partial<6>(x, w, part, M, K, N, ksplit, kchunk, s);
    case 7: return launch_partial<7>(x, w, part, M, K, N, ksplit, kchunk, s);
    default: return launch_partial<8>(x, w, part, M, K, N, ksplit, kchunk, s);
  }
}

// ------------------------------------------------------------------ //
// bf16 x: tensor cores                                                //
// ------------------------------------------------------------------ //

constexpr int kMmaThreads = 256;  // 8 warps x 32 weight columns
constexpr int kTileN = 256;       // weight columns a CTA
constexpr int kTileK = 64;        // K rows a stage
constexpr int kStages = 4;
constexpr int kWRow = kTileN + 16;  // bytes a staged weight row
constexpr int kXRow = kTileK + 8;   // bf16 a staged x row (144 bytes)
constexpr int kWStage = kTileK * kWRow;

// Rows of x a CTA stages: the T n8 tiles rounded up to whole ldmatrix.x4
// pairs.
template <int T>
__host__ __device__ constexpr int x_rows() { return 16 * ((T + 1) / 2); }

template <int T>
__host__ __device__ constexpr int mma_smem_bytes() { return kStages * (kWStage + x_rows<T>() * kXRow * 2); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; `bytes` < 16 zero-fills the rest (0: all zeros).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 32-bit words of int8 weights, columns c..c+3 of rows k (lo) and k+1
// (hi), to four bf16x2: p[i] = (w[k][c+i], w[k+1][c+i]), k in the low half.
__device__ __forceinline__ void int8_pairs_to_bf16(uint32_t lo, uint32_t hi,
                                                   uint32_t (&p)[4]) {
  const uint32_t ul = lo ^ 0x80808080u, uh = hi ^ 0x80808080u;  // b + 128, unsigned
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // 0x4B0000uu is the float 2^23 + u; minus 2^23 + 128 leaves b exactly
    const float fl = __uint_as_float(__byte_perm(ul, 0x4B000000u, 0x7440 | i)) - 8388736.0f;
    const float fh = __uint_as_float(__byte_perm(uh, 0x4B000000u, 0x7440 | i)) - 8388736.0f;
    p[i] = __byte_perm(__float_as_uint(fl), __float_as_uint(fh), 0x7632);  // high halves
  }
}

// One stage: weight rows [k0, k0 + kTileK) x columns [n0, n0 + kTileN) and
// x rows [m0, m0 + 8T) x the same k, zero outside [kbeg, kend) x N x M.
template <int T>
__device__ __forceinline__ void load_stage(int8_t* ws, __nv_bfloat16* xs,
                                           const __nv_bfloat16* __restrict__ x,
                                           const int8_t* __restrict__ w, int M, int K, int N,
                                           int m0, int n0, int k0, int kend, bool w_vec,
                                           bool x_vec) {
  const int tid = threadIdx.x;
  constexpr int kWChunks = kTileK * kTileN / 16;
#pragma unroll
  for (int i = tid; i < kWChunks; i += kMmaThreads) {
    const int r = i / (kTileN / 16), c = i % (kTileN / 16);
    const int k = k0 + r, col = n0 + c * 16;
    int8_t* dst = ws + r * kWRow + c * 16;
    const bool in = k < kend && col < N;
    if (w_vec) {  // N % 16 == 0: a chunk is all in or all out
      cp_async16(dst, in ? w + (size_t)k * N + col : w, in ? 16 : 0);
    } else {
      int4 v = make_int4(0, 0, 0, 0);
      if (in) {
        int8_t* b = reinterpret_cast<int8_t*>(&v);
        const int8_t* src = w + (size_t)k * N + col;
        for (int j = 0; j < 16; ++j) b[j] = col + j < N ? src[j] : int8_t(0);
      }
      *reinterpret_cast<int4*>(dst) = v;
    }
  }
  constexpr int kXChunks = x_rows<T>() * kTileK / 8;
  for (int i = tid; i < kXChunks; i += kMmaThreads) {
    const int r = i / (kTileK / 8), c = i % (kTileK / 8);
    const int m = m0 + r, k = k0 + c * 8;
    __nv_bfloat16* dst = xs + r * kXRow + c * 8;
    const bool in = r < 8 * T && m < M && k < kend;
    if (x_vec) {  // K % 8 == 0 and kend too: a chunk is all in or all out
      cp_async16(dst, in ? x + (size_t)m * K + k : x, in ? 16 : 0);
    } else {
      for (int j = 0; j < 8; ++j)
        dst[j] = in && k + j < kend ? x[(size_t)m * K + k + j] : __float2bfloat16(0.0f);
    }
  }
}

// grid (row blocks of 8T, ceil(N / kTileN), ksplit); 256 threads.
template <int T>
__global__ void __launch_bounds__(kMmaThreads, 2) int8_matmul_mma(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    float* __restrict__ part, int M, int K, int N, int kchunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* wsm = reinterpret_cast<int8_t*>(smem);
  __nv_bfloat16* xsm = reinterpret_cast<__nv_bfloat16*>(smem + kStages * kWStage);
  constexpr int kXStage = x_rows<T>() * kXRow;  // bf16 elements

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * 8 * T;
  const int n0 = blockIdx.y * kTileN;
  const int split = blockIdx.z;
  const int kbeg = split * kchunk;
  const int kend = min(K, kbeg + kchunk);
  const int tiles = (kend - kbeg + kTileK - 1) / kTileK;
  const bool w_vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool x_vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;

  float acc[T][8];  // [n8 tile of x rows][m16 tile 0: c0..c3, tile 1: c0..c3]
#pragma unroll
  for (int tt = 0; tt < T; ++tt)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[tt][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles)
      load_stage<T>(wsm + s * kWStage, xsm + s * kXStage, x, w, M, K, N, m0, n0,
                    kbeg + s * kTileK, kend, w_vec, x_vec);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // this lane's ldmatrix row and column inside a 16 x 16 block of x
  const int lm_row = ((lane >> 4) << 3) + (lane & 7), lm_col = ((lane >> 3) & 1) * 8;
  for (int it = 0; it < tiles; ++it) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();  // tile `it` is in; every warp is done with tile it - 1
    {
      const int nt = it + kStages - 1, buf = nt % kStages;
      if (nt < tiles)
        load_stage<T>(wsm + buf * kWStage, xsm + buf * kXStage, x, w, M, K, N, m0, n0,
                      kbeg + nt * kTileK, kend, w_vec, x_vec);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    const int8_t* ws = wsm + (it % kStages) * kWStage + warp * 32 + 4 * g;
    const __nv_bfloat16* xs = xsm + (it % kStages) * kXStage;
#pragma unroll
    for (int ks = 0; ks < kTileK / 16; ++ks) {
      const int8_t* wr = ws + (ks * 16 + 2 * t) * kWRow;
      uint32_t lo[4], hi[4];
      int8_pairs_to_bf16(*reinterpret_cast<const uint32_t*>(wr),
                         *reinterpret_cast<const uint32_t*>(wr + kWRow), lo);
      int8_pairs_to_bf16(*reinterpret_cast<const uint32_t*>(wr + 8 * kWRow),
                         *reinterpret_cast<const uint32_t*>(wr + 9 * kWRow), hi);
      // m16 tile 0 holds columns 4g (row g) and 4g+1 (row g+8), tile 1 4g+2, 4g+3
      const uint32_t a0[4] = {lo[0], lo[1], hi[0], hi[1]};
      const uint32_t a1[4] = {lo[2], lo[3], hi[2], hi[3]};
#pragma unroll
      for (int j = 0; j < (T + 1) / 2; ++j) {
        uint32_t b[4];  // b0, b1 of n8 tiles 2j and 2j + 1
        ldmatrix_x4(b, xs + (16 * j + lm_row) * kXRow + ks * 16 + lm_col);
        mma_bf16(acc[2 * j], a0, b[0], b[1]);
        mma_bf16(acc[2 * j] + 4, a1, b[0], b[1]);
        if (2 * j + 1 < T) {
          mma_bf16(acc[2 * j + 1], a0, b[2], b[3]);
          mma_bf16(acc[2 * j + 1] + 4, a1, b[2], b[3]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // acc[tt][h], [2 + h], [4 + h], [6 + h]: x row m0 + 8tt + 2t + h at columns
  // n0 + 32 warp + 4g + 0..3
  const int n = n0 + warp * 32 + 4 * g;
  const bool vec = N % 4 == 0 && n + 4 <= N;
#pragma unroll
  for (int tt = 0; tt < T; ++tt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 8 * tt + 2 * t + h;
      if (m >= M || n >= N) continue;
      const float v[4] = {acc[tt][h], acc[tt][2 + h], acc[tt][4 + h], acc[tt][6 + h]};
      float* dst = part + ((size_t)split * M + m) * N + n;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        for (int q = 0; q < 4; ++q)
          if (n + q < N) dst[q] = v[q];
      }
    }
  }
}

template <int T>
cudaError_t launch_mma(const void* x, const void* w, void* part, int M, int K, int N,
                       int ksplit, int kchunk, cudaStream_t s) {
  constexpr int bytes = mma_smem_bytes<T>();
  cudaError_t err = dq::allow_smem(int8_matmul_mma<T>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(dq::ceil_div(M, 8 * T), dq::ceil_div(N, kTileN), ksplit);
  int8_matmul_mma<T><<<grid, kMmaThreads, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<float*>(part), M, K, N, kchunk);
  return cudaGetLastError();
}

// T n8 tiles of x rows a CTA: the fewest that cover the row blocks of <= 64
// rows evenly (M = 34: 5; 272: 7 in 5 blocks; 340: 8 in 6 blocks).
cudaError_t run_bf16(const void* x, const void* w, void* part, int M, int K, int N, int ksplit,
                     int kchunk, cudaStream_t s) {
  const int blocks = dq::ceil_div(M, 64);
  switch (dq::ceil_div(M, 8 * blocks)) {
    case 1: return launch_mma<1>(x, w, part, M, K, N, ksplit, kchunk, s);
    case 2: return launch_mma<2>(x, w, part, M, K, N, ksplit, kchunk, s);
    case 3: return launch_mma<3>(x, w, part, M, K, N, ksplit, kchunk, s);
    case 4: return launch_mma<4>(x, w, part, M, K, N, ksplit, kchunk, s);
    case 5: return launch_mma<5>(x, w, part, M, K, N, ksplit, kchunk, s);
    case 6: return launch_mma<6>(x, w, part, M, K, N, ksplit, kchunk, s);
    case 7: return launch_mma<7>(x, w, part, M, K, N, ksplit, kchunk, s);
    default: return launch_mma<8>(x, w, part, M, K, N, ksplit, kchunk, s);
  }
}

// out[m][n] = (sum over splits of part[split][m][n]) * scale[n], splits in order.
template <typename T>
__global__ void int8_matmul_reduce(const float* __restrict__ part,
                                   const float* __restrict__ scale, T* __restrict__ out,
                                   int M, int N, int ksplit) {
  const size_t total = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < ksplit; ++sp) s += part[sp * total + i];
  out[i] = dq::from_f32<T>(s * scale[i % N]);
}

template <typename T>
cudaError_t launch_reduce(const void* part, const void* scale, void* out, int M, int N,
                          int ksplit, cudaStream_t s) {
  const size_t total = (size_t)M * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  int8_matmul_reduce<T><<<blocks, threads, 0, s>>>(static_cast<const float*>(part),
                                                   static_cast<const float*>(scale),
                                                   static_cast<T*>(out), M, N, ksplit);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) contiguous, bf16 (bf16 = 1: tensor cores) or float32; w_q (K, N)
// int8 and scale (N,) float32, contiguous; part a (ksplit, M, N) float32
// scratch; K split into ksplit chunks of kchunk rows (a multiple of 64 for
// bf16, 32 for float32).
extern "C" int dq_int8_matmul(const void* x, const void* w_q, const void* scale, void* part,
                              void* out, int M, int K, int N, int ksplit, int kchunk,
                              int bf16, int device, void* stream) {
  if (M < 1 || K < 1 || N < 1 || ksplit < 1 || (long long)ksplit * kchunk < K ||
      kchunk % (bf16 ? kTileK : kBlockK) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bf16 ? run_bf16(x, w_q, part, M, K, N, ksplit, kchunk, s)
             : run_f32(x, w_q, part, M, K, N, ksplit, kchunk, s);
  if (err != cudaSuccess) return (int)err;
  err = bf16 ? launch_reduce<__nv_bfloat16>(part, scale, out, M, N, ksplit, s)
             : launch_reduce<float>(part, scale, out, M, N, ksplit, s);
  return (int)err;
}
