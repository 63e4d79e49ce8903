// K3: int8 weight-streaming matmul, out = (x @ w_q) * scale[col].
//
// Replaces the TPU kernel dquartic_tpu/ops/int8_matmul.py:int8_matmul
// (_matmul_kernel). At the main path's shape (M = b*rt = 34, K = 30000,
// N = 10000) one call reads 300 MB of int8 weights and only ~2 MB of
// everything else, so it is bound by device-memory bandwidth (>= 0.09 ms at
// 3.35 TB/s), and at 34 rows the float32 multiply-adds (10.2 G per call)
// come next. Design:
//   * CTAs tile N by 128 columns and split K, about four CTAs per SM, so
//     the whole card streams weights at once;
//   * each K step stages a 32 x 128 int8 weight tile in shared memory with
//     one 16-byte coalesced load per thread, and the matching x slice;
//   * a warp owns R rows of x and a lane 4 columns: every weight byte is
//     read from device memory once per CTA and used for all its rows;
//   * partial sums go to a float32 (ksplit, M, N) scratch and a second
//     kernel sums them in a fixed order and applies the scale once, so the
//     result is deterministic (no float atomics).
// int8 values and bf16 x are exact in float32, so the products equal the
// bf16 x bf16 -> f32 products of the TPU kernel; only the summation order
// differs.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBlockN = 128;  // 32 lanes x 4 columns
constexpr int kBlockK = 32;

template <typename T, int R>
__global__ void __launch_bounds__(kThreads) int8_matmul_partial(
    const T* __restrict__ x, const int8_t* __restrict__ w, float* __restrict__ part,
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
      xs[m][kk] = (m < mc && k < kend) ? dq::to_f32(x[(size_t)(m0 + m) * K + k]) : 0.f;
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

template <typename T, int R>
cudaError_t launch_partial(const void* x, const void* w, void* part, int M, int K, int N,
                           int ksplit, int kchunk, cudaStream_t stream) {
  dim3 grid(dq::ceil_div(N, kBlockN), ksplit, dq::ceil_div(M, R * kWarps));
  int8_matmul_partial<T, R><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), static_cast<float*>(part),
      M, K, N, kchunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* x, const void* w, const void* scale, void* part, void* out,
                int M, int K, int N, int ksplit, int kchunk, cudaStream_t stream) {
  // R rows per warp: the fewest that cover M in one chunk, at most 8
  const int rows = std::min(8, dq::ceil_div(M, kWarps));
  cudaError_t err;
  switch (rows) {
    case 1: err = launch_partial<T, 1>(x, w, part, M, K, N, ksplit, kchunk, stream); break;
    case 2: err = launch_partial<T, 2>(x, w, part, M, K, N, ksplit, kchunk, stream); break;
    case 3: err = launch_partial<T, 3>(x, w, part, M, K, N, ksplit, kchunk, stream); break;
    case 4: err = launch_partial<T, 4>(x, w, part, M, K, N, ksplit, kchunk, stream); break;
    case 5: err = launch_partial<T, 5>(x, w, part, M, K, N, ksplit, kchunk, stream); break;
    case 6: err = launch_partial<T, 6>(x, w, part, M, K, N, ksplit, kchunk, stream); break;
    case 7: err = launch_partial<T, 7>(x, w, part, M, K, N, ksplit, kchunk, stream); break;
    default: err = launch_partial<T, 8>(x, w, part, M, K, N, ksplit, kchunk, stream); break;
  }
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)M * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  int8_matmul_reduce<T><<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(scale),
      static_cast<T*>(out), M, N, ksplit);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dq_int8_matmul(const void* x, const void* w_q, const void* scale, void* part,
                              void* out, int M, int K, int N, int ksplit, int kchunk,
                              int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bf16 ? run<__nv_bfloat16>(x, w_q, scale, part, out, M, K, N, ksplit, kchunk, s)
             : run<float>(x, w_q, scale, part, out, M, K, N, ksplit, kchunk, s);
  return (int)err;
}
