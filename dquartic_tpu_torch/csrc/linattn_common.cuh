// The weights, the slices and the cluster launches of the linear-attention
// kernels, shared by K1 (linear_attention.cu), K4 (linear_attention_bwd.cu),
// K6 (linear_attention_sp.cu) and K8 (linear_attention_rows.cu): the weights
// as the caller holds them, a CTA's slice of a (B, C, N) tensor staged in
// shared memory or read from device memory, the cluster size a launch takes
// (choose_cluster) or the CTAs a row of a launch without a cluster
// (choose_grid), and the host entry points through which K6 runs K1's and
// K4's cluster kernels in their sequence-parallel modes.
#pragma once

#include <map>
#include <mutex>
#include <tuple>

#include "mma.cuh"

namespace dq {

// The op's weights as the caller holds them: w_qkv (C, 3H), w_out (H, C),
// b_out, g, g_pre (C), each float32 or bf16 (bit i of `bf16`, in this
// order), read through their strides. A launch that reads only some of them
// (K6a: w_qkv and g_pre) leaves the others null.
struct Weights {
  const void* wqkv;
  long long wqkv_c, wqkv_h;
  const void* wout;
  long long wout_h, wout_c;
  const void* b_out;
  long long b_out_c;
  const void* g;
  long long g_c;
  const void* g_pre;
  long long g_pre_c;
  int bf16;
};

// Their gradients as the caller allocated them, in the same layout, written
// through their strides.
struct Grads {
  void* wqkv;
  long long wqkv_c, wqkv_h;
  void* wout;
  long long wout_h, wout_c;
  void* b_out;
  long long b_out_c;
  void* g;
  long long g_c;
  void* g_pre;
  long long g_pre_c;
  int bf16;
};

// K6's launches (stats: (B, H, C + 1) float32 [A | s] per row; z: (B, H, C)
// float32; rowpart, ctapart: K4's partials, see linear_attention_bwd.cu).
// K6a, p and xh rounded to x's dtype (bf16), or float32 x: K1's phase 0.
cudaError_t linattn_stats(const void* x, float* stats, const Weights& w, int B, int C, int N,
                          int heads, bool bf16, cudaStream_t s);
// K6b, from the summed stats: y = RMSNorm_g(M q + b_out) + x on the rank's
// columns, M folded from the stats: K1's apply.
cudaError_t linattn_apply(const void* x, void* y, const float* stats, const Weights& w, int B,
                          int C, int N, int heads, bool bf16, cudaStream_t s);
// K6a, bf16 x with float32 operands (the backward's recompute): K4's pass 0.
cudaError_t linattn_bwd_stats(const void* x, float* stats, const Weights& w, int B, int C,
                              int N, int heads, cudaStream_t s);
// K6c, launch 1: from the summed stats, the rank's Z and each row's db, dg.
cudaError_t linattn_sp_bwd_z(const void* x, const void* dy, const Weights& w,
                             const float* stats, float* z, float* rowpart, int B, int C, int N,
                             int heads, bool bf16, cudaStream_t s);
// K6c, launches 2 and 3: from the summed stats and Z, dx and the rank's
// weight gradients (dW_out and dW_v from its own stats, stats_local).
cudaError_t linattn_sp_bwd_x(const void* x, const void* dy, void* dx, const Weights& w,
                             const Grads& g, const float* stats, const float* stats_local,
                             const float* z, float* rowpart, float* ctapart, int B, int C,
                             int N, int heads, bool bf16, cudaStream_t s);

}  // namespace dq

namespace {

using dq::cluster_config;
using dq::Grads;
using dq::launch_cluster;
using dq::Weights;

constexpr int kMaxC = 16;
constexpr int kMaxH = 256;
constexpr int kDimHead = 32;
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kColsPerCta = 256;  // fewest columns a CTA is given when a cluster has more than one
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ld(const void* p, long long i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// v = the CB float32 values at src (16-byte aligned, CB a multiple of 4)
template <int CB>
__device__ __forceinline__ void load_row(const float* src, float (&v)[CB]) {
#pragma unroll
  for (int c = 0; c < CB; c += 4) {
    const float4 q = *reinterpret_cast<const float4*>(src + c);
    v[c] = q.x, v[c + 1] = q.y, v[c + 2] = q.z, v[c + 3] = q.w;
  }
}

// acc + w . v, the products added in channel order
template <int CB>
__device__ __forceinline__ float dot(const float (&w)[CB], const float (&v)[CB],
                                     float acc = 0.0f) {
#pragma unroll
  for (int c = 0; c < CB; ++c) acc = fmaf(w[c], v[c], acc);
  return acc;
}

// x of this CTA's slice: staged rows in shared memory, or device memory.
template <typename T>
struct Slice {
  const char* xs;   // staged row 0 (already shifted to the source's phase)
  int row_bytes;
  const T* xg;      // x[b, 0, nbeg] in device memory
  long long N;
  bool staged;
  __device__ __forceinline__ float at(int c, int j) const {
    return dq::to_f32(staged ? reinterpret_cast<const T*>(xs + c * row_bytes)[j]
                             : xg[c * N + j]);
  }
};

// Copies `cols` elements of each of the C rows (stride N) at src into
// shared rows of stride row_bytes at dst, which has src's phase mod 16:
// 16-byte cp.async for the aligned middle, plain copies at the ends.
template <typename T>
__device__ void stage_rows(char* dst, int row_bytes, const T* src, long long N, int C,
                           int cols) {
  constexpr int kVec = 16 / sizeof(T);
  for (int c = 0; c < C; ++c) {
    const T* s = src + c * N;
    T* d = reinterpret_cast<T*>(dst + c * row_bytes);
    const int head = min(cols, (int)(((16 - (reinterpret_cast<uintptr_t>(s) & 15)) & 15) /
                                     sizeof(T)));
    const int nvec = (cols - head) / kVec;
    for (int i = threadIdx.x; i < nvec; i += blockDim.x)
      cp_async16(d + head + i * kVec, s + head + i * kVec);
    const int tail0 = head + nvec * kVec;
    for (int i = threadIdx.x; i < head + cols - tail0; i += blockDim.x) {
      const int j = i < head ? i : tail0 + i - head;
      d[j] = s[j];
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// CTAs per cluster for a launch of `kernel` over B rows of N columns: the
// fewest waves of clusters the card holds at once times the columns of a
// CTA; among equals, the smaller cluster. make(cl) is the launch's plan at
// cl CTAs a cluster (its `chunk` of columns a CTA and its shared `bytes`).
// Cached per kernel and shape (the occupancy queries take host time).
template <typename P, typename K, typename Make>
cudaError_t choose_cluster(K kernel, int threads, int B, int C, int N, int H, Make make,
                           P* out) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int, int>, P> cache;
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel), B, C, N, H);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  long long best = -1;
  for (int cl = 1; cl <= kMaxCluster; ++cl) {
    if (cl > 1 && N / cl < kColsPerCta) break;
    const P p = make(cl);
    cudaError_t err = dq::allow_smem(kernel, p.bytes);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(cl, B, threads, p.bytes, nullptr, attr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) continue;
    const long long cost = (long long)dq::ceil_div(B, clusters) * p.chunk;
    if (best < 0 || cost < best) best = cost, *out = p;
  }
  if (best < 0) return cudaErrorInvalidConfiguration;
  cache[key] = *out;
  return cudaSuccess;
}

// CTAs a row of a launch without a cluster (K6b and K9's apply, whose CTAs
// share nothing): the g of the fewest columns on the fullest SM, the grid's
// B g CTAs spread evenly over the card's SMs, each CTA counted kColsPerCta /
// 2 columns more for what it does once (the weights, M); among equals, the
// smaller g. A CTA has at least kColsPerCta / 2 columns, and
// the grid fits the card at once where it can. Cached per kernel and shape.
template <typename P, typename K, typename Make>
cudaError_t choose_grid(K kernel, int threads, int B, int C, int N, int H, Make make, P* out) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int, int>, P> cache;
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel), B, C, N, H);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int most = std::max(1, std::min(dq::ceil_div(N, kColsPerCta / 2), 65535));
  long long best = -1;
  for (int g = 1; g <= most; ++g) {
    const P p = make(g);
    err = dq::allow_smem(kernel, p.bytes);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, p.bytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) continue;
    if (g > 1 && (long long)B * g > (long long)sms * per_sm) break;  // past one wave
    const long long cost =
        (long long)dq::ceil_div(B * g, sms) * (p.chunk + kColsPerCta / 2);
    if (best < 0 || cost < best) best = cost, *out = p;
  }
  if (best < 0) return cudaErrorInvalidConfiguration;
  cache[key] = *out;
  return cudaSuccess;
}

inline bool linattn_valid(int B, int C, int N, int heads) {
  const int H = heads * kDimHead;
  return B >= 1 && B <= 65535 && C >= 1 && C <= kMaxC && N >= 1 && H >= kDimHead && H <= kMaxH;
}

}  // namespace
