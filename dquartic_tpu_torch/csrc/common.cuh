// Shared helpers for the dquartic_tpu_torch kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace dq {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// Rounds v to the matmul operand type of the compute dtype: bf16 operands
// for bf16 models, float32 otherwise (the JAX kernels' `cd` cast).
template <typename T>
__device__ __forceinline__ float round_cd(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float silu_grad(float v) {
  const float s = 1.0f / (1.0f + expf(-v));
  return s * (1.0f + v * (1.0f - s));
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

namespace {

// Opts a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The launch of grid (cl, B) in clusters of cl CTAs along x.
inline cudaLaunchConfig_t cluster_config(int cl, int B, int threads, int smem, cudaStream_t s,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launches `kernel` over grid (cl, B), a cluster of cl CTAs per row.
template <typename K, typename... Args>
cudaError_t launch_cluster(K kernel, int cl, int B, int threads, int smem, cudaStream_t s,
                           Args... args) {
  cudaError_t err = dq::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(cl, B, threads, smem, s, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

}  // namespace dq
