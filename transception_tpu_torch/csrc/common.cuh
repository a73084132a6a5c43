// Shared device helpers of the port's kernels (bf16 rounding, warp
// reductions, fixed-order partial sums, the shared-memory opt-in). Plain C
// interface, no PyTorch headers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

using bf16 = __nv_bfloat16;

#define FULL_MASK 0xffffffffu

// Round an fp32 value to bf16 and back (the TPU kernels' `.astype(dt)`).
__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

// out[i] = Σ_p part[p·n + i] over P per-block partials, in a fixed order
// (the backward kernels' cross-block reduction: deterministic, no
// atomics), stored as T (float or bf16).
template <typename T>
__global__ void sum_partials(const float* part, int P, size_t n, T* out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int p = 0; p < P; ++p) s += part[(size_t)p * n + i];
  if constexpr (std::is_same<T, bf16>::value)
    out[i] = __float2bfloat16(s);
  else
    out[i] = s;
}

// Opt kernel fn into `bytes` of dynamic shared memory. Each (kernel,
// device) asks the CUDA runtime once for the most it has needed (launches
// come from one host thread), so a launch costs no attribute call after
// the first.
inline cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  constexpr int SLOTS = 128;
  static const void* fns[SLOTS];
  static int devs[SLOTS];
  static size_t granted[SLOTS];
  static int used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e) return e;
  int i = 0;
  while (i < used && (fns[i] != fn || devs[i] != dev)) ++i;
  if (i < used && granted[i] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e || i == SLOTS) return e;
  fns[i] = fn;
  devs[i] = dev;
  granted[i] = bytes;
  if (i == used) ++used;
  return cudaSuccess;
}
