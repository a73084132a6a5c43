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

// The element type E of a kernel's activations and weights: bf16, or fp32
// for the fp32 forms of the forward kernels. At fp32 every rounding point
// of the bf16 path (`.astype(dt)` in the Pallas kernels) is the identity.
template <typename E>
constexpr bool IS_F32 = std::is_same<E, float>::value;
// Elements of a 16-byte chunk (a cp.async or vector access) and of a
// 128-byte swizzled panel row (one staged product step's depth).
template <typename E>
constexpr int EPC = 16 / (int)sizeof(E);
template <typename E>
constexpr int KD = 128 / (int)sizeof(E);

// x rounded to E and back.
template <typename E>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (IS_F32<E>)
    return x;
  else
    return rbf(x);
}

__device__ __forceinline__ float tof(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float tof(float v) { return v; }

template <typename E>
__device__ __forceinline__ E fromf(float x) {
  if constexpr (IS_F32<E>)
    return x;
  else
    return __float2bfloat16(x);
}

// Two neighbouring elements as a register pair: __nv_bfloat162 or float2.
template <typename E>
using Pair = typename std::conditional<IS_F32<E>, float2,
                                       __nv_bfloat162>::type;

__device__ __forceinline__ float2 f2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}
__device__ __forceinline__ float2 f2(float2 v) { return v; }

// (a, b) rounded to E as a pair.
template <typename E>
__device__ __forceinline__ Pair<E> mk2(float a, float b) {
  if constexpr (IS_F32<E>)
    return make_float2(a, b);
  else
    return __floats2bfloat162_rn(a, b);
}

// The pair of elements at p (4- or 8-byte aligned) in fp32.
template <typename E>
__device__ __forceinline__ float2 ld2(const E* p) {
  return f2(*reinterpret_cast<const Pair<E>*>(p));
}

template <typename E>
__device__ __forceinline__ void st2(E* p, float a, float b) {
  *reinterpret_cast<Pair<E>*>(p) = mk2<E>(a, b);
}

// The EPC<E> elements of a 16-byte chunk in fp32, and back (rounded to E).
template <typename E>
__device__ __forceinline__ void unpack(const uint4& u, float* v) {
  if constexpr (IS_F32<E>) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  } else {
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(p2[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  }
}

template <typename E>
__device__ __forceinline__ uint4 pack16(const float* v) {
  uint4 u;
  if constexpr (IS_F32<E>) {
    u = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                   __float_as_uint(v[2]), __float_as_uint(v[3]));
  } else {
    __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p2[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  }
  return u;
}

// Eight consecutive elements at p (16-byte aligned) in fp32: one 16-byte
// load at bf16, two at fp32.
template <typename E>
__device__ __forceinline__ void ld8(const E* p, float (&v)[8]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 8 / EPC<E>; ++i) unpack<E>(q[i], v + i * EPC<E>);
}

template <typename E>
__device__ __forceinline__ void st8(E* p, const float (&v)[8]) {
  uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int i = 0; i < 8 / EPC<E>; ++i) q[i] = pack16<E>(v + i * EPC<E>);
}

// Shared-memory loads by address (the staged tiles are addressed as
// 32-bit shared-window offsets).
__device__ __forceinline__ float lds32(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ float2 lds64(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0,%1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a));
  return v;
}

__device__ __forceinline__ float4 lds128(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
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
