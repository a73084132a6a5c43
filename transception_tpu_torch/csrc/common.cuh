// Shared device helpers of the port's kernels (bf16 rounding, warp
// reductions, WMMA tile products). Plain C interface, no PyTorch headers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

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

// Pointer to the 16x16 fragment at (r0, c0) of a matrix stored row- or
// column-major with leading dimension ld.
template <typename Layout>
__device__ __forceinline__ const bf16* frag_ptr(const bf16* p, int ld, int r0,
                                                int c0) {
  if constexpr (std::is_same<Layout, wmma::row_major>::value)
    return p + (size_t)r0 * ld + c0;
  else
    return p + (size_t)c0 * ld + r0;
}

// out[M x N] (fp32, row-major, ldo) = A[M x K] * B[K x N], bf16 operands,
// fp32 accumulation on the tensor cores. M, N, K multiples of 16; the
// 16x16 output tiles are spread over the block's warps. A's and B's
// fragment addresses must be 32-byte aligned.
template <typename LA, typename LB>
__device__ void gemm_tiles(const bf16* A, int lda, const bf16* B, int ldb,
                           int M, int N, int K, float* out, int ldo) {
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int mt = M >> 4, nt = N >> 4;
  for (int t = warp; t < mt * nt; t += nwarps) {
    const int i = (t % mt) << 4, j = (t / mt) << 4;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
      wmma::load_matrix_sync(a, frag_ptr<LA>(A, lda, i, k), lda);
      wmma::load_matrix_sync(b, frag_ptr<LB>(B, ldb, k, j), ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(out + (size_t)i * ldo + j, acc, ldo,
                            wmma::mem_row_major);
  }
}

// Dense layer on a row tile: out = A · Wᵀ with W a torch Linear weight
// (out_features, in_features) row-major in device memory.
__device__ __forceinline__ void dense_tile(const bf16* A, int lda,
                                           const bf16* W, int in_f, int M,
                                           int out_f, float* out, int ldo) {
  gemm_tiles<wmma::row_major, wmma::col_major>(A, lda, W, in_f, M, out_f,
                                               in_f, out, ldo);
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
