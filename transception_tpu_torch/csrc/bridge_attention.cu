// Bridge softmax cross-attention: out = softmax(Q·Kᵀ·scale) · V, d = 64.
// Replaces transception_tpu/ops/pallas/bridge_attention_kernel.py:256
// bridge_softmax_attention (rounding of its _kernel, :59-75). Design
// notes: ops/kernels/bridge_attention.py.
//
// One block of 4 warps per (64 query rows, batch·head); each warp owns 16
// rows and walks K/V in 16-key chunks straight from device memory (K/V of
// one batch row, 2 x 100 KB, stay in L2 across its blocks). Pass 1 finds
// the row max over all M keys; pass 2 recomputes the logits, forms
// e = exp(l − m), adds the unrounded e into the fp32 row sum and the
// bf16-rounded e into P·V on the tensor cores; the (16, 64) output is
// divided by the row sum at the end. Query rows past N are zero-filled
// on load and never stored.
#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int WARPS = 4;
constexpr int ROWS = 16 * WARPS;

__global__ void __launch_bounds__(32 * WARPS)
bridge_attention_kernel(const bf16* q, const bf16* k, const bf16* v,
                        bf16* out, int N, int M, float scale) {
  __shared__ __align__(128) bf16 qs[ROWS * D];
  __shared__ __align__(128) float lg[WARPS][16 * 16];
  __shared__ __align__(128) bf16 pb[WARPS][16 * 16];
  __shared__ __align__(128) float ost[WARPS][16 * D];
  const int bh = blockIdx.y, n0 = blockIdx.x * ROWS;
  const bf16* qg = q + (size_t)bh * N * D;
  const bf16* kg = k + (size_t)bh * M * D;
  const bf16* vg = v + (size_t)bh * M * D;

  // Q tile -> shared memory, 16 bytes per thread per step, zero past N.
  for (int i = threadIdx.x; i < ROWS * D / 8; i += blockDim.x) {
    const int row = i / (D / 8), cv = i % (D / 8);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (n0 + row < N)
      val = reinterpret_cast<const uint4*>(qg + (size_t)(n0 + row) * D)[cv];
    reinterpret_cast<uint4*>(qs)[i] = val;
  }
  __syncthreads();

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 8;  // this lane's 8 logits
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], qs + w * 16 * D + kk * 16, D);
  float* lw = lg[w];
  bf16* pw = pb[w];

  auto logits = [&](int key0) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
      wmma::load_matrix_sync(kb, kg + (size_t)key0 * D + kk * 16, D);
      wmma::mma_sync(acc, qa[kk], kb, acc);
    }
    wmma::store_matrix_sync(lw, acc, 16, wmma::mem_row_major);
    __syncwarp();
  };

  // Pass 1: row max of the scaled logits over all keys.
  float mx = -INFINITY;
  for (int key0 = 0; key0 < M; key0 += 16) {
    logits(key0);
#pragma unroll
    for (int c = 0; c < 8; ++c) mx = fmaxf(mx, lw[r * 16 + c0 + c] * scale);
    __syncwarp();
  }
  mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));

  // Pass 2: e = exp(l − m); fp32 row sum of e; P·V with P = bf16(e).
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(o[j], 0.0f);
  float sum = 0.0f;
  for (int key0 = 0; key0 < M; key0 += 16) {
    logits(key0);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float e = expf(lw[r * 16 + c0 + c] * scale - mx);
      sum += e;
      pw[r * 16 + c0 + c] = __float2bfloat16(e);
    }
    __syncwarp();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
    wmma::load_matrix_sync(pa, pw, 16);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
      wmma::load_matrix_sync(vb, vg + (size_t)key0 * D + j * 16, D);
      wmma::mma_sync(o[j], pa, vb, o[j]);
    }
    __syncwarp();
  }
  sum += __shfl_xor_sync(FULL_MASK, sum, 1);

  float* ow = ost[w];
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(ow + j * 16, o[j], D, wmma::mem_row_major);
  __syncwarp();
  const int n = n0 + w * 16 + r;
  if (n < N) {
    bf16* og = out + ((size_t)bh * N + n) * D;
    const int cb = (lane & 1) * (D / 2);
#pragma unroll 8
    for (int c = 0; c < D / 2; ++c)
      og[cb + c] = __float2bfloat16(ow[r * D + cb + c] / sum);
  }
}

}  // namespace

extern "C" int bridge_attention(const bf16* q, const bf16* k, const bf16* v,
                                bf16* out, int BH, int N, int M, float scale,
                                void* stream) {
  const dim3 grid((N + ROWS - 1) / ROWS, BH);
  bridge_attention_kernel<<<grid, 32 * WARPS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, N, M, scale);
  return cudaGetLastError();
}
