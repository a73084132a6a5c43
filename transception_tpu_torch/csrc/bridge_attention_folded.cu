// Folded bridge spatial attention, one head of d = 64:
//   out = bf16(res + bf16(proj(bf16(softmax(q·Kᵀ·scale)·V)))),
//   q = bf16(x·Wqᵀ + bq),  proj(a) = a·Wpᵀ + bp.
// Replaces transception_tpu/ops/pallas/bridge_attention_kernel.py:307
// bridge_attention_folded (rounding of its _folded_kernel, :78-133).
// Design notes: ops/kernels/bridge_attention.py.
//
// K3's block (csrc/bridge_attention.cu) with a prologue and an epilogue.
// One block of 4 warps per (64 stream rows, batch row):
//   prologue  the x tile -> shared memory (zero past N); q = x·Wqᵀ on the
//             tensor cores, + bq in fp32, rounded to bf16;
//   attention each warp owns 16 rows and walks K/V in 16-key chunks from
//             device memory: pass 1 the row max over all M keys, pass 2
//             e = exp(l − m), the unrounded e into the fp32 row sum and
//             bf16(e) into P·V; the (16, 64) output divided by the sum and
//             rounded into the (free) x tile;
//   epilogue  proj = attn·Wpᵀ on the tensor cores, + bp, rounded; + res in
//             fp32, rounded, stored for the rows below N only.
#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int WARPS = 4;
constexpr int ROWS = 16 * WARPS;

__global__ void __launch_bounds__(32 * WARPS)
bridge_attention_folded_kernel(const bf16* x, const bf16* res, const bf16* wq,
                               const float* bq, const bf16* k, const bf16* v,
                               const bf16* wp, const float* bp, bf16* out,
                               int N, int M, float scale) {
  __shared__ __align__(128) bf16 xs[ROWS * D];   // x tile, then attention out
  __shared__ __align__(128) bf16 qs[ROWS * D];
  __shared__ __align__(128) float lg[WARPS][16 * 16];
  __shared__ __align__(128) bf16 pb[WARPS][16 * 16];
  __shared__ __align__(128) float acc[ROWS * D];  // fp32 products
  const int b = blockIdx.y, n0 = blockIdx.x * ROWS;
  const bf16* xg = x + (size_t)b * N * D;
  const bf16* kg = k + (size_t)b * M * D;
  const bf16* vg = v + (size_t)b * M * D;

  // Prologue: x tile, 16 bytes per thread per step, zero past N.
  for (int i = threadIdx.x; i < ROWS * D / 8; i += blockDim.x) {
    const int row = i / (D / 8), cv = i % (D / 8);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (n0 + row < N)
      val = reinterpret_cast<const uint4*>(xg + (size_t)(n0 + row) * D)[cv];
    reinterpret_cast<uint4*>(xs)[i] = val;
  }
  __syncthreads();
  dense_tile(xs, D, wq, D, ROWS, D, acc, D);
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * D; i += blockDim.x)
    qs[i] = __float2bfloat16(acc[i] + bq[i % D]);
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
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> a;
    wmma::fill_fragment(a, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
      wmma::load_matrix_sync(kb, kg + (size_t)key0 * D + kk * 16, D);
      wmma::mma_sync(a, qa[kk], kb, a);
    }
    wmma::store_matrix_sync(lw, a, 16, wmma::mem_row_major);
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

  // The warp's (16, 64) output / sum, rounded, into its rows of xs.
  float* ow = acc + w * 16 * D;
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(ow + j * 16, o[j], D, wmma::mem_row_major);
  __syncwarp();
  {
    const int cb = (lane & 1) * (D / 2);
    bf16* aw = xs + (w * 16 + r) * D;
#pragma unroll 8
    for (int c = 0; c < D / 2; ++c)
      aw[cb + c] = __float2bfloat16(ow[r * D + cb + c] / sum);
  }
  __syncthreads();

  // Epilogue: proj = attn·Wpᵀ + bp, rounded; + res in fp32, rounded.
  dense_tile(xs, D, wp, D, ROWS, D, acc, D);
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * D; i += blockDim.x) {
    const int row = i / D, c = i % D, n = n0 + row;
    if (n >= N) continue;
    const size_t g = ((size_t)b * N + n) * D + c;
    const float pr = rbf(acc[i] + bp[c]);
    out[g] = __float2bfloat16(pr + __bfloat162float(res[g]));
  }
}

}  // namespace

extern "C" int bridge_attention_folded(const bf16* x, const bf16* res,
                                       const bf16* wq, const float* bq,
                                       const bf16* k, const bf16* v,
                                       const bf16* wp, const float* bp,
                                       bf16* out, int B, int N, int M,
                                       float scale, void* stream) {
  const dim3 grid((N + ROWS - 1) / ROWS, B);
  bridge_attention_folded_kernel<<<grid, 32 * WARPS, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      x, res, wq, bq, k, v, wp, bp, out, N, M, scale);
  return cudaGetLastError();
}
