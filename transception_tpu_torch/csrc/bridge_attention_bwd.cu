// Backward of the bridge softmax cross-attention out = softmax(Q·Kᵀ·s)·V,
// d = 64: dQ, dK, dV given the cotangent G of out. Replaces
// transception_tpu/ops/pallas/bridge_attention_kernel.py:190
// bridge_softmax_attention_bwd (its _bwd_kernel, :136-186). Design notes:
// ops/kernels/bridge_attention.py.
//
// With E = exp(L − m) (L the scaled logits, m the row max), S = rowsum(E),
// dP = G·Vᵀ and c = rowsum(E∘dP)/S, T = E∘(dP − c):
//   dQ = (T·K)·s/S,  dK = Tᵀ·(Q·s/S),  dV = Eᵀ·(G/S).
// The (N, M) matrices never reach device memory.
//
// rows kernel: one block of 4 warps per (64 query rows, batch·head), each
//   warp 16 rows, three passes over K/V in 16-key chunks: the row max, then
//   S and rowsum(E∘dP), then T·K on the tensor cores. Writes dQ (bf16) and
//   the row statistics (m, S, c) for the column kernel.
// cols kernel: one block of up to 7 warps per (112 keys, row segment,
//   batch·head), each warp 16 keys with their dK/dV (16 x 64 each) in fp32
//   accumulators, walking the segment's query rows in 16-row chunks: it
//   recomputes L and dP for (16 rows, 16 keys), forms E and T from the saved
//   statistics, and adds Eᵀ·(G/S) and Tᵀ·(Q·s/S). Each segment writes its
//   own fp32 partial; sum_partials adds the segments in a fixed order and
//   rounds to bf16. No atomics: the result does not depend on scheduling.
// Query rows past N are zero-filled and masked (E = 0).
#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int RW = 4;             // warps of the rows kernel
constexpr int ROWS = 16 * RW;     // query rows per rows-kernel block
constexpr int CW = 7;             // warps of the cols kernel
constexpr int KEYS = 16 * CW;     // keys per cols-kernel block

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__global__ void __launch_bounds__(32 * RW)
rows_kernel(const bf16* q, const bf16* k, const bf16* v, const bf16* g,
            bf16* dq, float* stats, int N, int M, float scale) {
  __shared__ __align__(128) bf16 qs[ROWS * D];
  __shared__ __align__(128) bf16 gs[ROWS * D];
  __shared__ __align__(128) float lg[RW][256];
  __shared__ __align__(128) float dpb[RW][256];
  __shared__ __align__(128) bf16 tb[RW][256];
  __shared__ __align__(128) float ost[RW][16 * D];
  const int bh = blockIdx.y, n0 = blockIdx.x * ROWS;
  const bf16* qg = q + (size_t)bh * N * D;
  const bf16* gg = g + (size_t)bh * N * D;
  const bf16* kg = k + (size_t)bh * M * D;
  const bf16* vg = v + (size_t)bh * M * D;

  for (int i = threadIdx.x; i < ROWS * D / 8; i += blockDim.x) {
    const int row = i / (D / 8), cv = i % (D / 8);
    uint4 a = make_uint4(0, 0, 0, 0), b = a;
    if (n0 + row < N) {
      a = reinterpret_cast<const uint4*>(qg + (size_t)(n0 + row) * D)[cv];
      b = reinterpret_cast<const uint4*>(gg + (size_t)(n0 + row) * D)[cv];
    }
    reinterpret_cast<uint4*>(qs)[i] = a;
    reinterpret_cast<uint4*>(gs)[i] = b;
  }
  __syncthreads();

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 8;  // this lane's 8 entries
  FragA qa[D / 16], ga[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qa[kk], qs + w * 16 * D + kk * 16, D);
    wmma::load_matrix_sync(ga[kk], gs + w * 16 * D + kk * 16, D);
  }
  float* lw = lg[w];
  float* dw = dpb[w];
  bf16* tw = tb[w];

  // (16 rows, 16 keys) tile of A·Bᵀ with B = K or V rows key0..key0+15.
  auto tile = [&](const FragA* a, const bf16* b, int key0, float* out) {
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragBc kb;
      wmma::load_matrix_sync(kb, b + (size_t)key0 * D + kk * 16, D);
      wmma::mma_sync(acc, a[kk], kb, acc);
    }
    wmma::store_matrix_sync(out, acc, 16, wmma::mem_row_major);
  };

  // Pass 1: row max of the scaled logits.
  float mx = -INFINITY;
  for (int key0 = 0; key0 < M; key0 += 16) {
    tile(qa, kg, key0, lw);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 8; ++c) mx = fmaxf(mx, lw[r * 16 + c0 + c] * scale);
    __syncwarp();
  }
  mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));

  // Pass 2: S = rowsum(E) and rowsum(E∘dP).
  float sum = 0.0f, edp = 0.0f;
  for (int key0 = 0; key0 < M; key0 += 16) {
    tile(qa, kg, key0, lw);
    tile(ga, vg, key0, dw);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float e = expf(lw[r * 16 + c0 + c] * scale - mx);
      sum += e;
      edp += e * dw[r * 16 + c0 + c];
    }
    __syncwarp();
  }
  sum += __shfl_xor_sync(FULL_MASK, sum, 1);
  edp += __shfl_xor_sync(FULL_MASK, edp, 1);
  const float cc = edp / sum;

  // Pass 3: dQ = (T·K)·s/S with T = E∘(dP − c), T rounded to bf16.
  Acc o[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(o[j], 0.0f);
  for (int key0 = 0; key0 < M; key0 += 16) {
    tile(qa, kg, key0, lw);
    tile(ga, vg, key0, dw);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int e_i = r * 16 + c0 + c;
      const float e = expf(lw[e_i] * scale - mx);
      tw[e_i] = __float2bfloat16(e * (dw[e_i] - cc));
    }
    __syncwarp();
    FragA ta;
    wmma::load_matrix_sync(ta, tw, 16);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      FragBr kb;
      wmma::load_matrix_sync(kb, kg + (size_t)key0 * D + j * 16, D);
      wmma::mma_sync(o[j], ta, kb, o[j]);
    }
    __syncwarp();
  }

  float* ow = ost[w];
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(ow + j * 16, o[j], D, wmma::mem_row_major);
  __syncwarp();
  const int n = n0 + w * 16 + r;
  if (n < N) {
    const float f = scale / sum;
    bf16* og = dq + ((size_t)bh * N + n) * D;
    const int cb = (lane & 1) * (D / 2);
#pragma unroll 8
    for (int c = 0; c < D / 2; ++c)
      og[cb + c] = __float2bfloat16(ow[r * D + cb + c] * f);
    if ((lane & 1) == 0) {
      float* st = stats + ((size_t)bh * N + n) * 4;
      st[0] = mx;
      st[1] = sum;
      st[2] = cc;
    }
  }
}

__global__ void __launch_bounds__(32 * CW)
cols_kernel(const bf16* q, const bf16* k, const bf16* v, const bf16* g,
            const float* stats, float* dkp, float* dvp, int BH, int N,
            int M, float scale, int seg_rows) {
  __shared__ __align__(128) bf16 qc[16 * D];   // Q chunk
  __shared__ __align__(128) bf16 gc[16 * D];   // G chunk
  __shared__ __align__(128) bf16 qsc[16 * D];  // Q·s/S
  __shared__ __align__(128) bf16 gsc[16 * D];  // G/S
  __shared__ float rm[16], rc[16];
  __shared__ __align__(128) float lg[CW][256];
  __shared__ __align__(128) float dpb[CW][256];
  __shared__ __align__(128) bf16 eb[CW][256];
  __shared__ __align__(128) bf16 tb[CW][256];
  const int bh = blockIdx.z, seg = blockIdx.y;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key0 = blockIdx.x * KEYS + w * 16;
  const bool active = key0 < M;
  const bf16* qg = q + (size_t)bh * N * D;
  const bf16* gg = g + (size_t)bh * N * D;
  const float* sg = stats + (size_t)bh * N * 4;
  const int row_begin = seg * seg_rows;
  const int row_end = min(N, row_begin + seg_rows);

  FragBc kb[D / 16], vb[D / 16];
  Acc dk[D / 16], dv[D / 16];
  if (active) {
    const bf16* kg = k + ((size_t)bh * M + key0) * D;
    const bf16* vg = v + ((size_t)bh * M + key0) * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::load_matrix_sync(kb[kk], kg + kk * 16, D);
      wmma::load_matrix_sync(vb[kk], vg + kk * 16, D);
      wmma::fill_fragment(dk[kk], 0.0f);
      wmma::fill_fragment(dv[kk], 0.0f);
    }
  }
  const int r = lane >> 1, c0 = (lane & 1) * 8;

  for (int n0 = row_begin; n0 < row_end; n0 += 16) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < 2 * 16 * D / 8; i += blockDim.x) {
      const int which = i / (16 * D / 8), j = i % (16 * D / 8);
      const int row = j / (D / 8), cv = j % (D / 8), n = n0 + row;
      const bf16* src = which ? gg : qg;
      bf16* raw = which ? gc : qc;
      bf16* scl = which ? gsc : qsc;
      uint4 val = make_uint4(0, 0, 0, 0);
      float f = 0.0f;
      if (n < N) {
        val = reinterpret_cast<const uint4*>(src + (size_t)n * D)[cv];
        f = (which ? 1.0f : scale) / sg[(size_t)n * 4 + 1];
      }
      reinterpret_cast<uint4*>(raw)[j] = val;
      const bf16* e8 = reinterpret_cast<const bf16*>(&val);
      uint4 out;
      bf16* o8 = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int t = 0; t < 8; ++t)
        o8[t] = __float2bfloat16(__bfloat162float(e8[t]) * f);
      reinterpret_cast<uint4*>(scl)[j] = out;
    }
    if (threadIdx.x < 16) {
      const int n = n0 + threadIdx.x;
      rm[threadIdx.x] = n < N ? sg[(size_t)n * 4] : 0.0f;
      rc[threadIdx.x] = n < N ? sg[(size_t)n * 4 + 2] : 0.0f;
    }
    __syncthreads();
    if (!active) continue;

    float* lw = lg[w];
    float* dw = dpb[w];
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA a;
      wmma::load_matrix_sync(a, qc + kk * 16, D);
      wmma::mma_sync(acc, a, kb[kk], acc);
    }
    wmma::store_matrix_sync(lw, acc, 16, wmma::mem_row_major);
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA a;
      wmma::load_matrix_sync(a, gc + kk * 16, D);
      wmma::mma_sync(acc, a, vb[kk], acc);
    }
    wmma::store_matrix_sync(dw, acc, 16, wmma::mem_row_major);
    __syncwarp();
    const bool valid = n0 + r < N;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int e_i = r * 16 + c0 + c;
      const float e = valid ? expf(lw[e_i] * scale - rm[r]) : 0.0f;
      eb[w][e_i] = __float2bfloat16(e);
      tb[w][e_i] = __float2bfloat16(e * (dw[e_i] - rc[r]));
    }
    __syncwarp();
    FragAc ea, ta;  // Eᵀ, Tᵀ: (16 keys, 16 rows)
    wmma::load_matrix_sync(ea, eb[w], 16);
    wmma::load_matrix_sync(ta, tb[w], 16);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      FragBr b;
      wmma::load_matrix_sync(b, gsc + j * 16, D);
      wmma::mma_sync(dv[j], ea, b, dv[j]);
      wmma::load_matrix_sync(b, qsc + j * 16, D);
      wmma::mma_sync(dk[j], ta, b, dk[j]);
    }
  }

  if (active) {
    const size_t base = (((size_t)seg * BH + bh) * M + key0) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::store_matrix_sync(dkp + base + j * 16, dk[j], D,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(dvp + base + j * 16, dv[j], D,
                              wmma::mem_row_major);
    }
  }
}

}  // namespace

// q, g, dq: (BH, N, 64) bf16; k, v, dk, dv: (BH, M, 64) bf16. Scratch:
// stats (BH, N, 4) fp32, dkp/dvp (nseg, BH, M, 64) fp32.
extern "C" int bridge_attention_bwd(const bf16* q, const bf16* k,
                                    const bf16* v, const bf16* g, bf16* dq,
                                    bf16* dk, bf16* dv, float* stats,
                                    float* dkp, float* dvp, int BH, int N,
                                    int M, float scale, int nseg,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rows_kernel<<<dim3((N + ROWS - 1) / ROWS, BH), 32 * RW, 0, st>>>(
      q, k, v, g, dq, stats, N, M, scale);
  cudaError_t e = cudaGetLastError();
  if (e) return e;
  const int chunks = (N + 15) / 16;
  const int seg_rows = (chunks + nseg - 1) / nseg * 16;
  const int warps = min(CW, M / 16);
  cols_kernel<<<dim3((M + KEYS - 1) / KEYS, nseg, BH), 32 * warps, 0, st>>>(
      q, k, v, g, stats, dkp, dvp, BH, N, M, scale, seg_rows);
  if ((e = cudaGetLastError())) return e;
  const size_t n = (size_t)BH * M * D;
  sum_partials<bf16><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      dkp, nseg, n, dk);
  if ((e = cudaGetLastError())) return e;
  sum_partials<bf16><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      dvp, nseg, n, dv);
  return cudaGetLastError();
}
