// Linear attention per (batch, head):
//   out = bf16(scale · Q' · bf16(bf16(softmax_N(K))ᵀ · V)),
//   Q' = bf16(softmax_d(Q)) or Q.
// Replaces transception_tpu/ops/pallas/linear_attention_kernel.py:235
// linear_attention (rounding of its _kernel, :203-231; the scale of the
// factorized attention applied to the fp32 product before the one rounding,
// as ops/attention.py:68-73 does). Design notes:
// ops/kernels/linear_attention.py.
//
// Four launches on one stream; N is cut into S segments so that short and
// long sequences alike fill the card:
//   la_stats  per (segment, batch·head): online column max and sum of
//             exp(K - max) over the segment's rows
//   la_ctx    per (64 x 64 context tile, segment, batch·head): combine the
//             statistics, Ks = bf16(exp(K - m) / S) and V in 64-row chunks
//             through shared memory, the tile's fp32 partial of Ksᵀ·V on
//             the tensor cores
//   sum_partials  the S partials added in a fixed order, rounded to bf16
//   la_out    per (64 rows, 64 output columns, batch·head): Q' rows and the
//             context's column tile in shared memory, Q'·ctx on the tensor
//             cores, scale, one rounding
// The tensor cores take 16-wide operands: head dims that are no multiple
// of 16 (8, 40) are zero-padded in shared memory, which adds exact zeros.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int TK = 64;        // context tile: keys' channels
constexpr int TV = 64;        // context / output tile: values' channels
constexpr int RC = 64;        // rows per chunk of la_ctx
constexpr int RO = 64;        // rows per block of la_out
// 16 x 16 fragments of a 64 x 64 tile, 2 per warp: fragment f covers rows
// (f % 4)·16.. and columns (f / 4)·16.. of the tile.
constexpr int FRAGS = (64 / 16) * (64 / 16) / WARPS;

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ int pad16(int n) { return (n + 15) & ~15; }

__global__ void __launch_bounds__(THREADS)
la_stats(const bf16* k, float2* part, int N, int dk, int rps) {
  __shared__ float sm[WARPS][32], sl[WARPS][32];
  const int seg = blockIdx.x, bh = blockIdx.y;
  const int n0 = seg * rps, n1 = min(N, n0 + rps);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* kb = k + (size_t)bh * N * dk;
  for (int c0 = 0; c0 < dk; c0 += 32) {
    const int j = c0 + lane;
    float m = -INFINITY, l = 0.0f;
    if (j < dk) {
      for (int n = n0 + w; n < n1; n += WARPS) {
        const float x = __bfloat162float(kb[(size_t)n * dk + j]);
        if (x > m) {
          l = l * expf(m - x) + 1.0f;
          m = x;
        } else {
          l += expf(x - m);
        }
      }
    }
    sm[w][lane] = m;
    sl[w][lane] = l;
    __syncthreads();
    if (w == 0 && j < dk) {
      float mm = -INFINITY;
      for (int i = 0; i < WARPS; ++i) mm = fmaxf(mm, sm[i][lane]);
      float ll = 0.0f;
      for (int i = 0; i < WARPS; ++i)
        if (sm[i][lane] > -INFINITY) ll += sl[i][lane] * expf(sm[i][lane] - mm);
      part[((size_t)seg * gridDim.y + bh) * dk + j] = make_float2(mm, ll);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
la_ctx(const bf16* k, const bf16* v, const float2* part, float* pctx, int N,
       int dk, int dv, int rps) {
  __shared__ __align__(128) bf16 ks[RC * TK];   // Ks chunk, rows x keys
  __shared__ __align__(128) bf16 vs[RC * TV];   // V chunk, rows x values
  __shared__ __align__(128) float scr[WARPS][256];
  __shared__ float colm[TK], cols[TK];
  const int tiles_v = (dv + TV - 1) / TV;
  const int a0 = (blockIdx.x / tiles_v) * TK, c0 = (blockIdx.x % tiles_v) * TV;
  const int seg = blockIdx.y, bh = blockIdx.z, S = gridDim.y, BH = gridDim.z;
  const int n0 = seg * rps, n1 = min(N, n0 + rps);
  const bf16* kb = k + (size_t)bh * N * dk;
  const bf16* vb = v + (size_t)bh * N * dv;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Column softmax statistics over all N, from the S segment partials in a
  // fixed order.
  for (int a = threadIdx.x; a < TK; a += blockDim.x) {
    float m = -INFINITY, l = 0.0f;
    if (a0 + a < dk) {
      for (int s = 0; s < S; ++s)
        m = fmaxf(m, part[((size_t)s * BH + bh) * dk + a0 + a].x);
      for (int s = 0; s < S; ++s) {
        const float2 p = part[((size_t)s * BH + bh) * dk + a0 + a];
        if (p.x > -INFINITY) l += p.y * expf(p.x - m);
      }
    }
    colm[a] = m;
    cols[a] = l;
  }
  // This warp's fragments; those wholly outside the (dk, dv) context do
  // nothing (the zero padding of a head dim under 16 stays inside one).
  Acc acc[FRAGS];
  bool live[FRAGS];
#pragma unroll
  for (int f = 0; f < FRAGS; ++f) {
    const int fr = w + f * WARPS;
    live[f] = a0 + (fr % 4) * 16 < dk && c0 + (fr / 4) * 16 < dv;
    wmma::fill_fragment(acc[f], 0.0f);
  }
  for (int r0 = n0; r0 < n1; r0 += RC) {
    __syncthreads();
    for (int i = threadIdx.x; i < RC * TK; i += blockDim.x) {
      const int r = i / TK, a = i % TK, n = r0 + r;
      float e = 0.0f;
      if (n < n1 && a0 + a < dk)
        e = expf(__bfloat162float(kb[(size_t)n * dk + a0 + a]) - colm[a]) /
            cols[a];
      ks[i] = __float2bfloat16(e);
    }
    for (int i = threadIdx.x; i < RC * TV; i += blockDim.x) {
      const int r = i / TV, c = i % TV, n = r0 + r;
      vs[i] = (n < n1 && c0 + c < dv) ? vb[(size_t)n * dv + c0 + c]
                                      : __float2bfloat16(0.0f);
    }
    __syncthreads();
#pragma unroll
    for (int f = 0; f < FRAGS; ++f) {
      if (!live[f]) continue;
      const int fr = w + f * WARPS, i0 = (fr % 4) * 16, j0 = (fr / 4) * 16;
      for (int kk = 0; kk < RC; kk += 16) {
        // Ksᵀ: column-major view of the (rows, keys) chunk.
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, ks + kk * TK + i0, TK);
        wmma::load_matrix_sync(fb, vs + kk * TV + j0, TV);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      }
    }
  }
  float* out = pctx + ((size_t)seg * BH + bh) * dk * dv;
  float* sw = scr[w];
#pragma unroll
  for (int f = 0; f < FRAGS; ++f) {
    if (!live[f]) continue;
    const int fr = w + f * WARPS;
    const int i0 = a0 + (fr % 4) * 16, j0 = c0 + (fr / 4) * 16;
    wmma::store_matrix_sync(sw, acc[f], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int a = i0 + (e >> 4), c = j0 + (e & 15);
      if (a < dk && c < dv) out[(size_t)a * dv + c] = sw[e];
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(THREADS)
la_out(const bf16* q, const bf16* ctx, bf16* out, int N, int dk, int dv,
       int q_softmax, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dkp = pad16(dk);
  bf16* qs = reinterpret_cast<bf16*>(smem);           // RO x dkp: Q' rows
  bf16* cs = qs + (size_t)RO * dkp;                   // dkp x TV: ctx tile
  float* os = reinterpret_cast<float*>(cs + (size_t)dkp * TV);  // RO x TV
  const int n0 = blockIdx.x * RO, c0 = blockIdx.y * TV, bh = blockIdx.z;
  const bf16* qb = q + (size_t)bh * N * dk;
  const bf16* cb = ctx + (size_t)bh * dk * dv;
  const bf16 zero = __float2bfloat16(0.0f);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = w; r < RO; r += WARPS) {
    const int n = n0 + r;
    bf16* dst = qs + (size_t)r * dkp;
    const bf16* qr = qb + (size_t)n * dk;
    if (n >= N) {
      for (int j = lane; j < dkp; j += 32) dst[j] = zero;
      continue;
    }
    if (!q_softmax) {
      for (int j = lane; j < dkp; j += 32) dst[j] = j < dk ? qr[j] : zero;
      continue;
    }
    float m = -INFINITY;
    for (int j = lane; j < dk; j += 32) m = fmaxf(m, __bfloat162float(qr[j]));
    m = warp_max(m);
    float l = 0.0f;
    for (int j = lane; j < dk; j += 32) l += expf(__bfloat162float(qr[j]) - m);
    l = warp_sum(l);
    for (int j = lane; j < dkp; j += 32)
      dst[j] = j < dk ? __float2bfloat16(expf(__bfloat162float(qr[j]) - m) / l)
                      : zero;
  }
  for (int i = threadIdx.x; i < dkp * TV; i += blockDim.x) {
    const int a = i / TV, c = i % TV;
    cs[i] = (a < dk && c0 + c < dv) ? cb[(size_t)a * dv + c0 + c] : zero;
  }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < FRAGS; ++f) {
    const int fr = w + f * WARPS, i0 = (fr % 4) * 16, j0 = (fr / 4) * 16;
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    if (c0 + j0 < dv) {
      for (int kk = 0; kk < dkp; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, qs + (size_t)i0 * dkp + kk, dkp);
        wmma::load_matrix_sync(fb, cs + (size_t)kk * TV + j0, TV);
        wmma::mma_sync(acc, fa, fb, acc);
      }
    }
    wmma::store_matrix_sync(os + i0 * TV + j0, acc, TV, wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < RO * TV; i += blockDim.x) {
    const int r = i / TV, c = i % TV, n = n0 + r;
    if (n < N && c0 + c < dv)
      out[((size_t)bh * N + n) * dv + c0 + c] = __float2bfloat16(os[i] * scale);
  }
}

}  // namespace

// Shared memory of one la_out block (mirrored by out_smem_bytes in
// ops/kernels/linear_attention.py, which checks it against the limit).
static size_t out_smem(int dk) {
  const size_t dkp = (dk + 15) & ~15;
  return (RO * dkp + dkp * TV) * 2 + (size_t)RO * TV * 4;
}

extern "C" int linear_attention(const bf16* q, const bf16* k, const bf16* v,
                                bf16* out, float2* part, float* pctx,
                                bf16* ctx, int BH, int N, int dk, int dv,
                                int S, int q_softmax, float scale,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rps = (N + S - 1) / S;
  const int tiles = ((dk + TK - 1) / TK) * ((dv + TV - 1) / TV);
  cudaError_t e;
  la_stats<<<dim3(S, BH), THREADS, 0, st>>>(k, part, N, dk, rps);
  if ((e = cudaGetLastError())) return e;
  la_ctx<<<dim3(tiles, S, BH), THREADS, 0, st>>>(k, v, part, pctx, N, dk, dv,
                                                 rps);
  if ((e = cudaGetLastError())) return e;
  const size_t n = (size_t)BH * dk * dv;
  sum_partials<bf16><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(pctx, S, n,
                                                                   ctx);
  if ((e = cudaGetLastError())) return e;
  const size_t smem = out_smem(dk);
  if ((e = set_smem((const void*)la_out, smem))) return e;
  la_out<<<dim3((N + RO - 1) / RO, (dv + TV - 1) / TV, BH), THREADS, smem,
           st>>>(q, ctx, out, N, dk, dv, q_softmax, scale);
  return cudaGetLastError();
}
