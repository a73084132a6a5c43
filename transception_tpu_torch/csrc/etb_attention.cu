// Folded EfficientTransformerBlock attention (head_count 1):
//   out = x + reproj(softmax_C(Q) · (softmax_N(K)ᵀ · V)),  Q/K/V = Dense(LN(x)).
// Replaces transception_tpu/ops/pallas/linear_attention_kernel.py:131
// efficient_attention_block_folded. Design notes: ops/kernels/etb_attention.py.
//
// Four launches on one stream, each over a (tiles of 64 tokens, B) grid:
//   etb_stats  LN -> K per tile; per-column tile max and sum of exp(K - max)
//   etb_ctx    combine the stats, Ks = bf16(exp(K - m) / S), V; atomically
//              add the tile's Ksᵀ·V into the fp32 (B, C, C) context
//   etb_round  context -> bf16
//   etb_out    LN -> Q, channel softmax, ·ctx, reprojection, + residual
#include "common.cuh"

namespace {

constexpr int T = 64;          // tokens per tile
constexpr int THREADS = 256;   // 8 warps

// LayerNorm (fp32 stats, E[x²]−E[x]²) of rows [n0, n0+T) into hn (bf16,
// T x C); rows past N are zero.
__device__ void ln_rows(const bf16* x, const float* ls, const float* lb,
                        int N, int C, int n0, float eps, bf16* hn) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int r = warp; r < T; r += nw) {
    const int n = n0 + r;
    bf16* dst = hn + (size_t)r * C;
    if (n >= N) {
      for (int c = lane; c < C; c += 32) dst[c] = __float2bfloat16(0.0f);
      continue;
    }
    const bf16* src = x + (size_t)n * C;
    float s = 0.0f, sq = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float v = __bfloat162float(src[c]);
      s += v;
      sq += v * v;
    }
    s = warp_sum(s);
    sq = warp_sum(sq);
    const float mu = s / C;
    const float rs = rsqrtf(sq / C - mu * mu + eps);
    for (int c = lane; c < C; c += 32) {
      const float v = __bfloat162float(src[c]);
      dst[c] = __float2bfloat16((v - mu) * rs * ls[c] + lb[c]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
etb_stats(const bf16* x, const float* ls, const float* lb, const bf16* wk,
          const float* bk, float* stats, int N, int C, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* hn = reinterpret_cast<bf16*>(smem);
  float* st = reinterpret_cast<float*>(smem + (size_t)T * C * 2);
  const int tile = blockIdx.x, b = blockIdx.y, n0 = tile * T;
  x += (size_t)b * N * C;
  ln_rows(x, ls, lb, N, C, n0, eps, hn);
  __syncthreads();
  dense_tile(hn, C, wk, C, T, C, st, C);
  __syncthreads();
  const int rows = min(T, N - n0);
  float* out = stats + ((size_t)b * gridDim.x + tile) * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float bias = bk[c];
    float m = -INFINITY;
    for (int r = 0; r < rows; ++r) m = fmaxf(m, rbf(st[r * C + c] + bias));
    float s = 0.0f;
    for (int r = 0; r < rows; ++r) s += expf(rbf(st[r * C + c] + bias) - m);
    out[c] = m;
    out[C + c] = s;
  }
}

__global__ void __launch_bounds__(THREADS)
etb_ctx(const bf16* x, const float* ls, const float* lb, const bf16* wk,
        const float* bk, const bf16* wv, const float* bv, const float* stats,
        float* ctx32, int N, int C, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* hn = reinterpret_cast<bf16*>(smem);                       // T x C
  float* st = reinterpret_cast<float*>(smem + (size_t)T * C * 2);  // T x C
  bf16* ks = reinterpret_cast<bf16*>(smem + (size_t)T * C * 6);    // T x C
  float* colm = reinterpret_cast<float*>(smem + (size_t)T * C * 8);
  float* cols = colm + C;
  float* scratch = cols + C;  // 256 floats per warp
  const int tile = blockIdx.x, b = blockIdx.y, n0 = tile * T;
  const int ntiles = gridDim.x;
  x += (size_t)b * N * C;

  // Column softmax statistics of K over all N, from the per-tile partials.
  const float* sb = stats + (size_t)b * ntiles * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float m = -INFINITY;
    for (int t = 0; t < ntiles; ++t) m = fmaxf(m, sb[(size_t)t * 2 * C + c]);
    float s = 0.0f;
    for (int t = 0; t < ntiles; ++t)
      s += sb[(size_t)t * 2 * C + C + c] * expf(sb[(size_t)t * 2 * C + c] - m);
    colm[c] = m;
    cols[c] = s;
  }
  ln_rows(x, ls, lb, N, C, n0, eps, hn);
  __syncthreads();
  dense_tile(hn, C, wk, C, T, C, st, C);
  __syncthreads();
  for (int i = threadIdx.x; i < T * C; i += blockDim.x) {
    const int r = i / C, c = i % C;
    float e = 0.0f;
    if (n0 + r < N) e = expf(rbf(st[i] + bk[c]) - colm[c]) / cols[c];
    ks[i] = __float2bfloat16(e);
  }
  __syncthreads();
  dense_tile(hn, C, wv, C, T, C, st, C);
  __syncthreads();
  for (int i = threadIdx.x; i < T * C; i += blockDim.x) {  // V over hn
    const int r = i / C, c = i % C;
    hn[i] = __float2bfloat16(n0 + r < N ? st[i] + bv[c] : 0.0f);
  }
  __syncthreads();

  // ctx[b] += Ksᵀ · V  (C x C), Ksᵀ read column-major from ks.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scr = scratch + warp * 256;
  const int ct = C >> 4;
  float* cb = ctx32 + (size_t)b * C * C;
  for (int t = warp; t < ct * ct; t += blockDim.x >> 5) {
    const int i = (t % ct) << 4, j = (t / ct) << 4;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < T; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
      wmma::load_matrix_sync(a, ks + (size_t)k * C + i, C);
      wmma::load_matrix_sync(bm, hn + (size_t)k * C + j, C);
      wmma::mma_sync(acc, a, bm, acc);
    }
    wmma::store_matrix_sync(scr, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32)
      atomicAdd(cb + (size_t)(i + (e >> 4)) * C + j + (e & 15), scr[e]);
    __syncwarp();
  }
}

__global__ void etb_round(const float* in, bf16* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __float2bfloat16(in[i]);
}

__global__ void __launch_bounds__(THREADS)
etb_out(const bf16* x, const float* ls, const float* lb, const bf16* wq,
        const float* bq, const bf16* ctx16, const bf16* wp, const float* bp,
        bf16* out, int N, int C, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* hn = reinterpret_cast<bf16*>(smem);
  float* st = reinterpret_cast<float*>(smem + (size_t)T * C * 2);
  const int tile = blockIdx.x, b = blockIdx.y, n0 = tile * T;
  x += (size_t)b * N * C;
  out += (size_t)b * N * C;
  ln_rows(x, ls, lb, N, C, n0, eps, hn);
  __syncthreads();
  dense_tile(hn, C, wq, C, T, C, st, C);
  __syncthreads();

  // Softmax of each Q row over all C channels -> hn.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < T; r += blockDim.x >> 5) {
    const float* q = st + (size_t)r * C;
    float m = -INFINITY;
    for (int c = lane; c < C; c += 32) m = fmaxf(m, rbf(q[c] + bq[c]));
    m = warp_max(m);
    float s = 0.0f;
    for (int c = lane; c < C; c += 32) s += expf(rbf(q[c] + bq[c]) - m);
    s = warp_sum(s);
    for (int c = lane; c < C; c += 32)
      hn[(size_t)r * C + c] = __float2bfloat16(expf(rbf(q[c] + bq[c]) - m) / s);
  }
  __syncthreads();
  gemm_tiles<wmma::row_major, wmma::row_major>(
      hn, C, ctx16 + (size_t)b * C * C, C, T, C, C, st, C);
  __syncthreads();
  for (int i = threadIdx.x; i < T * C; i += blockDim.x)
    hn[i] = __float2bfloat16(st[i]);
  __syncthreads();
  dense_tile(hn, C, wp, C, T, C, st, C);
  __syncthreads();
  for (int i = threadIdx.x; i < T * C; i += blockDim.x) {
    const int r = i / C, c = i % C, n = n0 + r;
    if (n < N) {
      const float pr = rbf(st[i] + bp[c]);
      out[(size_t)n * C + c] =
          __float2bfloat16(pr + __bfloat162float(x[(size_t)n * C + c]));
    }
  }
}

}  // namespace

extern "C" int etb_attention(const bf16* x, const float* ls, const float* lb,
                             const bf16* wq, const float* bq, const bf16* wk,
                             const float* bk, const bf16* wv, const float* bv,
                             const bf16* wp, const float* bp, float* stats,
                             float* ctx32, bf16* ctx16, bf16* out, int B,
                             int N, int C, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + T - 1) / T, B);
  const size_t sm_tile = (size_t)T * C * 6;
  const size_t sm_ctx = (size_t)T * C * 8 + 2 * C * 4 + (THREADS / 32) * 1024;
  cudaError_t e;
  if ((e = set_smem((const void*)etb_stats, sm_tile))) return e;
  if ((e = set_smem((const void*)etb_ctx, sm_ctx))) return e;
  if ((e = set_smem((const void*)etb_out, sm_tile))) return e;
  etb_stats<<<grid, THREADS, sm_tile, s>>>(x, ls, lb, wk, bk, stats, N, C,
                                           eps);
  if ((e = cudaGetLastError())) return e;
  etb_ctx<<<grid, THREADS, sm_ctx, s>>>(x, ls, lb, wk, bk, wv, bv, stats,
                                        ctx32, N, C, eps);
  if ((e = cudaGetLastError())) return e;
  const int n = B * C * C;
  etb_round<<<(n + 255) / 256, 256, 0, s>>>(ctx32, ctx16, n);
  if ((e = cudaGetLastError())) return e;
  etb_out<<<grid, THREADS, sm_tile, s>>>(x, ls, lb, wq, bq, ctx16, wp, bp,
                                         out, N, C, eps);
  return cudaGetLastError();
}
