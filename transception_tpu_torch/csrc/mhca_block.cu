// One whole MHCA block on (B, s², C) token maps:
//   x1  = bf16(bf16(dw3x3(x) + b) + x)                       (CPE)
//   q,k,v = bf16(bf16(LN1(x1) · Wqkv) + bf16(b))
//   att = bf16(scale · Q · bf16(softmax_N(K)_hᵀ V_h))        (per head)
//   a   = bf16(att + bf16(Q ⊙ bf16(CRPE_3/5/7(V) + b)))
//   x2  = bf16(x1 + bf16(bf16(a · Wp) + bf16(bp)))
//   out = x2 + MixFFN_skip(LN2(x2))                          (mixffn.cuh)
// Replaces transception_tpu/ops/pallas/mhca_block_kernel.py:200
// fused_mhca_block. Design notes: ops/kernels/mhca_block.py.
//
// Four kernels on one stream, with three bf16 intermediates in device
// memory (x1, the fused q|k|v rows, x2) and the per-head contexts:
//   mhca_qkv  one block per (32 tokens, batch): CPE, LN1, the qkv product
//             on the tensor cores;
//   mhca_ctx  one block per (head, batch): softmax of K over all tokens and
//             the head's d x d context, both from shared memory;
//   mhca_out  one block per (32 tokens, batch): Q · context, CRPE, the proj
//             product on the tensor cores, the residual;
//   the MixFFN kernel, one block per (map row, batch).
#include "mixffn.cuh"

namespace {

constexpr int TM = 32;  // tokens per block of mhca_qkv / mhca_out
constexpr int THREADS = 256;

struct Crpe {  // the CRPE windows: channels [c0, c1) window k1, etc.
  const float* w[3];
  const float* b[3];
  int k[3];
  int end[3];
};

__global__ void __launch_bounds__(THREADS)
mhca_qkv_kernel(const bf16* x, const float* cpe_w, const float* cpe_b,
                const float* l1s, const float* l1b, const bf16* wqkv,
                const float* bqkv, bf16* x1, bf16* qkv, int s, int C,
                float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xf = reinterpret_cast<float*>(smem);  // TM x C: x1, then products
  bf16* cur = reinterpret_cast<bf16*>(smem + (size_t)TM * C * 4);  // TM x C
  const int N = s * s, t0 = blockIdx.x * TM, b = blockIdx.y;
  const bf16* xb = x + (size_t)b * N * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;

  for (int i = threadIdx.x; i < TM * C; i += blockDim.x) {
    const int r = i / C, c = i % C, t = t0 + r;
    if (t >= N) {
      xf[i] = 0.0f;
      continue;
    }
    const int row = t / s, col = t % s;
    float acc = 0.0f;
    for (int di = 0; di < 3; ++di) {
      const int rr = row + di - 1;
      if (rr < 0 || rr >= s) continue;
      for (int dj = 0; dj < 3; ++dj) {
        const int cc = col + dj - 1;
        if (cc < 0 || cc >= s) continue;
        acc += __bfloat162float(xb[((size_t)rr * s + cc) * C + c]) *
               rbf(cpe_w[c * 9 + di * 3 + dj]);
      }
    }
    const float v =
        rbf(rbf(acc + cpe_b[c]) + __bfloat162float(xb[(size_t)t * C + c]));
    xf[i] = v;
    x1[((size_t)b * N + t) * C + c] = __float2bfloat16(v);
  }
  __syncthreads();

  for (int r = warp; r < TM; r += nw) {
    const float* xr = xf + (size_t)r * C;
    bf16* dst = cur + (size_t)r * C;
    float sm = 0.0f, sq = 0.0f;
    for (int c = lane; c < C; c += 32) {
      sm += xr[c];
      sq += xr[c] * xr[c];
    }
    sm = warp_sum(sm);
    sq = warp_sum(sq);
    const float mean = sm / C;
    const float inv = rsqrtf(sq / C - mean * mean + eps);
    for (int c = lane; c < C; c += 32)
      dst[c] = __float2bfloat16((xr[c] - mean) * inv * l1s[c] + l1b[c]);
  }
  __syncthreads();

  for (int part = 0; part < 3; ++part) {
    dense_tile(cur, C, wqkv + (size_t)part * C * C, C, TM, C, xf, C);
    __syncthreads();
    for (int i = threadIdx.x; i < TM * C; i += blockDim.x) {
      const int r = i / C, c = i % C, t = t0 + r;
      if (t < N)
        qkv[((size_t)b * N + t) * 3 * C + part * C + c] = __float2bfloat16(
            rbf(xf[i]) + rbf(bqkv[part * C + c]));
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
mhca_ctx_kernel(const bf16* qkv, float* ctx, int N, int C, int d) {
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                  // N x d: K, then bf16(softmax_N(K))
  float* vs = ks + (size_t)N * d;  // N x d
  float* red = vs + (size_t)N * d;  // THREADS partial sums
  const int h = blockIdx.x, b = blockIdx.y;
  const bf16* base = qkv + (size_t)b * N * 3 * C + h * d;

  for (int i = threadIdx.x; i < N * d; i += blockDim.x) {
    const int n = i / d, j = i % d;
    ks[i] = __bfloat162float(base[(size_t)n * 3 * C + C + j]);
    vs[i] = __bfloat162float(base[(size_t)n * 3 * C + 2 * C + j]);
  }
  __syncthreads();

  // Column softmax over the N tokens: `parts` threads per column.
  const int parts = blockDim.x / d;
  const int j = threadIdx.x % d, part = threadIdx.x / d;
  const bool active = part < parts;
  float m = -INFINITY;
  if (active)
    for (int n = part; n < N; n += parts) m = fmaxf(m, ks[(size_t)n * d + j]);
  red[threadIdx.x] = m;
  __syncthreads();
  if (active && part == 0)
    for (int p = 1; p < parts; ++p) m = fmaxf(m, red[p * d + j]);
  __syncthreads();
  if (active && part == 0) red[j] = m;
  __syncthreads();
  m = red[j];
  __syncthreads();
  float l = 0.0f;
  if (active)
    for (int n = part; n < N; n += parts) l += expf(ks[(size_t)n * d + j] - m);
  red[threadIdx.x] = l;
  __syncthreads();
  if (active && part == 0)
    for (int p = 1; p < parts; ++p) l += red[p * d + j];
  __syncthreads();
  if (active && part == 0) red[j] = l;
  __syncthreads();
  l = red[j];
  __syncthreads();
  if (active)
    for (int n = part; n < N; n += parts) {
      float* e = ks + (size_t)n * d + j;
      *e = rbf(expf(*e - m) / l);
    }
  __syncthreads();

  // Context: `cparts` threads per (i, j) pair of the d x d block.
  const int pairs = d * d;
  float* out = ctx + ((size_t)b * (C / d) + h) * pairs;
  for (int p0 = 0; p0 < pairs; p0 += blockDim.x) {
    const int n_pairs = min(pairs - p0, (int)blockDim.x);
    const int cparts = blockDim.x / n_pairs;
    const int pi = p0 + threadIdx.x % n_pairs, cp = threadIdx.x / n_pairs;
    float acc = 0.0f;
    if (cp < cparts) {
      const int a = pi / d, c = pi % d;
      for (int n = cp; n < N; n += cparts)
        acc += ks[(size_t)n * d + a] * vs[(size_t)n * d + c];
    }
    red[threadIdx.x] = acc;
    __syncthreads();
    if (cp == 0 && threadIdx.x < n_pairs) {
      for (int p = 1; p < cparts; ++p) acc += red[p * n_pairs + threadIdx.x];
      out[pi] = rbf(acc);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
mhca_out_kernel(const bf16* qkv, const float* ctx, const bf16* x1, Crpe crpe,
                const bf16* wp, const float* bp, bf16* x2, int s, int C,
                int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* pf = reinterpret_cast<float*>(smem);  // TM x C products
  bf16* as = reinterpret_cast<bf16*>(smem + (size_t)TM * C * 4);  // TM x C
  float* cs = reinterpret_cast<float*>(smem + (size_t)TM * C * 6);  // C x d
  const int N = s * s, t0 = blockIdx.x * TM, b = blockIdx.y;
  const bf16* qb = qkv + (size_t)b * N * 3 * C;

  for (int i = threadIdx.x; i < C * d; i += blockDim.x)
    cs[i] = ctx[(size_t)b * C * d + i];
  __syncthreads();

  for (int i = threadIdx.x; i < TM * C; i += blockDim.x) {
    const int r = i / C, c = i % C, t = t0 + r;
    if (t >= N) {
      as[i] = __float2bfloat16(0.0f);
      continue;
    }
    const int h = c / d, cj = c % d;
    const bf16* qr = qb + (size_t)t * 3 * C;
    const float* ch = cs + (size_t)h * d * d;
    float acc = 0.0f;
    for (int a = 0; a < d; ++a)
      acc += __bfloat162float(qr[h * d + a]) * ch[a * d + cj];
    const float att = rbf(scale * acc);

    const int seg = c < crpe.end[0] ? 0 : (c < crpe.end[1] ? 1 : 2);
    const int k = crpe.k[seg], p = k / 2;
    const int c0 = seg ? crpe.end[seg - 1] : 0;
    const float* w = crpe.w[seg] + (size_t)(c - c0) * k * k;
    const int row = t / s, col = t % s;
    float conv = 0.0f;
    for (int di = 0; di < k; ++di) {
      const int rr = row + di - p;
      if (rr < 0 || rr >= s) continue;
      for (int dj = 0; dj < k; ++dj) {
        const int cc = col + dj - p;
        if (cc < 0 || cc >= s) continue;
        const size_t nb = (size_t)rr * s + cc;
        conv += __bfloat162float(qb[nb * 3 * C + 2 * C + c]) *
                rbf(w[di * k + dj]);
      }
    }
    const float cv = rbf(conv + crpe.b[seg][c - c0]);
    const float crp = rbf(__bfloat162float(qr[c]) * cv);
    as[i] = __float2bfloat16(att + crp);
  }
  __syncthreads();

  dense_tile(as, C, wp, C, TM, C, pf, C);
  __syncthreads();
  for (int i = threadIdx.x; i < TM * C; i += blockDim.x) {
    const int r = i / C, c = i % C, t = t0 + r;
    if (t >= N) continue;
    const size_t o = ((size_t)b * N + t) * C + c;
    const float proj = rbf(rbf(pf[i]) + rbf(bp[c]));
    x2[o] = __float2bfloat16(__bfloat162float(x1[o]) + proj);
  }
}

}  // namespace

extern "C" int mhca_block(
    const bf16* x, const float* cpe_w, const float* cpe_b, const float* l1s,
    const float* l1b, const bf16* wqkv, const float* bqkv,
    const float* crpe_w0, const float* crpe_w1, const float* crpe_w2,
    const float* crpe_b0, const float* crpe_b1, const float* crpe_b2,
    const bf16* wp, const float* bp, const float* l2s, const float* l2b,
    const bf16* w1, const float* b1, const bf16* dw, const float* dwb,
    const float* ls, const float* lb, const bf16* w2, const float* b2,
    bf16* x1, bf16* qkv, float* ctx, bf16* x2, bf16* out, int B, int s,
    int C, int heads, int hid, int k0, int k1, int k2, int n0, int n1,
    float eps1, float eps2, float eps, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = s * s, d = C / heads, tiles = (N + TM - 1) / TM;
  cudaError_t e;

  const size_t smem_qkv = (size_t)TM * C * 6;
  if ((e = set_smem((const void*)mhca_qkv_kernel, smem_qkv))) return e;
  mhca_qkv_kernel<<<dim3(tiles, B), THREADS, smem_qkv, st>>>(
      x, cpe_w, cpe_b, l1s, l1b, wqkv, bqkv, x1, qkv, s, C, eps1);
  if ((e = cudaGetLastError())) return e;

  const size_t smem_ctx = ((size_t)2 * N * d + THREADS) * 4;
  if ((e = set_smem((const void*)mhca_ctx_kernel, smem_ctx))) return e;
  mhca_ctx_kernel<<<dim3(heads, B), THREADS, smem_ctx, st>>>(qkv, ctx, N, C,
                                                             d);
  if ((e = cudaGetLastError())) return e;

  Crpe crpe{{crpe_w0, crpe_w1, crpe_w2},
            {crpe_b0, crpe_b1, crpe_b2},
            {k0, k1, k2},
            {n0, n0 + n1, C}};
  const size_t smem_out = (size_t)TM * C * 6 + (size_t)C * d * 4;
  if ((e = set_smem((const void*)mhca_out_kernel, smem_out))) return e;
  mhca_out_kernel<<<dim3(tiles, B), THREADS, smem_out, st>>>(
      qkv, ctx, x1, crpe, wp, bp, x2, s, C, d, scale);
  if ((e = cudaGetLastError())) return e;

  const size_t smem_ffn = mixffn::smem_bytes(s, C, hid);
  if ((e = set_smem((const void*)mixffn::mixffn_ln_skip_kernel<false>,
                    smem_ffn)))
    return e;
  mixffn::mixffn_ln_skip_kernel<false><<<dim3(s, B), mixffn::THREADS,
                                         smem_ffn, st>>>(
      x2, l2s, l2b, w1, b1, dw, dwb, ls, lb, w2, b2, out, s, C, hid, 1, eps2,
      eps);
  return cudaGetLastError();
}
