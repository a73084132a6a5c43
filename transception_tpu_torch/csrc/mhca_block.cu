// One whole MHCA block on (B, s², C) token maps:
//   x1  = bf16(bf16(dw3x3(x) + b) + x)                       (CPE)
//   q,k,v = bf16(bf16(LN1(x1) · Wqkv) + bf16(b))
//   att = bf16(scale · Q · bf16(softmax_N(K)_hᵀ V_h))        (per head)
//   a   = bf16(att + bf16(Q ⊙ bf16(CRPE_3/5/7(V) + b)))
//   x2  = bf16(x1 + bf16(bf16(a · Wp) + bf16(bp)))
//   out = x2 + MixFFN_skip(LN2(x2))                          (ffn::forward)
// Replaces transception_tpu/ops/pallas/mhca_block_kernel.py:200
// fused_mhca_block. Design notes: ops/kernels/mhca_block.py.
//
// Bound on the H100: operations, narrowly (at (32, 28², 64) 2.8 GFLOP of
// products, windows and Q · context, 2.8 us at the bf16 peak, against 6.7
// MB of x, out and weights, 2.0 us). What it takes in practice is the
// traffic of its intermediates and the CUDA-core work of the windows, the
// LayerNorms and the GELU. The TPU kernel keeps a whole
// map and its hidden state in VMEM; here softmax(K) and the contexts
// reduce over every token of a map and the FFN's hidden state does not
// fit a block, so the block runs as eight stages over the whole batch, on
// one stream, each of which fills the card, with its intermediates (x1,
// q|k|v, the contexts, the attention output, x2, the FFN's h and a) in
// device memory for the length of one call:
//   1. cpe   x1, a block per (map row, batch), a thread per pair of
//            channels and 8 columns with its 3 x 10 window of x loaded at
//            once and the rounded taps in registers;
//   2. qkv   the tiled product (mixffn_stages.cuh) with LN1 folded into
//            its A panel and the Dense epilogue;
//   3. ctx   per (head, batch): softmax of K over all tokens and the d x d
//            context, from shared memory;
//   4. attn  per (band of map rows, batch): Q and V of the band (V with a
//            3-row, 3-column zero-padded halo) and the contexts staged in
//            shared memory once; a thread per channel pair over the band's
//            tokens, its CRPE window's taps rounded once into registers
//            (centred in a 7 x 7 grid of zeros, so no warp splits over
//            window sizes), Q · context from the staged rows;
//   5. proj  the tiled product with the residual epilogue: x2;
//   6-8.     the MixFFN forward chain on x2 with LN2 (ffn::forward).
// Eight launches per call; the plan of tiles and band rows is the
// wrapper's (ops/kernels/mhca_block.py plan).
//
// The fp32 form (mhca_block_f32, the fp32 eval forward's) is every stage
// at E = float: no rounding points, the products on the CUDA cores
// (mixffn_stages.cuh), and the attention stage's CRPE taps in shared
// memory rather than registers (49 fp32 pairs a thread would spill).
#include "mixffn_stages.cuh"

namespace {

using ffn::THREADS;
constexpr int KID = 5;
constexpr int HALO = 3;  // the widest CRPE window's reach (7 x 7)
constexpr int KW = 2 * HALO + 1;

struct Crpe {  // the CRPE windows: channels [c0, c1) window k1, etc.
  const float* w[3];
  const float* b[3];
  int k[3];
  int end[3];
};

// Stage 1: x1 = E(E(dw3x3(x) + b) + x), a block per (map row r, batch).
// A work item is a pair of channels over ffn::SEG columns of the row: the
// thread loads the 3 x (SEG + 2) window of x around them (zero off the
// map) at once, the taps rounded to E in registers.
template <typename E>
__global__ void __launch_bounds__(THREADS)
mhca_cpe_kernel(const E* x, const float* w, const float* bias, E* x1, int s,
                int C) {
  constexpr int SEG = ffn::SEG;
  const int r = blockIdx.x, P = C / 2, nseg = (s + SEG - 1) / SEG;
  const size_t brow = (size_t)blockIdx.y * s;
  for (int item = threadIdx.x; item < P * nseg; item += THREADS) {
    const int c = 2 * (item % P), j0 = item / P * SEG;
    const int nj = min(SEG, s - j0);
    float2 wk[9];
#pragma unroll
    for (int q = 0; q < 9; ++q)
      wk[q] = make_float2(rnd<E>(w[c * 9 + q]), rnd<E>(w[(c + 1) * 9 + q]));
    const float2 bc = make_float2(bias[c], bias[c + 1]);
    Pair<E> win[3][SEG + 2];
#pragma unroll
    for (int di = 0; di < 3; ++di) {
      const int rr = r + di - 1;
#pragma unroll
      for (int q = 0; q < SEG + 2; ++q) {
        const int j = j0 - 1 + q;
        win[di][q] = rr >= 0 && rr < s && j >= 0 && j < s
                         ? *reinterpret_cast<const Pair<E>*>(
                               x + ((brow + rr) * s + j) * C + c)
                         : mk2<E>(0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int jj = 0; jj < SEG; ++jj) {
      if (jj >= nj) break;  // the row ends inside the segment
      float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const float2 v = f2(win[di][jj + dj]);
          acc.x += v.x * wk[di * 3 + dj].x;
          acc.y += v.y * wk[di * 3 + dj].y;
        }
      const float2 xc = f2(win[1][jj + 1]);
      st2<E>(x1 + ((brow + r) * s + j0 + jj) * C + c,
             rnd<E>(acc.x + bc.x) + xc.x, rnd<E>(acc.y + bc.y) + xc.y);
    }
  }
}

// Stage 3: per (head, batch), the column softmax of K over the N tokens
// and the head's d x d context, both from shared memory.
template <typename E>
__global__ void __launch_bounds__(THREADS)
mhca_ctx_kernel(const E* qkv, float* ctx, int N, int C, int d) {
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                  // N x d: K, then E(softmax_N(K))
  float* vs = ks + (size_t)N * d;  // N x d
  float* red = vs + (size_t)N * d;  // THREADS partial sums
  const int h = blockIdx.x, b = blockIdx.y;
  const E* base = qkv + (size_t)b * N * 3 * C + h * d;

  // K and V of the head, 8 values a load (d % 8 == 0).
  for (int i = threadIdx.x; i < N * d / 8; i += blockDim.x) {
    const int n = i / (d / 8), j = i % (d / 8) * 8;
    float kv[8], vv[8];
    ld8<E>(base + (size_t)n * 3 * C + C + j, kv);
    ld8<E>(base + (size_t)n * 3 * C + 2 * C + j, vv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      *reinterpret_cast<float2*>(ks + (size_t)n * d + j + 2 * e) =
          make_float2(kv[2 * e], kv[2 * e + 1]);
      *reinterpret_cast<float2*>(vs + (size_t)n * d + j + 2 * e) =
          make_float2(vv[2 * e], vv[2 * e + 1]);
    }
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
      *e = rnd<E>(expf(*e - m) / l);
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
      out[pi] = rnd<E>(acc);
    }
    __syncthreads();
  }
}

// Shared memory of one attention-stage block over elements of es bytes:
// the transposed contexts, Q of the band, the padded band of V and at
// fp32 the CRPE taps (mirrored by attn_smem in ops/kernels/mhca_block.py).
__host__ __device__ inline size_t attn_smem(int s, int C, int d, int R,
                                            int es = 2) {
  return (size_t)d * C * 4 + (size_t)R * s * C * es +
         (size_t)(R + 2 * HALO) * (s + 2 * HALO) * C * es +
         (es == 4 ? (size_t)KW * KW * C * 4 : 0);
}

// Stage 4, per (band of R map rows from blockIdx.x·R, batch): the contexts
// transposed to ct[a·C + c] = ctx[c / d][a][c % d] (conflict-free across a
// warp's channels), Q of the band's rows and V of its rows with a HALO of
// rows and columns (zero off the map) in shared memory. Then thread t
// takes the channel pair (c, c + 1), c = 2·(t % (C/2)) (C/2 divides
// THREADS), over every THREADS/(C/2)-th token of the band, with the taps of
// its CRPE window, rounded to E, centred in a 7 x 7 grid of zeros: every
// lane runs the same window (the three window sizes never split a warp's
// path), and the zero taps add exact zeros. The taps sit in registers at
// bf16 and in shared memory at fp32 (tw[q·C/2 + pair]). att = E(scale ·
// Σ_a q[h·d + a] · ct[a·C + c]); cv = E(window(V) + b), summed a row of the
// window at a time; a = E(att + E(q[c] · cv)).
template <typename E>
__global__ void __launch_bounds__(THREADS)
mhca_attn_kernel(const E* qkv, const float* ctx, Crpe crpe, E* att, int s,
                 int C, int d, int R, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ct = reinterpret_cast<float*>(smem);             // d x C
  E* qs = reinterpret_cast<E*>(ct + (size_t)d * C);       // R x s x C
  E* vb = qs + (size_t)R * s * C;  // (R + 2·HALO) x (s + 2·HALO) x C
  const int W = s + 2 * HALO, N = s * s;
  float2* tw = reinterpret_cast<float2*>(vb + (size_t)(R + 2 * HALO) * W * C);
  const int r0 = blockIdx.x * R, b = blockIdx.y;
  const int rows = min(R, s - r0);
  const float* cb = ctx + (size_t)b * C * d;
  const E* qb = qkv + (size_t)b * N * 3 * C;

  for (int i = threadIdx.x; i < d * C; i += THREADS) {
    const int a = i / C, c = i % C;
    ct[i] = cb[((c / d) * d + a) * d + c % d];
  }
  // Q and V of the band by cp.async, all in flight at once (zero-filled
  // off the map), while the taps load.
  const uint32_t sq = bsa::smem_addr(qs), sv = bsa::smem_addr(vb);
  const int cc = C / EPC<E>;  // 16-byte pieces of a token's q or V
  for (int i = threadIdx.x; i < rows * s * cc; i += THREADS) {
    const int piece = i % cc, tl = i / cc;
    bsa::cp_async16(sq + (tl * C + piece * EPC<E>) * sizeof(E),
                    qb + (size_t)(r0 * s + tl) * 3 * C + piece * EPC<E>,
                    true);
  }
  for (int i = threadIdx.x; i < (R + 2 * HALO) * W * cc; i += THREADS) {
    const int piece = i % cc, pos = i / cc;
    const int rr = r0 - HALO + pos / W, col = pos % W - HALO;
    const bool in = rr >= 0 && rr < s && col >= 0 && col < s;
    bsa::cp_async16(sv + (pos * C + piece * EPC<E>) * sizeof(E),
                    in ? qb + (size_t)(rr * s + col) * 3 * C + 2 * C +
                             piece * EPC<E>
                       : qb,
                    in);
  }
  bsa::cp_async_commit();

  // The CRPE window of channel pair c (segment boundaries are whole heads,
  // so even): its segment's window side k, its corner off in the 7 x 7
  // grid and its first tap.
  auto window = [&](int c, int& k, int& off, const float*& w0) {
    const int seg = c < crpe.end[0] ? 0 : (c < crpe.end[1] ? 1 : 2);
    const int c0 = seg ? crpe.end[seg - 1] : 0;
    k = crpe.k[seg];
    off = HALO - k / 2;
    w0 = crpe.w[seg] + (size_t)(c - c0) * k * k;
    return seg;
  };
  const int P = C / 2, c = 2 * (threadIdx.x % P);
  int k, off;
  const float* w0;
  const int seg = window(c, k, off, w0);
  const int cs0 = seg ? crpe.end[seg - 1] : 0;
  Pair<E> wk[IS_F32<E> ? 1 : KW * KW];
  if constexpr (IS_F32<E>) {
    for (int i = threadIdx.x; i < KW * KW * P; i += THREADS) {
      const int q = i / P, pc = 2 * (i % P);
      int kq, oq;
      const float* wq;
      window(pc, kq, oq, wq);
      const int di = q / KW - oq, dj = q % KW - oq;
      const bool in = di >= 0 && di < kq && dj >= 0 && dj < kq;
      tw[i] = make_float2(in ? wq[di * kq + dj] : 0.0f,
                          in ? wq[kq * kq + di * kq + dj] : 0.0f);
    }
  } else {
#pragma unroll
    for (int q = 0; q < KW * KW; ++q) {
      const int di = q / KW - off, dj = q % KW - off;
      const bool in = di >= 0 && di < k && dj >= 0 && dj < k;
      wk[q] = mk2<E>(in ? w0[di * k + dj] : 0.0f,
                     in ? w0[k * k + di * k + dj] : 0.0f);
    }
  }
  const float2 bias =
      make_float2(crpe.b[seg][c - cs0], crpe.b[seg][c - cs0 + 1]);
  const int h0 = c / d * d;
  bsa::cp_async_wait<0>();
  __syncthreads();

  E* ab = att + ((size_t)b * N + (size_t)r0 * s) * C;
  for (int tl = threadIdx.x / P; tl < rows * s; tl += THREADS / P) {
    const int row = tl / s, col = tl % s;
    const E* qr = qs + (size_t)tl * C;
    float2 acc = make_float2(0.0f, 0.0f);
    for (int a = 0; a < d; ++a) {
      const float qa = tof(qr[h0 + a]);
      const float2 cx = *reinterpret_cast<const float2*>(ct + a * C + c);
      acc.x += qa * cx.x;
      acc.y += qa * cx.y;
    }
    const Pair<E>* vp = reinterpret_cast<const Pair<E>*>(
        vb + ((size_t)row * W + col) * C + c);
    float2 conv = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int di = 0; di < KW; ++di) {
      float2 part = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int dj = 0; dj < KW; ++dj) {
        const float2 v = f2(vp[((size_t)di * W + dj) * P]);
        float2 wv;
        if constexpr (IS_F32<E>)
          wv = tw[(di * KW + dj) * P + c / 2];
        else
          wv = f2(wk[di * KW + dj]);
        part.x += v.x * wv.x;
        part.y += v.y * wv.y;
      }
      conv.x += part.x;
      conv.y += part.y;
    }
    const float2 qc = ld2<E>(qr + c);
    st2<E>(ab + ((size_t)row * s + col) * C + c,
           rnd<E>(scale * acc.x) + rnd<E>(qc.x * rnd<E>(conv.x + bias.x)),
           rnd<E>(scale * acc.y) + rnd<E>(qc.y * rnd<E>(conv.y + bias.y)));
  }
}

// Indices into the wrapper's plan (ops/kernels/mhca_block.py plan); the
// FFN's forward plan (ffn::FwdPlan) follows.
enum Plan { QKV_BM, QKV_BN, PROJ_BM, PROJ_BN, BAND_ROWS, FFN_PLAN };

// x, out: (B, s², C) E; wqkv (3C, C), wp (C, C), w1 (hid, C), dw (hid,
// 9), w2 (C, hid) E; the CPE taps (C, 9), the CRPE windows and every
// vector fp32. Workspace: x1, att, x2 (B·s², C), qkv (B·s², 3C), h, a
// (B·s², hid) E; ctx (B, heads, d, d) fp32. plan: FFN_PLAN +
// ffn::FWD_PLAN_LEN ints.
template <typename E>
int block(const E* x, const float* cpe_w, const float* cpe_b,
          const float* l1s, const float* l1b, const E* wqkv,
          const float* bqkv, const float* crpe_w0, const float* crpe_w1,
          const float* crpe_w2, const float* crpe_b0, const float* crpe_b1,
          const float* crpe_b2, const E* wp, const float* bp,
          const float* l2s, const float* l2b, const E* w1, const float* b1,
          const E* dw, const float* dwb, const float* ls, const float* lb,
          const E* w2, const float* b2, E* x1, E* qkv, float* ctx, E* att,
          E* x2, E* h, E* a, E* out, const int* plan, int B, int s, int C,
          int heads, int hid, int k0, int k1, int k2, int n0, int n1,
          float eps1, float eps2, float eps, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = s * s, T = B * N, d = C / heads, R = plan[BAND_ROWS];
  cudaError_t e;
#define STEP(call) \
  if ((e = (call))) return e

  mhca_cpe_kernel<E><<<dim3(s, B), THREADS, 0, st>>>(x, cpe_w, cpe_b, x1, s,
                                                     C);
  STEP(cudaGetLastError());
  STEP((ffn::gemm<KID, true, true, true, ffn::EPI_DENSE>(
      plan[QKV_BM], plan[QKV_BN], x1, C, wqkv, C, qkv, 3 * C, bqkv, nullptr,
      ffn::Norm{l1s, l1b, C, eps1}, T, 3 * C, C, ffn::depth<E>(C), 0, st)));

  const size_t smem_ctx = ((size_t)2 * N * d + THREADS) * 4;
  STEP(set_smem((const void*)mhca_ctx_kernel<E>, smem_ctx));
  mhca_ctx_kernel<E><<<dim3(heads, B), THREADS, smem_ctx, st>>>(qkv, ctx, N,
                                                                C, d);
  STEP(cudaGetLastError());

  const Crpe crpe{{crpe_w0, crpe_w1, crpe_w2},
                  {crpe_b0, crpe_b1, crpe_b2},
                  {k0, k1, k2},
                  {n0, n0 + n1, C}};
  const size_t smem_attn = attn_smem(s, C, d, R, (int)sizeof(E));
  STEP(set_smem((const void*)mhca_attn_kernel<E>, smem_attn));
  mhca_attn_kernel<E><<<dim3((s + R - 1) / R, B), THREADS, smem_attn, st>>>(
      qkv, ctx, crpe, att, s, C, d, R, scale);
  STEP(cudaGetLastError());

  STEP((ffn::gemm<KID, true, true, false, ffn::EPI_DENSE_RESID>(
      plan[PROJ_BM], plan[PROJ_BN], att, C, wp, C, x2, C, bp, x1, ffn::Norm{},
      T, C, C, ffn::depth<E>(C), 0, st)));

  return ffn::forward<KID, false, E>(x2, ffn::Norm{l2s, l2b, C, eps2}, w1, b1,
                                     dw, dwb, ls, lb, w2, b2, x2, h, a, out,
                                     plan + FFN_PLAN, B, s, C, hid, eps, st);
#undef STEP
}

}  // namespace

#define MHCA_BLOCK(NAME, E)                                                  \
  extern "C" int NAME(                                                       \
      const E* x, const float* cpe_w, const float* cpe_b, const float* l1s,  \
      const float* l1b, const E* wqkv, const float* bqkv,                    \
      const float* crpe_w0, const float* crpe_w1, const float* crpe_w2,      \
      const float* crpe_b0, const float* crpe_b1, const float* crpe_b2,      \
      const E* wp, const float* bp, const float* l2s, const float* l2b,      \
      const E* w1, const float* b1, const E* dw, const float* dwb,           \
      const float* ls, const float* lb, const E* w2, const float* b2, E* x1, \
      E* qkv, float* ctx, E* att, E* x2, E* h, E* a, E* out,                 \
      const int* plan, int B, int s, int C, int heads, int hid, int k0,      \
      int k1, int k2, int n0, int n1, float eps1, float eps2, float eps,     \
      float scale, void* stream) {                                           \
    return block<E>(x, cpe_w, cpe_b, l1s, l1b, wqkv, bqkv, crpe_w0, crpe_w1, \
                    crpe_w2, crpe_b0, crpe_b1, crpe_b2, wp, bp, l2s, l2b, w1, \
                    b1, dw, dwb, ls, lb, w2, b2, x1, qkv, ctx, att, x2, h, a, \
                    out, plan, B, s, C, heads, hid, k0, k1, k2, n0, n1, eps1, \
                    eps2, eps, scale, stream);                               \
  }
MHCA_BLOCK(mhca_block, bf16)
MHCA_BLOCK(mhca_block_f32, float)
#undef MHCA_BLOCK
