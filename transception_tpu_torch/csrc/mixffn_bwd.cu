// Backward of the LN- and residual-folded MixFFN_skip
//   out = x + fc2(GELU(LN_h(dwconv3x3(h) + h))),  h = fc1(groupLN(x)),
// given the cotangent g of out: dx and the ten parameter gradients.
// Replaces transception_tpu/ops/pallas/mixffn_kernel.py:659
// fused_mixffn_ln_skip_bwd (its _bwd_kernel_ln, :479-653). Design notes:
// ops/kernels/mixffn.py.
//
// Bound on the H100: operations at the train shapes (five products of
// 2·T·C·hid flop each over the T = B·s² tokens: 1.2e10 flop at (24, 56²,
// 64, hidden 256), 0.012 ms at the bf16 peak, against about 29 MB of
// inputs and outputs, 0.009 ms). With the hidden intermediates in device
// memory this design moves about 32 bytes per token and hidden channel,
// which is what bounds it in practice.
//
// Few tokens per map row and a wide hidden layer leave a block per map
// row short of the card's 132 SMs, and a block cannot carry the weight
// gradients across the batch. So the backward runs as stages over the
// whole batch, each of which fills the card:
//   1. ln    xn = bf16(groupLN(x)), a warp per token;
//   2. gemm  h = bf16(xn·w1ᵀ + b1) and da = g·w2 (fp32);
//   3. conv  d = bf16(conv3x3(h) + dwb), a warp per map column walking
//            down the map with a 3 x 3 window of h in registers, a lane
//            per channel;
//      rows  per tile of TT tokens, over the whole hidden width, a thread
//            per channel: y = d + h, the hidden LN's statistics, z, GELU′,
//            dz = da·GELU′, the LN backward's two means, dy (fp32, written
//            over da) and a = bf16(GELU(z)) (over d); the block's partials
//            of ddwb, dls and dlb;
//   4. dwt   dh = dy + the correlation of dy with the taps, rounded to
//            bf16 (a tensor-core operand), and the block's partials of the
//            nine tap gradients and db1: conv's column walk, with windows
//            of dy and h;
//   5. gemm  dxn = dh·w1 (fp32); dw1 = dhᵀ·xn and dw2 = gᵀ·a, K split
//            over token ranges into a fixed number of fp32 partials;
//   6. lnb   the group-LN backward per token: dx = LN′(dxn·lts) + g, and
//            the block's partials of dlts, dltb and db2;
//   7. sum   adds each set of partials in a fixed order, one launch.
// The products are the forward's tiled product (mixffn_stages.cuh
// mixffn_gemm_kernel: 128- or 64-wide output tiles, a cp.async ring of
// swizzled panels, ldmatrix and mma.sync), with the fp32 and bias
// epilogues. The wrapper's plan
// (ops/kernels/mixffn.py bwd_plan) picks the tiles, the splits and the
// token ranges per block and allocates the intermediates. No atomics: two
// launches give the same bits.
//
// The fp32 form (mixffn_ln_skip_bwd_f32, the fp32 train step's): every
// stage is a template on the element type E of the activations, weights
// and the E intermediates (xn, h, a, dh), bf16 or fp32. At fp32 the
// rounding points are identities and the products are the tiled product's
// fp32 step (mixffn_stages.cuh: bsa::ffma_step on the CUDA cores, 32 deep
// a staged step); the fp32 intermediates and partials are the same. Bound
// at fp32: operations at 67 TFLOP/s of FFMA.
#include "mixffn_stages.cuh"

namespace {

using ffn::BK;
using ffn::EPI_BIAS;
using ffn::EPI_F32;
using ffn::NW;
using ffn::RSQRT2;
using ffn::THREADS;

constexpr int TT = 8;       // tokens per tile of the rows kernel
constexpr int CH = 32;      // channels of a column-walk block (a lane each)
constexpr float INV_SQRT_2PI = 0.3989422804014327f;

// Mean and rsqrt(E[x²] - mean² + eps) of one token over channels
// [c0, c0 + n), reduced over the warp.
template <typename E>
__device__ __forceinline__ float2 ln_stats(const E* src, int c0, int n,
                                           float eps_ln, int lane) {
  float sm = 0.0f, sq = 0.0f;
  for (int c = c0 + lane; c < c0 + n; c += 32) {
    const float v = tof(src[c]);
    sm += v;
    sq += v * v;
  }
  sm = warp_sum(sm);
  sq = warp_sum(sq);
  const float mean = sm / n;
  return make_float2(mean, rsqrtf(sq / n - mean * mean + eps_ln));
}

// The caller's LayerNorm of one token over channels [c0, c0 + n).
template <typename E>
__device__ __forceinline__ void ln_range(const E* src, E* dst,
                                         const float* lts, const float* ltb,
                                         int c0, int n, float eps_ln,
                                         int lane) {
  const float2 st = ln_stats(src, c0, n, eps_ln, lane);
  for (int c = c0 + lane; c < c0 + n; c += 32) {
    const float v = tof(src[c]);
    dst[c] = fromf<E>((v - st.x) * st.y * lts[c] + ltb[c]);
  }
}

// One product of the backward (owner tag 11 in the profile).
template <bool AMK, bool BNK, int EPI, typename E>
cudaError_t gemm(int bm, int bn, const E* A, int lda, const E* B, int ldb,
                 void* out, int ldo, const float* bias, int M, int N, int K,
                 int kper, size_t split, cudaStream_t st) {
  return ffn::gemm<11, AMK, BNK, false, EPI>(bm, bn, A, lda, B, ldb, out, ldo,
                                             bias, nullptr, ffn::Norm{}, M, N,
                                             K, kper, split, st);
}

// Stage 1: xn = E(groupLN(x)), a warp per token.
template <typename E>
__global__ void __launch_bounds__(THREADS)
mixffn_bwd_ln_kernel(const E* x, const float* lts, const float* ltb, E* xn,
                     int T, int C, int gsz, float eps_ln) {
  const int n = blockIdx.x * NW + (threadIdx.x >> 5);
  if (n >= T) return;
  for (int c0 = 0; c0 < C; c0 += gsz)
    ln_range(x + (size_t)n * C, xn + (size_t)n * C, lts, ltb, c0,
                     gsz, eps_ln, threadIdx.x & 31);
}

// tok[t·4 + o + q] = the block's sum of v_q[t] (q = 0, 1), for t < TT, in
// a fixed order: the values go through shared memory (red: 2 x TT x
// THREADS) and warp t adds token t's, 8 a lane, then across the lanes.
static_assert(TT == NW, "block_sum2 gives each token a warp");
__device__ __forceinline__ void block_sum2(const float (&v0)[TT],
                                           const float (&v1)[TT], float* red,
                                           float* tok, int o) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < TT; ++t) {
    red[t * THREADS + threadIdx.x] = v0[t];
    red[(TT + t) * THREADS + threadIdx.x] = v1[t];
  }
  __syncthreads();
  float a = 0.0f, b = 0.0f;
#pragma unroll
  for (int k = lane; k < THREADS; k += 32) {
    a += red[w * THREADS + k];
    b += red[(TT + w) * THREADS + k];
  }
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    tok[w * 4 + o] = a;
    tok[w * 4 + o + 1] = b;
  }
  __syncthreads();
}

__host__ __device__ inline size_t rows_smem(int H) {
  return (size_t)(2 * TT * H + 3 * H + 2 * TT * THREADS + TT * 4) * 4;
}

// A warp's 3 x 3 window of one channel around map row i, column j: rows
// i-1, i, i+1 by columns j-1, j, j+1, zero off the R x s map. The column
// walks below move it down one row a step, loading the new row's three
// values.
template <typename E>
struct Window {
  const E* p;  // channel c of batch row b: element (i, j) at p[(i·s + j)·H]
  int R, s, j;
  size_t H;
  float v[3][3];
  __device__ float at(int i, int jj) const {
    if (i < 0 || i >= R || jj < 0 || jj >= s) return 0.0f;
    return to_f(p[(size_t)(i * s + jj) * H]);
  }
  static __device__ float to_f(float x) { return x; }
  static __device__ float to_f(bf16 x) { return __bfloat162float(x); }
  __device__ void start() {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      v[0][q] = 0.0f;
      v[1][q] = at(0, j - 1 + q);
      v[2][q] = at(1, j - 1 + q);
    }
  }
  __device__ void step(int i) {  // from centre row i to i + 1
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      v[0][q] = v[1][q];
      v[1][q] = v[2][q];
      v[2][q] = at(i + 2, j - 1 + q);
    }
  }
};

// Stage 3a: d = E(conv3x3(h) + dwb) (the forward's tap order), written
// into a's buffer. One block per (NW map columns, batch row, CH channels)
// of B maps of R rows and s columns: warp w walks column blockIdx.x·NW + w
// down the map, lane l takes channel blockIdx.z·CH + l, coalesced across
// the lanes.
template <typename E>
__global__ void __launch_bounds__(THREADS)
mixffn_bwd_conv_kernel(const E* h, const E* dw, const float* dwb, E* d,
                       int R, int s, int H) {
  const int j = blockIdx.x * NW + (threadIdx.x >> 5);
  const int c = blockIdx.z * CH + (threadIdx.x & 31);
  if (j >= s || c >= H) return;
  const size_t base = (size_t)blockIdx.y * R * s * H + c;
  float wk[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) wk[q] = tof(dw[(size_t)c * 9 + q]);
  const float bd = dwb[c];
  Window<E> wh{h + base, R, s, j, (size_t)H};
  wh.start();
  for (int i = 0; i < R; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int dj = 0; dj < 3; ++dj)
#pragma unroll
      for (int di = 0; di < 3; ++di) acc += wh.v[di][dj] * wk[di * 3 + dj];
    d[base + (size_t)(i * s + j) * H] = fromf<E>(acc + bd);
    wh.step(i);
  }
}

// Stage 3b, per tile of TT tokens (the block's tiles [blockIdx.x·tpb, +tpb))
// over the whole hidden width, a thread per channel: y = d + h, the hidden
// LN's statistics, z, GELU′, dz = da·GELU′, the LN backward's two means,
// dy over da, a = E(GELU(z)) over d. y and dz of the tile stay in shared
// memory (each thread touches only its own channels there); the per-token
// sums go through block_sum2.
template <typename E>
__global__ void __launch_bounds__(THREADS)
mixffn_bwd_rows_kernel(const E* h, float* da, E* a, const float* ls,
                       const float* lb, float* part, int T, int H, int tpb,
                       float eps) {
  extern __shared__ __align__(16) float sm[];
  float* ys = sm;              // TT x H
  float* dzs = ys + TT * H;    // TT x H
  float* col = dzs + TT * H;   // ddwb, dls, dlb: 3 x H
  float* red = col + 3 * H;    // 2 x TT x THREADS
  float* tok = red + 2 * TT * THREADS;  // TT x (Σ y, Σ y², Σ dyh, Σ dyh·yh)
  const int ntile = (T + TT - 1) / TT;
  for (int c = threadIdx.x; c < 3 * H; c += THREADS) col[c] = 0.0f;
  const int tile1 = min(ntile, (blockIdx.x + 1) * tpb);
  for (int tile = blockIdx.x * tpb; tile < tile1; ++tile) {
    const int n0 = tile * TT;
    float p1[TT], p2[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) p1[t] = p2[t] = 0.0f;
    for (int c = threadIdx.x; c < H; c += THREADS) {
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        const size_t e = (size_t)(n0 + t) * H + c;
        const float y = n0 + t < T ? tof(a[e]) + tof(h[e]) : 0.0f;
        ys[t * H + c] = y;
        p1[t] += y;
        p2[t] += y * y;
      }
    }
    block_sum2(p1, p2, red, tok, 0);
    float mean[TT], inv[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      mean[t] = tok[t * 4] / H;
      inv[t] = rsqrtf(tok[t * 4 + 1] / H - mean[t] * mean[t] + eps);
      p1[t] = p2[t] = 0.0f;
    }
    // z, GELU′, dz; a = E(z·Φ(z)); the sums of dyh = dz·ls and dyh·yh.
    for (int c = threadIdx.x; c < H; c += THREADS) {
      const float lsc = ls[c], lbc = lb[c];
      float dls = 0.0f, dlb = 0.0f;
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        if (n0 + t >= T) continue;
        const size_t e = (size_t)(n0 + t) * H + c;
        const float yh = (ys[t * H + c] - mean[t]) * inv[t];
        const float z = rnd<E>(yh * lsc + lbc);
        const float half1e = 0.5f * (1.0f + erff(z * RSQRT2));
        const float gp = half1e + z * expf(-0.5f * z * z) * INV_SQRT_2PI;
        const float dz = da[e] * gp;
        dzs[t * H + c] = dz;
        p1[t] += dz * lsc;
        p2[t] += dz * lsc * yh;
        dls += dz * yh;
        dlb += dz;
        a[e] = fromf<E>(z * half1e);
      }
      col[H + c] += dls;
      col[2 * H + c] += dlb;
    }
    block_sum2(p1, p2, red, tok, 2);
    float m1[TT], m2[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      m1[t] = tok[t * 4 + 2] / H;
      m2[t] = tok[t * 4 + 3] / H;
    }
    // dy (= dd), over da.
    for (int c = threadIdx.x; c < H; c += THREADS) {
      const float lsc = ls[c];
      float dd = 0.0f;
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        if (n0 + t >= T) continue;
        const float yh = (ys[t * H + c] - mean[t]) * inv[t];
        const float dy = inv[t] * (dzs[t * H + c] * lsc - m1[t] - yh * m2[t]);
        da[(size_t)(n0 + t) * H + c] = dy;
        dd += dy;
      }
      col[c] += dd;
    }
  }
  float* p = part + (size_t)blockIdx.x * 3 * H;
  for (int c = threadIdx.x; c < 3 * H; c += THREADS) p[c] = col[c];
}

// Stage 4: dh = dy + the conv transpose of dy (a correlation with the
// taps), rounded to E; the tap gradients Σ dy(i, j)·h(i+di−1, j+dj−1)
// and db1 (from the fp32 dh). The column walk of stage 3a, with windows of
// dy and h; the block's warps are added in a fixed order into partial
// blockIdx.y·gridDim.x + blockIdx.x, laid out [db1 (H), ddw (H x 9)], of
// which the block writes its CH channels.
template <typename E>
__global__ void __launch_bounds__(THREADS)
mixffn_bwd_dwt_kernel(const float* dy, const E* h, const E* dw, E* dh,
                      float* part, int R, int s, int H) {
  __shared__ float red[10][NW][CH];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * NW + w, c = blockIdx.z * CH + lane;
  float acc[10];  // the nine tap gradients, db1
#pragma unroll
  for (int q = 0; q < 10; ++q) acc[q] = 0.0f;
  if (j < s && c < H) {
    const size_t base = (size_t)blockIdx.y * R * s * H + c;
    float wk[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) wk[q] = tof(dw[(size_t)c * 9 + q]);
    Window<float> wd{dy + base, R, s, j, (size_t)H};
    Window<E> wh{h + base, R, s, j, (size_t)H};
    wd.start();
    wh.start();
    for (int i = 0; i < R; ++i) {
      const float dyc = wd.v[1][1];
      float d = dyc;
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          d += wd.v[2 - di][2 - dj] * wk[di * 3 + dj];  // dy(i-di+1, j-dj+1)
          acc[di * 3 + dj] += dyc * wh.v[di][dj];        // h(i+di-1, j+dj-1)
        }
      dh[base + (size_t)(i * s + j) * H] = fromf<E>(d);
      acc[9] += d;
      wd.step(i);
      wh.step(i);
    }
  }
#pragma unroll
  for (int q = 0; q < 10; ++q) red[q][w][lane] = acc[q];
  __syncthreads();
  float* pb = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 10 * H;
  for (int i = threadIdx.x; i < 10 * CH; i += THREADS) {
    const int q = i / CH, l = i % CH, cc = blockIdx.z * CH + l;
    if (cc >= H) continue;
    float v = 0.0f;
    for (int k = 0; k < NW; ++k) v += red[q][k][l];
    if (q == 9)
      pb[cc] = v;
    else
      pb[H + (size_t)cc * 9 + q] = v;
  }
}

// Stage 6: the group-LN backward, a warp per token of the block's range:
// dx = inv·(d − mean(d) − yhx·mean(d·yhx)) + g with d = dxn·lts; the
// block's partials of db2 (Σ g), dlts (Σ dxn·yhx) and dltb (Σ dxn), kept
// per warp in shared memory (each entry written by one lane only).
template <typename E>
__global__ void __launch_bounds__(THREADS)
mixffn_bwd_lnb_kernel(const E* x, const E* g, const float* dxn,
                      const float* lts, E* dx, float* part, int T, int C,
                      int gsz, int tpb, float eps_ln) {
  extern __shared__ __align__(16) float red[];  // 3 x NW x C
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 3 * NW * C; i += THREADS) red[i] = 0.0f;
  __syncthreads();
  const int nb = blockIdx.x * tpb * TT, ne = min(T, nb + tpb * TT);
  for (int n = nb + w; n < ne; n += NW) {
    const E* src = x + (size_t)n * C;
    const E* gc = g + (size_t)n * C;
    const float* dxr = dxn + (size_t)n * C;
    for (int c0 = 0; c0 < C; c0 += gsz) {
      const float2 ms = ln_stats(src, c0, gsz, eps_ln, lane);
      const float mean = ms.x, inv = ms.y;
      float n1 = 0.0f, n2 = 0.0f;
      for (int c = c0 + lane; c < c0 + gsz; c += 32) {
        const float yhx = (tof(src[c]) - mean) * inv;
        const float d = dxr[c] * lts[c];
        n1 += d;
        n2 += d * yhx;
      }
      n1 = warp_sum(n1) / gsz;
      n2 = warp_sum(n2) / gsz;
      for (int c = c0 + lane; c < c0 + gsz; c += 32) {
        const float yhx = (tof(src[c]) - mean) * inv;
        const float gv = tof(gc[c]);
        const float d = dxr[c] * lts[c];
        dx[(size_t)n * C + c] = fromf<E>(inv * (d - n1 - yhx * n2) + gv);
        red[(0 * NW + w) * C + c] += gv;
        red[(1 * NW + w) * C + c] += dxr[c] * yhx;
        red[(2 * NW + w) * C + c] += dxr[c];
      }
    }
  }
  __syncthreads();
  float* p = part + (size_t)blockIdx.x * 3 * C;
  for (int i = threadIdx.x; i < 3 * C; i += THREADS) {
    const int q = i / C, c = i % C;
    float v = 0.0f;
    for (int k = 0; k < NW; ++k) v += red[(q * NW + k) * C + c];
    p[i] = v;
  }
}

// Stage 7: grads = [dw1, dw2 | db1, ddw | ddwb, dls, dlb | db2, dlts,
// dltb], each part the sum of its set of partials in a fixed order. The
// weight set (many outputs, a few partials) takes a thread per output,
// the others (few outputs, hundreds of partials) a warp per output: lane
// l adds partials l, l + 32, ... in turn, then the warp's fixed shuffle
// tree. Blocks [0, wblocks) take the first, the rest the others.
struct Sums {
  const float* p[4];
  int n[4];
  size_t end[4];  // grads[end[k-1], end[k]) sums set k
};

__global__ void mixffn_bwd_sum_kernel(Sums s, float* grads, int wblocks) {
  if ((int)blockIdx.x < wblocks) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= s.end[0]) return;
    float v = 0.0f;
#pragma unroll 8
    for (int q = 0; q < s.n[0]; ++q) v += s.p[0][(size_t)q * s.end[0] + i];
    grads[i] = v;
    return;
  }
  const size_t i = s.end[0] +
                   ((size_t)(blockIdx.x - wblocks) * blockDim.x + threadIdx.x) / 32;
  if (i >= s.end[3]) return;  // whole warps
  int k = 1;
  while (i >= s.end[k]) ++k;
  const size_t lo = s.end[k - 1], len = s.end[k] - lo;
  const float* p = s.p[k] + (i - lo);
  float v = 0.0f;
  for (int q = threadIdx.x & 31; q < s.n[k]; q += 32) v += p[(size_t)q * len];
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) grads[i] = v;
}

// K11's hidden-sharded form (H of the hidden layer's Hn channels on this
// rank; st holds each token's (Σ y, Σ y²) summed over the ranks, from the
// forward). The rows kernel splits at the LN backward's two sums over the
// hidden width:
// A: z, GELU′, dz = da·GELU′ (over da), a = E(GELU(z)), the block's
//    partials of dls and dlb, and each token's partial (Σ dz·ls,
//    Σ dz·ls·ŷ) into m; the caller sums m over the ranks;
// B: with m summed, dy = inv·(dz·ls − m₁ − ŷ·m₂) into dy and the block's
//    partials of ddwb.
// The tiles and token ranges are the unsharded rows kernel's.
template <typename E>
__global__ void __launch_bounds__(THREADS)
mixffn_tp_rows_a_kernel(const E* h, const E* d, float* da, E* a,
                        const float* ls, const float* lb, const float2* st,
                        float2* m, float* part, int T, int H, int Hn,
                        int tpb, float eps) {
  extern __shared__ __align__(16) float sm[];
  float* col = sm;                      // dls, dlb: 2 x H
  float* red = col + 2 * H;             // 2 x TT x THREADS
  float* tok = red + 2 * TT * THREADS;  // TT x 4
  const int ntile = (T + TT - 1) / TT;
  for (int c = threadIdx.x; c < 2 * H; c += THREADS) col[c] = 0.0f;
  const int tile1 = min(ntile, (blockIdx.x + 1) * tpb);
  for (int tile = blockIdx.x * tpb; tile < tile1; ++tile) {
    const int n0 = tile * TT;
    float mean[TT], inv[TT], p1[TT], p2[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      const float2 v = n0 + t < T ? st[n0 + t] : make_float2(0.0f, 1.0f);
      mean[t] = v.x / Hn;
      inv[t] = rsqrtf(v.y / Hn - mean[t] * mean[t] + eps);
      p1[t] = p2[t] = 0.0f;
    }
    for (int c = threadIdx.x; c < H; c += THREADS) {
      const float lsc = ls[c], lbc = lb[c];
      float dls = 0.0f, dlb = 0.0f;
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        if (n0 + t >= T) continue;
        const size_t e = (size_t)(n0 + t) * H + c;
        const float yh = (tof(d[e]) + tof(h[e]) - mean[t]) * inv[t];
        const float z = rnd<E>(yh * lsc + lbc);
        const float half1e = 0.5f * (1.0f + erff(z * RSQRT2));
        const float gp = half1e + z * expf(-0.5f * z * z) * INV_SQRT_2PI;
        const float dz = da[e] * gp;
        da[e] = dz;
        p1[t] += dz * lsc;
        p2[t] += dz * lsc * yh;
        dls += dz * yh;
        dlb += dz;
        a[e] = fromf<E>(z * half1e);
      }
      col[c] += dls;
      col[H + c] += dlb;
    }
    block_sum2(p1, p2, red, tok, 0);
    if (threadIdx.x < TT && n0 + (int)threadIdx.x < T)
      m[n0 + threadIdx.x] =
          make_float2(tok[threadIdx.x * 4], tok[threadIdx.x * 4 + 1]);
  }
  __syncthreads();
  float* p = part + (size_t)blockIdx.x * 2 * H;
  for (int c = threadIdx.x; c < 2 * H; c += THREADS) p[c] = col[c];
}

template <typename E>
__global__ void __launch_bounds__(THREADS)
mixffn_tp_rows_b_kernel(const E* h, const E* d, const float* dz,
                        const float* ls, const float2* st, const float2* m,
                        float* dy, float* part, int T, int H, int Hn,
                        int tpb, float eps) {
  extern __shared__ __align__(16) float col[];  // ddwb: H
  const int ntile = (T + TT - 1) / TT;
  for (int c = threadIdx.x; c < H; c += THREADS) col[c] = 0.0f;
  const int tile1 = min(ntile, (blockIdx.x + 1) * tpb);
  for (int tile = blockIdx.x * tpb; tile < tile1; ++tile) {
    const int n0 = tile * TT;
    float mean[TT], inv[TT], m1[TT], m2[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      const bool in = n0 + t < T;
      const float2 v = in ? st[n0 + t] : make_float2(0.0f, 1.0f);
      const float2 q = in ? m[n0 + t] : make_float2(0.0f, 0.0f);
      mean[t] = v.x / Hn;
      inv[t] = rsqrtf(v.y / Hn - mean[t] * mean[t] + eps);
      m1[t] = q.x / Hn;
      m2[t] = q.y / Hn;
    }
    for (int c = threadIdx.x; c < H; c += THREADS) {
      const float lsc = ls[c];
      float dd = 0.0f;
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        if (n0 + t >= T) continue;
        const size_t e = (size_t)(n0 + t) * H + c;
        const float yh = (tof(d[e]) + tof(h[e]) - mean[t]) * inv[t];
        const float v = inv[t] * (dz[e] * lsc - m1[t] - yh * m2[t]);
        dy[e] = v;
        dd += v;
      }
      col[c] += dd;
    }
  }
  __syncthreads();
  float* p = part + (size_t)blockIdx.x * H;
  for (int c = threadIdx.x; c < H; c += THREADS) p[c] = col[c];
}

// Indices into the wrapper's plan (ops/kernels/mixffn.py bwd_plan).
enum Plan {
  H_BM, H_BN, DA_BM, DA_BN, DXN_BM, DXN_BN, DW1_BM, DW1_BN, DW2_BM, DW2_BN,
  SPLITS, KPER, BLOCKS, TILES_PER_BLOCK, PLAN_LEN
};

}  // namespace

// x, g, dx: (B, R·s, C) E, B maps of R rows and s columns (R = s: a whole
// square map; R != s: a block of a map's rows with its halo rows, g zero
// on the halo rows); w1 (hid, C), dw (hid, 9), w2 (C, hid) E;
// lts/ltb (C,) the tiled group-LN scale/bias, the rest fp32 vectors.
// grads: fp32 dw1 (hid, C), dw2 (C, hid), db1, ddw (hid, 9), ddwb, dls,
// dlb, db2, dlts, dltb. Workspace (T = B·R·s tokens): xn (T, C) E, h
// (T, hid) E, da (T, hid) fp32 (dy after stage 3), a and dh (T, hid)
// E (a holds the conv output d until stage 3b), dxn (T, C) fp32;
// partials pw (splits, 2·hid·C), pr (blocks, 3·hid), pd (B·ceil(s/NW),
// 10·hid), pl (blocks, 3·C), fp32. plan: PLAN_LEN ints. E: bf16, or fp32
// for mixffn_ln_skip_bwd_f32.
template <typename E>
int ln_skip_bwd(const E* x, const E* g, const float* lts, const float* ltb,
                const E* w1, const float* b1, const E* dw, const float* dwb,
                const float* ls, const float* lb, const E* w2, E* dx,
                float* grads, E* xn, E* h, float* da, E* a, E* dh, float* dxn,
                float* pw, float* pr, float* pd, float* pl, const int* plan,
                int B, int R, int s, int C, int hid, int groups, float eps_ln,
                float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = B * R * s, H = hid, gsz = C / groups;
  const int P = plan[BLOCKS], tpb = plan[TILES_PER_BLOCK];
  const int S = plan[SPLITS], kper = plan[KPER];
  const size_t HC = (size_t)H * C;
  cudaError_t e;
#define STEP(call) \
  if ((e = (call))) return e
  mixffn_bwd_ln_kernel<E><<<(T + NW - 1) / NW, THREADS, 0, st>>>(
      x, lts, ltb, xn, T, C, gsz, eps_ln);
  STEP(cudaGetLastError());
  STEP((gemm<true, true, EPI_BIAS>(plan[H_BM], plan[H_BN], xn, C, w1, C, h, H,
                               b1, T, H, C, (C + BK - 1) / BK * BK, 0, st)));
  STEP((gemm<true, false, EPI_F32>(plan[DA_BM], plan[DA_BN], g, C, w2, H, da,
                                 H, nullptr, T, H, C, (C + BK - 1) / BK * BK,
                                 0, st)));
  const dim3 walk((s + NW - 1) / NW, B, (H + CH - 1) / CH);
  mixffn_bwd_conv_kernel<E><<<walk, THREADS, 0, st>>>(h, dw, dwb, a, R, s,
                                                      H);
  STEP(cudaGetLastError());
  const size_t rs = rows_smem(H);
  STEP(set_smem((const void*)mixffn_bwd_rows_kernel<E>, rs));
  mixffn_bwd_rows_kernel<E><<<P, THREADS, rs, st>>>(h, da, a, ls, lb, pr, T,
                                                    H, tpb, eps);
  STEP(cudaGetLastError());
  mixffn_bwd_dwt_kernel<E><<<walk, THREADS, 0, st>>>(da, h, dw, dh, pd, R, s,
                                                     H);
  STEP(cudaGetLastError());
  STEP((gemm<true, false, EPI_F32>(plan[DXN_BM], plan[DXN_BN], dh, H, w1, C,
                                 dxn, C, nullptr, T, C, H,
                                 (H + BK - 1) / BK * BK, 0, st)));
  STEP((gemm<false, false, EPI_F32>(plan[DW1_BM], plan[DW1_BN], dh, H, xn, C,
                                  pw, C, nullptr, H, C, T, kper, 2 * HC,
                                  st)));
  STEP((gemm<false, false, EPI_F32>(plan[DW2_BM], plan[DW2_BN], g, C, a, H,
                                  pw + HC, H, nullptr, C, H, T, kper, 2 * HC,
                                  st)));
  const size_t ls_ = (size_t)3 * NW * C * 4;
  STEP(set_smem((const void*)mixffn_bwd_lnb_kernel<E>, ls_));
  mixffn_bwd_lnb_kernel<E><<<P, THREADS, ls_, st>>>(x, g, dxn, lts, dx, pl, T,
                                                    C, gsz, tpb, eps_ln);
  STEP(cudaGetLastError());
  const Sums sums{{pw, pd, pr, pl},
                  {S, (int)(walk.x * walk.y), P, P},
                  {2 * HC, 2 * HC + 10 * (size_t)H, 2 * HC + 13 * (size_t)H,
                   2 * HC + 13 * (size_t)H + 3 * (size_t)C}};
  const int wblocks = (int)((sums.end[0] + 255) / 256);
  const int rblocks = (int)((sums.end[3] - sums.end[0] + 7) / 8);
  mixffn_bwd_sum_kernel<<<wblocks + rblocks, 256, 0, st>>>(sums, grads,
                                                           wblocks);
  STEP(cudaGetLastError());
#undef STEP
  return cudaSuccess;
}

#define LN_SKIP_BWD(NAME, E)                                                  \
  extern "C" int NAME(const E* x, const E* g, const float* lts,               \
                      const float* ltb, const E* w1, const float* b1,         \
                      const E* dw, const float* dwb, const float* ls,         \
                      const float* lb, const E* w2, E* dx, float* grads,      \
                      E* xn, E* h, float* da, E* a, E* dh, float* dxn,        \
                      float* pw, float* pr, float* pd, float* pl,             \
                      const int* plan, int B, int R, int s, int C, int hid,   \
                      int groups, float eps_ln, float eps, void* stream) {    \
    return ln_skip_bwd<E>(x, g, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, dx,    \
                          grads, xn, h, da, a, dh, dxn, pw, pr, pd, pl, plan, \
                          B, R, s, C, hid, groups, eps_ln, eps, stream);      \
  }
LN_SKIP_BWD(mixffn_ln_skip_bwd, bf16)
LN_SKIP_BWD(mixffn_ln_skip_bwd_f32, float)
#undef LN_SKIP_BWD

// The entries of K11's hidden-sharded form (H of the hidden layer's Hn
// channels on this rank), between which the caller sums over the ranks:
//   mixffn_tp_bwd_rows  xn, h, da = g·w2 (on the rank's w2 columns), the
//                       conv d, then rows A (above): dz, a, the partial
//                       sums m (B·s², 2), and dls, dlb summed (grads:
//                       2·H fp32);
//   mixffn_tp_bwd_dh    with m summed: rows B (dy), the depthwise
//                       transpose (dh), the fp32 partial dxn = dh·w1
//                       (B·s², C), dw1 = dhᵀ·xn, dw2 = gᵀ·a (the rank's
//                       columns), the sums (grads: dw1, dw2, db1, ddw,
//                       ddwb);
//   mixffn_tp_bwd_ln    with dxn summed: the caller's group-LN backward,
//                       dx = LN′(dxn·lts) + g, and db2, dlts, dltb (grads:
//                       3·C), equal on every rank.
// The unsharded K11's stages, tiles and plan (bwd_plan at hidden H); st is
// the forward's summed (Σ y, Σ y²). E: bf16, or fp32 (_f32).
template <typename E>
int tp_bwd_rows(const E* x, const E* g, const float* lts, const float* ltb,
                const E* w1, const float* b1, const E* dw, const float* dwb,
                const float* ls, const float* lb, const E* w2,
                const float* st, E* xn, E* h, E* d, E* a, float* dz,
                float* m, float* grads, float* pr, const int* plan, int B,
                int s, int C, int H, int Hn, int groups, float eps_ln,
                float eps, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int T = B * s * s, gsz = C / groups;
  const int P = plan[BLOCKS], tpb = plan[TILES_PER_BLOCK];
  cudaError_t e;
#define STEP(call) \
  if ((e = (call))) return e
  mixffn_bwd_ln_kernel<E><<<(T + NW - 1) / NW, THREADS, 0, cs>>>(
      x, lts, ltb, xn, T, C, gsz, eps_ln);
  STEP(cudaGetLastError());
  STEP((gemm<true, true, EPI_BIAS>(plan[H_BM], plan[H_BN], xn, C, w1, C, h, H,
                                   b1, T, H, C, (C + BK - 1) / BK * BK, 0,
                                   cs)));
  STEP((gemm<true, false, EPI_F32>(plan[DA_BM], plan[DA_BN], g, C, w2, H, dz,
                                   H, nullptr, T, H, C,
                                   (C + BK - 1) / BK * BK, 0, cs)));
  const dim3 walk((s + NW - 1) / NW, B, (H + CH - 1) / CH);
  mixffn_bwd_conv_kernel<E><<<walk, THREADS, 0, cs>>>(h, dw, dwb, d, s, s,
                                                      H);
  STEP(cudaGetLastError());
  const size_t rs = (size_t)(2 * H + 2 * TT * THREADS + TT * 4) * 4;
  STEP(set_smem((const void*)mixffn_tp_rows_a_kernel<E>, rs));
  mixffn_tp_rows_a_kernel<E><<<P, THREADS, rs, cs>>>(
      h, d, dz, a, ls, lb, reinterpret_cast<const float2*>(st),
      reinterpret_cast<float2*>(m), pr, T, H, Hn, tpb, eps);
  STEP(cudaGetLastError());
  const Sums sums{{pr, pr, pr, pr}, {0, 0, P, 0},
                  {0, 0, 2 * (size_t)H, 2 * (size_t)H}};
  mixffn_bwd_sum_kernel<<<(2 * H + 7) / 8, 256, 0, cs>>>(sums, grads, 0);
  STEP(cudaGetLastError());
  return cudaSuccess;
}

template <typename E>
int tp_bwd_dh(const E* xn, const E* h, const E* d, const E* a,
              const float* dz, const E* g, const E* dw, const float* ls,
              const E* w1, const float* st, const float* m, float* dxn,
              float* grads, float* dy, E* dh, float* pw, float* pd,
              float* pr, const int* plan, int B, int s, int C, int H, int Hn,
              float eps, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int T = B * s * s;
  const int P = plan[BLOCKS], tpb = plan[TILES_PER_BLOCK];
  const int kper = plan[KPER];
  const size_t HC = (size_t)H * C;
  cudaError_t e;
  const size_t rs = (size_t)H * 4;
  STEP(set_smem((const void*)mixffn_tp_rows_b_kernel<E>, rs));
  mixffn_tp_rows_b_kernel<E><<<P, THREADS, rs, cs>>>(
      h, d, dz, ls, reinterpret_cast<const float2*>(st),
      reinterpret_cast<const float2*>(m), dy, pr, T, H, Hn, tpb, eps);
  STEP(cudaGetLastError());
  const dim3 walk((s + NW - 1) / NW, B, (H + CH - 1) / CH);
  mixffn_bwd_dwt_kernel<E><<<walk, THREADS, 0, cs>>>(dy, h, dw, dh, pd, s, s,
                                                     H);
  STEP(cudaGetLastError());
  STEP((gemm<true, false, EPI_F32>(plan[DXN_BM], plan[DXN_BN], dh, H, w1, C,
                                   dxn, C, nullptr, T, C, H,
                                   (H + BK - 1) / BK * BK, 0, cs)));
  STEP((gemm<false, false, EPI_F32>(plan[DW1_BM], plan[DW1_BN], dh, H, xn, C,
                                    pw, C, nullptr, H, C, T, kper, 2 * HC,
                                    cs)));
  STEP((gemm<false, false, EPI_F32>(plan[DW2_BM], plan[DW2_BN], g, C, a, H,
                                    pw + HC, H, nullptr, C, H, T, kper,
                                    2 * HC, cs)));
  const Sums sums{{pw, pd, pr, pr},
                  {plan[SPLITS], (int)(walk.x * walk.y), P, 0},
                  {2 * HC, 2 * HC + 10 * (size_t)H, 2 * HC + 11 * (size_t)H,
                   2 * HC + 11 * (size_t)H}};
  const int wblocks = (int)((sums.end[0] + 255) / 256);
  const int rblocks = (int)((sums.end[3] - sums.end[0] + 7) / 8);
  mixffn_bwd_sum_kernel<<<wblocks + rblocks, 256, 0, cs>>>(sums, grads,
                                                           wblocks);
  STEP(cudaGetLastError());
  return cudaSuccess;
}

template <typename E>
int tp_bwd_ln(const E* x, const E* g, const float* dxn, const float* lts,
              E* dx, float* grads, float* pl, int P, int tpb, int B, int s,
              int C, int groups, float eps_ln, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int T = B * s * s;
  cudaError_t e;
  const size_t ls_ = (size_t)3 * NW * C * 4;
  STEP(set_smem((const void*)mixffn_bwd_lnb_kernel<E>, ls_));
  mixffn_bwd_lnb_kernel<E><<<P, THREADS, ls_, cs>>>(x, g, dxn, lts, dx, pl, T,
                                                    C, C / groups, tpb,
                                                    eps_ln);
  STEP(cudaGetLastError());
  const Sums sums{{pl, pl, pl, pl}, {0, 0, 0, P},
                  {0, 0, 0, 3 * (size_t)C}};
  mixffn_bwd_sum_kernel<<<(3 * C + 7) / 8, 256, 0, cs>>>(sums, grads, 0);
  STEP(cudaGetLastError());
#undef STEP
  return cudaSuccess;
}

#define TP_BWD(SUF, E)                                                        \
  extern "C" int mixffn_tp_bwd_rows##SUF(                                     \
      const E* x, const E* g, const float* lts, const float* ltb,             \
      const E* w1, const float* b1, const E* dw, const float* dwb,            \
      const float* ls, const float* lb, const E* w2, const float* st, E* xn,  \
      E* h, E* d, E* a, float* dz, float* m, float* grads, float* pr,         \
      const int* plan, int B, int s, int C, int hid, int hid_all,             \
      int groups, float eps_ln, float eps, void* stream) {                    \
    return tp_bwd_rows<E>(x, g, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, st,   \
                          xn, h, d, a, dz, m, grads, pr, plan, B, s, C, hid,  \
                          hid_all, groups, eps_ln, eps, stream);              \
  }                                                                           \
  extern "C" int mixffn_tp_bwd_dh##SUF(                                       \
      const E* xn, const E* h, const E* d, const E* a, const float* dz,       \
      const E* g, const E* dw, const float* ls, const E* w1,                  \
      const float* st, const float* m, float* dxn, float* grads, float* dy,   \
      E* dh, float* pw, float* pd, float* pr, const int* plan, int B, int s,  \
      int C, int hid, int hid_all, float eps, void* stream) {                 \
    return tp_bwd_dh<E>(xn, h, d, a, dz, g, dw, ls, w1, st, m, dxn, grads,    \
                        dy, dh, pw, pd, pr, plan, B, s, C, hid, hid_all, eps, \
                        stream);                                              \
  }                                                                           \
  extern "C" int mixffn_tp_bwd_ln##SUF(                                       \
      const E* x, const E* g, const float* dxn, const float* lts, E* dx,      \
      float* grads, float* pl, int blocks, int tpb, int B, int s, int C,      \
      int groups, float eps_ln, void* stream) {                               \
    return tp_bwd_ln<E>(x, g, dxn, lts, dx, grads, pl, blocks, tpb, B, s, C,  \
                        groups, eps_ln, stream);                              \
  }
TP_BWD(, bf16)
TP_BWD(_f32, float)
#undef TP_BWD
