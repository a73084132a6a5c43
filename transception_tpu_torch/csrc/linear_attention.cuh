// The linear-attention core that the ETB attention (K1) and the linear
// attention (K6) share, as stages over every (batch, head) at once:
//   out = bf16(scale · Q' · ctx),  ctx = bf16(Ksᵀ · V),
//   Ks = bf16(exp(K − m) / S) with m and S the column max and sum of
//   exp(K − m) over all N rows, Q' = bf16(softmax over the head's channels
//   of Q) or Q itself.
// The rounding points are the Pallas kernels'
// (transception_tpu/ops/pallas/linear_attention_kernel.py:95-121 and
// :203-231): Ks, Q', the context and the output in bf16, the statistics
// and every sum in fp32; the scale multiplies the fp32 product before its
// one rounding (ops/attention.py:68-73). The only other order is that of
// the segments' exp sums, combined in a fixed order.
//
// A head of N = 3136 rows does not fit a block, and blocks run in no
// order, so the reductions over N are cut into S segments of N (the
// wrapper's plan picks S so that the context stage fills the card) and
// summed in a fixed order, with no atomics:
//   1. stats  per (32 key columns, segment, batch·head): the column max and
//             sum of exp(K − max) over the segment's rows, 16-byte loads
//             (4 lanes a row), a running max per lane, the 64 row groups
//             combined in order;
//   2. ctx    per (64 x 64 context tile, segment, batch·head): the
//             segments' statistics combined in order; K and V in 64-row
//             chunks through a 3-deep cp.async ring of swizzled panels,
//             Ks formed in place once per chunk, the tile's fp32 partial of
//             Ksᵀ·V by ldmatrix.trans and mma.sync (mixffn_stages.cuh's
//             product step); with one segment the tile is rounded to bf16
//             here, else written as an fp32 partial;
//   3. sum    (S > 1) the S partials added in order and rounded to bf16;
//   4. out    per (64 output columns, 64 rows, batch·head): Q's rows over
//             all dk channels and the context's column tile (dk x 64, in
//             pieces of out_ctx_rows where the whole does not fit beside
//             Q: fp32 at dk = 512) staged by cp.async, the channel softmax
//             of Q in place (eight lanes a row), Q'·ctx on the tensor cores,
//             scale, one rounding, 16-byte stores through a padded tile.
// The out stage recomputes Q's row softmax for each column tile rather
// than streaming the whole context past one block: at C = 320 the context
// (200 KB in bf16) and the rows do not fit a block together, and a block
// per (column tile, rows) gives 5x the blocks (640 at (32, 196, 320)
// against 128 for 132 SMs) for a re-read of Q from L2.
// q, k, v and the output are strided row views (View): K1 reads them from
// its packed q|k|v workspace, K6 from its (B·h, N, d) tensors. Head dims
// are multiples of 8 (16-byte rows). KID (1 or 6) names the owner of each
// stage in a profile.
// Every stage is a template on the element type E (bf16, or fp32 for the
// fp32 forms of K1 and K6): at fp32 the rounding points are identities,
// the ctx stage stages 32-row chunks (one fp32 product step,
// mixffn_stages.cuh), and the products run on the CUDA cores.
#pragma once

#include "mixffn_stages.cuh"

namespace lin {

using bsa::cp_async16;
using bsa::swz;
using ffn::THREADS;

constexpr int NW = THREADS / 32;
constexpr int CT = 64;       // context tile side (key and value channels)
constexpr int RC = 64;       // rows of a staged chunk of the ctx stage (bf16)
constexpr int RO = 64;       // rows of an out-stage block
constexpr int SCOLS = 32;    // key columns of a stats block
constexpr int CSTAGES = 3;   // cp.async ring depth of the ctx stage
constexpr int RGROUPS = THREADS / (SCOLS / 8);  // row groups of a stats block
static_assert(RC == ffn::BK && CT == ffn::BK, "the product steps are BK deep");

// Rows of a staged chunk of the ctx stage: one product step of E.
template <typename E>
constexpr int RCH = KD<E>;

// Rows of each batch·head of a row-major E matrix: row n of head bh at
// p + bh·bs + n·ld.
template <typename E>
struct View {
  E* p;
  int ld;
  size_t bs;
  __device__ __forceinline__ E* at(int bh, int n) const {
    return p + bh * bs + (size_t)n * ld;
  }
};

// ffn::stage with runtime sides: rows [0, R) x columns [0, W) (W a
// multiple of KD<E>) of the matrix at p into swizzled panels of R rows of
// 128 bytes at s; rows >= rv or columns >= cv zero-filled.
template <typename E>
__device__ __forceinline__ void stage_rt(uint32_t s, const E* p, int ld,
                                         int R, int W, int rv, int cv) {
  const int cw = W / EPC<E>;
  for (int i = threadIdx.x; i < R * cw; i += THREADS) {
    const int r = i / cw, c = i % cw;
    const bool ok = r < rv && c * EPC<E> < cv;
    cp_async16(s + (c >> 3) * (R * 128) + swz(r, c & 7),
               ok ? p + (size_t)r * ld + c * EPC<E> : p, ok);
  }
}

// Running column max m and sum l of exp(x − m).
__device__ __forceinline__ void running(float& m, float& l, float x) {
  if (x > m) {
    l = l * expf(m - x) + 1.0f;
    m = x;
  } else {
    l += expf(x - m);
  }
}

template <int KID, typename E>
__global__ void __launch_bounds__(THREADS)
lin_stats_kernel(View<E> k, float2* part, int N, int dk, int rps) {
  __shared__ float2 red[RGROUPS][SCOLS];
  const int c0 = blockIdx.x * SCOLS, seg = blockIdx.y, bh = blockIdx.z;
  const int n0 = seg * rps, n1 = min(N, n0 + rps);
  const int q = threadIdx.x % (SCOLS / 8), g = threadIdx.x / (SCOLS / 8);
  float m[8], l[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    m[e] = -INFINITY;
    l[e] = 0.0f;
  }
  if (c0 + q * 8 < dk) {
    const E* src = k.at(bh, 0) + c0 + q * 8;
#pragma unroll 4
    for (int n = n0 + g; n < n1; n += RGROUPS) {
      float x[8];
      ld8<E>(src + (size_t)n * k.ld, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) running(m[e], l[e], x[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) red[g][q * 8 + e] = make_float2(m[e], l[e]);
  __syncthreads();
  const int c = threadIdx.x;
  if (c < SCOLS && c0 + c < dk) {
    float mm = -INFINITY, ll = 0.0f;
    for (int i = 0; i < RGROUPS; ++i) mm = fmaxf(mm, red[i][c].x);
    for (int i = 0; i < RGROUPS; ++i)
      if (red[i][c].x > -INFINITY) ll += red[i][c].y * expf(red[i][c].x - mm);
    part[((size_t)seg * gridDim.z + bh) * dk + c0 + c] = make_float2(mm, ll);
  }
}

__host__ __device__ inline size_t ctx_smem() {
  return (size_t)CSTAGES * 2 * RC * CT * 2 + 2 * CT * 4;
}

template <int KID, typename E>
__global__ void __launch_bounds__(THREADS)
lin_ctx_kernel(View<E> k, View<E> v, const float2* part, float* pctx, E* ctx,
               int N, int dk, int dv, int rps) {
  using T = ffn::Tile<CT, CT>;
  constexpr int R = RCH<E>;                  // rows of a staged chunk
  constexpr int CHUNK = R * CT * sizeof(E);  // bytes of a K or V chunk
  constexpr int CPR = CT / EPC<E>;           // 16-byte chunks of a row
  extern __shared__ __align__(128) unsigned char smem[];
  float* colm = reinterpret_cast<float*>(smem + CSTAGES * 2 * CHUNK);
  float* cols = colm + CT;
  const uint32_t base = bsa::smem_addr(smem);
  const int tv = (dv + CT - 1) / CT;
  const int a0 = blockIdx.x / tv * CT, c0 = blockIdx.x % tv * CT;
  const int seg = blockIdx.y, bh = blockIdx.z, S = gridDim.y, BH = gridDim.z;
  const int n0 = seg * rps, n1 = min(N, n0 + rps);
  const int nk = (n1 - n0 + R - 1) / R;
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int wm = (w % T::WARPS_M) * T::WM, wn = (w / T::WARPS_M) * T::WN;
  const E* kb = k.at(bh, 0) + a0;
  const E* vb = v.at(bh, 0) + c0;

  auto load = [&](int it) {
    if (it < nk) {
      const int r0 = n0 + it * R;
      const uint32_t s = base + (it % CSTAGES) * 2 * CHUNK;
      ffn::stage<R, CT>(s, kb + (size_t)r0 * k.ld, k.ld, n1 - r0, dk - a0);
      ffn::stage<R, CT>(s + CHUNK, vb + (size_t)r0 * v.ld, v.ld, n1 - r0,
                        dv - c0);
    }
    bsa::cp_async_commit();  // empty groups keep the count uniform
  };
#pragma unroll
  for (int t = 0; t < CSTAGES - 1; ++t) load(t);
  // The column statistics over all N while the first chunks land: the
  // segments' partials combined in a fixed order.
  if (threadIdx.x < CT) {
    const int a = a0 + threadIdx.x;
    float m = -INFINITY, s = 0.0f;
    if (a < dk) {
      for (int i = 0; i < S; ++i)
        m = fmaxf(m, part[((size_t)i * BH + bh) * dk + a].x);
      for (int i = 0; i < S; ++i) {
        const float2 p = part[((size_t)i * BH + bh) * dk + a];
        if (p.x > -INFINITY) s += p.y * expf(p.x - m);
      }
    }
    colm[threadIdx.x] = m;
    cols[threadIdx.x] = s;
  }
  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
  for (int it = 0; it < nk; ++it) {
    bsa::cp_async_wait<CSTAGES - 2>();
    __syncthreads();  // chunk it landed; chunk it-1's slot is free
    load(it + CSTAGES - 1);
    unsigned char* pk = smem + (it % CSTAGES) * 2 * CHUNK;
    const int rows = n1 - (n0 + it * R);
    // Ks = E(exp(K − m) / S) in place; rows past the segment and columns
    // past dk become exact zeros. Chunk c of row r: panel c / 8.
    for (int i = threadIdx.x; i < R * CPR; i += THREADS) {
      const int r = i / CPR, c = i % CPR;
      uint4* pu = reinterpret_cast<uint4*>(
          pk + (CPR > 8 ? (c >> 3) * (R * 128) : 0) + swz(r, c & 7));
      uint4 u = *pu;
      uint32_t* pw = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // a 32-bit word: 2 bf16 or 1 fp32
        const int a = (c * 4 + e) * EPC<E> / 4;
        const bool ok = r < rows && a0 + a < dk;  // dk % 8 == 0
        if constexpr (IS_F32<E>) {
          const float x = __uint_as_float(pw[e]);
          pw[e] = __float_as_uint(ok ? expf(x - colm[a]) / cols[a] : 0.0f);
        } else {
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(pw + e));
          pw[e] = bsa::pack(ok ? expf(x.x - colm[a]) / cols[a] : 0.0f,
                            ok ? expf(x.y - colm[a + 1]) / cols[a + 1] : 0.0f);
        }
      }
      *pu = u;
    }
    __syncthreads();
    const uint32_t sk = base + (it % CSTAGES) * 2 * CHUNK;
    ffn::mma_step<CT, CT, false, false, E>(sk, sk + CHUNK, wm, wn, acc);
  }
  bsa::cp_async_wait<0>();

  const int g = l >> 2, t = l & 3;
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = a0 + wm + i * 16 + g + 8 * h;
        const int c = c0 + wn + j * 8 + 2 * t;
        if (a >= dk || c >= dv) continue;
        const size_t o = (size_t)a * dv + c;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (S == 1)
          st2<E>(ctx + (size_t)bh * dk * dv + o, v0, v1);
        else
          *reinterpret_cast<float2*>(pctx + ((size_t)seg * BH + bh) * dk * dv +
                                     o) = make_float2(v0, v1);
      }
}

template <int KID, typename E>
__global__ void lin_sum_kernel(const float* pctx, int S, size_t n, E* ctx) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int p = 0; p < S; ++p) s += pctx[(size_t)p * n + i];
  ctx[i] = fromf<E>(s);
}

// Rows of the context's column tile an out-stage block stages at once
// (a multiple of CT): all dk (rounded up to 64) where they fit beside Q's
// rows in OUT_SMEM_MAX, else as many as fit, in pieces one after another
// (fp32 at dk = 512: 384, then 128).
constexpr size_t OUT_SMEM_MAX = 232448;  // what a block may opt into, sm_90
__host__ __device__ inline int out_ctx_rows(int dk, int es = 2) {
  const long dkp = (dk + CT - 1) / CT * CT;
  const long room = ((long)OUT_SMEM_MAX / es - RO * dkp) / CT / CT * CT;
  return (int)(room < dkp ? room : dkp);
}

// Q's rows (RO x dk rounded up to 64) and a piece of the context's column
// tile (out_ctx_rows x CT), elements of es bytes; the padded output tile
// reuses them.
__host__ __device__ inline size_t out_smem(int dk, int es = 2) {
  const size_t dkp = (dk + CT - 1) / CT * CT;
  return (RO * dkp + (size_t)out_ctx_rows(dk, es) * CT) * es;
}

template <int KID, typename E>
__global__ void __launch_bounds__(THREADS)
lin_out_kernel(View<E> q, const E* ctx, View<E> o, int N, int dk, int dv,
               int q_softmax, float scale) {
  using T = ffn::Tile<RO, CT>;
  constexpr int KS = KD<E>;   // depth of a product step
  constexpr int EC = EPC<E>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = bsa::smem_addr(smem);
  const int dkp = (dk + CT - 1) / CT * CT, nk = dkp / KS;
  const int kp = out_ctx_rows(dk, (int)sizeof(E));  // context rows a piece
  const int c0 = blockIdx.x * CT, n0 = blockIdx.y * RO, bh = blockIdx.z;
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int wm = (w % T::WARPS_M) * T::WM, wn = (w / T::WARPS_M) * T::WN;
  const uint32_t sc = base + nk * RO * 128;  // the context: kp rows
  const E* cb = ctx + (size_t)bh * dk * dv + c0;
  stage_rt(base, q.at(bh, n0), q.ld, RO, dkp, N - n0, dk);
  bsa::cp_async_commit();
  stage_rt(sc, cb, dv, kp, CT, dk, dv - c0);
  bsa::cp_async_commit();
  if (q_softmax) {
    // Q' = E(softmax of each row over its dk channels) in place while
    // the context lands: eight lanes a row, lane lq on the 16-byte chunks
    // lq, lq + 8, ... of the row, four rows a warp at a time.
    bsa::cp_async_wait<1>();
    __syncthreads();
    const int lq = l & 7, rows = min(RO, N - n0), nch = dk / EC;
    for (int r = w * 4 + (l >> 3); r - (l >> 3) < rows; r += NW * 4) {
      const bool live = r < rows;
      auto chunk = [&](int c) {
        return reinterpret_cast<uint4*>(smem + (c >> 3) * (RO * 128) +
                                        swz(r, c & 7));
      };
      float m = -INFINITY, s = 0.0f;
      for (int c = lq; c < nch && live; c += 8) {
        float x[EC];
        unpack<E>(*chunk(c), x);
#pragma unroll
        for (int e = 0; e < EC / 2; ++e)
          m = fmaxf(m, fmaxf(x[2 * e], x[2 * e + 1]));
      }
#pragma unroll
      for (int sh = 1; sh < 8; sh <<= 1)
        m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, sh));
      for (int c = lq; c < nch && live; c += 8) {
        float x[EC];
        unpack<E>(*chunk(c), x);
#pragma unroll
        for (int e = 0; e < EC / 2; ++e)
          s += expf(x[2 * e] - m) + expf(x[2 * e + 1] - m);
      }
#pragma unroll
      for (int sh = 1; sh < 8; sh <<= 1)
        s += __shfl_xor_sync(FULL_MASK, s, sh);
      for (int c = lq; c < nch && live; c += 8) {
        float x[EC];
        unpack<E>(*chunk(c), x);
#pragma unroll
        for (int e = 0; e < EC; ++e) x[e] = expf(x[e] - m) / s;
        *chunk(c) = pack16<E>(x);
      }
    }
  }
  bsa::cp_async_wait<0>();
  __syncthreads();
  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
  // Step it: Q's panel it and the context's rows it·KS.. of the piece
  // staged (its column panels kp rows apart); the next piece is staged
  // over the last once every warp is done with it.
  for (int p0 = 0; p0 < dkp; p0 += kp) {
    if (p0) {
      __syncthreads();
      stage_rt(sc, cb + (size_t)p0 * dv, dv, kp, CT, dk - p0, dv - c0);
      bsa::cp_async_commit();
      bsa::cp_async_wait<0>();
      __syncthreads();
    }
    for (int it = p0 / KS; it < min(p0 + kp, dkp) / KS; ++it)
      ffn::mma_step<RO, CT, true, false, E>(base + it * RO * 128,
                                            sc + (it * KS - p0) * 128, wm,
                                            wn, acc, KS * 128, kp * 128);
  }

  // E(scale · acc) into a padded tile over the operands, then 16-byte
  // stores of EC columns a thread.
  constexpr int TLD = CT + 8;
  E* tile = reinterpret_cast<E*>(smem);
  const int g = l >> 2, t = l & 3;
  __syncthreads();  // every warp is done with the operands
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        st2<E>(tile + (wm + i * 16 + g + 8 * h) * TLD + wn + j * 8 + 2 * t,
               acc[i][j][2 * h] * scale, acc[i][j][2 * h + 1] * scale);
  __syncthreads();
  for (int e = threadIdx.x; e < RO * CT / EC; e += THREADS) {
    const int r = e / (CT / EC), cc = e % (CT / EC) * EC;
    if (n0 + r >= N || c0 + cc >= dv) continue;
    *reinterpret_cast<uint4*>(o.at(bh, n0 + r) + c0 + cc) =
        *reinterpret_cast<const uint4*>(tile + r * TLD + cc);
  }
}

// The four stages on BH heads of N rows: q, k (dk channels) and v (dv)
// into o (dv). part: S·BH·dk float2; pctx: S·BH·dk·dv fp32 (S > 1 only);
// ctx: BH·dk·dv E. S segments of rps rows (the wrapper's plan).
template <int KID, typename E>
cudaError_t attention(View<E> q, View<E> k, View<E> v, View<E> o,
                      float2* part, float* pctx, E* ctx, int BH, int N,
                      int dk, int dv, int S, int rps, int q_softmax,
                      float scale, cudaStream_t st) {
  if (S <= 0 || rps <= 0 || (size_t)S * rps < (size_t)N || dk % 8 ||
      dv % 8 || rps % RCH<E> || out_ctx_rows(dk, (int)sizeof(E)) < CT)
    return cudaErrorInvalidValue;
  cudaError_t e;
  lin_stats_kernel<KID, E><<<dim3((dk + SCOLS - 1) / SCOLS, S, BH), THREADS,
                             0, st>>>(k, part, N, dk, rps);
  if ((e = cudaGetLastError())) return e;
  const int tk = (dk + CT - 1) / CT, tv = (dv + CT - 1) / CT;
  const size_t cs = ctx_smem();
  if ((e = set_smem((const void*)lin_ctx_kernel<KID, E>, cs))) return e;
  lin_ctx_kernel<KID, E><<<dim3(tk * tv, S, BH), THREADS, cs, st>>>(
      k, v, part, pctx, ctx, N, dk, dv, rps);
  if ((e = cudaGetLastError())) return e;
  if (S > 1) {
    const size_t n = (size_t)BH * dk * dv;
    lin_sum_kernel<KID, E><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        pctx, S, n, ctx);
    if ((e = cudaGetLastError())) return e;
  }
  const size_t os = out_smem(dk, (int)sizeof(E));
  if ((e = set_smem((const void*)lin_out_kernel<KID, E>, os))) return e;
  lin_out_kernel<KID, E><<<dim3(tv, (N + RO - 1) / RO, BH), THREADS, os,
                           st>>>(q, ctx, o, N, dk, dv, q_softmax, scale);
  return cudaGetLastError();
}

}  // namespace lin
