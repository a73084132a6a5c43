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
//             all dk channels and the context's column tile (dk x 64)
//             staged by cp.async, the channel softmax of Q in place (eight
//             lanes a row), Q'·ctx on the tensor cores, scale, one rounding,
//             16-byte stores through a padded tile.
// The out stage recomputes Q's row softmax for each column tile rather
// than streaming the whole context past one block: at C = 320 the context
// (200 KB in bf16) and the rows do not fit a block together, and a block
// per (column tile, rows) gives 5x the blocks (640 at (32, 196, 320)
// against 128 for 132 SMs) for a re-read of Q from L2.
// q, k, v and the output are strided row views (View): K1 reads them from
// its packed q|k|v workspace, K6 from its (B·h, N, d) tensors. Head dims
// are multiples of 8 (16-byte rows). KID (1 or 6) names the owner of each
// stage in a profile.
#pragma once

#include "mixffn_stages.cuh"

namespace lin {

using bsa::cp_async16;
using bsa::swz;
using ffn::THREADS;

constexpr int NW = THREADS / 32;
constexpr int CT = 64;       // context tile side (key and value channels)
constexpr int RC = 64;       // rows of a staged chunk of the ctx stage
constexpr int RO = 64;       // rows of an out-stage block
constexpr int SCOLS = 32;    // key columns of a stats block
constexpr int CSTAGES = 3;   // cp.async ring depth of the ctx stage
constexpr int RGROUPS = THREADS / (SCOLS / 8);  // row groups of a stats block
static_assert(RC == ffn::BK && CT == ffn::BK, "the product steps are BK deep");

// Rows of each batch·head of a row-major bf16 matrix: row n of head bh at
// p + bh·bs + n·ld.
struct View {
  bf16* p;
  int ld;
  size_t bs;
  __device__ __forceinline__ bf16* at(int bh, int n) const {
    return p + bh * bs + (size_t)n * ld;
  }
};

// ffn::stage with runtime sides: rows [0, R) x columns [0, W) (W a
// multiple of 64) of the matrix at p into swizzled 64-column panels of R
// rows at s; rows >= rv or columns >= cv zero-filled.
__device__ __forceinline__ void stage_rt(uint32_t s, const bf16* p, int ld,
                                         int R, int W, int rv, int cv) {
  const int cw = W / 8;
  for (int i = threadIdx.x; i < R * cw; i += THREADS) {
    const int r = i / cw, c = i % cw;
    const bool ok = r < rv && c * 8 < cv;
    cp_async16(s + (c >> 3) * (R * 128) + swz(r, c & 7),
               ok ? p + (size_t)r * ld + c * 8 : p, ok);
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

template <int KID>
__global__ void __launch_bounds__(THREADS)
lin_stats_kernel(View k, float2* part, int N, int dk, int rps) {
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
    const bf16* src = k.at(bh, 0) + c0 + q * 8;
#pragma unroll 4
    for (int n = n0 + g; n < n1; n += RGROUPS) {
      const uint4 u = *reinterpret_cast<const uint4*>(src + (size_t)n * k.ld);
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(p2[e]);
        running(m[2 * e], l[2 * e], x.x);
        running(m[2 * e + 1], l[2 * e + 1], x.y);
      }
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

template <int KID>
__global__ void __launch_bounds__(THREADS)
lin_ctx_kernel(View k, View v, const float2* part, float* pctx, bf16* ctx,
               int N, int dk, int dv, int rps) {
  using T = ffn::Tile<CT, CT>;
  constexpr int CHUNK = RC * CT * 2;  // bytes of one staged K or V chunk
  extern __shared__ __align__(128) unsigned char smem[];
  float* colm = reinterpret_cast<float*>(smem + CSTAGES * 2 * CHUNK);
  float* cols = colm + CT;
  const uint32_t base = bsa::smem_addr(smem);
  const int tv = (dv + CT - 1) / CT;
  const int a0 = blockIdx.x / tv * CT, c0 = blockIdx.x % tv * CT;
  const int seg = blockIdx.y, bh = blockIdx.z, S = gridDim.y, BH = gridDim.z;
  const int n0 = seg * rps, n1 = min(N, n0 + rps);
  const int nk = (n1 - n0 + RC - 1) / RC;
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int wm = (w % T::WARPS_M) * T::WM, wn = (w / T::WARPS_M) * T::WN;
  const bf16* kb = k.at(bh, 0) + a0;
  const bf16* vb = v.at(bh, 0) + c0;

  auto load = [&](int it) {
    if (it < nk) {
      const int r0 = n0 + it * RC;
      const uint32_t s = base + (it % CSTAGES) * 2 * CHUNK;
      ffn::stage<RC, CT>(s, kb + (size_t)r0 * k.ld, k.ld, n1 - r0, dk - a0);
      ffn::stage<RC, CT>(s + CHUNK, vb + (size_t)r0 * v.ld, v.ld, n1 - r0,
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
    const int rows = n1 - (n0 + it * RC);
    // Ks = bf16(exp(K − m) / S) in place; rows past the segment and
    // columns past dk become exact zeros.
    for (int i = threadIdx.x; i < RC * 8; i += THREADS) {
      const int r = i >> 3, c = i & 7;
      uint4* pu = reinterpret_cast<uint4*>(pk + swz(r, c));
      uint4 u = *pu;
      uint32_t* pw = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int a = c * 8 + 2 * e;
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(pw + e));
        const bool ok = r < rows && a0 + a < dk;  // dk % 8 == 0: pairs whole
        pw[e] = bsa::pack(ok ? expf(x.x - colm[a]) / cols[a] : 0.0f,
                          ok ? expf(x.y - colm[a + 1]) / cols[a + 1] : 0.0f);
      }
      *pu = u;
    }
    __syncthreads();
    const uint32_t sk = base + (it % CSTAGES) * 2 * CHUNK;
    ffn::mma_step<CT, CT, false, false>(sk, sk + CHUNK, wm, wn, acc);
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
          *reinterpret_cast<uint32_t*>(ctx + (size_t)bh * dk * dv + o) =
              bsa::pack(v0, v1);
        else
          *reinterpret_cast<float2*>(pctx + ((size_t)seg * BH + bh) * dk * dv +
                                     o) = make_float2(v0, v1);
      }
}

template <int KID>
__global__ void lin_sum_kernel(const float* pctx, int S, size_t n, bf16* ctx) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int p = 0; p < S; ++p) s += pctx[(size_t)p * n + i];
  ctx[i] = __float2bfloat16(s);
}

// Q's rows (RO x dk rounded up to 64) and the context's column tile (that
// many rows x CT); the padded output tile reuses them.
__host__ __device__ inline size_t out_smem(int dk) {
  const size_t dkp = (dk + CT - 1) / CT * CT;
  return (RO + CT) * dkp * 2;
}

template <int KID>
__global__ void __launch_bounds__(THREADS)
lin_out_kernel(View q, const bf16* ctx, View o, int N, int dk, int dv,
               int q_softmax, float scale) {
  using T = ffn::Tile<RO, CT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = bsa::smem_addr(smem);
  const int dkp = (dk + CT - 1) / CT * CT, nk = dkp / CT;
  const int c0 = blockIdx.x * CT, n0 = blockIdx.y * RO, bh = blockIdx.z;
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int wm = (w % T::WARPS_M) * T::WM, wn = (w / T::WARPS_M) * T::WN;
  const uint32_t sc = base + nk * RO * 128;
  stage_rt(base, q.at(bh, n0), q.ld, RO, dkp, N - n0, dk);
  bsa::cp_async_commit();
  stage_rt(sc, ctx + (size_t)bh * dk * dv + c0, dv, dkp, CT, dk, dv - c0);
  bsa::cp_async_commit();
  if (q_softmax) {
    // Q' = bf16(softmax of each row over its dk channels) in place while
    // the context lands: eight lanes a row, lane lq on the 16-byte chunks
    // lq, lq + 8, ... of the row, four rows a warp at a time.
    bsa::cp_async_wait<1>();
    __syncthreads();
    const int lq = l & 7, rows = min(RO, N - n0), nch = dk / 8;
    for (int r = w * 4 + (l >> 3); r - (l >> 3) < rows; r += NW * 4) {
      const bool live = r < rows;
      auto chunk = [&](int c) {
        return reinterpret_cast<uint4*>(smem + (c >> 3) * (RO * 128) +
                                        swz(r, c & 7));
      };
      float m = -INFINITY, s = 0.0f;
      for (int c = lq; c < nch && live; c += 8) {
        const uint4 u = *chunk(c);
        const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(p2[e]);
          m = fmaxf(m, fmaxf(x.x, x.y));
        }
      }
#pragma unroll
      for (int sh = 1; sh < 8; sh <<= 1)
        m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, sh));
      for (int c = lq; c < nch && live; c += 8) {
        const uint4 u = *chunk(c);
        const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(p2[e]);
          s += expf(x.x - m) + expf(x.y - m);
        }
      }
#pragma unroll
      for (int sh = 1; sh < 8; sh <<= 1)
        s += __shfl_xor_sync(FULL_MASK, s, sh);
      for (int c = lq; c < nch && live; c += 8) {
        uint4 u = *chunk(c);
        uint32_t* pw = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(pw + e));
          pw[e] = bsa::pack(expf(x.x - m) / s, expf(x.y - m) / s);
        }
        *chunk(c) = u;
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
  for (int it = 0; it < nk; ++it)
    ffn::mma_step<RO, CT, true, false>(base + it * RO * 128,
                                       sc + it * CT * 128, wm, wn, acc);

  // bf16(scale · acc) into a padded tile over the operands, then 16-byte
  // stores of 8 columns a thread.
  constexpr int TLD = CT + 8;
  bf16* tile = reinterpret_cast<bf16*>(smem);
  const int g = l >> 2, t = l & 3;
  __syncthreads();  // every warp is done with the operands
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(tile + (wm + i * 16 + g + 8 * h) * TLD +
                                     wn + j * 8 + 2 * t) =
            bsa::pack(acc[i][j][2 * h] * scale, acc[i][j][2 * h + 1] * scale);
  __syncthreads();
  for (int e = threadIdx.x; e < RO * CT / 8; e += THREADS) {
    const int r = e / (CT / 8), cc = e % (CT / 8) * 8;
    if (n0 + r >= N || c0 + cc >= dv) continue;
    *reinterpret_cast<uint4*>(o.at(bh, n0 + r) + c0 + cc) =
        *reinterpret_cast<const uint4*>(tile + r * TLD + cc);
  }
}

// The four stages on BH heads of N rows: q, k (dk channels) and v (dv)
// into o (dv). part: S·BH·dk float2; pctx: S·BH·dk·dv fp32 (S > 1 only);
// ctx: BH·dk·dv bf16. S segments of rps rows (the wrapper's plan).
template <int KID>
cudaError_t attention(View q, View k, View v, View o, float2* part,
                      float* pctx, bf16* ctx, int BH, int N, int dk, int dv,
                      int S, int rps, int q_softmax, float scale,
                      cudaStream_t st) {
  if (S <= 0 || rps <= 0 || (size_t)S * rps < (size_t)N || dk % 8 ||
      dv % 8)
    return cudaErrorInvalidValue;
  cudaError_t e;
  lin_stats_kernel<KID><<<dim3((dk + SCOLS - 1) / SCOLS, S, BH), THREADS, 0,
                          st>>>(k, part, N, dk, rps);
  if ((e = cudaGetLastError())) return e;
  const int tk = (dk + CT - 1) / CT, tv = (dv + CT - 1) / CT;
  const size_t cs = ctx_smem();
  if ((e = set_smem((const void*)lin_ctx_kernel<KID>, cs))) return e;
  lin_ctx_kernel<KID><<<dim3(tk * tv, S, BH), THREADS, cs, st>>>(
      k, v, part, pctx, ctx, N, dk, dv, rps);
  if ((e = cudaGetLastError())) return e;
  if (S > 1) {
    const size_t n = (size_t)BH * dk * dv;
    lin_sum_kernel<KID><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        pctx, S, n, ctx);
    if ((e = cudaGetLastError())) return e;
  }
  const size_t os = out_smem(dk);
  if ((e = set_smem((const void*)lin_out_kernel<KID>, os))) return e;
  lin_out_kernel<KID><<<dim3(tv, (N + RO - 1) / RO, BH), THREADS, os, st>>>(
      q, ctx, o, N, dk, dv, q_softmax, scale);
  return cudaGetLastError();
}

}  // namespace lin
