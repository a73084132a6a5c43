// Backward of the bridge softmax cross-attention out = softmax(Q·Kᵀ·s)·V,
// d = 64: dQ, dK, dV given the cotangent G of out. Replaces
// transception_tpu/ops/pallas/bridge_attention_kernel.py:190
// bridge_softmax_attention_bwd (its _bwd_kernel, :136-186). Design notes:
// ops/kernels/bridge_attention.py.
//
// With E = exp(L − m) (L the scaled logits, m the row max), S = rowsum(E),
// dP = G·Vᵀ and c = rowsum(E∘dP)/S, T = E∘(dP − c):
//   dQ = (T·K)·s/S,  dK = Tᵀ·Q·s/S (per row),  dV = Eᵀ·G/S (per row).
// The (N, M) matrices never reach device memory.
//
// Bound on the H100: operations. 10·B·N·M·d flop (L, dP, T·K, Tᵀ·Q, Eᵀ·G)
// is 7.3e10 at the published b=24 shape, 0.074 ms at the bf16 peak, against
// ~70 MB of traffic (0.021 ms). This design makes 9 products of 2·N·M·d
// flop: 5 in the rows kernel (L and dP in each pass, T·K), 4 in the
// columns kernel.
//
// rows kernel (dQ and the row statistics): bridge_softmax.cuh's skeleton.
//   One block of 8 warps per (128 query rows, batch·head); each warp keeps
//   its 16 rows of Q and G as A fragments in registers; K and V come
//   through the block's 2-deep cp.async ring of 112-key chunks. Pass 1
//   computes L and dP 16 keys at a time and keeps m, S and rowsum(E∘dP)
//   with an online rescale when the running max rises (all fp32, no bf16
//   rounding in them); pass 2 recomputes L and dP, forms T = E∘(dP − c) in
//   registers, packs bf16(T) into A fragments and adds T·K (K through
//   ldmatrix.trans). Five products a key over the two passes. Writes dQ
//   (bf16) and (m·log2e, c, 1/S, s/S) per row.
// cols kernel (dK and dV): one block of 4 warps per (KT = 64 keys, row
//   segment, batch·head), the segments from bwd_plan (enough for 8 blocks
//   an SM); each warp keeps its 16 keys of K and V as A fragments and
//   their dK, dV (16 x 64 each) as fp32 accumulators, and walks the
//   segment's query rows in RC = 64-row chunks of Q, G and the row
//   statistics through a cp.async ring. It forms the transposed tiles
//   Lᵀ = K·Qᵀ and dPᵀ = V·Gᵀ, so that Eᵀ and Tᵀ land in A-fragment layout,
//   folds the per-row factors in before rounding (bf16(E/S) and
//   bf16(T·s/S)), and adds Eᵀ·G and Tᵀ·Q with Q and G straight from shared
//   memory. (The rounded tensor-core operands are thus e/S and T·s/S with
//   Q, G exact, where the previous kernel rounded e, T, G/S and Q·s/S; the
//   JAX backward is fp32 throughout, so both are operand roundings of the
//   same products.) Each segment writes an fp32 partial and sum_partials
//   adds them in a fixed order and rounds once. No atomics: every run gives
//   the same bits.
// Query rows past N (or past the segment) load as zero, with zero
// statistics, so they add nothing; they are never stored.
//
// The fp32 form (bridge_attention_bwd_f32, the fp32 train step's): the
// same two kernels, the same statistics and the same fixed-order sum of
// the segments' partials, fp32 throughout with nothing rounded, on the
// CUDA cores (FFMA). Operands stay in shared memory (bridge_softmax.cuh
// swz32): rows of 64 fp32 swizzled in 16-byte chunks. A warp holds its 16 rows
// (rows kernel: q and g; cols kernel: k and v) in 8 KB of its own, the
// other side comes through the 2-deep cp.async ring (64-key chunks of K and
// V, 128 KB a rows block: one block an SM; RC-row chunks of Q, G and the
// statistics, 98 KB a cols block). Lane (g, t) forms the dot products of
// its two rows g, g + 8 with the ring's rows 8j + 2t + e of a 16-row step
// (dots16_f32); the quad's shuffles then hand every lane the 16 values of
// its rows for the product with the ring's rows (pb16_f32). Five products
// in the rows kernel and four in the cols kernel, as at bf16. Bound:
// operations, 10·B·N·M·d flop at 67 TFLOP/s of FFMA (1.09 ms at b=24).
#include "bridge_softmax.cuh"

namespace {

using namespace bsa;

constexpr int RW = 8;                       // warps of the rows kernel
constexpr int RROWS = 16 * RW;              // query rows per rows block
constexpr int RC = 64;                      // query rows per cols chunk
constexpr int KT = 64;                      // keys per cols block
constexpr int CW = KT / 16;                 // warps of the cols kernel
constexpr int QG_BYTES = RC * ROW_BYTES;    // one staged Q or G chunk
constexpr int CSTAGE = 2 * QG_BYTES + RC * 16;  // Q, G, row statistics
constexpr int CRING = STAGES * CSTAGE;

__global__ void __launch_bounds__(32 * RW, 2)
rows_kernel(const bf16* q, const bf16* k, const bf16* v, const bf16* g,
            bf16* dq, float4* stats, int N, int M, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_addr(smem);
  const int bh = blockIdx.y, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * RROWS + w * 16;
  const size_t qo = (size_t)bh * N * D, ko = (size_t)bh * M * D;
  const float sl2 = scale * LOG2E;
  uint32_t qa[4][4], ga[4][4];
  load_a(q + qo, r0, N, qa);
  load_a(g + qo, r0, N, ga);

  const int nch = (M + KC - 1) / KC, steps = 2 * nch;
  auto fetch = [&](int t) {
    if (t < steps) {
      const int key0 = (t < nch ? t : t - nch) * KC;
      const int rows = min(KC, M - key0);
      const uint32_t slot = ring + (t % STAGES) * 2 * TILE_BYTES;
      load_tile(slot, k + ko + (size_t)key0 * D, rows, rows);
      load_tile(slot + TILE_BYTES, v + ko + (size_t)key0 * D, rows, rows);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) fetch(t);

  // Steps 0..C-1 stage pass 1's chunks, C..2C-1 pass 2's (the same K, V).
  auto next = [&](int t, int& nks) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step t landed; step t-1's slot is free
    fetch(t + STAGES - 1);
    nks = min(KC, M - (t < nch ? t : t - nch) * KC) / 16;
    return ring + (t % STAGES) * 2 * TILE_BYTES;
  };

  // Pass 1, per row g + 8h: the running max (log2 units), S and
  // rowsum(E∘dP), rescaled when the max rises; then c.
  float m2[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
  float edp[2] = {0.0f, 0.0f}, c[2];
  for (int t = 0; t < nch; ++t) {
    int nks;
    const uint32_t ks = next(t, nks), vs = ks + TILE_BYTES;
#pragma unroll
    for (int st = 0; st < KSTEPS; ++st) {
      if (st < nks) {
        float s[2][4] = {}, dp[2][4] = {};
        abt16(qa, ks, st * 16, s);
        abt16(ga, vs, st * 16, dp);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float cm = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                                 fmaxf(s[1][2 * h], s[1][2 * h + 1]));
          const float mn = fmaxf(m2[h], quad_max(cm) * sl2);
          if (mn > m2[h]) {  // the same in the 4 lanes of a row
            const float a = ex2(m2[h] - mn);
            sum[h] *= a;
            edp[h] *= a;
            m2[h] = mn;
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float e = ex2(fmaf(s[j][i], sl2, -m2[i >> 1]));
            sum[i >> 1] += e;
            edp[i >> 1] += e * dp[j][i];
          }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] = quad_sum(sum[h]);
    c[h] = quad_sum(edp[h]) / sum[h];
  }

  // Pass 2: T = E∘(dP − c) in registers, bf16(T)·K into dQ.
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  for (int t = nch; t < steps; ++t) {
    int nks;
    const uint32_t ks = next(t, nks), vs = ks + TILE_BYTES;
#pragma unroll
    for (int st = 0; st < KSTEPS; ++st) {
      if (st < nks) {
        float s[2][4] = {}, dp[2][4] = {};
        abt16(qa, ks, st * 16, s);
        abt16(ga, vs, st * 16, dp);
        uint32_t p[4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float e0 = ex2(fmaf(s[j][2 * h], sl2, -m2[h]));
            const float e1 = ex2(fmaf(s[j][2 * h + 1], sl2, -m2[h]));
            p[2 * j + h] = pack(e0 * (dp[j][2 * h] - c[h]),
                                e1 * (dp[j][2 * h + 1] - c[h]));
          }
        pb16(p, ks, st * 16, o);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  const float f[2] = {scale / sum[0], scale / sum[1]};
  store_rows<false>(o, f, ring + w * 16 * ROW_BYTES, dq + qo, r0, N);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = r0 + (lane >> 2) + 8 * h;
      if (n < N)
        stats[(size_t)bh * N + n] =
            make_float4(m2[h], c[h], 1.0f / sum[h], f[h]);
    }
  }
}

__global__ void __launch_bounds__(32 * CW)
cols_kernel(const bf16* q, const bf16* k, const bf16* v, const bf16* g,
            const float4* stats, float* dkp, float* dvp, int BH, int N, int M,
            float scale, int seg_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_addr(smem);
  const int bh = blockIdx.z, seg = blockIdx.y;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key0 = blockIdx.x * KT + w * 16;  // 16 keys a warp
  const bool active = key0 < M;
  const size_t qo = (size_t)bh * N * D, ko = (size_t)bh * M * D;
  const int rb = seg * seg_rows, re = min(N, rb + seg_rows);
  const int nrc = re > rb ? (re - rb + RC - 1) / RC : 0;
  const float sl2 = scale * LOG2E;
  uint32_t ka[4][4], va[4][4];
  load_a(k + ko, key0, M, ka);
  load_a(v + ko, key0, M, va);

  auto fetch = [&](int t) {
    if (t < nrc) {
      const int n0 = rb + t * RC, valid = min(RC, re - n0);
      const uint32_t slot = ring + (t % STAGES) * CSTAGE;
      load_tile(slot, q + qo + (size_t)n0 * D, RC, valid);
      load_tile(slot + QG_BYTES, g + qo + (size_t)n0 * D, RC, valid);
      const float4* sg = stats + (size_t)bh * N + n0;
      for (int i = threadIdx.x; i < RC; i += 32 * CW)
        cp_async16(slot + 2 * QG_BYTES + i * 16, sg + (i < valid ? i : 0),
                   i < valid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) fetch(t);

  float dka[8][4], dva[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[j][i] = dva[j][i] = 0.0f;
  const int tq = lane & 3;
  for (int t = 0; t < nrc; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    fetch(t + STAGES - 1);
    if (!active) continue;
    const uint32_t qs = ring + (t % STAGES) * CSTAGE, gs = qs + QG_BYTES;
    const float4* rst = reinterpret_cast<const float4*>(
        smem + (t % STAGES) * CSTAGE + 2 * QG_BYTES);
#pragma unroll
    for (int rs = 0; rs < RC / 16; ++rs) {
      float s[2][4] = {}, dp[2][4] = {};
      abt16(ka, qs, rs * 16, s);   // Lᵀ: keys x rows
      abt16(va, gs, rs * 16, dp);  // dPᵀ
      uint32_t pe[4], pt[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // Statistics of the two query rows (columns) this lane holds.
        const float4 a = rst[rs * 16 + j * 8 + 2 * tq];
        const float4 b = rst[rs * 16 + j * 8 + 2 * tq + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float e0 = ex2(fmaf(s[j][2 * h], sl2, -a.x));
          const float e1 = ex2(fmaf(s[j][2 * h + 1], sl2, -b.x));
          pe[2 * j + h] = pack(e0 * a.z, e1 * b.z);
          pt[2 * j + h] = pack(e0 * (dp[j][2 * h] - a.y) * a.w,
                               e1 * (dp[j][2 * h + 1] - b.y) * b.w);
        }
      }
      pb16(pe, gs, rs * 16, dva);  // dV += (E/S)ᵀ·G
      pb16(pt, qs, rs * 16, dka);  // dK += (T·s/S)ᵀ·Q
    }
  }
  if (!active) return;
  const int gr = lane >> 2;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t at =
          (((size_t)seg * BH + bh) * M + key0 + gr + 8 * h) * D + j * 8 +
          2 * tq;
      *reinterpret_cast<float2*>(dkp + at) =
          make_float2(dka[j][2 * h], dka[j][2 * h + 1]);
      *reinterpret_cast<float2*>(dvp + at) =
          make_float2(dva[j][2 * h], dva[j][2 * h + 1]);
    }
}

// ---- The fp32 form ----
constexpr int QG32 = 2 * Q32;                    // a warp's 16 rows of two
constexpr int RSMEM32 = RING32 + RW * QG32;      // rows kernel, 128 KB
constexpr int RC32_BYTES = RC * ROW32;           // a staged Q or G chunk
constexpr int CSTAGE32 = 2 * RC32_BYTES + RC * 16;
constexpr int CSMEM32 = STAGES * CSTAGE32 + CW * QG32;  // cols kernel

// s[j][e] (row g) and s[j][2 + e] (row g + 8) = a·b over the 64 fp32
// channels, a the warp's rows g, g + 8 staged at as and b row b0 + 8j +
// 2t + e of the tile at bs (both swizzled rows of 64 fp32, swz32): the
// layout of K3's fp32 logits.
__device__ __forceinline__ void dots16_f32(uint32_t as, uint32_t bs, int b0,
                                           float (&s)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll 1
  for (int c = 0; c < 16; ++c) {
    const float4 a0 = lds128(as + swz32(g, c));
    const float4 a1 = lds128(as + swz32(g + 8, c));
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 b = lds128(bs + swz32(b0 + 8 * j + 2 * t + e, c));
        float& x = s[j][e];
        float& y = s[j][2 + e];
        x = fmaf(a0.x, b.x, x);
        x = fmaf(a0.y, b.y, x);
        x = fmaf(a0.z, b.z, x);
        x = fmaf(a0.w, b.w, x);
        y = fmaf(a1.x, b.x, y);
        y = fmaf(a1.y, b.y, y);
        y = fmaf(a1.z, b.z, y);
        y = fmaf(a1.w, b.w, y);
      }
  }
}

// o (rows g, g + 8 by columns 8c + 2t, + 1) += Σ_b p[row][b] · B[b0 + b]
// over the 16 rows b of the tile at bs from b0, p in dots16_f32's layout
// (lane (g, m) holds b = 8j + 2m + e): the quad's shuffles hand each lane
// the 16 values of its two rows.
__device__ __forceinline__ void pb16_f32(const float (&p)[2][4], uint32_t bs,
                                         int b0, float (&o)[8][4]) {
  const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll 1
    for (int m = 0; m < 4; ++m) {
      const int src = (lane & ~3) | m;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = __shfl_sync(FULL_MASK, p[j][e], src);
        const float p1 = __shfl_sync(FULL_MASK, p[j][2 + e], src);
        const int b = b0 + 8 * j + 2 * m + e;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float2 v = lds64(bs + swz32(b, 2 * c + (t >> 1)) + 8 * (t & 1));
          o[c][0] = fmaf(p0, v.x, o[c][0]);
          o[c][1] = fmaf(p0, v.y, o[c][1]);
          o[c][2] = fmaf(p1, v.x, o[c][2]);
          o[c][3] = fmaf(p1, v.y, o[c][3]);
        }
      }
    }
  }
}

// The warp's 16 rows from r0 of a (n, 64) fp32 matrix at p into its
// swizzled rows at s, asynchronously; rows >= n zero-filled.
__device__ __forceinline__ void load_rows32(uint32_t s, const float* p,
                                            int r0, int n) {
  for (int i = threadIdx.x & 31; i < 16 * 16; i += 32) {
    const int r = i >> 4, c = i & 15;
    const bool ok = r0 + r < n;
    cp_async16(s + swz32(r, c), p + (size_t)(ok ? r0 + r : 0) * D + c * 4,
               ok);
  }
}

// dQ and the row statistics at fp32: the rows kernel's two passes, with
// the warp's q and g rows in shared memory and 64-key fp32 chunks of K and
// V through the ring.
__global__ void __launch_bounds__(32 * RW)
rows32_kernel(const float* q, const float* k, const float* v, const float* g,
              float* dq, float4* stats, int N, int M, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_addr(smem);
  const int bh = blockIdx.y, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * RROWS + w * 16;
  const size_t qo = (size_t)bh * N * D, ko = (size_t)bh * M * D;
  const float sl2 = scale * LOG2E;
  const uint32_t qs = ring + RING32 + w * QG32, gs = qs + Q32;
  load_rows32(qs, q + qo, r0, N);  // committed with the first chunk
  load_rows32(gs, g + qo, r0, N);

  const int nch = (M + KC32 - 1) / KC32, steps = 2 * nch;
  auto fetch = [&](int t) {
    if (t < steps) {
      const int key0 = (t < nch ? t : t - nch) * KC32;
      const int rows = min(KC32, M - key0);
      const uint32_t slot = ring + (t % STAGES) * 2 * TILE32;
      load_tile32(slot, k + ko + (size_t)key0 * D, rows, rows);
      load_tile32(slot + TILE32, v + ko + (size_t)key0 * D, rows, rows);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) fetch(t);

  float m2[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
  float edp[2] = {0.0f, 0.0f}, c[2] = {0.0f, 0.0f};
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step t landed; step t-1's slot is free
    fetch(t + STAGES - 1);
    if (t == nch) {  // pass 1 done: S and c of the two rows
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] = quad_sum(sum[h]);
        c[h] = quad_sum(edp[h]) / sum[h];
      }
    }
    const int key0 = (t < nch ? t : t - nch) * KC32;
    const int nks = min(KC32, M - key0) / 16;
    const uint32_t ks = ring + (t % STAGES) * 2 * TILE32, vs = ks + TILE32;
    for (int k16 = 0; k16 < nks; ++k16) {
      float s[2][4], dp[2][4];
      dots16_f32(qs, ks, k16 * 16, s);
      dots16_f32(gs, vs, k16 * 16, dp);
      if (t < nch) {
        // Pass 1: the running max (log2 units), S and rowsum(E∘dP),
        // rescaled when the max rises.
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float cm = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                                 fmaxf(s[1][2 * h], s[1][2 * h + 1]));
          const float mn = fmaxf(m2[h], quad_max(cm) * sl2);
          if (mn > m2[h]) {  // the same in the 4 lanes of a row
            const float a = ex2(m2[h] - mn);
            sum[h] *= a;
            edp[h] *= a;
            m2[h] = mn;
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float e = ex2(fmaf(s[j][i], sl2, -m2[i >> 1]));
            sum[i >> 1] += e;
            edp[i >> 1] += e * dp[j][i];
          }
        continue;
      }
      // Pass 2: T = E∘(dP − c), then T·K into dQ.
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[j][i] = ex2(fmaf(s[j][i], sl2, -m2[i >> 1])) *
                    (dp[j][i] - c[i >> 1]);
      pb16_f32(s, ks, k16 * 16, o);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  const float f[2] = {sum[0] / scale, sum[1] / scale};  // dQ = T·K·s/S
  store_rows32(o, f, qs, dq + qo, r0, N);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = r0 + (lane >> 2) + 8 * h;
      if (n < N)
        stats[(size_t)bh * N + n] =
            make_float4(m2[h], c[h], 1.0f / sum[h], scale / sum[h]);
    }
  }
}

// dK and dV at fp32: the cols kernel with the warp's 16 keys of K and V in
// shared memory and RC-row chunks of Q, G and the statistics through the
// ring; Lᵀ and dPᵀ by dots16_f32, so that lane (g, t) holds E and T of
// keys g, g + 8 against rows 8j + 2t + e, scaled by 1/S and s/S of each
// row before the products with G and Q.
__global__ void __launch_bounds__(32 * CW)
cols32_kernel(const float* q, const float* k, const float* v, const float* g,
              const float4* stats, float* dkp, float* dvp, int BH, int N,
              int M, float scale, int seg_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_addr(smem);
  const int bh = blockIdx.z, seg = blockIdx.y;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key0 = blockIdx.x * KT + w * 16;  // 16 keys a warp
  const bool active = key0 < M;
  const size_t qo = (size_t)bh * N * D, ko = (size_t)bh * M * D;
  const int rb = seg * seg_rows, re = min(N, rb + seg_rows);
  const int nrc = re > rb ? (re - rb + RC - 1) / RC : 0;
  const float sl2 = scale * LOG2E;
  const uint32_t ksw = ring + STAGES * CSTAGE32 + w * QG32, vsw = ksw + Q32;
  load_rows32(ksw, k + ko, key0, M);  // committed with the first chunk
  load_rows32(vsw, v + ko, key0, M);

  auto fetch = [&](int t) {
    if (t < nrc) {
      const int n0 = rb + t * RC, valid = min(RC, re - n0);
      const uint32_t slot = ring + (t % STAGES) * CSTAGE32;
      load_tile32(slot, q + qo + (size_t)n0 * D, RC, valid);
      load_tile32(slot + RC32_BYTES, g + qo + (size_t)n0 * D, RC, valid);
      const float4* sg = stats + (size_t)bh * N + n0;
      for (int i = threadIdx.x; i < RC; i += 32 * CW)
        cp_async16(slot + 2 * RC32_BYTES + i * 16, sg + (i < valid ? i : 0),
                   i < valid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) fetch(t);

  float dka[8][4], dva[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[j][i] = dva[j][i] = 0.0f;
  const int tq = lane & 3;
  for (int t = 0; t < nrc; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    fetch(t + STAGES - 1);
    if (!active) continue;
    const uint32_t qs = ring + (t % STAGES) * CSTAGE32, gs = qs + RC32_BYTES;
    const float4* rst = reinterpret_cast<const float4*>(
        smem + (t % STAGES) * CSTAGE32 + 2 * RC32_BYTES);
#pragma unroll 1
    for (int rs = 0; rs < RC / 16; ++rs) {
      float s[2][4], dp[2][4];
      dots16_f32(ksw, qs, rs * 16, s);   // Lᵀ: keys x rows
      dots16_f32(vsw, gs, rs * 16, dp);  // dPᵀ
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // Statistics of query row (column) rs·16 + 8j + 2tq + e.
          const float4 st = rst[rs * 16 + j * 8 + 2 * tq + e];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float ex = ex2(fmaf(s[j][2 * h + e], sl2, -st.x));
            s[j][2 * h + e] = ex * st.z;                              // E/S
            dp[j][2 * h + e] = ex * (dp[j][2 * h + e] - st.y) * st.w;  // T·s/S
          }
        }
      pb16_f32(s, gs, rs * 16, dva);   // dV += (E/S)ᵀ·G
      pb16_f32(dp, qs, rs * 16, dka);  // dK += (T·s/S)ᵀ·Q
    }
  }
  if (!active) return;
  const int gr = lane >> 2;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t at =
          (((size_t)seg * BH + bh) * M + key0 + gr + 8 * h) * D + j * 8 +
          2 * tq;
      *reinterpret_cast<float2*>(dkp + at) =
          make_float2(dka[j][2 * h], dka[j][2 * h + 1]);
      *reinterpret_cast<float2*>(dvp + at) =
          make_float2(dva[j][2 * h], dva[j][2 * h + 1]);
    }
}

}  // namespace

// q, g, dq: (BH, N, 64) bf16; k, v, dk, dv: (BH, M, 64) bf16. Scratch:
// stats (BH, N, 4) fp32; dkp/dvp (nseg, BH, M, 64) fp32. Launch plan
// (ops/kernels/bridge_attention.py bwd_plan, which mirrors RC and KT):
// nseg row segments of seg_rows rows, a multiple of RC.
extern "C" int bridge_attention_bwd(const bf16* q, const bf16* k,
                                    const bf16* v, const bf16* g, bf16* dq,
                                    bf16* dk, bf16* dv, float* stats,
                                    float* dkp, float* dvp, int BH, int N,
                                    int M, float scale, int nseg,
                                    int seg_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = set_smem((const void*)rows_kernel, RING_BYTES);
  if (!e) e = set_smem((const void*)cols_kernel, CRING);
  if (e) return e;
  float4* stats4 = reinterpret_cast<float4*>(stats);
  rows_kernel<<<dim3((N + RROWS - 1) / RROWS, BH), 32 * RW, RING_BYTES,
                st>>>(q, k, v, g, dq, stats4, N, M, scale);
  if ((e = cudaGetLastError())) return e;
  cols_kernel<<<dim3((M + KT - 1) / KT, nseg, BH), 32 * CW, CRING, st>>>(
      q, k, v, g, stats4, dkp, dvp, BH, N, M, scale, seg_rows);
  if ((e = cudaGetLastError())) return e;
  const size_t n = (size_t)BH * M * D;
  sum_partials<bf16><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      dkp, nseg, n, dk);
  if ((e = cudaGetLastError())) return e;
  sum_partials<bf16><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      dvp, nseg, n, dv);
  return cudaGetLastError();
}

// The fp32 form: every tensor fp32, the same scratch and launch plan.
extern "C" int bridge_attention_bwd_f32(const float* q, const float* k,
                                        const float* v, const float* g,
                                        float* dq, float* dk, float* dv,
                                        float* stats, float* dkp, float* dvp,
                                        int BH, int N, int M, float scale,
                                        int nseg, int seg_rows,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = set_smem((const void*)rows32_kernel, RSMEM32);
  if (!e) e = set_smem((const void*)cols32_kernel, CSMEM32);
  if (e) return e;
  float4* stats4 = reinterpret_cast<float4*>(stats);
  rows32_kernel<<<dim3((N + RROWS - 1) / RROWS, BH), 32 * RW, RSMEM32,
                  st>>>(q, k, v, g, dq, stats4, N, M, scale);
  if ((e = cudaGetLastError())) return e;
  cols32_kernel<<<dim3((M + KT - 1) / KT, nseg, BH), 32 * CW, CSMEM32, st>>>(
      q, k, v, g, stats4, dkp, dvp, BH, N, M, scale, seg_rows);
  if ((e = cudaGetLastError())) return e;
  const size_t n = (size_t)BH * M * D;
  sum_partials<float><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      dkp, nseg, n, dk);
  if ((e = cudaGetLastError())) return e;
  sum_partials<float><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      dvp, nseg, n, dv);
  return cudaGetLastError();
}
