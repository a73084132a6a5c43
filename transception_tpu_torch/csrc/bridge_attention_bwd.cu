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
