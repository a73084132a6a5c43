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
// the segments' partials, fp32 throughout with nothing rounded to a
// narrower type, every product 3xTF32 on the tensor cores (K3's fp32
// core's pieces, bridge_softmax.cuh): a warp's own 16 rows split once into
// its shared memory, each chunk of the other side split once a block as
// rows and transposed, E and T handed from one product to the next in
// registers. Its own chunk sizes (32 keys in the rows kernel; 32 query
// rows and 112 keys a block in the cols kernel: KC3, RC3, KT3 below) fit
// the split operands into a block's shared memory. Bound: operations,
// 10·B·N·M·d flop as 3 TF32 products each at 495 TFLOP/s (0.443 ms at
// b=24; 1.09 ms at 67 TFLOP/s of FFMA); the kernels do 9 products of
// 2·B·N·M·d, 1.8x the function's.
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

// ---- The fp32 form: 3xTF32 on the tensor cores ----
// The two kernels above at fp32, every product an fp32-accurate 3xTF32
// product on bridge_softmax.cuh's pieces (tf32, split, mma_tf32; see
// attend32): each operand split into hi and lo, a·b = lo·hi + hi·lo +
// hi·hi in fp32, on mma.m16n8k8. A warp's own 16 rows (rows kernel: q and
// g; cols kernel: k and v) are split once into its own shared memory and
// read as A fragments; each chunk of the other side is split once a block,
// as rows (the B operand of a product over the 64 channels) and
// transposed (the B operand of a product over the chunk's keys or query
// rows), hi and lo, each value split once for both (split_block32). The
// logit tiles read their B rows in the order (l7 / 2) + 4 (l7 % 2), so
// that an accumulator's columns 2t, 2t + 1 are rows t, t + 4 of the tile,
// where the next product's A fragment wants them: E and T never leave the
// registers. The tensor cores' fp32 sums
// round toward zero: L, dP, Lᵀ and dPᵀ keep hi·hi apart from the two small
// terms, and T·K, (E/S)ᵀ·G and (T·s/S)ᵀ·Q are summed a chunk apart and
// added into fp32 totals. Every split is split() (cvt.rna), T, E/S and
// T·s/S too, so a NaN in q, k, v or g reaches dq, dk and dv as in the
// plain version.
// Shared memory sets the block (227 KB at most; one block an SM):
// - rows kernel: the raw ring (2 chunks of KC3 = 32 keys of K and V,
//   32 KB), the split chunk (K and V rows, Kᵀ; hi and lo: 48 KB) and the
//   RW = 8 warps' q and g rows (16 KB each): 208 KB. 64-key chunks would
//   take 288 KB, 12 warps 272 KB.
// - cols kernel: the raw ring (2 chunks of RC3 = 32 query rows of Q, G
//   and their statistics, 33 KB), the split chunk (Q and G rows, Qᵀ and
//   Gᵀ: 64 KB) and the CW3 = 7 warps' k and v rows: 209 KB; 7 warps of 16
//   keys cover the published 784 keys in 7 whole tiles.
// So 8 and 7 warps an SM, which leaves latency to hide: the two logit-like
// products of a kernel (L and dP; Lᵀ and dPᵀ) run interleaved, as
// independent mma chains (one after the other is slower on an H100), and
// the rows kernel keeps q's and g's hi fragments in registers (half of its
// A fragment loads gone). The split runs between two barriers, the tensor
// cores idle; halving the chunks to fit a second split buffer (one
// barrier a chunk) was slower still.
constexpr int KC3 = 32;              // rows kernel: keys a chunk
constexpr int RC3 = 32;              // cols kernel: query rows a chunk
constexpr int KT3 = 112;             // cols kernel: keys a block
constexpr int CW3 = KT3 / 16;        // cols kernel: warps, 16 keys each
constexpr int T3 = 32 * ROW32;       // a chunk of 32 rows, or its transpose
constexpr int W3 = 4 * Q32;          // a warp's two row blocks, hi and lo
constexpr int RSMEM32 = STAGES * 2 * T3 + 6 * T3 + RW * W3;
constexpr int CSTAGE32 = 2 * T3 + RC3 * 16;  // raw Q, G, row statistics
constexpr int CSMEM32 = STAGES * CSTAGE32 + 8 * T3 + CW3 * W3;
static_assert(KC3 == 32 && RC3 == 32, "transposed rows of 128 bytes (swz)");
static_assert(RSMEM32 <= 232448 && CSMEM32 <= 232448, "a block an SM");

// Rows [0, rows) of a raw chunk at raw (swz32) split into hi rows at hi
// and lo rows T3 bytes on (swz32), by threads tid = 0..n - 1.
__device__ __forceinline__ void split_rows32(uint32_t raw, uint32_t hi,
                                             int rows, int tid, int n) {
  for (int i = tid; i < rows * 16; i += n) {
    const uint32_t at = swz32(i >> 4, i & 15);
    uint4 h, l;
    split4(lds128(raw + at), h, l);
    sts128(hi + at, h);
    sts128(hi + T3 + at, l);
  }
}

// Block T (0..127) of a raw chunk of 32 rows of one matrix at raw (swz32),
// 4 rows by 4 channels, split once into both layouts: hi and lo rows at
// hi (lo T3 on, swz32) and hi and lo transposed at ht (lo T3 on, swz):
// four 16-byte loads, 16 splits, four 16-byte stores to each of the four
// tiles. Rows past `rows` are skipped. Block T = i + 8m' + 64b (i =
// 0..7) is channel chunk c = i + 8b, row group rg = (i / 2) ^ m', so that
// the 8 threads of a quarter-warp (T = 8 x + i) hit 8 different bank
// groups in every load and store (rows: chunk c ^ row % 8 = i ^ 4 (rg %
// 2) ^ e; transposed: rg ^ (4c + e') % 8 = rg ^ 4 (i % 2) ^ e').
__device__ __forceinline__ void split_block32(uint32_t raw, uint32_t hi,
                                              uint32_t ht, int rows, int T) {
  const int i = T & 7, c = i + 8 * (T >> 6), rg = (i >> 1) ^ ((T >> 3) & 7);
  if (4 * rg >= rows) return;
  uint4 h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t at = swz32(4 * rg + e, c);
    split4(lds128(raw + at), h[e], l[e]);
    sts128(hi + at, h[e]);
    sts128(hi + T3 + at, l[e]);
  }
  const uint32_t* hw = reinterpret_cast<const uint32_t*>(h);
  const uint32_t* lw = reinterpret_cast<const uint32_t*>(l);
#pragma unroll
  for (int e = 0; e < 4; ++e) {  // channel 4c + e: rows 4rg..4rg + 3
    const uint32_t at = swz(4 * c + e, rg);
    sts128(ht + at, make_uint4(hw[e], hw[4 + e], hw[8 + e], hw[12 + e]));
    sts128(ht + T3 + at, make_uint4(lw[e], lw[4 + e], lw[8 + e], lw[12 + e]));
  }
}

// Two logit-like products of a warp's 16 rows against the 8-row tiles j <
// nv (rows b0 + 8j.., b0 a multiple of 8) of the split chunk at b, over
// the 64 channels: x = A1·Xᵀ and y = A2·Yᵀ, A1 and A2 the warp's split rows
// at a1 and a2 (hi, lo Q32 on), X's rows at b (hi, lo T3 on) and Y's 2·T3
// on. hi·hi goes to xh and yh, the two small terms to xl and yl. Per 16
// channels: eight ldmatrix.x4 of A, then per tile four of X and Y and 12
// mma.
// HREG: A1's and A2's hi fragments come from registers (h1, h2: channel
// step kk in [kk]), only their lo ones from shared memory.
template <int NT, bool HREG>
__device__ __forceinline__ void dots3(uint32_t a1, uint32_t a2,
                                      const uint32_t (&h1)[8][4],
                                      const uint32_t (&h2)[8][4], uint32_t b,
                                      int b0, int nv, float (&xh)[NT][4],
                                      float (&xl)[NT][4], float (&yh)[NT][4],
                                      float (&yl)[NT][4]) {
  const int lane = threadIdx.x & 31, l7 = lane & 7, l3 = lane >> 3;
  // A's ldmatrix rows: l7 + 8 (l3 % 2) at chunk 2kk + l3 / 2; B's: row
  // (l7 / 2) + 4 (l7 % 2) of a tile at chunk 4m + l3 (channel steps 2m, +1).
  const uint32_t ar = (l7 + 8 * (l3 & 1)) * ROW32;
  const int br = (l7 >> 1) + 4 * (l7 & 1);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xh[j][i] = xl[j][i] = yh[j][i] = yl[j][i] = 0.0f;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    uint32_t ah[2][4], al[2][4], ch[2][4], cl[2][4];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const uint32_t off = ar + (((4 * m + 2 * v + (l3 >> 1)) ^ l7) << 4);
      if constexpr (HREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[v][i] = h1[2 * m + v][i];
          ch[v][i] = h2[2 * m + v][i];
        }
      } else {
        ldsm_x4(a1 + off, ah[v]);
        ldsm_x4(a2 + off, ch[v]);
      }
      ldsm_x4(a1 + Q32 + off, al[v]);
      ldsm_x4(a2 + Q32 + off, cl[v]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nv) {
        const uint32_t at = b + (b0 + 8 * j) * ROW32 + swz32(br, 4 * m + l3);
        uint32_t xh4[4], xl4[4], yh4[4], yl4[4];
        ldsm_x4(at, xh4);
        ldsm_x4(at + T3, xl4);
        ldsm_x4(at + 2 * T3, yh4);
        ldsm_x4(at + 3 * T3, yl4);
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          mma_tf32(xl[j], al[v], xh4[2 * v], xh4[2 * v + 1]);
          mma_tf32(xl[j], ah[v], xl4[2 * v], xl4[2 * v + 1]);
          mma_tf32(xh[j], ah[v], xh4[2 * v], xh4[2 * v + 1]);
          mma_tf32(yl[j], cl[v], yh4[2 * v], yh4[2 * v + 1]);
          mma_tf32(yl[j], ch[v], yl4[2 * v], yl4[2 * v + 1]);
          mma_tf32(yh[j], ch[v], yh4[2 * v], yh4[2 * v + 1]);
        }
      }
    }
  }
}

// The hi A fragments of the warp's split rows at a (dots3's layout), for
// the 8 channel steps.
__device__ __forceinline__ void load_hi(uint32_t a, uint32_t (&h)[8][4]) {
  const int lane = threadIdx.x & 31, l7 = lane & 7, l3 = lane >> 3;
  const uint32_t ar = a + (l7 + 8 * (l3 & 1)) * ROW32;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    ldsm_x4(ar + (((2 * kk + (l3 >> 1)) ^ l7) << 4), h[kk]);
}

// o[n] (the warp's 16 rows by channels 8n + 2t, + 1) += p · X over one
// 8-row tile (rows r0.., r0 a multiple of 8) of the split chunk's
// transpose at xt (hi, lo T3 on): p the tile's values in accumulator
// layout (columns 2t, 2t + 1 = the tile's rows t, t + 4), split here into
// the A fragment (a0, a1: rows g, g + 8 at t; a2, a3: at t + 4). Per 16
// channels: two ldmatrix.x4 (hi, lo; B fragments of two 8-channel tiles)
// and 6 mma.
__device__ __forceinline__ void pt3(const float (&p)[4], uint32_t xt, int r0,
                                    float (&o)[8][4]) {
  const int lane = threadIdx.x & 31, l7 = lane & 7, l3 = lane >> 3;
  uint32_t ph[4], pl[4];
  split(p[0], ph[0], pl[0]);
  split(p[2], ph[1], pl[1]);
  split(p[1], ph[2], pl[2]);
  split(p[3], ph[3], pl[3]);
  // Lanes 8i.. address matrix i: channel rows 8 (n + i / 2) + l7 at chunk
  // r0 / 4 + i % 2 (the tile's rows t, then t + 4).
  const uint32_t at = xt + swz(l7 + 8 * (l3 >> 1), (r0 >> 2) + (l3 & 1));
#pragma unroll
  for (int n = 0; n < 8; n += 2) {
    uint32_t h[4], l[4];
    ldsm_x4(at + n * 8 * ROW_BYTES, h);
    ldsm_x4(at + n * 8 * ROW_BYTES + T3, l);
    mma_tf32(o[n], pl, h[0], h[1]);
    mma_tf32(o[n], ph, l[0], l[1]);
    mma_tf32(o[n], ph, h[0], h[1]);
    mma_tf32(o[n + 1], pl, h[2], h[3]);
    mma_tf32(o[n + 1], ph, l[2], l[3]);
    mma_tf32(o[n + 1], ph, h[2], h[3]);
  }
}

// dQ and the row statistics at fp32: the rows kernel's two passes over
// KC3-key chunks of K and V (through the raw ring, split once a block:
// K and V rows for L and dP, in pass 2 Kᵀ for T·K), the warp's q and g
// rows split once into its own shared memory, their hi fragments then
// held in registers.
__global__ void __launch_bounds__(32 * RW, 1)
rows32_kernel(const float* q, const float* k, const float* v, const float* g,
              float* dq, float4* stats, int N, int M, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_addr(smem), sp = ring + STAGES * 2 * T3;
  const int bh = blockIdx.y, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * RROWS + w * 16;
  const size_t qo = (size_t)bh * N * D, ko = (size_t)bh * M * D;
  const float sl2 = scale * LOG2E;
  const uint32_t qs = sp + 6 * T3 + w * W3, gs = qs + 2 * Q32;

  const int nch = (M + KC3 - 1) / KC3, steps = 2 * nch;
  auto fetch = [&](int t) {
    if (t < steps) {
      const int key0 = (t < nch ? t : t - nch) * KC3;
      const int rows = min(KC3, M - key0);
      const uint32_t slot = ring + (t % STAGES) * 2 * T3;
      load_tile32(slot, k + ko + (size_t)key0 * D, rows, rows);
      load_tile32(slot + T3, v + ko + (size_t)key0 * D, rows, rows);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) fetch(t);
  stage_q(q + qo, r0, N, qs);  // while the first chunk comes in
  stage_q(g + qo, r0, N, gs);

  // Per row g + 8h: the running max (log2 units), S and rowsum(E∘dP);
  // then c; dQ's fp32 total.
  float m2[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
  float edp[2] = {0.0f, 0.0f}, c[2] = {0.0f, 0.0f};
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  uint32_t qh[8][4], gh[8][4];  // q's and g's hi A fragments
  __syncwarp();  // the warp's split rows are in shared memory
  load_hi(qs, qh);
  load_hi(gs, gh);
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk t landed; every warp is done with t - 1's split
    fetch(t + STAGES - 1);
    const bool p2 = t >= nch;
    const int rows = min(KC3, M - (p2 ? t - nch : t) * KC3), nv = rows / 8;
    const uint32_t slot = ring + (t % STAGES) * 2 * T3;
    if (p2) {  // K as rows and Kᵀ (threads 0..127), V (128..255)
      if (threadIdx.x < 128)
        split_block32(slot, sp, sp + 4 * T3, rows, threadIdx.x);
      else
        split_rows32(slot + T3, sp + 2 * T3, rows, threadIdx.x - 128, 128);
    } else {  // K and V
      split_rows32(slot, sp, rows, threadIdx.x, 32 * RW);
      split_rows32(slot + T3, sp + 2 * T3, rows, threadIdx.x, 32 * RW);
    }
    __syncthreads();  // the split chunk is ready
    // L (keys t, t + 4 of tile j at columns 2t, 2t + 1) and dP.
    float lh[4][4], ll[4][4], ph[4][4], pl[4][4];
    dots3<4, true>(qs, gs, qh, gh, sp, 0, nv, lh, ll, ph, pl);
    if (!p2) {
      // Pass 1: the new row max (the max of the raw logits, as the
      // launchers refuse a scale that is not positive) and the factor
      // 2^(m_old − m_new) on S and rowsum(E∘dP) (0 at the first chunk).
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float cm = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nv)
            cm = fmaxf(cm, fmaxf(lh[j][2 * h] + ll[j][2 * h],
                                 lh[j][2 * h + 1] + ll[j][2 * h + 1]));
        const float mn = fmaxf(m2[h], quad_max(cm) * sl2);
        const float a = ex2(m2[h] - mn);
        m2[h] = mn;
        sum[h] *= a;
        edp[h] *= a;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < nv)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float e =
                ex2(fmaf(lh[j][i] + ll[j][i], sl2, -m2[i >> 1]));
            sum[i >> 1] += e;
            edp[i >> 1] += e * (ph[j][i] + pl[j][i]);
          }
      if (t == nch - 1) {  // pass 1 done: S and c of the two rows
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[h] = quad_sum(sum[h]);
          c[h] = quad_sum(edp[h]) / sum[h];
        }
      }
      continue;
    }
    // Pass 2: T = E∘(dP − c) per tile, T·K summed over the chunk and added
    // to dQ's total.
    float po[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
      po[n][0] = po[n][1] = po[n][2] = po[n][3] = 0.0f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u < nv) {
        float tt[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          tt[i] = ex2(fmaf(lh[u][i] + ll[u][i], sl2, -m2[i >> 1])) *
                  (ph[u][i] + pl[u][i] - c[i >> 1]);
        pt3(tt, sp + 4 * T3, 8 * u, po);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] += po[n][i];
  }
  cp_async_wait<0>();
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

// dK and dV at fp32: the cols kernel over its segment's RC3-row chunks of
// Q, G and the row statistics (through the raw ring, split once a block:
// Q and G rows for Lᵀ = K·Qᵀ and dPᵀ = V·Gᵀ, Qᵀ and Gᵀ for the products
// with Q and G), the warp's 16 keys of k and v split once into its own
// shared memory. E/S and T·s/S (each query row's factors folded in before
// the split) are the A fragments of (E/S)ᵀ·G and (T·s/S)ᵀ·Q.
__global__ void __launch_bounds__(32 * CW3, 1)
cols32_kernel(const float* q, const float* k, const float* v, const float* g,
              const float4* stats, float* dkp, float* dvp, int BH, int N,
              int M, float scale, int seg_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_addr(smem), sp = ring + STAGES * CSTAGE32;
  const int bh = blockIdx.z, seg = blockIdx.y;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
  const int key0 = blockIdx.x * KT3 + w * 16;  // 16 keys a warp
  const bool active = key0 < M;
  const size_t qo = (size_t)bh * N * D, ko = (size_t)bh * M * D;
  const int rb = seg * seg_rows, re = min(N, rb + seg_rows);
  const int nrc = re > rb ? (re - rb + RC3 - 1) / RC3 : 0;
  const float sl2 = scale * LOG2E;
  const uint32_t ks = sp + 8 * T3 + w * W3, vs = ks + 2 * Q32;

  auto fetch = [&](int t) {
    if (t < nrc) {
      const int n0 = rb + t * RC3, valid = min(RC3, re - n0);
      const uint32_t slot = ring + (t % STAGES) * CSTAGE32;
      load_tile32(slot, q + qo + (size_t)n0 * D, RC3, valid);
      load_tile32(slot + T3, g + qo + (size_t)n0 * D, RC3, valid);
      const float4* sg = stats + (size_t)bh * N + n0;
      for (int i = threadIdx.x; i < RC3; i += 32 * CW3)
        cp_async16(slot + 2 * T3 + i * 16, sg + (i < valid ? i : 0),
                   i < valid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) fetch(t);
  stage_q(k + ko, key0, M, ks);  // while the first chunk comes in
  stage_q(v + ko, key0, M, vs);

  const uint32_t none[8][4] = {};  // (k's and v's hi A fragments are read
                                  // from shared memory: dots3<., false>)
  float dka[8][4], dva[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.0f;
  for (int t = 0; t < nrc; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk t landed; every warp is done with t - 1's split
    fetch(t + STAGES - 1);
    const uint32_t slot = ring + (t % STAGES) * CSTAGE32;
    // Q and Qᵀ (blocks 0..127), G and Gᵀ (128..255).
    for (int T = threadIdx.x; T < 256; T += 32 * CW3) {
      const int x = T >> 7;
      split_block32(slot + x * T3, sp + x * 2 * T3, sp + (4 + 2 * x) * T3,
                    RC3, T & 127);
    }
    __syncthreads();  // the split chunk is ready
    if (!active) continue;
    const float4* rst = reinterpret_cast<const float4*>(
        smem + (t % STAGES) * CSTAGE32 + 2 * T3);
    float pk[8][4], pv[8][4];  // the chunk's sums
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) pk[n][i] = pv[n][i] = 0.0f;
#pragma unroll
    for (int r16 = 0; r16 < RC3; r16 += 16) {
      // Lᵀ and dPᵀ: keys g, g + 8 by query rows r16 + 8j + t (columns 2t)
      // and + 4 (2t + 1).
      float lh[2][4], ll[2][4], ph[2][4], pl[2][4];
      dots3<2, false>(ks, vs, none, none, sp, r16, 2, lh, ll, ph, pl);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // Statistics of this lane's two query rows (columns).
        const float4 sa = rst[r16 + 8 * j + tq];
        const float4 sb = rst[r16 + 8 * j + tq + 4];
        float es[4], ts[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4& st = (i & 1) ? sb : sa;
          const float ex = ex2(fmaf(lh[j][i] + ll[j][i], sl2, -st.x));
          es[i] = ex * st.z;                                 // E/S
          ts[i] = ex * (ph[j][i] + pl[j][i] - st.y) * st.w;  // T·s/S
        }
        pt3(es, sp + 6 * T3, r16 + 8 * j, pv);  // dV += (E/S)ᵀ·G
        pt3(ts, sp + 4 * T3, r16 + 8 * j, pk);  // dK += (T·s/S)ᵀ·Q
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dka[n][i] += pk[n][i];
        dva[n][i] += pv[n][i];
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
// (ops/kernels/bridge_attention.py bwd_plan, which mirrors RC and KT, and
// RC3 and KT3 at fp32): nseg row segments of seg_rows rows, a multiple of
// RC (RC3).
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

// The fp32 form: every tensor fp32, the same scratch; the plan in RC3-row
// chunks and KT3-key tiles.
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
  cols32_kernel<<<dim3((M + KT3 - 1) / KT3, nseg, BH), 32 * CW3, CSMEM32,
                  st>>>(
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
