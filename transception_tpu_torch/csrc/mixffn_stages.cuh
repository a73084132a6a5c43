// The stages that the MixFFN forward (K2, K9), the MHCA block (K5) and the
// MixFFN backward (K11) share, as kernels over the whole batch:
//   - mixffn_gemm_kernel, the tiled product on the tensor cores, with the
//     caller's (grouped) LayerNorm optionally folded into its A operand
//     and a compile-time epilogue (also the ETB attention's (K1) qkv and
//     proj; its BK-deep step, mma_step, also the linear-attention core's);
//   - mixffn_convrows_kernel, the forward's depthwise 3x3 conv, y = d + h,
//     the hidden LayerNorm and the GELU, a block per map row;
//   - ffn::forward, the MixFFN_skip forward chain on them, which replaces
//     the body of transception_tpu/ops/pallas/mixffn_kernel.py:342
//     fused_mixffn_ln_skip (and, BARE, :285 fused_mixffn_skip):
//       out = x + fc2(GELU(LN_h(dwconv3x3(h) + h))),  h = fc1(groupLN(x)).
//
// What bounds the forward on the H100: it sits near the ridge (at (32,
// 56², 64, hidden 256) 25.7 MB of x and out, 7.7 us at 3.35 TB/s, against
// 7.0 GFLOP, 7.1 us at the bf16 peak; operations at the smaller maps).
// What it takes in practice is the hidden state that the 3x3 conv and the
// LayerNorm over the hidden width need, h and the GELU output a, 2·T·hid
// bf16 values over the T = B·s² tokens, which a block of 227 KB cannot
// hold for a whole map. The TPU kernel holds a map in VMEM; a Hopper block
// per map row would hold one row's hidden state (~160 KB: one block an
// SM), run products of 3 or 16 rows and read both weight matrices from L2
// in every block. So the forward runs as three stages over the whole
// batch, each of which fills
// the card, with h and a in device memory for the length of one call
// (2·T·hid·2 bytes; 98 MiB at (32, 56², 64, 256)):
//   1. fc1   h = bf16(groupLN(x)·w1ᵀ + b1): the product stages x's rows
//            for the whole depth (K = C <= 512 fits a 128-row panel) and
//            normalises them in place, so xn never reaches device memory
//            (BARE: A = x through the ring, as it is);
//   2. rows  per (map row, batch): a thread per pair of hidden channels
//            and SEG columns loads its 3 x (SEG + 2) window of h at once
//            and computes d = bf16(conv3x3(h) + dwb) with the taps in
//            registers, y = d + h into shared memory; then a warp per
//            token: the hidden LN, z = bf16(LN(y)), a = bf16(GELU(z)) in
//            the erfc form;
//   3. fc2   out = bf16(bf16(a·w2ᵀ + b2) + x) (BARE: bf16(a·w2ᵀ + b2)).
// Three launches per call. The product kernel: BM x BN output tiles (128
// or 64 each, 8 warps), 64-deep operand tiles staged with cp.async through
// a 3-deep ring of XOR-swizzled 64-column panels (bridge_softmax.cuh's
// layout), fragments by ldmatrix (.trans for operands whose M or N is
// contiguous), mma.sync.m16n8k16 with fp32 accumulation; a bf16 result
// leaves through a padded shared-memory tile in 16-byte stores, the
// residual read the same way. The plan of tiles
// is the wrapper's (ops/kernels/mixffn.py fwd_plan). KID, the number of the
// kernel that launches a stage (1, 2, 5, 9, 11), is a template argument only
// so that a profile can tell the owners' stages apart by name.
//
// Rounding points are the Pallas kernel's: the caller's LN output, h, the
// conv output, z and a in bf16; y, the statistics and every sum in fp32;
// the fc2 output rounded before the residual is added and rounded again.
//
// Every stage is a template on the element type E of its activations and
// weights: bf16, or fp32 for the fp32 forward (the Pallas kernels are
// dtype-generic, and the published protocol evaluates at fp32). At fp32
// the rounding points are identities, the staged panels keep their
// 128-byte rows (32 fp32 columns: a product step is 32 deep, KD<E>), and
// the product step is bsa::ffma_step on the CUDA cores in place of
// ldmatrix + mma.sync, with the same accumulator layout, so the LN fold,
// the epilogues and the rows stage are the bf16 code with E in place of
// bf16.
#pragma once

#include "bridge_softmax.cuh"

namespace ffn {

using bsa::cp_async16;
using bsa::swz;

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int BIG = 128;    // output tile sides of the products
constexpr int SMALL = 64;
constexpr int BK = 64;      // bf16 product depth per staged operand tile
constexpr int GSTAGES = 3;  // cp.async ring depth of the products
constexpr int SEG = 8;      // map columns of a rows-stage work item
constexpr float RSQRT2 = 0.70710678118654752f;

// A parameter whose type follows the others' (not deduced from it, so that
// nullptr passes for an unused residual).
template <typename T>
struct Id {
  using type = T;
};
template <typename T>
using Same = typename Id<T>::type;

// Product epilogues, a template argument each (a runtime branch in a K2
// body had cost 1.27 -> 1.94 ms a launch on an H100).
constexpr int EPI_F32 = 0;          // fp32 acc (at blockIdx.z · split)
constexpr int EPI_BIAS = 1;         // bf16(acc + bias)
constexpr int EPI_RESID = 2;        // bf16(bf16(acc + bias) + res)
constexpr int EPI_DENSE = 3;        // bf16(bf16(acc) + bf16(bias))
constexpr int EPI_DENSE_RESID = 4;  // bf16(res + bf16(bf16(acc) + bf16(bias)))

// The caller's LayerNorm folded into a product's A operand: per group of
// gsz channels, scale s and bias b (C,)-tiled.
struct Norm {
  const float* s;
  const float* b;
  int gsz;
  float eps;
};

template <int BM, int BN>
struct Tile {
  static constexpr int WARPS_M = (BM == BIG && BN == SMALL) ? 4 : 2;
  static constexpr int WARPS_N = NW / WARPS_M;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;
  // One staged step of A and B: 128-byte panel rows (KD<E> deep).
  static constexpr int A_BYTES = BM * 128, B_BYTES = BN * 128;
  static constexpr int STAGE = A_BYTES + B_BYTES;
};

// Shared memory of one product block over elements of es bytes: the ring
// of A and B tiles, or with the LN folded (ALN) A's whole normalised panel
// (K rounded up to the step depth) and a ring of B tiles; the epilogue's
// output tile reuses it.
__host__ __device__ inline size_t gemm_smem(bool aln, int bm, int bn, int K,
                                            int es = 2) {
  const int kd = 128 / es;
  const size_t ring_b = (size_t)GSTAGES * bn * 128;
  const size_t ops = aln ? (size_t)bm * ((K + kd - 1) / kd * kd) * es + ring_b
                         : (size_t)GSTAGES * bm * 128 + ring_b;
  const size_t tile = (size_t)bm * (bn + 8) * es;  // the E epilogue's
  return ops > tile ? ops : tile;
}

// Rows [0, R) x columns [0, W) (W a multiple of KD<E>) of the row-major
// matrix at p (leading dimension ld) into swizzled panels of R rows of 128
// bytes at s, asynchronously; rows >= rv or columns >= cv zero-filled.
template <int R, int W, typename E>
__device__ __forceinline__ void stage(uint32_t s, const E* p, int ld, int rv,
                                      int cv) {
  constexpr int CW = W / EPC<E>;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < R * CW; i += THREADS) {
    const int r = i / CW, c = i % CW;
    const bool ok = r < rv && c * EPC<E> < cv;
    cp_async16(s + (c >> 3) * (R * 128) + swz(r, c & 7),
               ok ? p + (size_t)r * ld + c * EPC<E> : p, ok);
  }
}

// One KD<E>-deep step of a warp's WM x WN share of a BM x BN product, acc
// += A·B: A's tile at sa (AMK: BM rows of KD<E>, else KD<E> rows of BM in
// panels aps bytes apart), B's at sb (BNK: BN rows of KD<E>, else KD<E>
// rows of BN in panels bps bytes apart), each in stage's swizzled panels.
// bf16: the tensor cores, fragments by ldmatrix (.trans where M or N is
// the contiguous side); fp32: bsa::ffma_step, the same accumulator layout.
template <int BM, int BN, bool AMK, bool BNK, typename E = bf16>
__device__ __forceinline__ void mma_step(
    uint32_t sa, uint32_t sb, int wm, int wn,
    float (&acc)[Tile<BM, BN>::MT][Tile<BM, BN>::NT][4],
    int aps = KD<E> * 128, int bps = KD<E> * 128) {
  using T = Tile<BM, BN>;
  if constexpr (IS_F32<E>) {
    bsa::ffma_step<T::MT, T::NT, AMK, BNK>(sa, sb, wm, wn, aps, bps, acc);
  } else {
    const int l = threadIdx.x & 31;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[T::MT][4], bf[T::NT][2];
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        const int mi = wm + i * 16;
        if (AMK) {
          bsa::ldsm_x4(sa + swz(mi + (l & 15), (kk >> 3) + (l >> 4)), af[i]);
        } else {
          const int cc = (mi >> 3) + ((l >> 3) & 1);
          const int r = kk + (l & 7) + ((l >> 4) << 3);
          bsa::ldsm_x4_t(sa + (cc >> 3) * aps + swz(r, cc & 7), af[i]);
        }
      }
#pragma unroll
      for (int j = 0; j < T::NT; j += 2) {
        const int ni = wn + j * 8;
        uint32_t f[4];
        if (BNK) {
          bsa::ldsm_x4(sb + swz(ni + (l & 7) + ((l >> 4) << 3),
                                (kk >> 3) + ((l >> 3) & 1)), f);
        } else {
          const int cc = (ni >> 3) + (l >> 4);
          bsa::ldsm_x4_t(sb + (cc >> 3) * bps + swz(kk + (l & 15), cc & 7),
                         f);
        }
        bf[j][0] = f[0];
        bf[j][1] = f[1];
        bf[j + 1][0] = f[2];
        bf[j + 1][1] = f[3];
      }
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
          bsa::mma(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
}

// out (+ blockIdx.z · split) = A · B over k in [z·kper, (z+1)·kper), with
// A (M x K) stored [M][K] (AMK) or [K][M], B (K x N) stored [N][K] (BNK)
// or [K][N], and the epilogue EPI (res: the residual, M x N with leading
// dimension ldo). ALN: A is x [M][K], normalised by nrm into the block's
// panel before the loop (AMK, one split).
template <int KID, bool AMK, bool BNK, bool ALN, int BM, int BN, int EPI,
          typename E>
__global__ void __launch_bounds__(THREADS)
mixffn_gemm_kernel(const E* A, int lda, const E* B, int ldb, void* out,
                   int ldo, const float* bias, const E* res, Norm nrm, int M,
                   int N, int K, int kper, size_t split) {
  static_assert(!ALN || AMK, "the folded LN normalises rows of A");
  using T = Tile<BM, BN>;
  constexpr int KS = KD<E>;   // depth of a staged step
  constexpr int EC = EPC<E>;  // elements of a 16-byte chunk
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = bsa::smem_addr(smem);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * kper, ke = min(K, kb + kper);
  const int nk = (ke - kb + KS - 1) / KS;
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int wm = (w % T::WARPS_M) * T::WM, wn = (w / T::WARPS_M) * T::WN;
  // ALN: A's panel (nk tiles of BM x KS) first, then the ring of B tiles.
  const uint32_t ring = ALN ? base + nk * T::A_BYTES : base;
  const int slot = ALN ? T::B_BYTES : T::STAGE;

  auto load = [&](int it) {
    if (it < nk) {
      const int k0 = kb + it * KS;
      const uint32_t sb = ring + (it % GSTAGES) * slot + (ALN ? 0 : T::A_BYTES);
      if (!ALN) {
        const uint32_t sa = sb - T::A_BYTES;
        if (AMK)
          stage<BM, KS>(sa, A + (size_t)m0 * lda + k0, lda, M - m0, ke - k0);
        else
          stage<KS, BM>(sa, A + (size_t)k0 * lda + m0, lda, ke - k0, M - m0);
      }
      if (BNK)
        stage<BN, KS>(sb, B + (size_t)n0 * ldb + k0, ldb, N - n0, ke - k0);
      else
        stage<KS, BN>(sb, B + (size_t)k0 * ldb + n0, ldb, ke - k0, N - n0);
    }
    bsa::cp_async_commit();  // empty groups keep the count uniform
  };

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
  if constexpr (ALN) {  // x's rows of every k tile: one group, first
    for (int it = 0; it < nk; ++it)
      stage<BM, KS>(base + it * T::A_BYTES, A + (size_t)m0 * lda + it * KS,
                    lda, M - m0, K - it * KS);
    bsa::cp_async_commit();
  }
#pragma unroll
  for (int t = 0; t < GSTAGES - 1; ++t) load(t);
  if constexpr (ALN) {
    // The caller's LN of the block's rows in place in the panel while the
    // first B tiles land: element (r, c) at panel c / KS, chunk (c % KS) /
    // EC. Rows >= M and columns >= K stay zero.
    bsa::cp_async_wait<GSTAGES - 1>();
    __syncthreads();
    // Eight lanes a row, four rows a warp at a time; lane q of a row takes
    // the 16-byte chunks q, q + 8, ... of each group (gsz % 64 == 0), whose
    // statistics are reduced over the eight lanes.
    const int q = l & 7, rows = min(BM, M - m0), per = nrm.gsz / (8 * EC);
    for (int r = w * 4 + (l >> 3); r - (l >> 3) < rows; r += NW * 4) {
      const bool live = r < rows;
      for (int c0 = 0; c0 < K; c0 += nrm.gsz) {
        float sm = 0.0f, sq = 0.0f;
        for (int i = 0; i < per && live; ++i) {
          const int c = c0 + (i * 8 + q) * EC;
          float v[EC];
          unpack<E>(*reinterpret_cast<const uint4*>(
                        smem + (c / KS) * T::A_BYTES + swz(r, (c % KS) / EC)),
                    v);
#pragma unroll
          for (int e = 0; e < EC / 2; ++e) {
            sm += v[2 * e] + v[2 * e + 1];
            sq += v[2 * e] * v[2 * e] + v[2 * e + 1] * v[2 * e + 1];
          }
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) {
          sm += __shfl_xor_sync(FULL_MASK, sm, o);
          sq += __shfl_xor_sync(FULL_MASK, sq, o);
        }
        const float mean = sm / nrm.gsz;
        const float inv = rsqrtf(sq / nrm.gsz - mean * mean + nrm.eps);
        for (int i = 0; i < per && live; ++i) {
          const int c = c0 + (i * 8 + q) * EC;
          uint4* pu = reinterpret_cast<uint4*>(
              smem + (c / KS) * T::A_BYTES + swz(r, (c % KS) / EC));
          float v[EC];
          unpack<E>(*pu, v);
#pragma unroll
          for (int e = 0; e < EC; ++e)
            v[e] = (v[e] - mean) * inv * nrm.s[c + e] + nrm.b[c + e];
          *pu = pack16<E>(v);
        }
      }
    }
  }
  for (int it = 0; it < nk; ++it) {
    bsa::cp_async_wait<GSTAGES - 2>();
    __syncthreads();  // tile it landed; tile it-1's slot is free
    load(it + GSTAGES - 1);
    const uint32_t sb = ring + (it % GSTAGES) * slot + (ALN ? 0 : T::A_BYTES);
    const uint32_t sa = ALN ? base + it * T::A_BYTES : sb - T::A_BYTES;
    mma_step<BM, BN, AMK, BNK, E>(sa, sb, wm, wn, acc);
  }
  bsa::cp_async_wait<0>();

  const int g = l >> 2, t = l & 3;
  if constexpr (EPI == EPI_F32) {
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm + i * 16 + g + 8 * h;
          const int n = n0 + wn + j * 8 + 2 * t;
          if (m >= M || n >= N) continue;
          *reinterpret_cast<float2*>(static_cast<float*>(out) +
                                     blockIdx.z * split + (size_t)m * ldo +
                                     n) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
  } else {
    // The E epilogues: the branch (the product with its bias, rounded
    // where the Pallas kernel rounds it) into a padded tile over the freed
    // operand tiles, then 16-byte stores of EC columns a thread, the
    // residual read likewise, added in fp32 and rounded once more.
    constexpr int TLD = BN + 8;
    E* tile = reinterpret_cast<E*>(smem);
    __syncthreads();  // every warp is done with the operand tiles
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rm = wm + i * 16 + g + 8 * h, cn = wn + j * 8 + 2 * t;
          const int n = min(n0 + cn, N - 2);  // columns >= N never stored
          const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
          float o0, o1;
          if constexpr (EPI == EPI_BIAS) {
            o0 = v0 + bias[n];
            o1 = v1 + bias[n + 1];
          } else if constexpr (EPI == EPI_RESID) {
            o0 = rnd<E>(v0 + bias[n]);
            o1 = rnd<E>(v1 + bias[n + 1]);
          } else {  // EPI_DENSE, EPI_DENSE_RESID
            o0 = rnd<E>(v0) + rnd<E>(bias[n]);
            o1 = rnd<E>(v1) + rnd<E>(bias[n + 1]);
          }
          st2<E>(tile + rm * TLD + cn, o0, o1);
        }
    __syncthreads();
    constexpr int CPR = BN / EC;  // 16-byte chunks of a tile row
    for (int e = threadIdx.x; e < BM * CPR; e += THREADS) {
      const int rm = e / CPR, cc = e % CPR * EC;
      const int m = m0 + rm, n = n0 + cc;
      if (m >= M || n >= N) continue;
      uint4 v = *reinterpret_cast<const uint4*>(tile + rm * TLD + cc);
      const size_t o = (size_t)m * ldo + n;
      if constexpr (EPI == EPI_RESID || EPI == EPI_DENSE_RESID) {
        float a[EC], b[EC];
        unpack<E>(v, a);
        unpack<E>(*reinterpret_cast<const uint4*>(res + o), b);
#pragma unroll
        for (int q = 0; q < EC; ++q) a[q] += b[q];
        v = pack16<E>(a);
      }
      *reinterpret_cast<uint4*>(static_cast<E*>(out) + o) = v;
    }
  }
}

template <int KID, bool AMK, bool BNK, bool ALN, int BM, int BN, int EPI,
          typename E>
cudaError_t gemm_launch(const E* A, int lda, const E* B, int ldb, void* out,
                        int ldo, const float* bias, const E* res, Norm nrm,
                        int M, int N, int K, int kper, size_t split,
                        cudaStream_t st) {
  const void* fn =
      (const void*)mixffn_gemm_kernel<KID, AMK, BNK, ALN, BM, BN, EPI, E>;
  const size_t smem =
      gemm_smem(ALN, BM, BN, ALN ? K : kper, (int)sizeof(E));
  cudaError_t e = set_smem(fn, smem);
  if (e) return e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, (K + kper - 1) / kper);
  mixffn_gemm_kernel<KID, AMK, BNK, ALN, BM, BN, EPI, E>
      <<<grid, THREADS, smem, st>>>(A, lda, B, ldb, out, ldo, bias, res, nrm,
                                    M, N, K, kper, split);
  return cudaGetLastError();
}

// One product with the plan's (bm, bn) output tile; kper: the depth of a
// split (whole KD<E> steps; K rounded up for none). E follows A.
template <int KID, bool AMK, bool BNK, bool ALN, int EPI, typename E>
cudaError_t gemm(int bm, int bn, const E* A, int lda, const Same<E>* B,
                 int ldb, void* out, int ldo, const float* bias,
                 const Same<E>* res, Norm nrm, int M, int N, int K, int kper,
                 size_t split, cudaStream_t st) {
  if (kper <= 0 || kper % KD<E> || (ALN && kper < K))
    return cudaErrorInvalidValue;
#define TILE(BM_, BN_)                                                     \
  if (bm == BM_ && bn == BN_)                                              \
    return gemm_launch<KID, AMK, BNK, ALN, BM_, BN_, EPI, E>(              \
        A, lda, B, ldb, out, ldo, bias, res, nrm, M, N, K, kper, split, st);
  TILE(BIG, BIG)
  TILE(BIG, SMALL)
  TILE(SMALL, BIG)
  TILE(SMALL, SMALL)
#undef TILE
  return cudaErrorInvalidValue;
}

// K rounded up to whole product steps of E.
template <typename E = bf16>
inline int depth(int K) {
  return (K + KD<E> - 1) / KD<E> * KD<E>;
}

// What the rows stage does with y: the hidden LN over the block's H
// channels (ROWS_FULL); or, for a hidden layer sharded over the model
// axis (H of its Hn channels here), the token's partial sums (Σ y, Σ y²)
// into st (ROWS_STATS), or the LN from st's sums over all Hn channels,
// summed over the ranks in between (ROWS_NORM).
constexpr int ROWS_FULL = 0, ROWS_STATS = 1, ROWS_NORM = 2;

// Stage 2 of the forward, per (map row r = blockIdx.x, batch blockIdx.y)
// of an R x s map (R = s for a whole square map; a block of a map's rows
// with its halo rows, R != s, for the bridge's sequence sharding).
// A work item is a pair of hidden channels (c, c + 1) over SEG columns of
// the row: the thread loads the 3 x (SEG + 2) window of h around them
// (rows r-1, r, r+1, zero off the R x s map) at once, as pairs, then
// d = E(conv3x3(h) + dwb) with the taps in registers and y = d + h
// into shared memory (s x H fp32). Then a warp per token: the hidden LN's
// statistics over y, z = E(LN(y)), a = E(GELU(z)) (MODE, above).
template <int KID, typename E, int MODE = ROWS_FULL>
__global__ void __launch_bounds__(THREADS)
mixffn_convrows_kernel(const E* h, const E* dw, const float* dwb,
                       const float* ls, const float* lb, E* a, int R, int s,
                       int H, float eps, float2* st, int Hn) {
  extern __shared__ __align__(16) float ys[];  // s x H
  const int r = blockIdx.x, P = H / 2, nseg = (s + SEG - 1) / SEG;
  const size_t brow = (size_t)blockIdx.y * R;  // map row 0 of batch row b
  const size_t t0 = (brow + r) * s;            // token (b, r, 0)
  for (int item = threadIdx.x; item < P * nseg; item += THREADS) {
    const int c = 2 * (item % P), j0 = item / P * SEG;
    const int nj = min(SEG, s - j0);
    float2 wk[9];
#pragma unroll
    for (int q = 0; q < 9; ++q)
      wk[q] = make_float2(tof(dw[(size_t)c * 9 + q]),
                          tof(dw[(size_t)(c + 1) * 9 + q]));
    const float2 bd = make_float2(dwb[c], dwb[c + 1]);
    Pair<E> win[3][SEG + 2];
#pragma unroll
    for (int di = 0; di < 3; ++di) {
      const int rr = r + di - 1;
#pragma unroll
      for (int q = 0; q < SEG + 2; ++q) {
        const int j = j0 - 1 + q;
        win[di][q] = rr >= 0 && rr < R && j >= 0 && j < s
                         ? *reinterpret_cast<const Pair<E>*>(
                               h + ((brow + rr) * s + j) * H + c)
                         : mk2<E>(0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int jj = 0; jj < SEG; ++jj) {
      if (jj >= nj) break;  // the row ends inside the segment
      float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
#pragma unroll
        for (int di = 0; di < 3; ++di) {
          const float2 v = f2(win[di][jj + dj]);
          acc.x += v.x * wk[di * 3 + dj].x;
          acc.y += v.y * wk[di * 3 + dj].y;
        }
      const float2 hc = f2(win[1][jj + 1]);
      *reinterpret_cast<float2*>(ys + (size_t)(j0 + jj) * H + c) =
          make_float2(rnd<E>(acc.x + bd.x) + hc.x,
                      rnd<E>(acc.y + bd.y) + hc.y);
    }
  }
  __syncthreads();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = w; j < s; j += NW) {
    const float2* y = reinterpret_cast<const float2*>(ys + (size_t)j * H);
    float sm = 0.0f, sq = 0.0f;
    if constexpr (MODE == ROWS_NORM) {
      const float2 t = st[t0 + j];
      sm = t.x;
      sq = t.y;
    } else {
      for (int p = lane; p < P; p += 32) {
        const float2 v = y[p];
        sm += v.x + v.y;
        sq += v.x * v.x + v.y * v.y;
      }
      sm = warp_sum(sm);
      sq = warp_sum(sq);
    }
    if constexpr (MODE == ROWS_STATS) {
      if (lane == 0) st[t0 + j] = make_float2(sm, sq);
      continue;
    }
    const float mean = sm / Hn;
    const float inv = rsqrtf(sq / Hn - mean * mean + eps);
    Pair<E>* out = reinterpret_cast<Pair<E>*>(a + (t0 + j) * H);
    for (int p = lane; p < P; p += 32) {
      const float2 v = y[p];
      const float z0 = rnd<E>((v.x - mean) * inv * ls[2 * p] + lb[2 * p]);
      const float z1 =
          rnd<E>((v.y - mean) * inv * ls[2 * p + 1] + lb[2 * p + 1]);
      out[p] = mk2<E>(0.5f * z0 * erfcf(-z0 * RSQRT2),
                      0.5f * z1 * erfcf(-z1 * RSQRT2));
    }
  }
}

__host__ __device__ inline size_t rows_smem(int s, int H) {
  return (size_t)s * H * 4;
}

// Indices into the wrapper's forward plan (ops/kernels/mixffn.py fwd_plan).
enum FwdPlan { FC1_BM, FC1_BN, FC2_BM, FC2_BN, FWD_PLAN_LEN };

// The MixFFN_skip forward on x (T = B·R·s tokens of C channels: B maps of
// R rows and s columns), hidden H: fc1 (with the caller's LN nrm unless
// BARE), the conv/rows stage, fc2 (+ the residual res unless BARE) into
// out. h and a: (T, H) E workspace. Three launches.
template <int KID, bool BARE, typename E>
cudaError_t forward(const E* x, Norm nrm, const E* w1, const float* b1,
                    const E* dw, const float* dwb, const float* ls,
                    const float* lb, const E* w2, const float* b2,
                    const E* res, E* h, E* a, E* out, const int* plan, int B,
                    int R, int s, int C, int H, float eps, cudaStream_t st) {
  const int T = B * R * s;
  cudaError_t e;
  e = gemm<KID, true, true, !BARE, EPI_BIAS>(plan[FC1_BM], plan[FC1_BN], x,
                                             C, w1, C, h, H, b1, nullptr, nrm,
                                             T, H, C, depth<E>(C), 0, st);
  if (e) return e;
  const size_t rs = rows_smem(s, H);
  if ((e = set_smem((const void*)mixffn_convrows_kernel<KID, E>, rs)))
    return e;
  mixffn_convrows_kernel<KID, E><<<dim3(R, B), THREADS, rs, st>>>(
      h, dw, dwb, ls, lb, a, R, s, H, eps, nullptr, H);
  if ((e = cudaGetLastError())) return e;
  return gemm<KID, true, true, false, BARE ? EPI_BIAS : EPI_RESID>(
      plan[FC2_BM], plan[FC2_BN], a, H, w2, H, out, C, b2, res, Norm{}, T, C,
      H, depth<E>(H), 0, st);
}

// The forward of a MixFFN whose hidden layer is sharded over the model
// axis (H of its Hn channels on this rank), split at its two sums over
// the hidden width, between which the caller sums over the ranks:
//   fc1_stats  h = E(groupLN(x)·w1ᵀ + b1) (BARE: E(x·w1ᵀ + b1), K9's) on
//              the rank's w1 rows, then the conv and each token's partial
//              (Σ y, Σ y²) into st;
//   act_fc2    the LN from the summed st over Hn channels, a = E(GELU(z)),
//              and the fp32 partial p = a·w2ᵀ over the rank's w2 columns
//              (no bias, no residual: the caller sums p over the ranks).
// Two launches each; the plan is fwd_plan's at hidden H. K2's sharded
// form, K9's (BARE) and the FFN of K5's sharded form run them.
template <int KID, typename E, bool BARE = false>
cudaError_t fc1_stats(const E* x, Norm nrm, const E* w1, const float* b1,
                      const E* dw, const float* dwb, E* h, float2* stats,
                      const int* plan, int B, int s, int C, int H,
                      cudaStream_t st) {
  const int T = B * s * s;
  cudaError_t e;
  e = gemm<KID, true, true, !BARE, EPI_BIAS>(plan[FC1_BM], plan[FC1_BN], x,
                                             C, w1, C, h, H, b1, nullptr, nrm,
                                             T, H, C, depth<E>(C), 0, st);
  if (e) return e;
  const size_t rs = rows_smem(s, H);
  const void* fn = (const void*)mixffn_convrows_kernel<KID, E, ROWS_STATS>;
  if ((e = set_smem(fn, rs))) return e;
  mixffn_convrows_kernel<KID, E, ROWS_STATS><<<dim3(s, B), THREADS, rs, st>>>(
      h, dw, dwb, nullptr, nullptr, nullptr, s, s, H, 0.0f, stats, H);
  return cudaGetLastError();
}

template <int KID, typename E>
cudaError_t act_fc2(const E* h, const E* dw, const float* dwb,
                    const float* ls, const float* lb, const E* w2,
                    const float2* stats, E* a, float* p, const int* plan,
                    int B, int s, int C, int H, int Hn, float eps,
                    cudaStream_t st) {
  const int T = B * s * s;
  cudaError_t e;
  const size_t rs = rows_smem(s, H);
  const void* fn = (const void*)mixffn_convrows_kernel<KID, E, ROWS_NORM>;
  if ((e = set_smem(fn, rs))) return e;
  mixffn_convrows_kernel<KID, E, ROWS_NORM><<<dim3(s, B), THREADS, rs, st>>>(
      h, dw, dwb, ls, lb, a, s, s, H, eps, const_cast<float2*>(stats), Hn);
  if ((e = cudaGetLastError())) return e;
  return gemm<KID, true, true, false, EPI_F32>(
      plan[FC2_BM], plan[FC2_BN], a, H, w2, H, p, C, nullptr, nullptr,
      Norm{}, T, C, H, depth<E>(H), 0, st);
}

}  // namespace ffn
