// The expand body that the x4 expand head (K4, csrc/expand_head.cu) and the
// patch expand (K7, csrc/patch_expand.cu) share: for a tile of BM tokens
// and a run of whole LN groups, y_g = x · W_gᵀ on the tensor cores, one
// c-wide group at a time, handed to the kernel's epilogue in registers.
//
// What bounds it on the H100: K7 is bytes at every shape (x in, p² times
// its width out: at (32, 3136, 64) -> 1024, 205 MB of output); K4 writes
// only p² ids a token, so its ~16 GFLOP of products and ~1 G CUDA-core
// operations of LN bound it. The design keeps every byte that is not x,
// W or the result out of device memory, and each operand where it is
// read most cheaply:
//   - x once per block: the block's whole (BM, Cin) x panel (Cin <= 512,
//     a multiple of 64) is staged once with cp.async into XOR-swizzled
//     64-column panels (bridge_softmax.cuh's layout) and every group of
//     the block is walked from it;
//   - W streams from L2: the (C, 64) weight tiles of the block's groups,
//     in order, through a 3-deep cp.async ring shared by the block (one
//     barrier a tile: a slot is refilled only after every warp has read
//     it). A K4 whose 8 groups' tiles were all resident beside the
//     panel, with no barrier in its group loop, measured no faster on an
//     H100, nor did one with three blocks an SM; what its time follows is
//     the instructions a group issues (PERF.md §6), so a thread stages
//     a fixed number of 16-byte chunks a tile from running offsets, with
//     counters in place of divisions, and the LN rounds in pairs and
//     normalises with two FMAs a value;
//   - fragments by ldmatrix, products on mma.sync.m16n8k16 with fp32
//     accumulation (mixffn_stages.cuh's mma_step, with B stored [n][k]);
//   - whole groups in a tile: the N-extent of a tile is one LN group of C
//     columns, split over WARPS_N warps of WN columns, so a group's
//     statistics never cross blocks (no atomics, no partials in device
//     memory). Each warp owns a 16-token strip of its WN columns; the
//     epilogue gets the warp's (16, WN) accumulators in the m16n8 layout
//     (row g: columns 2t, 2t+1 of each n8 tile in acc[j][0..1], row g + 8
//     in acc[j][2..3]; g = lane / 4, t = lane % 4), rounds them to bf16 and
//     reduces each row's sum and sum of squares in the quad with shuffles,
//     through a (BM, WARPS_N) shared array where warps share a group.
// The plan of a launch (grid, group split, shared bytes) is the wrapper's
// (ops/kernels/patch_expand.py plan, mirrored by smem_bytes here).
#pragma once

#include "bridge_softmax.cuh"

namespace xpd {

using bsa::cp_async16;
using bsa::swz;

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int BK = 64;      // depth of a staged weight tile
constexpr int STAGES = 3;   // the weight ring
constexpr int MAX_CIN = 512;

// The warp split of a tile of one C-wide group: WARPS_N warps share the
// group's columns, WARPS_M strips of 16 tokens make the BM rows.
__host__ __device__ constexpr int warps_n(int c) {
  return c <= 64 ? 1 : (c <= 160 ? 2 : 4);
}
__host__ __device__ constexpr int block_rows(int c) {
  return 16 * (NW / warps_n(c));
}

template <int C>
struct Split {
  static constexpr int WARPS_N = warps_n(C);
  static constexpr int WARPS_M = NW / WARPS_N;
  static constexpr int BM = block_rows(C);
  static constexpr int WN = C / WARPS_N;  // columns of a warp
  static constexpr int NT = WN / 8;       // its n8 tiles
  static constexpr int W_TILE = C * BK * 2;
  static_assert(WN * WARPS_N == C && WN % 16 == 0,
                "a warp takes whole pairs of n8 tiles of one group");
};

// Shared memory of a block: the x panel (BM x Cin), the weight ring, the
// LN partials where warps share a group, and with `tile` the padded bf16
// output tile of the store epilogue, in that order.
__host__ __device__ inline size_t red_offset(int c, int Cin) {
  return (size_t)block_rows(c) * Cin * 2 + (size_t)STAGES * c * BK * 2;
}
__host__ __device__ inline size_t tile_offset(int c, int Cin) {
  const int wn = warps_n(c);
  return red_offset(c, Cin) + (wn > 1 ? (size_t)block_rows(c) * wn * 8 : 0);
}
__host__ __device__ inline size_t smem_bytes(int c, int Cin, bool tile) {
  return tile_offset(c, Cin) + (tile ? (size_t)block_rows(c) * (c + 8) * 2
                                     : 0);
}

// A parameter vector read in the dtype its caller keeps it in (bf16 ->
// fp32 is exact).
__device__ __forceinline__ float ld(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float ld(const bf16* p, int i) {
  return __bfloat162float(p[i]);
}

// The LN scale and bias of a thread's columns: wn + 8j + 2t and the next.
template <int NT, typename LT>
__device__ __forceinline__ void ln_params(const LT* ls, const LT* lb, int wn,
                                          float2 (&sc)[NT], float2 (&bi)[NT]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = wn + 8 * j + 2 * t;
    sc[j] = make_float2(ld(ls, col), ld(ls, col + 1));
    bi[j] = make_float2(ld(lb, col), ld(lb, col + 1));
  }
}

// (a, b) rounded to bf16 and back, one conversion for the pair.
__device__ __forceinline__ float2 rbf2(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

// Rows g and g + 8 of a warp's (16, WN) accumulators rounded to bf16 (the
// Pallas kernel's y), with each row's fp32 sum and sum of squares over the
// warp's columns reduced in the quad: s = {sum g, sumsq g, sum g+8,
// sumsq g+8}.
template <int NT>
__device__ __forceinline__ void round_and_sum(float (&acc)[NT][4],
                                              float (&s)[4]) {
  s[0] = s[1] = s[2] = s[3] = 0.0f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v = rbf2(acc[j][2 * h], acc[j][2 * h + 1]);
      acc[j][2 * h] = v.x;
      acc[j][2 * h + 1] = v.y;
      s[2 * h] += v.x + v.y;
      s[2 * h + 1] = fmaf(v.y, v.y, fmaf(v.x, v.x, s[2 * h + 1]));
    }
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = bsa::quad_sum(s[i]);
}

// inv = 1 / sqrt(var + eps) and −mean·inv of a c-wide group from its sum
// and sum of squares (flax's E[y²] − E[y]²).
__device__ __forceinline__ float2 moments(float sum, float sq, int c,
                                          float eps) {
  const float mean = sum / c;
  const float inv = rsqrtf(sq / c - mean * mean + eps);
  return make_float2(inv, -mean * inv);
}

// Two normalised values of a row, (y − mean)·inv·s + b as two FMAs each
// (r from moments), packed to bf16.
__device__ __forceinline__ uint32_t norm_pack(float y0, float y1, float2 r,
                                              float2 s, float2 b) {
  return bsa::pack(fmaf(fmaf(y0, r.x, r.y), s.x, b.x),
                   fmaf(fmaf(y1, r.x, r.y), s.y, b.y));
}

// The body: rows [m0, m0 + BM) of x (M x Cin, row-major) against the
// weight rows of groups [g0, g0 + gpb) (w: (groups·C, Cin), a torch Linear
// weight). For each group in turn the warp's share of the (BM, C) product
// is accumulated over Cin, then epi(gl, acc) runs (gl: the group's index
// within the block). Rows >= M are zero.
template <int C, typename Epi>
__device__ __forceinline__ void run(const bf16* x, const bf16* w, int M,
                                    int Cin, int m0, int g0, int gpb,
                                    unsigned char* smem, Epi& epi) {
  using S = Split<C>;
  // 16-byte chunks a thread stages per weight tile: rows r0 + 32k, chunk
  // wc of each.
  constexpr int WCH = C * 8 / THREADS;
  static_assert(C * 8 % THREADS == 0, "whole chunks a thread");
  const uint32_t base = bsa::smem_addr(smem);
  const uint32_t ring = base + S::BM * Cin * 2;
  const int nk = Cin / BK, total = gpb * nk, cch = Cin / 8;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int wm = (warp % S::WARPS_M) * 16, wn = (warp / S::WARPS_M) * S::WN;
  const int r0 = threadIdx.x >> 3, wc = threadIdx.x & 7;

  // The x panel: nk panels of BM rows x 64 columns, one cp.async group.
  for (int i = threadIdx.x; i < S::BM * cch; i += THREADS) {
    const int r = i / cch, ch = i % cch;
    const bool ok = m0 + r < M;
    cp_async16(base + (ch >> 3) * (S::BM * 128) + swz(r, ch & 7),
               ok ? x + (size_t)(m0 + r) * Cin + ch * 8 : x, ok);
  }
  bsa::cp_async_commit();
  // The weight tiles in order, (group, depth) = (lg, lk) next, C rows x
  // 64 columns each, into ring slot ls; counters, not divisions.
  const bf16* wsrc = w + (size_t)g0 * C * Cin + (size_t)r0 * Cin + wc * 8;
  const uint32_t wdst = ring + swz(r0, wc);
  int lg = 0, lk = 0, ls = 0;
  auto load = [&]() {
    if (lg < gpb) {
      const bf16* src = wsrc + (size_t)lg * C * Cin + lk * BK;
      const uint32_t dst = wdst + ls * S::W_TILE;
#pragma unroll
      for (int k = 0; k < WCH; ++k)  // rows r0 + 32k: the same swizzle
        cp_async16(dst + k * 32 * 128, src + (size_t)k * 32 * Cin, true);
      if (++lk == nk) {
        lk = 0;
        ++lg;
      }
      ls = ls + 1 == STAGES ? 0 : ls + 1;
    }
    bsa::cp_async_commit();  // empty groups keep the count uniform
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load();

  float acc[S::NT][4];
  for (int it = 0, gl = 0, kt = 0, cs = 0; it < total; ++it) {
    bsa::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile it (and the panel) landed; slot it-1 is free
    load();
    if (kt == 0) {
#pragma unroll
      for (int j = 0; j < S::NT; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    }
    const uint32_t sa = base + kt * (S::BM * 128);
    const uint32_t sb = ring + cs * S::W_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4];
      bsa::ldsm_x4(sa + swz(wm + (l & 15), (kk >> 3) + (l >> 4)), af);
#pragma unroll
      for (int j = 0; j < S::NT; j += 2) {
        uint32_t f[4];
        bsa::ldsm_x4(sb + swz(wn + j * 8 + (l & 7) + ((l >> 4) << 3),
                              (kk >> 3) + ((l >> 3) & 1)), f);
        bsa::mma(acc[j], af, f[0], f[1]);
        bsa::mma(acc[j + 1], af, f[2], f[3]);
      }
    }
    cs = cs + 1 == STAGES ? 0 : cs + 1;
    if (++kt == nk) {
      epi(gl++, acc);
      kt = 0;
    }
  }
  bsa::cp_async_wait<0>();
}

}  // namespace xpd
