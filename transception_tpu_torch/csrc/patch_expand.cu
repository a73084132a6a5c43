// Fused patch expand + per-group LayerNorm, with the pixel shuffle folded
// into the store:
//   y = bf16(x · Wᵀ) (C -> p²·c), out_g = bf16(LN(y_g)) for each c-wide
//   group g = (p1, p2), written either in pre-shuffle order (B, N, p²·c)
//   or shuffled (B, p²·H·W, c): token (h, w), group (p1, p2) -> row
//   (h·p + p1)·(W·p) + w·p + p2.
// Replaces transception_tpu/ops/pallas/expand_kernel.py:233
// fused_patch_expand (and the XLA transpose after it,
// ops/pallas/patch_expand.py:56-58). Design notes: expand_stages.cuh and
// ops/kernels/patch_expand.py.
//
// The expand body (expand_stages.cuh, the weight through its ring) plus a
// store epilogue: per group, the LN in registers (statistics through a
// small shared array where warps share the group's columns), each warp's
// normalised bf16 (16, WN) share into its own part of a padded shared
// tile, then, after a warp barrier only, 16-byte stores of 8 columns a
// lane to each token's place in the chosen layout. A block takes BM
// tokens and a run of groups (the plan splits the groups over blocks
// where the tokens alone would not fill the card). The LN vectors are
// read in their own dtype.
#include "expand_stages.cuh"

namespace {

using xpd::Split;
using xpd::THREADS;

template <typename LT, bool POST, int C>
__global__ void __launch_bounds__(THREADS)
patch_expand_kernel(const bf16* x, const bf16* w, const LT* ls, const LT* lb,
                    bf16* out, int M, int Cin, int p, int gpb, int N, int Wd,
                    float eps) {
  using S = Split<C>;
  constexpr int WCH = S::WN / 8;      // 16-byte chunks of a warp's row
  constexpr int E = 16 * WCH / 32;    // chunks a lane stores
  constexpr int TLD = C + 8;
  static_assert(16 * WCH % 32 == 0, "whole chunks a lane");
  extern __shared__ __align__(128) unsigned char smem[];
  float2* red = reinterpret_cast<float2*>(smem + xpd::red_offset(C, Cin));
  bf16* tile = reinterpret_cast<bf16*>(smem + xpd::tile_offset(C, Cin));
  const int m0 = blockIdx.x * S::BM, g0 = blockIdx.y * gpb;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int g = l >> 2, t = l & 3;
  const int wj = warp / S::WARPS_M;
  const int wm = (warp % S::WARPS_M) * 16, wn = wj * S::WN;
  float2 sc[S::NT], bi[S::NT];
  xpd::ln_params<S::NT>(ls, lb, wn, sc, bi);
  // Where each chunk this lane stores goes for group 0 (-1: a row past
  // M); a group adds its own offset. Chunk e of the warp: row wm + e /
  // WCH, columns wn + 8·(e % WCH).
  long long dst[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int e = l + k * 32, m = m0 + wm + e / WCH;
    const int ch = wn / 8 + e % WCH;
    if (m >= M) {
      dst[k] = -1;
    } else if (POST) {
      const int b = m / N, n = m - b * N, h = n / Wd, ww = n - h * Wd;
      dst[k] = ((long long)b * p * p * N + (long long)h * p * Wd * p +
                (long long)ww * p) * C + ch * 8;
    } else {
      dst[k] = (long long)m * p * p * C + ch * 8;
    }
  }

  auto epi = [&](int gl, float (&acc)[S::NT][4]) {
    const int gg = g0 + gl;
    float s[4];
    xpd::round_and_sum<S::NT>(acc, s);
    if constexpr (S::WARPS_N > 1) {
      if (t == 0) {
        red[wj * S::BM + wm + g] = make_float2(s[0], s[1]);
        red[wj * S::BM + wm + g + 8] = make_float2(s[2], s[3]);
      }
      __syncthreads();
      s[0] = s[1] = s[2] = s[3] = 0.0f;
#pragma unroll
      for (int k = 0; k < S::WARPS_N; ++k) {  // a fixed order
        const float2 a = red[k * S::BM + wm + g];
        const float2 b = red[k * S::BM + wm + g + 8];
        s[0] += a.x;
        s[1] += a.y;
        s[2] += b.x;
        s[3] += b.y;
      }
    }
    const float2 r0 = xpd::moments(s[0], s[1], C, eps);
    const float2 r1 = xpd::moments(s[2], s[3], C, eps);
#pragma unroll
    for (int j = 0; j < S::NT; ++j) {
      const int col = wn + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(tile + (wm + g) * TLD + col) =
          xpd::norm_pack(acc[j][0], acc[j][1], r0, sc[j], bi[j]);
      *reinterpret_cast<uint32_t*>(tile + (wm + g + 8) * TLD + col) =
          xpd::norm_pack(acc[j][2], acc[j][3], r1, sc[j], bi[j]);
    }
    __syncwarp();  // the warp's share of the tile is whole
    const long long goff =
        POST ? ((long long)(gg / p) * Wd * p + gg % p) * C : (long long)gg * C;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      if (dst[k] < 0) continue;
      const int e = l + k * 32;
      *reinterpret_cast<uint4*>(out + dst[k] + goff) =
          *reinterpret_cast<const uint4*>(tile + (wm + e / WCH) * TLD + wn +
                                          (e % WCH) * 8);
    }
    // The tile is rewritten only after the next group's first barrier.
  };
  xpd::run<C>(x, w, M, Cin, m0, g0, gpb, smem, epi);
}

template <typename LT, bool POST, int C>
cudaError_t launch(const bf16* x, const bf16* w, const void* ls,
                   const void* lb, bf16* out, int M, int Cin, int p,
                   int splits, int N, int Wd, float eps, cudaStream_t st) {
  const void* fn = (const void*)patch_expand_kernel<LT, POST, C>;
  const size_t smem = xpd::smem_bytes(C, Cin, true);
  cudaError_t e = set_smem(fn, smem);
  if (e) return e;
  const dim3 grid((M + Split<C>::BM - 1) / Split<C>::BM, splits);
  patch_expand_kernel<LT, POST, C><<<grid, THREADS, smem, st>>>(
      x, w, static_cast<const LT*>(ls), static_cast<const LT*>(lb), out, M,
      Cin, p, p * p / splits, N, Wd, eps);
  return cudaGetLastError();
}

template <typename LT, bool POST>
cudaError_t by_width(int c, const bf16* x, const bf16* w, const void* ls,
                     const void* lb, bf16* out, int M, int Cin, int p,
                     int splits, int N, int Wd, float eps, cudaStream_t st) {
  switch (c) {
    case 64:
      return launch<LT, POST, 64>(x, w, ls, lb, out, M, Cin, p, splits, N, Wd,
                                  eps, st);
    case 160:
      return launch<LT, POST, 160>(x, w, ls, lb, out, M, Cin, p, splits, N,
                                   Wd, eps, st);
    case 256:
      return launch<LT, POST, 256>(x, w, ls, lb, out, M, Cin, p, splits, N,
                                   Wd, eps, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x (M = B·N tokens, Cin), w (p²·c, Cin) bf16; ls, lb (c,) bf16 or fp32
// (ln_f32); out (B, N, p²·c) or, with post, (B, p²·N, c) for a map of N =
// H·Wd tokens. splits: blocks a token tile's p² groups are split over.
extern "C" int patch_expand(const bf16* x, const bf16* w, const void* ls,
                            const void* lb, bf16* out, int M, int Cin, int c,
                            int p, int splits, int N, int Wd, int post,
                            int ln_f32, float eps, void* stream) {
  if (M <= 0 || Cin % xpd::BK || Cin > xpd::MAX_CIN || splits <= 0 ||
      (p * p) % splits || N <= 0 || Wd <= 0 || N % Wd)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (ln_f32)
    return post ? by_width<float, true>(c, x, w, ls, lb, out, M, Cin, p,
                                        splits, N, Wd, eps, st)
                : by_width<float, false>(c, x, w, ls, lb, out, M, Cin, p,
                                         splits, N, Wd, eps, st);
  return post ? by_width<bf16, true>(c, x, w, ls, lb, out, M, Cin, p, splits,
                                     N, Wd, eps, st)
              : by_width<bf16, false>(c, x, w, ls, lb, out, M, Cin, p,
                                      splits, N, Wd, eps, st);
}
