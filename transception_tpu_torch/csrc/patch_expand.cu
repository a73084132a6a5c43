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
// read in their own dtype. patch_expand_f32 is the fp32 form (the fp32
// eval forward's p = 2 expands and its x4 expand before the fp32 head):
// the same body at E = float, no rounding, the product on the CUDA cores.
#include "expand_stages.cuh"

namespace {

using xpd::Split;
using xpd::THREADS;

template <typename E, typename LT, bool POST, int C>
__global__ void __launch_bounds__(THREADS)
patch_expand_kernel(const E* x, const E* w, const LT* ls, const LT* lb,
                    E* out, int M, int Cin, int p, int gpb, int N, int Wd,
                    float eps) {
  using S = Split<C>;
  constexpr int EC = EPC<E>;
  constexpr int WCH = S::WN / EC;     // 16-byte chunks of a warp's row
  constexpr int NE = 16 * WCH / 32;   // chunks a lane stores
  constexpr int TLD = C + 8;
  static_assert(16 * WCH % 32 == 0, "whole chunks a lane");
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ES = sizeof(E);
  float2* red = reinterpret_cast<float2*>(smem + xpd::red_offset(C, Cin, ES));
  E* tile = reinterpret_cast<E*>(smem + xpd::tile_offset(C, Cin, ES));
  const int m0 = blockIdx.x * S::BM, g0 = blockIdx.y * gpb;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int g = l >> 2, t = l & 3;
  const int wj = warp / S::WARPS_M;
  const int wm = (warp % S::WARPS_M) * 16, wn = wj * S::WN;
  float2 sc[S::NT], bi[S::NT];
  xpd::ln_params<S::NT>(ls, lb, wn, sc, bi);
  // Where each chunk this lane stores goes for group 0 (-1: a row past
  // M); a group adds its own offset. Chunk e of the warp: row wm + e /
  // WCH, columns wn + EC·(e % WCH).
  long long dst[NE];
#pragma unroll
  for (int k = 0; k < NE; ++k) {
    const int e = l + k * 32, m = m0 + wm + e / WCH;
    const int ch = wn / EC + e % WCH;
    if (m >= M) {
      dst[k] = -1;
    } else if (POST) {
      const int b = m / N, n = m - b * N, h = n / Wd, ww = n - h * Wd;
      dst[k] = ((long long)b * p * p * N + (long long)h * p * Wd * p +
                (long long)ww * p) * C + ch * EC;
    } else {
      dst[k] = (long long)m * p * p * C + ch * EC;
    }
  }

  auto epi = [&](int gl, float (&acc)[S::NT][4]) {
    const int gg = g0 + gl;
    float s[4];
    xpd::round_and_sum<S::NT, E>(acc, s);
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
      xpd::norm_store<E>(tile + (wm + g) * TLD + col, acc[j][0], acc[j][1],
                         r0, sc[j], bi[j]);
      xpd::norm_store<E>(tile + (wm + g + 8) * TLD + col, acc[j][2],
                         acc[j][3], r1, sc[j], bi[j]);
    }
    __syncwarp();  // the warp's share of the tile is whole
    const long long goff =
        POST ? ((long long)(gg / p) * Wd * p + gg % p) * C : (long long)gg * C;
#pragma unroll
    for (int k = 0; k < NE; ++k) {
      if (dst[k] < 0) continue;
      const int e = l + k * 32;
      *reinterpret_cast<uint4*>(out + dst[k] + goff) =
          *reinterpret_cast<const uint4*>(tile + (wm + e / WCH) * TLD + wn +
                                          (e % WCH) * EC);
    }
    // The tile is rewritten only after the next group's first barrier.
  };
  xpd::run<C>(x, w, M, Cin, m0, g0, gpb, smem, epi);
}

template <typename E, typename LT, bool POST, int C>
cudaError_t launch(const E* x, const E* w, const void* ls, const void* lb,
                   E* out, int M, int Cin, int p, int splits, int N, int Wd,
                   float eps, cudaStream_t st) {
  const void* fn = (const void*)patch_expand_kernel<E, LT, POST, C>;
  const size_t smem = xpd::smem_bytes(C, Cin, true, (int)sizeof(E));
  cudaError_t e = set_smem(fn, smem);
  if (e) return e;
  const dim3 grid((M + Split<C>::BM - 1) / Split<C>::BM, splits);
  patch_expand_kernel<E, LT, POST, C><<<grid, THREADS, smem, st>>>(
      x, w, static_cast<const LT*>(ls), static_cast<const LT*>(lb), out, M,
      Cin, p, p * p / splits, N, Wd, eps);
  return cudaGetLastError();
}

template <typename E, typename LT, bool POST>
cudaError_t by_width(int c, const E* x, const E* w, const void* ls,
                     const void* lb, E* out, int M, int Cin, int p,
                     int splits, int N, int Wd, float eps, cudaStream_t st) {
  switch (c) {
    case 64:
      return launch<E, LT, POST, 64>(x, w, ls, lb, out, M, Cin, p, splits, N,
                                     Wd, eps, st);
    case 160:
      return launch<E, LT, POST, 160>(x, w, ls, lb, out, M, Cin, p, splits,
                                      N, Wd, eps, st);
    case 256:
      return launch<E, LT, POST, 256>(x, w, ls, lb, out, M, Cin, p, splits,
                                      N, Wd, eps, st);
  }
  return cudaErrorInvalidValue;
}

// x (M = B·N tokens, Cin), w (p²·c, Cin) E; ls, lb (c,) bf16 or fp32
// (ln_f32); out (B, N, p²·c) or, with post, (B, p²·N, c) for a map of N =
// H·Wd tokens. splits: blocks a token tile's p² groups are split over.
template <typename E>
int expand(const E* x, const E* w, const void* ls, const void* lb, E* out,
           int M, int Cin, int c, int p, int splits, int N, int Wd, int post,
           int ln_f32, float eps, void* stream) {
  if (M <= 0 || Cin % xpd::BK || Cin > xpd::MAX_CIN || splits <= 0 ||
      (p * p) % splits || N <= 0 || Wd <= 0 || N % Wd)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (ln_f32)
    return post ? by_width<E, float, true>(c, x, w, ls, lb, out, M, Cin, p,
                                           splits, N, Wd, eps, st)
                : by_width<E, float, false>(c, x, w, ls, lb, out, M, Cin, p,
                                            splits, N, Wd, eps, st);
  if constexpr (IS_F32<E>)
    return cudaErrorInvalidValue;  // the fp32 form takes fp32 LN vectors
  else
    return post ? by_width<E, bf16, true>(c, x, w, ls, lb, out, M, Cin, p,
                                          splits, N, Wd, eps, st)
                : by_width<E, bf16, false>(c, x, w, ls, lb, out, M, Cin, p,
                                           splits, N, Wd, eps, st);
}

}  // namespace

extern "C" int patch_expand(const bf16* x, const bf16* w, const void* ls,
                            const void* lb, bf16* out, int M, int Cin, int c,
                            int p, int splits, int N, int Wd, int post,
                            int ln_f32, float eps, void* stream) {
  return expand<bf16>(x, w, ls, lb, out, M, Cin, c, p, splits, N, Wd, post,
                      ln_f32, eps, stream);
}

extern "C" int patch_expand_f32(const float* x, const float* w,
                                const void* ls, const void* lb, float* out,
                                int M, int Cin, int c, int p, int splits,
                                int N, int Wd, int post, int ln_f32,
                                float eps, void* stream) {
  return expand<float>(x, w, ls, lb, out, M, Cin, c, p, splits, N, Wd, post,
                       ln_f32, eps, stream);
}
