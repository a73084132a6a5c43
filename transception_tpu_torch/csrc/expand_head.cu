// Fused x4 patch expand + per-group LayerNorm + 1x1 head + argmax:
//   y = bf16(x · Wᵀ) (Cin -> 16·64), yn_g = bf16(LN(y_g)) for each of the
//   16 64-wide groups g = (p1, p2), logits_g = bf16(yn_g · Whᵀ + bh) with
//   the head weight rounded to bf16, ids = argmax (ties to the first
//   class), written in pre-shuffle order (B, N, 16) or as the shuffled
//   class map (B, 4H, 4W).
// Replaces transception_tpu/ops/pallas/expand_kernel.py:159
// fused_patch_expand_argmax (the argmax that JAX runs after the kernel and
// the pixel shuffle after that are fused here). Design notes:
// expand_stages.cuh and ops/kernels/expand_head.py.
//
// The expand body (expand_stages.cuh) with c = 64, plus a head epilogue
// that never leaves registers. Each warp owns a 16-token strip over the
// whole group, so the LN is the quad's shuffles alone. The normalised
// bf16 y is re-packed from the m16n8 accumulator layout into m16k16 A
// fragments (two neighbouring n8 tiles make one k16 tile, as
// bridge_softmax.cuh does between its products), multiplied by the bf16
// head weight zero-padded to 16 classes (B fragments loaded once per
// warp and kept in registers), the bias added and the logits rounded to
// bf16; classes >= ncls are masked and the argmax taken in the quad with
// (value, index) shuffles. Lane t of a quad keeps the ids of groups
// 4t..4t+3 (p1 = t) of its two tokens in one register each, and writes
// them once, after the block's last group: 4 bytes at column 4t of the
// token's 16 in pre-shuffle order, or at row 4h + t, columns 4w..4w+3 of
// the class map, so a quad's four stores cover a token's 16 ids.
#include "expand_stages.cuh"

namespace {

using xpd::THREADS;
constexpr int C = 64;        // the group width this kernel takes
constexpr int P = 4;         // x4 expand: 16 groups
constexpr int NPAD = 16;     // head classes padded to two n8 tiles
using S = xpd::Split<C>;
static_assert(S::WARPS_N == 1, "a warp holds whole groups");

template <typename LT, typename HT, bool POST>
__global__ void __launch_bounds__(THREADS)
expand_head_kernel(const bf16* x, const bf16* w, const LT* ls, const LT* lb,
                   const HT* hw, const HT* hb, uint8_t* ids, int M, int Cin,
                   int gpb, int ncls, int N, int Wd, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * S::BM, g0 = blockIdx.y * gpb;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int g = l >> 2, t = l & 3;
  const int wm = warp * 16;
  float2 sc[S::NT], bi[S::NT];
  xpd::ln_params<S::NT>(ls, lb, 0, sc, bi);
  // The head's B fragments (class n = 8·nt + g, depth 16·kk + 8·h + 2t and
  // the next), bf16 round-to-nearest-even, zero past ncls; and the bias of
  // this thread's classes 8·nt + 2t + e, −inf past ncls (a masked class
  // never wins: it is not greater than anything).
  uint32_t hf[2][4][2];
  float hbias[2][2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int n = nt * 8 + g;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = kk * 16 + h * 8 + 2 * t;
        hf[nt][kk][h] = n < ncls ? bsa::pack(xpd::ld(hw, n * C + k),
                                             xpd::ld(hw, n * C + k + 1))
                                 : 0u;
      }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cls = nt * 8 + 2 * t + e;
      hbias[nt][e] = cls < ncls ? xpd::ld(hb, cls) : -INFINITY;
    }
  }
  uint32_t word[2] = {0u, 0u};  // ids of rows g, g + 8 for groups 4t..4t+3

  auto epi = [&](int gl, float (&acc)[S::NT][4]) {
    const int gg = g0 + gl;
    float s[4];
    xpd::round_and_sum<S::NT>(acc, s);
    const float2 r0 = xpd::moments(s[0], s[1], C, eps);
    const float2 r1 = xpd::moments(s[2], s[3], C, eps);
    // yn in bf16 as the head's A fragments: k16 tile kk = n8 tiles 2kk and
    // 2kk + 1 of the accumulators.
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * kk + h;
        a[kk][2 * h] =
            xpd::norm_pack(acc[j][0], acc[j][1], r0, sc[j], bi[j]);
        a[kk][2 * h + 1] =
            xpd::norm_pack(acc[j][2], acc[j][3], r1, sc[j], bi[j]);
      }
    float lg[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      lg[nt][0] = lg[nt][1] = lg[nt][2] = lg[nt][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        bsa::mma(lg[nt], a[kk], hf[nt][kk][0], hf[nt][kk][1]);
    }
    // Per row: the best of this thread's classes in increasing order
    // (strict >: the first of equals), then over the quad.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float best = -INFINITY;
      int arg = NPAD;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 v = xpd::rbf2(lg[nt][2 * h] + hbias[nt][0],
                                   lg[nt][2 * h + 1] + hbias[nt][1]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ve = e ? v.y : v.x;
          if (ve > best) {
            best = ve;
            arg = nt * 8 + 2 * t + e;
          }
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float ob = __shfl_xor_sync(FULL_MASK, best, o);
        const int oa = __shfl_xor_sync(FULL_MASK, arg, o);
        if (ob > best || (ob == best && oa < arg)) {
          best = ob;
          arg = oa;
        }
      }
      if ((gg >> 2) == t) word[h] |= (uint32_t)arg << (8 * (gg & 3));
    }
  };
  xpd::run<C>(x, w, M, Cin, m0, g0, gpb, smem, epi);

  if (4 * t < g0 || 4 * t >= g0 + gpb) return;  // p1 = t not in this block
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + wm + g + 8 * h;
    if (m >= M) continue;
    long long off;
    if (POST) {
      const int b = m / N, n = m - b * N, hh = n / Wd, ww = n - hh * Wd;
      off = (long long)b * P * P * N + (long long)(P * hh + t) * (P * Wd) +
            P * ww;
    } else {
      off = (long long)m * P * P + 4 * t;
    }
    *reinterpret_cast<uint32_t*>(ids + off) = word[h];
  }
}

template <typename LT, typename HT, bool POST>
cudaError_t launch(const bf16* x, const bf16* w, const void* ls,
                   const void* lb, const void* hw, const void* hb,
                   uint8_t* ids, int M, int Cin, int splits, int ncls, int N,
                   int Wd, float eps, cudaStream_t st) {
  const void* fn = (const void*)expand_head_kernel<LT, HT, POST>;
  const size_t smem = xpd::smem_bytes(C, Cin, false);
  cudaError_t e = set_smem(fn, smem);
  if (e) return e;
  const dim3 grid((M + S::BM - 1) / S::BM, splits);
  expand_head_kernel<LT, HT, POST><<<grid, THREADS, smem, st>>>(
      x, w, static_cast<const LT*>(ls), static_cast<const LT*>(lb),
      static_cast<const HT*>(hw), static_cast<const HT*>(hb), ids, M, Cin,
      P * P / splits, ncls, N, Wd, eps);
  return cudaGetLastError();
}

template <typename LT, typename HT>
cudaError_t by_layout(int post, const bf16* x, const bf16* w, const void* ls,
                      const void* lb, const void* hw, const void* hb,
                      uint8_t* ids, int M, int Cin, int splits, int ncls,
                      int N, int Wd, float eps, cudaStream_t st) {
  return post ? launch<LT, HT, true>(x, w, ls, lb, hw, hb, ids, M, Cin,
                                     splits, ncls, N, Wd, eps, st)
              : launch<LT, HT, false>(x, w, ls, lb, hw, hb, ids, M, Cin,
                                      splits, ncls, N, Wd, eps, st);
}

}  // namespace

// x (M = B·N tokens, Cin), w (16·64, Cin) bf16; ls, lb (64,) bf16 or fp32
// (ln_f32); hw (ncls, 64), hb (ncls,) bf16 or fp32 (head_f32); ids (B, N,
// 16) or, with post, (B, 4H, 4·Wd) uint8 for a map of N = H·Wd tokens.
// splits: blocks a token tile's 16 groups are split over (1, 2 or 4).
extern "C" int expand_head(const bf16* x, const bf16* w, const void* ls,
                           const void* lb, const void* hw, const void* hb,
                           uint8_t* ids, int M, int Cin, int splits, int ncls,
                           int N, int Wd, int post, int ln_f32, int head_f32,
                           float eps, void* stream) {
  if (M <= 0 || Cin % xpd::BK || Cin > xpd::MAX_CIN ||
      (splits != 1 && splits != 2 && splits != 4) || ncls < 1 ||
      ncls > NPAD || N <= 0 || Wd <= 0 || N % Wd)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (ln_f32)
    return head_f32 ? by_layout<float, float>(post, x, w, ls, lb, hw, hb, ids,
                                              M, Cin, splits, ncls, N, Wd,
                                              eps, st)
                    : by_layout<float, bf16>(post, x, w, ls, lb, hw, hb, ids,
                                             M, Cin, splits, ncls, N, Wd, eps,
                                             st);
  return head_f32 ? by_layout<bf16, float>(post, x, w, ls, lb, hw, hb, ids, M,
                                           Cin, splits, ncls, N, Wd, eps, st)
                  : by_layout<bf16, bf16>(post, x, w, ls, lb, hw, hb, ids, M,
                                          Cin, splits, ncls, N, Wd, eps, st);
}
