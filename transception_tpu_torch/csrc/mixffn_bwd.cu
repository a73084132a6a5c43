// Backward of the LN- and residual-folded MixFFN_skip
//   out = x + fc2(GELU(LN_h(dwconv3x3(h) + h))),  h = fc1(groupLN(x)),
// given the cotangent g of out: dx and the ten parameter gradients.
// Replaces transception_tpu/ops/pallas/mixffn_kernel.py:659
// fused_mixffn_ln_skip_bwd (its _bwd_kernel_ln, :479-653). Design notes:
// ops/kernels/mixffn.py.
//
// One block per (R = 2 map rows, group of batch rows). For each batch row
// the block normalises the window rows r0-2 .. r0+R+1 (x's group LN, the
// two-row halo: dx at row r needs dd at r±1, which needs h at r±2) and
// loads g for rows r0-1 .. r0+R. It then walks the hidden width in
// 32-channel chunks, one channel per lane, three times:
//   A. h = fc1 on the window (tensor cores), y = d + h on rows r0-1..r0+R,
//      per-token sums of y and y² -> the hidden LN's mean and rsqrt;
//   B. da = g·w2 (tensor cores), dz = da·GELU'(z), per-token sums of
//      dyh = dz·ls and dyh·yh -> the LN backward's two means;
//   C. dy (= dd) on rows r0-1..r0+R, then for the centre rows
//      dh = dy + (conv transpose of dd: a correlation with the same taps)
//      and the chunk's gradients: dxn += dh·w1, dw1 += dhᵀ·xn,
//      dw2 += gᵀ·a on the tensor cores, db1, the nine taps, their bias,
//      the LN scale and bias in fp32 registers.
// Last, the group-LN backward of the centre rows gives dx (+ g, the
// residual). The hidden state lives in shared memory only. Weight
// gradients go to one fp32 partial per block (read-modify-written across
// the block's batch rows) and sum_partials adds the partials in a fixed
// order: no atomics, the result does not depend on scheduling.
#include "mixffn.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int HC = 32;  // hidden channels per chunk: one per lane
constexpr int R = 2;    // map rows per block
constexpr float RSQRT2 = 0.70710678118654752f;
constexpr float INV_SQRT_2PI = 0.3989422804014327f;

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }
__host__ __device__ inline size_t up128(size_t b) {
  return (b + 127) & ~(size_t)127;
}

// Shared-memory plan of one block; the same on host and device (mirrored
// by ops/kernels/mixffn.py bwd_smem_bytes).
struct Geo {
  int Th, Ty, Tc;     // window tokens: h rows R+4, y rows R+2, centre R
  int Thp, Typ, Tcp;  // padded to whole 16-token tiles
  size_t o_xn, o_g, o_h, o_da, o_dxn, o_dh, o_a, o_st, o_stage, o_red;
  size_t bytes;
};

__host__ __device__ inline Geo make_geo(int s, int C) {
  Geo G;
  G.Th = (R + 4) * s;
  G.Ty = (R + 2) * s;
  G.Tc = R * s;
  G.Tcp = pad16(G.Tc);
  // The centre rows' operands (xn from token 2s, g from token s) must
  // stay inside the buffers for a whole number of 16-token tiles.
  G.Thp = pad16(imax(G.Th, 2 * s + G.Tcp));
  G.Typ = pad16(imax(G.Ty, s + G.Tcp));
  size_t o = 0;
  G.o_xn = o;    o += up128((size_t)G.Thp * C * 2);
  G.o_g = o;     o += up128((size_t)G.Typ * C * 2);
  G.o_h = o;     o += up128((size_t)G.Thp * HC * 2);
  G.o_da = o;    o += up128((size_t)G.Typ * HC * 4);
  G.o_dxn = o;   o += up128((size_t)G.Tcp * C * 4);
  G.o_dh = o;    o += up128((size_t)G.Tcp * HC * 2);
  G.o_a = o;     o += up128((size_t)G.Tcp * HC * 2);
  G.o_st = o;    o += up128((size_t)G.Typ * 4 * 4);
  G.o_stage = o; o += up128((size_t)NW * 256 * 4);
  G.o_red = o;   o += up128((size_t)imax(13 * NW * 32, 3 * NW * C) * 4);
  G.bytes = o;
  return G;
}

// Floats of one block's partial: dw1, dw2, db1, ddw (9 taps), ddwb, dls,
// dlb (hidden-wide), db2, dlts, dltb (C-wide), padded to 64.
__host__ __device__ inline size_t partial_floats(int C, int hid) {
  return ((size_t)2 * hid * C + 13 * (size_t)hid + 3 * (size_t)C + 63) &
         ~(size_t)63;
}

// A[M x K] · B[K x N] on the tensor cores, 16x16 output tiles spread over
// the warps; each tile goes through the warp's staging buffer and
// epi(row, col, value).
template <typename LA, typename LB, typename Epi>
__device__ void gemm_epi(const bf16* A, int lda, const bf16* B, int ldb,
                         int M, int N, int K, float* stage, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sw = stage + warp * 256;
  const int mt = M >> 4, nt = N >> 4;
  for (int t = warp; t < mt * nt; t += NW) {
    const int i = (t % mt) << 4, j = (t / mt) << 4;
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
      wmma::load_matrix_sync(a, frag_ptr<LA>(A, lda, i, k), lda);
      wmma::load_matrix_sync(b, frag_ptr<LB>(B, ldb, k, j), ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(sw, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) epi(i + (e >> 4), j + (e & 15), sw[e]);
    __syncwarp();
  }
}

// out (M x N fp32, ldo, shared or device memory) = [out +] A · B. With
// first, out's old contents are ignored.
template <typename LA, typename LB>
__device__ void gemm_acc_tile(const bf16* A, int lda, const bf16* B, int ldb,
                              int i, int j, int K, float* out, int ldo,
                              bool first) {
  Acc acc;
  if (first)
    wmma::fill_fragment(acc, 0.0f);
  else
    wmma::load_matrix_sync(acc, out + (size_t)i * ldo + j, ldo,
                           wmma::mem_row_major);
  for (int k = 0; k < K; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
    wmma::load_matrix_sync(a, frag_ptr<LA>(A, lda, i, k), lda);
    wmma::load_matrix_sync(b, frag_ptr<LB>(B, ldb, k, j), ldb);
    wmma::mma_sync(acc, a, b, acc);
  }
  wmma::store_matrix_sync(out + (size_t)i * ldo + j, acc, ldo,
                          wmma::mem_row_major);
}

__device__ __forceinline__ void accum(float* p, float v, bool first) {
  *p = first ? v : *p + v;
}

__global__ void __launch_bounds__(THREADS)
mixffn_bwd_kernel(const bf16* x, const bf16* g, const float* lts,
                  const float* ltb, const bf16* w1, const float* b1,
                  const bf16* dw, const float* dwb, const float* ls,
                  const float* lb, const bf16* w2, bf16* dx, float* part,
                  int B, int bpb, int s, int C, int hid, int groups,
                  float eps_ln, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geo G = make_geo(s, C);
  bf16* xn = reinterpret_cast<bf16*>(smem + G.o_xn);      // Thp x C
  bf16* gb = reinterpret_cast<bf16*>(smem + G.o_g);       // Typ x C
  bf16* hb = reinterpret_cast<bf16*>(smem + G.o_h);       // Thp x HC
  float* dab = reinterpret_cast<float*>(smem + G.o_da);   // Typ x HC
  float* dxn = reinterpret_cast<float*>(smem + G.o_dxn);  // Tcp x C
  bf16* dhb = reinterpret_cast<bf16*>(smem + G.o_dh);     // Tcp x HC
  bf16* ab = reinterpret_cast<bf16*>(smem + G.o_a);       // Tcp x HC
  float* st = reinterpret_cast<float*>(smem + G.o_st);    // Typ x 4
  float* stage = reinterpret_cast<float*>(smem + G.o_stage);
  float* red = reinterpret_cast<float*>(smem + G.o_red);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * R, N = s * s, gsz = C / groups;
  const int b_begin = blockIdx.y * bpb, b_end = min(B, b_begin + bpb);
  float* p_dw1 = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                            partial_floats(C, hid);
  float* p_dw2 = p_dw1 + (size_t)hid * C;
  float* p_db1 = p_dw2 + (size_t)C * hid;
  float* p_ddw = p_db1 + hid;
  float* p_ddwb = p_ddw + 9 * hid;
  float* p_dls = p_ddwb + hid;
  float* p_dlb = p_dls + hid;
  float* p_db2 = p_dlb + hid;
  float* p_dlts = p_db2 + C;
  float* p_dltb = p_dlts + C;

  // Token t of the h window is map row r0-2 + t/s; of the y window (and
  // g) map row r0-1 + t/s; centre token tc is map row r0 + tc/s.
  auto h_ok = [&](int t) {
    const int rr = r0 - 2 + t / s;
    return t < G.Th && rr >= 0 && rr < s;
  };
  auto y_ok = [&](int t) {
    const int rr = r0 - 1 + t / s;
    return t < G.Ty && rr >= 0 && rr < s;
  };
  auto c_ok = [&](int tc) { return tc < G.Tc && r0 + tc / s < s; };

  for (size_t i = threadIdx.x; i < G.bytes / 4; i += THREADS)
    reinterpret_cast<float*>(smem)[i] = 0.0f;
  __syncthreads();

  for (int b = b_begin; b < b_end; ++b) {
    const bool first = b == b_begin;
    const bf16* xb = x + (size_t)b * N * C;
    const bf16* gg = g + (size_t)b * N * C;

    // x's group LN on the h window (zero off the map).
    for (int t = warp; t < G.Thp; t += NW) {
      bf16* dst = xn + (size_t)t * C;
      if (!h_ok(t)) {
        for (int c = lane; c < C; c += 32) dst[c] = __float2bfloat16(0.0f);
        continue;
      }
      const bf16* src = xb + ((size_t)(r0 - 2 + t / s) * s + t % s) * C;
      for (int c0 = 0; c0 < C; c0 += gsz)
        mixffn::ln_range(src, dst, lts, ltb, c0, gsz, eps_ln, lane);
    }
    // g on the y window (zero off the map).
    for (int t = warp; t < G.Typ; t += NW) {
      bf16* dst = gb + (size_t)t * C;
      const bool ok = y_ok(t);
      const bf16* src = gg + ((size_t)(r0 - 1 + t / s) * s + t % s) * C;
      for (int c = lane; c < C; c += 32)
        dst[c] = ok ? src[c] : __float2bfloat16(0.0f);
    }
    for (int i = threadIdx.x; i < G.Typ * 4; i += THREADS) st[i] = 0.0f;
    for (int i = threadIdx.x; i < G.Tcp * C; i += THREADS) dxn[i] = 0.0f;
    __syncthreads();

    for (int pass = 0; pass < 3; ++pass) {
      for (int k0 = 0; k0 < hid; k0 += HC) {
        const int ch = k0 + lane;
        float wk[9];
#pragma unroll
        for (int q = 0; q < 9; ++q)
          wk[q] = __bfloat162float(dw[(size_t)ch * 9 + q]);
        const float bd = dwb[ch], lsc = ls[ch], lbc = lb[ch];

        // h = bf16(xn · w1ᵀ + b1) on the window, zero off the map.
        gemm_epi<wmma::row_major, wmma::col_major>(
            xn, C, w1 + (size_t)k0 * C, C, G.Thp, HC, C, stage,
            [&](int t, int kk, float v) {
              hb[t * HC + kk] = __float2bfloat16(h_ok(t) ? v + b1[k0 + kk]
                                                         : 0.0f);
            });
        if (pass > 0)  // da = g · w2[:, chunk]
          gemm_tiles<wmma::row_major, wmma::row_major>(
              gb, C, w2 + k0, hid, G.Typ, HC, C, dab, HC);
        __syncthreads();

        // y = bf16(conv3x3(h) + dwb) + h at y-window token t, channel ch
        // (the forward's tap order).
        auto yval = [&](int t) {
          const int wy = t / s, j = t % s;
          float acc = 0.0f;
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            const int col = j + dj - 1;
            if (col < 0 || col >= s) continue;
#pragma unroll
            for (int di = 0; di < 3; ++di)
              acc += __bfloat162float(hb[((wy + di) * s + col) * HC + lane]) *
                     wk[di * 3 + dj];
          }
          return rbf(acc + bd) +
                 __bfloat162float(hb[((wy + 1) * s + j) * HC + lane]);
        };

        if (pass == 0) {
          for (int t = warp; t < G.Ty; t += NW) {
            if (!y_ok(t)) continue;
            const float y = yval(t);
            const float s1 = warp_sum(y), s2 = warp_sum(y * y);
            if (lane == 0) {
              st[t * 4] += s1;
              st[t * 4 + 1] += s2;
            }
          }
        } else if (pass == 1) {
          for (int t = warp; t < G.Ty; t += NW) {
            if (!y_ok(t)) continue;
            const float yh = (yval(t) - st[t * 4]) * st[t * 4 + 1];
            const float z = rbf(yh * lsc + lbc);
            const float gp = 0.5f * (1.0f + erff(z * RSQRT2)) +
                             z * expf(-0.5f * z * z) * INV_SQRT_2PI;
            const float dyh = dab[t * HC + lane] * gp * lsc;
            const float s1 = warp_sum(dyh), s2 = warp_sum(dyh * yh);
            if (lane == 0) {
              st[t * 4 + 2] += s1;
              st[t * 4 + 3] += s2;
            }
          }
        } else {
          float a_dls = 0.0f, a_dlb = 0.0f, a_ddwb = 0.0f, a_db1 = 0.0f;
          float a_ddw[9];
#pragma unroll
          for (int q = 0; q < 9; ++q) a_ddw[q] = 0.0f;
          // dy (= dd) on the y window; a = GELU(z) on the centre rows.
          for (int t = warp; t < G.Typ; t += NW) {
            const int tc = t - s;
            const bool centre = tc >= 0 && tc < G.Tc;
            float dy = 0.0f, a = 0.0f;
            if (y_ok(t)) {
              const float yh = (yval(t) - st[t * 4]) * st[t * 4 + 1];
              const float z = rbf(yh * lsc + lbc);
              const float gp = 0.5f * (1.0f + erff(z * RSQRT2)) +
                               z * expf(-0.5f * z * z) * INV_SQRT_2PI;
              const float dz = dab[t * HC + lane] * gp;
              dy = st[t * 4 + 1] *
                   (dz * lsc - st[t * 4 + 2] - yh * st[t * 4 + 3]);
              if (centre) {
                a_dls += dz * yh;
                a_dlb += dz;
                a_ddwb += dy;
                a = 0.5f * z * erfcf(-z * RSQRT2);
              }
            }
            dab[t * HC + lane] = dy;
            if (centre) ab[tc * HC + lane] = __float2bfloat16(a);
          }
          __syncthreads();
          // dh = dy + correlation of dd with the taps; the tap gradients.
          for (int tc = warp; tc < G.Tc; tc += NW) {
            if (!c_ok(tc)) {
              dhb[tc * HC + lane] = __float2bfloat16(0.0f);
              continue;
            }
            const int wy = tc / s + 1, j = tc % s;
            const float dyc = dab[(wy * s + j) * HC + lane];
            float dh = dyc;
#pragma unroll
            for (int di = 0; di < 3; ++di) {
#pragma unroll
              for (int dj = 0; dj < 3; ++dj) {
                const int cb = j - dj + 1, ch2 = j + dj - 1;
                if (cb >= 0 && cb < s)
                  dh += dab[((wy - di + 1) * s + cb) * HC + lane] *
                        wk[di * 3 + dj];
                if (ch2 >= 0 && ch2 < s)
                  a_ddw[di * 3 + dj] +=
                      dyc * __bfloat162float(
                                hb[((wy + di) * s + ch2) * HC + lane]);
              }
            }
            dhb[tc * HC + lane] = __float2bfloat16(dh);
            a_db1 += dh;
          }
          red[(0 * NW + warp) * 32 + lane] = a_dls;
          red[(1 * NW + warp) * 32 + lane] = a_dlb;
          red[(2 * NW + warp) * 32 + lane] = a_ddwb;
          red[(3 * NW + warp) * 32 + lane] = a_db1;
#pragma unroll
          for (int q = 0; q < 9; ++q)
            red[((4 + q) * NW + warp) * 32 + lane] = a_ddw[q];
          __syncthreads();
          for (int i = threadIdx.x; i < 13 * 32; i += THREADS) {
            const int q = i / 32, c = k0 + i % 32;
            float v = 0.0f;
            for (int w = 0; w < NW; ++w) v += red[(q * NW + w) * 32 + i % 32];
            float* dst = q == 0 ? p_dls + c
                       : q == 1 ? p_dlb + c
                       : q == 2 ? p_ddwb + c
                       : q == 3 ? p_db1 + c
                                : p_ddw + (size_t)c * 9 + (q - 4);
            accum(dst, v, first);
          }
          // dxn += dh·w1[chunk]; dw1[chunk] += dhᵀ·xn; dw2[:, chunk] += gᵀ·a
          // (centre rows).
          const int t1 = (G.Tcp / 16) * (C / 16), t2 = (HC / 16) * (C / 16);
          for (int t = warp; t < t1 + 2 * t2; t += NW) {
            if (t < t1) {
              gemm_acc_tile<wmma::row_major, wmma::row_major>(
                  dhb, HC, w1 + (size_t)k0 * C, C, (t % (G.Tcp / 16)) * 16,
                  (t / (G.Tcp / 16)) * 16, HC, dxn, C, false);
            } else if (t < t1 + t2) {
              const int u = t - t1;
              gemm_acc_tile<wmma::col_major, wmma::row_major>(
                  dhb, HC, xn + (size_t)2 * s * C, C, (u % 2) * 16,
                  (u / 2) * 16, G.Tcp, p_dw1 + (size_t)k0 * C, C, first);
            } else {
              const int u = t - t1 - t2;
              gemm_acc_tile<wmma::col_major, wmma::row_major>(
                  gb + (size_t)s * C, C, ab, HC, (u % (C / 16)) * 16,
                  (u / (C / 16)) * 16, G.Tcp, p_dw2 + k0, hid, first);
            }
          }
        }
        __syncthreads();
      }
      // Per-token statistics after the whole hidden width.
      if (pass < 2) {
        for (int t = threadIdx.x; t < G.Ty; t += THREADS) {
          float* p = st + t * 4 + 2 * pass;
          if (pass == 0) {
            const float mean = p[0] / hid;
            p[1] = rsqrtf(p[1] / hid - mean * mean + eps);
            p[0] = mean;
          } else {
            p[0] /= hid;
            p[1] /= hid;
          }
        }
        __syncthreads();
      }
    }

    // Group-LN backward of the centre rows, plus the residual's g.
    for (int q = 0; q < 3; ++q)
      for (int c = lane; c < C; c += 32) red[(q * NW + warp) * C + c] = 0.0f;
    for (int tc = warp; tc < G.Tc; tc += NW) {
      if (!c_ok(tc)) continue;
      const size_t n = (size_t)(r0 + tc / s) * s + tc % s;
      const bf16* src = xb + n * C;
      const bf16* gc = gb + (size_t)(s + tc) * C;
      const float* dxr = dxn + (size_t)tc * C;
      for (int c0 = 0; c0 < C; c0 += gsz) {
        const float2 ms = mixffn::ln_stats(src, c0, gsz, eps_ln, lane);
        const float mean = ms.x, inv = ms.y;
        float n1 = 0.0f, n2 = 0.0f;
        for (int c = c0 + lane; c < c0 + gsz; c += 32) {
          const float yhx = (__bfloat162float(src[c]) - mean) * inv;
          const float d = dxr[c] * lts[c];
          n1 += d;
          n2 += d * yhx;
        }
        n1 = warp_sum(n1) / gsz;
        n2 = warp_sum(n2) / gsz;
        for (int c = c0 + lane; c < c0 + gsz; c += 32) {
          const float yhx = (__bfloat162float(src[c]) - mean) * inv;
          const float gv = __bfloat162float(gc[c]);
          const float d = dxr[c] * lts[c];
          dx[(size_t)b * N * C + n * C + c] =
              __float2bfloat16(inv * (d - n1 - yhx * n2) + gv);
          red[(0 * NW + warp) * C + c] += dxr[c] * yhx;
          red[(1 * NW + warp) * C + c] += dxr[c];
          red[(2 * NW + warp) * C + c] += gv;
        }
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += THREADS) {
      float v[3] = {0.0f, 0.0f, 0.0f};
      for (int q = 0; q < 3; ++q)
        for (int w = 0; w < NW; ++w) v[q] += red[(q * NW + w) * C + c];
      accum(p_dlts + c, v[0], first);
      accum(p_dltb + c, v[1], first);
      accum(p_db2 + c, v[2], first);
    }
    __syncthreads();
  }
}

}  // namespace

// x, g, dx: (B, s², C) bf16; w1 (hid, C), dw (hid, 9), w2 (C, hid) bf16;
// lts/ltb (C,) the tiled group-LN scale/bias, the rest fp32 vectors.
// part: (blocks, partial_floats) fp32 scratch; grads: (partial_floats,)
// fp32, the sum over blocks in the partial layout.
extern "C" int mixffn_ln_skip_bwd(const bf16* x, const bf16* g,
                                  const float* lts, const float* ltb,
                                  const bf16* w1, const float* b1,
                                  const bf16* dw, const float* dwb,
                                  const float* ls, const float* lb,
                                  const bf16* w2, bf16* dx, float* part,
                                  float* grads, int B, int s, int C, int hid,
                                  int groups, int bpb, float eps_ln,
                                  float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = make_geo(s, C).bytes;
  cudaError_t e = set_smem((const void*)mixffn_bwd_kernel, smem);
  if (e) return e;
  const dim3 grid((s + R - 1) / R, (B + bpb - 1) / bpb);
  mixffn_bwd_kernel<<<grid, THREADS, smem, st>>>(
      x, g, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, dx, part, B, bpb, s, C,
      hid, groups, eps_ln, eps);
  if ((e = cudaGetLastError())) return e;
  const size_t n = partial_floats(C, hid);
  sum_partials<float><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      part, grid.x * grid.y, n, grads);
  return cudaGetLastError();
}
