// The fused MixFFN_skip kernel body, shared by the MixFFN kernel
// (mixffn.cu) and the MHCA block kernel (mhca_block.cu), which runs it as
// its last stage. Replaces the body of
// transception_tpu/ops/pallas/mixffn_kernel.py:342 fused_mixffn_ln_skip.
//   out = x + fc2(GELU(LN_h(dwconv3x3(h) + h))),  h = fc1(LN(x)).
//
// One block per (map row r, batch b). The block normalises the three map
// rows r-1, r, r+1 once, then walks the hidden width in 64-channel chunks:
// fc1 of the three-row window on the tensor cores, the 3x3 depthwise taps
// on the rounded h (zero outside the map), y = d + h kept in fp32 shared
// memory for the row. Then LN over hidden + GELU per token, fc2 on the
// tensor cores, bias, rounding and the residual. Only x is read from and
// out written to device memory.
#pragma once

#include "common.cuh"

namespace mixffn {

constexpr int THREADS = 256;  // 8 warps
constexpr int HC = 64;        // hidden channels per chunk

// Mean and rsqrt(E[x²] - mean² + eps) of one token over channels
// [c0, c0 + n), reduced over the warp.
__device__ __forceinline__ float2 ln_stats(const bf16* src, int c0, int n,
                                           float eps_ln, int lane) {
  float sm = 0.0f, sq = 0.0f;
  for (int c = c0 + lane; c < c0 + n; c += 32) {
    const float v = __bfloat162float(src[c]);
    sm += v;
    sq += v * v;
  }
  sm = warp_sum(sm);
  sq = warp_sum(sq);
  const float mean = sm / n;
  return make_float2(mean, rsqrtf(sq / n - mean * mean + eps_ln));
}

// The caller's LayerNorm of one token over channels [c0, c0 + n).
__device__ __forceinline__ void ln_range(const bf16* src, bf16* dst,
                                         const float* lts, const float* ltb,
                                         int c0, int n, float eps_ln,
                                         int lane) {
  const float2 st = ln_stats(src, c0, n, eps_ln, lane);
  for (int c = c0 + lane; c < c0 + n; c += 32) {
    const float v = __bfloat162float(src[c]);
    dst[c] = __float2bfloat16((v - st.x) * st.y * lts[c] + ltb[c]);
  }
}

// GROUPED: the caller's LN per group of C/groups channels (the bridge's
// norm2 on its wide layout, lts/ltb tiled to C). A compile-time switch:
// a runtime branch alone slowed the groups = 1 kernel by 11% at 14² x 320,
// so that instantiation keeps the plain loop.
template <bool GROUPED>
__global__ void __launch_bounds__(THREADS)
mixffn_ln_skip_kernel(const bf16* x, const float* lts, const float* ltb,
                      const bf16* w1, const float* b1, const bf16* dw,
                      const float* dwb, const float* ls, const float* lb,
                      const bf16* w2, const float* b2, bf16* out, int s,
                      int C, int hid, int groups, float eps_ln, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int SP = (s + 15) & ~15;  // map row padded to whole 16-row tiles
  const int r = blockIdx.x, b = blockIdx.y;
  bf16* xn = reinterpret_cast<bf16*>(smem);  // 3*SP x C
  size_t off = (size_t)3 * SP * C * 2;
  float* hst = reinterpret_cast<float*>(smem + off);  // 3*SP x HC | SP x C
  off += (size_t)max(3 * SP * HC, SP * C) * 4;
  float* Y = reinterpret_cast<float*>(smem + off);  // SP x hid
  off += (size_t)SP * hid * 4;
  bf16* A = reinterpret_cast<bf16*>(smem + off);  // SP x hid
  const bf16* xb = x + (size_t)b * s * s * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;

  // Caller's LayerNorm of the window rows r-1, r, r+1 (zero off the map).
  for (int idx = warp; idx < 3 * SP; idx += nw) {
    const int wr = idx / SP, j = idx % SP, rr = r - 1 + wr;
    bf16* dst = xn + (size_t)idx * C;
    if (rr < 0 || rr >= s || j >= s) {
      for (int c = lane; c < C; c += 32) dst[c] = __float2bfloat16(0.0f);
      continue;
    }
    const bf16* src = xb + ((size_t)rr * s + j) * C;
    if constexpr (GROUPED) {
      const int gsz = C / groups;
      for (int c0 = 0; c0 < C; c0 += gsz)
        ln_range(src, dst, lts, ltb, c0, gsz, eps_ln, lane);
    } else {
      ln_range(src, dst, lts, ltb, 0, C, eps_ln, lane);
    }
  }
  __syncthreads();

  for (int h0 = 0; h0 < hid; h0 += HC) {
    dense_tile(xn, C, w1 + (size_t)h0 * C, C, 3 * SP, HC, hst, HC);
    __syncthreads();
    for (int i = threadIdx.x; i < s * HC; i += blockDim.x) {
      const int j = i / HC, cc = i % HC, ch = h0 + cc;
      const float bias = b1[ch];
      const bf16* k9 = dw + (size_t)ch * 9;
      float acc = 0.0f;
      for (int dj = 0; dj < 3; ++dj) {
        const int col = j + dj - 1;
        if (col < 0 || col >= s) continue;
        for (int di = 0; di < 3; ++di) {
          const int rr = r - 1 + di;
          if (rr < 0 || rr >= s) continue;
          acc += rbf(hst[(size_t)(di * SP + col) * HC + cc] + bias) *
                 __bfloat162float(k9[di * 3 + dj]);
        }
      }
      const float d = rbf(acc + dwb[ch]);
      const float h = rbf(hst[(size_t)(SP + j) * HC + cc] + bias);
      Y[(size_t)j * hid + ch] = d + h;
    }
    __syncthreads();
  }

  // LN over the hidden width, then exact GELU (erfc form, as jax.nn.gelu).
  for (int j = warp; j < SP; j += nw) {
    bf16* arow = A + (size_t)j * hid;
    if (j >= s) {
      for (int c = lane; c < hid; c += 32) arow[c] = __float2bfloat16(0.0f);
      continue;
    }
    const float* yrow = Y + (size_t)j * hid;
    float sm = 0.0f, sq = 0.0f;
    for (int c = lane; c < hid; c += 32) {
      const float v = yrow[c];
      sm += v;
      sq += v * v;
    }
    sm = warp_sum(sm);
    sq = warp_sum(sq);
    const float mean = sm / hid;
    const float inv = rsqrtf(sq / hid - mean * mean + eps);
    for (int c = lane; c < hid; c += 32) {
      const float a = rbf((yrow[c] - mean) * inv * ls[c] + lb[c]);
      arow[c] = __float2bfloat16(0.5f * a * erfcf(-a * 0.70710678118654752f));
    }
  }
  __syncthreads();

  dense_tile(A, hid, w2, hid, SP, C, hst, C);
  __syncthreads();
  bf16* ob = out + (size_t)b * s * s * C;
  for (int i = threadIdx.x; i < s * C; i += blockDim.x) {
    const int j = i / C, c = i % C;
    const size_t n = (size_t)r * s + j;
    const float o = rbf(hst[(size_t)j * C + c] + b2[c]);
    ob[n * C + c] = __float2bfloat16(o + __bfloat162float(xb[n * C + c]));
  }
}

inline size_t smem_bytes(int s, int C, int hid) {
  const int SP = (s + 15) & ~15;
  const int stage = 3 * SP * HC > SP * C ? 3 * SP * HC : SP * C;
  return (size_t)3 * SP * C * 2 + (size_t)stage * 4 + (size_t)SP * hid * 6;
}

}  // namespace mixffn
