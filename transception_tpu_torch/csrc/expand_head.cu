// Fused x4 patch expand + per-group LayerNorm + 1x1 head + argmax:
//   y = bf16(x · W) (C -> p²·c), yn_g = bf16(LN(y_g)) for each of the p²
//   c-wide groups, logits_g = bf16(yn_g · Wh + bh), ids = argmax (first max).
// Replaces transception_tpu/ops/pallas/expand_kernel.py:159
// fused_patch_expand_argmax (the argmax that JAX runs after the kernel is
// fused here). Design notes: ops/kernels/expand_head.py.
//
// One block per 64 tokens. Per group: the (64, c) expansion on the tensor
// cores, LN per token (one warp per token), the head as a (64, c) x (c, 16)
// tensor-core product against the bf16 head weight zero-padded to 16
// classes, then the per-token argmax. Ids stay in shared memory and leave
// as one (64, p²) uint8 tile in pre-shuffle order.
#include "common.cuh"

namespace {

constexpr int T = 64;
constexpr int THREADS = 256;
constexpr int NPAD = 16;  // head classes padded to one WMMA tile

__global__ void __launch_bounds__(THREADS)
expand_head_kernel(const bf16* x, const bf16* w, const float* ls,
                   const float* lb, const bf16* hw, const float* hb,
                   uint8_t* ids, int rows, int Cin, int c, int groups,
                   int ncls, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);                    // T x Cin
  size_t off = (size_t)T * Cin * 2;
  float* ys = reinterpret_cast<float*>(smem + off);            // T x c
  off += (size_t)T * c * 4;
  bf16* yn = reinterpret_cast<bf16*>(smem + off);              // T x c
  off += (size_t)T * c * 2;
  bf16* hws = reinterpret_cast<bf16*>(smem + off);             // NPAD x c
  off += (size_t)NPAD * c * 2;
  float* lg = reinterpret_cast<float*>(smem + off);            // T x NPAD
  off += (size_t)T * NPAD * 4;
  uint8_t* idt = smem + off;                                   // T x groups
  const int t0 = blockIdx.x * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;

  for (int i = threadIdx.x; i < T * Cin; i += blockDim.x) {
    const int r = i / Cin;
    xs[i] = t0 + r < rows ? x[(size_t)t0 * Cin + i] : __float2bfloat16(0.0f);
  }
  for (int i = threadIdx.x; i < NPAD * c; i += blockDim.x)
    hws[i] = i / c < ncls ? hw[i] : __float2bfloat16(0.0f);
  __syncthreads();

  for (int g = 0; g < groups; ++g) {
    dense_tile(xs, Cin, w + (size_t)g * c * Cin, Cin, T, c, ys, c);
    __syncthreads();
    for (int r = warp; r < T; r += nw) {
      const float* y = ys + (size_t)r * c;
      float s = 0.0f, sq = 0.0f;
      for (int k = lane; k < c; k += 32) {
        const float v = rbf(y[k]);
        s += v;
        sq += v * v;
      }
      s = warp_sum(s);
      sq = warp_sum(sq);
      const float mean = s / c;
      const float inv = rsqrtf(sq / c - mean * mean + eps);
      for (int k = lane; k < c; k += 32)
        yn[(size_t)r * c + k] =
            __float2bfloat16((rbf(y[k]) - mean) * inv * ls[k] + lb[k]);
    }
    __syncthreads();
    dense_tile(yn, c, hws, c, T, NPAD, lg, NPAD);
    __syncthreads();
    if (threadIdx.x < T) {
      const int r = threadIdx.x;
      float best = -INFINITY;
      int arg = 0;
      for (int n = 0; n < ncls; ++n) {
        const float l = rbf(lg[r * NPAD + n] + hb[n]);
        if (l > best) {
          best = l;
          arg = n;
        }
      }
      idt[r * groups + g] = (uint8_t)arg;
    }
    __syncthreads();
  }
  const int nvalid = min(T, rows - t0);
  for (int i = threadIdx.x; i < nvalid * groups; i += blockDim.x)
    ids[(size_t)t0 * groups + i] = idt[i];
}

}  // namespace

static size_t expand_head_smem_bytes(int Cin, int c, int groups) {
  return (size_t)T * Cin * 2 + (size_t)T * c * 6 + (size_t)NPAD * c * 2 +
         (size_t)T * NPAD * 4 + (size_t)T * groups;
}

extern "C" int expand_head(const bf16* x, const bf16* w, const float* ls,
                           const float* lb, const bf16* hw, const float* hb,
                           uint8_t* ids, int rows, int Cin, int c, int groups,
                           int ncls, float eps, void* stream) {
  const size_t smem = expand_head_smem_bytes(Cin, c, groups);
  cudaError_t e = set_smem((const void*)expand_head_kernel, smem);
  if (e) return e;
  expand_head_kernel<<<(rows + T - 1) / T, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, w, ls, lb, hw, hb, ids, rows, Cin, c, groups, ncls, eps);
  return cudaGetLastError();
}
