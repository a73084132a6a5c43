// Fused patch expand + per-group LayerNorm, in pre-shuffle order:
//   y = bf16(x · W) (C -> p²·c), out_g = bf16(LN(y_g)) for each c-wide group.
// Replaces transception_tpu/ops/pallas/expand_kernel.py:233
// fused_patch_expand. Design notes: ops/kernels/patch_expand.py.
//
// One block per (32 tokens, group). The (32, c) expansion of the group runs
// on the tensor cores into fp32 shared memory; one warp per token then
// rounds it to bf16, normalises it in fp32 and writes the group's c-wide
// slice of the token's output row.
#include "common.cuh"

namespace {

constexpr int T = 32;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
patch_expand_kernel(const bf16* x, const bf16* w, const float* ls,
                    const float* lb, bf16* out, int rows, int Cin, int c,
                    int groups, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);                 // T x Cin
  float* ys = reinterpret_cast<float*>(smem + (size_t)T * Cin * 2);  // T x c
  const int t0 = blockIdx.x * T, g = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;

  for (int i = threadIdx.x; i < T * Cin; i += blockDim.x) {
    const int r = i / Cin;
    xs[i] = t0 + r < rows ? x[(size_t)t0 * Cin + i] : __float2bfloat16(0.0f);
  }
  __syncthreads();
  dense_tile(xs, Cin, w + (size_t)g * c * Cin, Cin, T, c, ys, c);
  __syncthreads();

  const int feats = groups * c;
  for (int r = warp; r < T && t0 + r < rows; r += nw) {
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
    bf16* o = out + (size_t)(t0 + r) * feats + (size_t)g * c;
    for (int k = lane; k < c; k += 32)
      o[k] = __float2bfloat16((rbf(y[k]) - mean) * inv * ls[k] + lb[k]);
  }
}

}  // namespace

extern "C" int patch_expand(const bf16* x, const bf16* w, const float* ls,
                            const float* lb, bf16* out, int rows, int Cin,
                            int c, int groups, float eps, void* stream) {
  const size_t smem = (size_t)T * Cin * 2 + (size_t)T * c * 4;
  cudaError_t e = set_smem((const void*)patch_expand_kernel, smem);
  if (e) return e;
  patch_expand_kernel<<<dim3((rows + T - 1) / T, groups), THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      x, w, ls, lb, out, rows, Cin, c, groups, eps);
  return cudaGetLastError();
}
