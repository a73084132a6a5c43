// Linear attention per (batch, head):
//   out = Q' · bf16(bf16(softmax_N(K))ᵀ · V),  Q' = bf16(softmax_d(Q)) or Q.
// Replaces transception_tpu/ops/pallas/linear_attention_kernel.py:235
// linear_attention. Design notes: ops/kernels/linear_attention.py.
//
// One block per (batch, head) holds the head's (N, dk) keys, (N, dv)
// values and (dk, dv) context in fp32 shared memory: the column softmax of
// K, the context and the output product are plain fp32 loops over it.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
linear_attention_kernel(const bf16* q, const bf16* k, const bf16* v,
                        bf16* out, int N, int dk, int dv, int q_softmax) {
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                      // N x dk: K, then softmax_N(K), then Q'
  float* vs = ks + (size_t)N * dk;     // N x dv
  float* ctx = vs + (size_t)N * dv;    // dk x dv
  const size_t bh = blockIdx.x;
  const bf16* qb = q + bh * N * dk;
  const bf16* kb = k + bh * N * dk;
  const bf16* vb = v + bh * N * dv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;

  for (int i = threadIdx.x; i < N * dk; i += blockDim.x)
    ks[i] = __bfloat162float(kb[i]);
  for (int i = threadIdx.x; i < N * dv; i += blockDim.x)
    vs[i] = __bfloat162float(vb[i]);
  __syncthreads();

  // Column softmax of K over the N tokens, rounded to bf16.
  for (int j = threadIdx.x; j < dk; j += blockDim.x) {
    float m = -INFINITY;
    for (int n = 0; n < N; ++n) m = fmaxf(m, ks[(size_t)n * dk + j]);
    float l = 0.0f;
    for (int n = 0; n < N; ++n) l += expf(ks[(size_t)n * dk + j] - m);
    for (int n = 0; n < N; ++n) {
      float* e = ks + (size_t)n * dk + j;
      *e = rbf(expf(*e - m) / l);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < dk * dv; i += blockDim.x) {
    const int a = i / dv, c = i % dv;
    float acc = 0.0f;
    for (int n = 0; n < N; ++n)
      acc += ks[(size_t)n * dk + a] * vs[(size_t)n * dv + c];
    ctx[i] = rbf(acc);
  }
  __syncthreads();

  // Q' into the K buffer: one warp per token row.
  for (int n = warp; n < N; n += nw) {
    const bf16* qr = qb + (size_t)n * dk;
    float* dst = ks + (size_t)n * dk;
    if (!q_softmax) {
      for (int j = lane; j < dk; j += 32) dst[j] = __bfloat162float(qr[j]);
      continue;
    }
    float m = -INFINITY;
    for (int j = lane; j < dk; j += 32) m = fmaxf(m, __bfloat162float(qr[j]));
    m = warp_max(m);
    float l = 0.0f;
    for (int j = lane; j < dk; j += 32) l += expf(__bfloat162float(qr[j]) - m);
    l = warp_sum(l);
    for (int j = lane; j < dk; j += 32)
      dst[j] = rbf(expf(__bfloat162float(qr[j]) - m) / l);
  }
  __syncthreads();

  bf16* ob = out + bh * N * dv;
  for (int i = threadIdx.x; i < N * dv; i += blockDim.x) {
    const int n = i / dv, c = i % dv;
    float acc = 0.0f;
    for (int a = 0; a < dk; ++a)
      acc += ks[(size_t)n * dk + a] * ctx[a * dv + c];
    ob[i] = __float2bfloat16(acc);
  }
}

}  // namespace

extern "C" int linear_attention(const bf16* q, const bf16* k, const bf16* v,
                                bf16* out, int BH, int N, int dk, int dv,
                                int q_softmax, void* stream) {
  const size_t smem = ((size_t)N * dk + (size_t)N * dv + (size_t)dk * dv) * 4;
  cudaError_t e = set_smem((const void*)linear_attention_kernel, smem);
  if (e) return e;
  linear_attention_kernel<<<BH, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, N, dk, dv, q_softmax);
  return cudaGetLastError();
}
