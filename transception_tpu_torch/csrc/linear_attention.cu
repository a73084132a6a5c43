// Linear attention per (batch, head):
//   out = bf16(scale · Q' · bf16(bf16(softmax_N(K))ᵀ · V)),
//   Q' = bf16(softmax_d(Q)) or Q.
// Replaces transception_tpu/ops/pallas/linear_attention_kernel.py:235
// linear_attention (rounding of its _kernel, :203-231; the scale of the
// factorized attention applied to the fp32 product before the one rounding,
// as ops/attention.py:68-73 does). Design notes:
// ops/kernels/linear_attention.py.
//
// Two bodies, the wrapper's plan picks one per shape:
//   head       where one head's q, k and v fit a block's shared memory (the
//              MHCA shapes (B, 8, 49, 40), (B, 8, 784, 8), (B, 8, 196, 16)):
//              one launch, a block per head (256 and 192 blocks at b = 32
//              and 24 for 132 SMs), the head's q, k and v staged whole by
//              cp.async as 16-byte rows; the column statistics, Ks in
//              place, the dk x dv context in fp32 then bf16, and the
//              output, all on chip, on the CUDA cores (head dims of 8 to
//              40 would leave the tensor cores' 16-wide operands mostly
//              padding, and the whole head is ~0.2 MFLOP);
//   segmented  anything larger (the ETB shapes (B, 1, N, C), q_softmax on):
//              the linear-attention core of linear_attention.cuh on the
//              (B·h, N, d) tensors, three or four launches.
// Both are templates on the element type: linear_attention_f32 is the fp32
// form (no rounding points; the fp32 eval forward's stage-4 attention).
#include "linear_attention.cuh"

namespace {

using ffn::THREADS;
constexpr int KID = 6;
constexpr int HEAD_MAX = 64;  // the widest head of the head body

// Bytes of shared memory of one head-body block over elements of es bytes
// (mirrored by head_smem in ops/kernels/linear_attention.py): q, k and v of
// the head, the column statistics, a reduction row, the context strips'
// partials, the E context.
__host__ __device__ inline size_t head_smem(int N, int dk, int dv,
                                            int es = 2) {
  const int strips = dk * (dv / 8);
  return ((size_t)2 * N * dk + (size_t)N * dv) * es +
         (2 * HEAD_MAX + THREADS) * 4 +
         (size_t)8 * (strips > THREADS ? strips : THREADS) * 4 +
         (size_t)dk * dv * es;
}

// n elements (a multiple of 8) from g to the shared address s, by cp.async.
template <typename E>
__device__ __forceinline__ void copy_rows(uint32_t s, const E* g, int n) {
  for (int i = threadIdx.x; i < n / EPC<E>; i += THREADS)
    bsa::cp_async16(s + i * 16, g + (size_t)i * EPC<E>, true);
}

template <typename E>
__device__ __forceinline__ void fma8(float (&acc)[8], float a, const E* p) {
  float b[8];
  ld8<E>(p, b);
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = fmaf(a, b[e], acc[e]);
}

template <typename E>
__global__ void __launch_bounds__(THREADS)
lin_head_kernel(const E* q, const E* k, const E* v, E* out, int N, int dk,
                int dv, int q_softmax, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  E* qs = reinterpret_cast<E*>(smem);
  E* ks = qs + (size_t)N * dk;
  E* vs = ks + (size_t)N * dk;
  float* colm = reinterpret_cast<float*>(vs + (size_t)N * dv);
  float* cols = colm + HEAD_MAX;
  float* red = cols + HEAD_MAX;
  float* part = red + THREADS;
  const int nv = dv / 8, strips = dk * nv;
  const int P = max(1, THREADS / strips);  // row parts of a context strip
  E* cb = reinterpret_cast<E*>(part + 8 * max(THREADS, strips));
  const int tid = threadIdx.x;
  const int G = THREADS / dk, c = tid % dk, g = tid / dk;  // stats groups
  const int bh = blockIdx.x;
  copy_rows(bsa::smem_addr(qs), q + (size_t)bh * N * dk, N * dk);
  copy_rows(bsa::smem_addr(ks), k + (size_t)bh * N * dk, N * dk);
  copy_rows(bsa::smem_addr(vs), v + (size_t)bh * N * dv, N * dv);
  bsa::cp_async_commit();
  bsa::cp_async_wait<0>();
  __syncthreads();
  // Column max, then sum of exp(K − max), over G row groups a column,
  // combined in a fixed order.
  float m = -INFINITY;
  if (g < G)
    for (int n = g; n < N; n += G)
      m = fmaxf(m, tof(ks[(size_t)n * dk + c]));
  red[tid] = m;
  __syncthreads();
  if (tid < dk) {
    float mm = -INFINITY;
    for (int i = 0; i < G; ++i) mm = fmaxf(mm, red[i * dk + tid]);
    colm[tid] = mm;
  }
  __syncthreads();
  float s = 0.0f;
  if (g < G)
    for (int n = g; n < N; n += G)
      s += expf(tof(ks[(size_t)n * dk + c]) - colm[c]);
  red[tid] = s;
  __syncthreads();
  if (tid < dk) {
    float ss = 0.0f;
    for (int i = 0; i < G; ++i) ss += red[i * dk + tid];
    cols[tid] = ss;
  }
  __syncthreads();
  // Ks = E(exp(K − m) / S) in place, 8 values (one row's) a step.
  for (int i = tid * 8; i < N * dk; i += THREADS * 8) {
    float x[8];
    ld8<E>(ks + i, x);
    const int a = i % dk;
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = expf(x[e] - colm[a + e]) / cols[a + e];
    st8<E>(ks + i, x);
  }
  // Q' = E(softmax of each row over its dk channels) in place.
  if (q_softmax)
    for (int n = tid; n < N; n += THREADS) {
      E* row = qs + (size_t)n * dk;
      float mq = -INFINITY, sq = 0.0f;
      for (int j = 0; j < dk; ++j) mq = fmaxf(mq, tof(row[j]));
      for (int j = 0; j < dk; ++j) sq += expf(tof(row[j]) - mq);
      for (int j = 0; j < dk; ++j)
        row[j] = fromf<E>(expf(tof(row[j]) - mq) / sq);
    }
  __syncthreads();
  // The context Ksᵀ·V in strips of 8 values (key channel a, value
  // channels 8·c8..), each over P interleaved parts of the rows.
  for (int t = tid; t < strips * P; t += THREADS) {
    const int sidx = t % strips, p = t / strips;
    const int a = sidx / nv, c8 = sidx % nv;
    float acc[8] = {};
    for (int n = p; n < N; n += P)
      fma8<E>(acc, tof(ks[(size_t)n * dk + a]), vs + (size_t)n * dv + c8 * 8);
#pragma unroll
    for (int e = 0; e < 8; ++e) part[(size_t)t * 8 + e] = acc[e];
  }
  __syncthreads();
  for (int o = tid; o < dk * dv; o += THREADS) {
    const int sidx = o / dv * nv + o % dv / 8, e = o % 8;
    float sum = 0.0f;
    for (int p = 0; p < P; ++p)
      sum += part[((size_t)p * strips + sidx) * 8 + e];
    cb[o] = fromf<E>(sum);
  }
  __syncthreads();
  // out = E(scale · Q'·ctx) in strips of 8 output columns, Q' read 8
  // channels at a time.
  E* ob = out + (size_t)bh * N * dv;
  for (int t = tid; t < N * nv; t += THREADS) {
    const int n = t / nv, c8 = t % nv;
    float acc[8] = {};
    for (int a0 = 0; a0 < dk; a0 += 8) {
      float qq[8];
      ld8<E>(qs + (size_t)n * dk + a0, qq);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        fma8<E>(acc, qq[j], cb + (size_t)(a0 + j) * dv + c8 * 8);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] *= scale;
    st8<E>(ob + (size_t)n * dv + c8 * 8, acc);
  }
}

// Indices into the wrapper's plan (ops/kernels/linear_attention.py plan).
enum Plan { BODY, SEGMENTS, SEGMENT_ROWS, PLAN_LEN };
enum Body { BODY_HEAD, BODY_SEGMENTED };

template <typename E>
int attend(const E* q, const E* k, const E* v, E* out, float2* part,
           float* pctx, E* ctx, const int* plan, int BH, int N, int dk,
           int dv, int q_softmax, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dk % 8 || dv % 8) return cudaErrorInvalidValue;  // 16-byte rows
  if (plan[BODY] == BODY_HEAD) {
    if (dk > HEAD_MAX || dv > HEAD_MAX) return cudaErrorInvalidValue;
    const size_t smem = head_smem(N, dk, dv, (int)sizeof(E));
    cudaError_t e = set_smem((const void*)lin_head_kernel<E>, smem);
    if (e) return e;
    lin_head_kernel<E><<<BH, THREADS, smem, st>>>(q, k, v, out, N, dk, dv,
                                                  q_softmax, scale);
    return cudaGetLastError();
  }
  auto view = [&](const E* p, int d) {
    return lin::View<E>{const_cast<E*>(p), d, (size_t)N * d};
  };
  return lin::attention<KID, E>(view(q, dk), view(k, dk), view(v, dv),
                                view(out, dv), part, pctx, ctx, BH, N, dk,
                                dv, plan[SEGMENTS], plan[SEGMENT_ROWS],
                                q_softmax, scale, st);
}

}  // namespace

#define LINEAR_ATTENTION(NAME, E)                                         \
  extern "C" int NAME(const E* q, const E* k, const E* v, E* out,         \
                      float2* part, float* pctx, E* ctx, const int* plan, \
                      int BH, int N, int dk, int dv, int q_softmax,       \
                      float scale, void* stream) {                        \
    return attend<E>(q, k, v, out, part, pctx, ctx, plan, BH, N, dk, dv,  \
                     q_softmax, scale, stream);                           \
  }
LINEAR_ATTENTION(linear_attention, bf16)
LINEAR_ATTENTION(linear_attention_f32, float)
#undef LINEAR_ATTENTION
