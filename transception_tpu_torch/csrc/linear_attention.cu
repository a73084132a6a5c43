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
#include "linear_attention.cuh"

namespace {

using ffn::THREADS;
constexpr int KID = 6;
constexpr int HEAD_MAX = 64;  // the widest head of the head body

// Bytes of shared memory of one head-body block (mirrored by head_smem in
// ops/kernels/linear_attention.py): q, k and v of the head, the column
// statistics, a reduction row, the context strips' partials, the bf16
// context.
__host__ __device__ inline size_t head_smem(int N, int dk, int dv) {
  const int strips = dk * (dv / 8);
  return ((size_t)2 * N * dk + (size_t)N * dv) * 2 +
         (2 * HEAD_MAX + THREADS) * 4 +
         (size_t)8 * (strips > THREADS ? strips : THREADS) * 4 +
         (size_t)dk * dv * 2;
}

__device__ __forceinline__ void copy_rows(uint32_t s, const bf16* g, int n) {
  for (int i = threadIdx.x; i < n / 8; i += THREADS)
    bsa::cp_async16(s + i * 16, g + (size_t)i * 8, true);
}

__device__ __forceinline__ void fma8(float (&acc)[8], float a, uint4 u) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 b = __bfloat1622float2(p2[e]);
    acc[2 * e] = fmaf(a, b.x, acc[2 * e]);
    acc[2 * e + 1] = fmaf(a, b.y, acc[2 * e + 1]);
  }
}

__global__ void __launch_bounds__(THREADS)
lin_head_kernel(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                int N, int dk, int dv, int q_softmax, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + (size_t)N * dk;
  bf16* vs = ks + (size_t)N * dk;
  float* colm = reinterpret_cast<float*>(vs + (size_t)N * dv);
  float* cols = colm + HEAD_MAX;
  float* red = cols + HEAD_MAX;
  float* part = red + THREADS;
  const int nv = dv / 8, strips = dk * nv;
  const int P = max(1, THREADS / strips);  // row parts of a context strip
  bf16* cb = reinterpret_cast<bf16*>(part + 8 * max(THREADS, strips));
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
      m = fmaxf(m, __bfloat162float(ks[(size_t)n * dk + c]));
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
      s += expf(__bfloat162float(ks[(size_t)n * dk + c]) - colm[c]);
  red[tid] = s;
  __syncthreads();
  if (tid < dk) {
    float ss = 0.0f;
    for (int i = 0; i < G; ++i) ss += red[i * dk + tid];
    cols[tid] = ss;
  }
  __syncthreads();
  // Ks = bf16(exp(K − m) / S) in place, 8 values (one row's) a step.
  for (int i = tid * 8; i < N * dk; i += THREADS * 8) {
    uint4* pu = reinterpret_cast<uint4*>(ks + i);
    uint4 u = *pu;
    uint32_t* pw = reinterpret_cast<uint32_t*>(&u);
    const int a = i % dk;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(pw + e));
      const int j = a + 2 * e;
      pw[e] = bsa::pack(expf(x.x - colm[j]) / cols[j],
                        expf(x.y - colm[j + 1]) / cols[j + 1]);
    }
    *pu = u;
  }
  // Q' = bf16(softmax of each row over its dk channels) in place.
  if (q_softmax)
    for (int n = tid; n < N; n += THREADS) {
      bf16* row = qs + (size_t)n * dk;
      float mq = -INFINITY, sq = 0.0f;
      for (int j = 0; j < dk; ++j) mq = fmaxf(mq, __bfloat162float(row[j]));
      for (int j = 0; j < dk; ++j) sq += expf(__bfloat162float(row[j]) - mq);
      for (int j = 0; j < dk; ++j)
        row[j] = __float2bfloat16(expf(__bfloat162float(row[j]) - mq) / sq);
    }
  __syncthreads();
  // The context Ksᵀ·V in strips of 8 values (key channel a, value
  // channels 8·c8..), each over P interleaved parts of the rows.
  for (int t = tid; t < strips * P; t += THREADS) {
    const int sidx = t % strips, p = t / strips;
    const int a = sidx / nv, c8 = sidx % nv;
    float acc[8] = {};
    for (int n = p; n < N; n += P)
      fma8(acc, __bfloat162float(ks[(size_t)n * dk + a]),
           *reinterpret_cast<const uint4*>(vs + (size_t)n * dv + c8 * 8));
#pragma unroll
    for (int e = 0; e < 8; ++e) part[(size_t)t * 8 + e] = acc[e];
  }
  __syncthreads();
  for (int o = tid; o < dk * dv; o += THREADS) {
    const int sidx = o / dv * nv + o % dv / 8, e = o % 8;
    float sum = 0.0f;
    for (int p = 0; p < P; ++p)
      sum += part[((size_t)p * strips + sidx) * 8 + e];
    cb[o] = __float2bfloat16(sum);
  }
  __syncthreads();
  // out = bf16(scale · Q'·ctx) in strips of 8 output columns, Q' read 8
  // channels at a time.
  bf16* ob = out + (size_t)bh * N * dv;
  for (int t = tid; t < N * nv; t += THREADS) {
    const int n = t / nv, c8 = t % nv;
    float acc[8] = {};
    for (int a0 = 0; a0 < dk; a0 += 8) {
      const uint4 qu =
          *reinterpret_cast<const uint4*>(qs + (size_t)n * dk + a0);
      const bf16* qq = reinterpret_cast<const bf16*>(&qu);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        fma8(acc, __bfloat162float(qq[j]),
             *reinterpret_cast<const uint4*>(cb + (size_t)(a0 + j) * dv +
                                             c8 * 8));
    }
    uint4 r;
    uint32_t* pr = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pr[e] = bsa::pack(acc[2 * e] * scale, acc[2 * e + 1] * scale);
    *reinterpret_cast<uint4*>(ob + (size_t)n * dv + c8 * 8) = r;
  }
}

}  // namespace

// Indices into the wrapper's plan (ops/kernels/linear_attention.py plan).
enum Plan { BODY, SEGMENTS, SEGMENT_ROWS, PLAN_LEN };
enum Body { BODY_HEAD, BODY_SEGMENTED };

extern "C" int linear_attention(const bf16* q, const bf16* k, const bf16* v,
                                bf16* out, float2* part, float* pctx,
                                bf16* ctx, const int* plan, int BH, int N,
                                int dk, int dv, int q_softmax, float scale,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dk % 8 || dv % 8) return cudaErrorInvalidValue;  // 16-byte rows
  if (plan[BODY] == BODY_HEAD) {
    if (dk > HEAD_MAX || dv > HEAD_MAX) return cudaErrorInvalidValue;
    const size_t smem = head_smem(N, dk, dv);
    cudaError_t e = set_smem((const void*)lin_head_kernel, smem);
    if (e) return e;
    lin_head_kernel<<<BH, THREADS, smem, st>>>(q, k, v, out, N, dk, dv,
                                               q_softmax, scale);
    return cudaGetLastError();
  }
  auto view = [&](const bf16* p, int d) {
    return lin::View{const_cast<bf16*>(p), d, (size_t)N * d};
  };
  return lin::attention<KID>(view(q, dk), view(k, dk), view(v, dv),
                             view(out, dv), part, pctx, ctx, BH, N, dk, dv,
                             plan[SEGMENTS], plan[SEGMENT_ROWS], q_softmax,
                             scale, st);
}
