// Folded bridge spatial attention, one head of d = 64:
//   out = bf16(res + bf16(proj(bf16(softmax(q·Kᵀ·scale)·V)))),
//   q = bf16(x·Wqᵀ + bq),  proj(a) = a·Wpᵀ + bp.
// Replaces transception_tpu/ops/pallas/bridge_attention_kernel.py:307
// bridge_attention_folded (rounding of its _folded_kernel, :78-133).
// Design notes: ops/kernels/bridge_attention.py.
//
// Bound on the H100: operations. At the published shape (x/res (32, 6076,
// 64) against k/v (32, 1, 784, 64)) the attention's 4·B·N·M·d = 3.9e10 flop
// and the two projections' 4·B·N·d² = 3.2e9 are 0.043 ms at the bf16 peak,
// against 81 MB of traffic (x, res, out, k, v), 0.024 ms. The exact max
// costs a third product (pass 1 recomputes q·Kᵀ), and 152 M exponentials
// run on the MUFU.
//
// K3's block (csrc/bridge_attention.cu) with the projections folded around
// bridge_softmax.cuh's softmax_av, so that q, the logits and the attention
// output never leave the registers. One block of 8 warps per (128 stream
// rows, batch row); each warp owns 16 rows:
//   prologue  Wq and Wp (64 x 64 bf16, 8 KB each) into swizzled shared
//             memory with cp.async, once per block; the warp's x rows as
//             mma A fragments straight from device memory; q = x·Wqᵀ with
//             mma.sync, + bq in fp32, rounded and packed: the fp32
//             accumulators of two 8-column tiles are the A fragment of
//             q·Kᵀ over those 16 columns;
//   attention softmax_av: K/V through the block's 2-deep cp.async ring of
//             112-key chunks, the row max over all M keys on the raw logits
//             (the launcher refuses a scale that is not positive), the
//             unrounded e into the fp32 row sum and bf16(e) into P·V;
//   epilogue  the fp32 output divided by the row sum and rounded is again
//             an A fragment, for attn·Wpᵀ; + bp, rounded; staged through
//             the warp's 2 KB of the (now free) ring; + res in fp32 with
//             16-byte coalesced reads, rounded, stored for rows below N.
// The biases sit in 512 B of shared memory. 57 KB of ring, 16 KB of
// weights and up to 128 registers a thread (102 used) let 2 blocks share
// an SM: held to K3's 80 registers for 3 blocks, the kernel spills. Rows
// past N load as zero and are never stored. No atomics: every run gives
// the same bits.
//
// The fp32 form (bridge_attention_folded_f32, the fp32 models' sp and para
// bridges and any fp32 model with bridge_attn_fold): nothing rounded, every
// product on the CUDA cores (FFMA), on K3's fp32 path. The same block of 8
// warps over 128 rows; each warp keeps its 16 rows in its 4 KB of shared
// memory (bridge_softmax.cuh Q32), which hold in turn x, q, the attention
// output and the projection:
//   prologue  Wq (64 x 64 fp32, 16 KB) into the first tile of the ring and
//             the warp's x rows (zero past N) into its rows, with cp.async;
//             q = x·Wqᵀ + bq by dots16_f32 (lane (g, t): rows g, g + 8,
//             columns 8j + 2t + e, as softmax_av_f32's logits), written
//             back over x;
//   attention softmax_av_f32 on the rows (64-key fp32 chunks of K and V
//             through the 2-deep ring; ex2.approx);
//   epilogue  o / rowsum over q, Wp into the now free ring, proj = ·Wpᵀ +
//             bp the same way, + res in fp32 with 16-byte coalesced reads,
//             stored for the rows below N.
// 64 KB of ring, 32 KB of rows and the biases: 2 blocks an SM where the
// registers allow (at most 128 a thread; the loops stay rolled).
#include "bridge_softmax.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int ROWS = 16 * WARPS;
constexpr int W_BYTES = bsa::D * bsa::ROW_BYTES;  // one 64 x 64 weight
constexpr int SMEM = bsa::RING_BYTES + 2 * W_BYTES + 2 * bsa::D * 4;

// acc (16 x 64 fp32, eight 8-column tiles) = A · Wᵀ for the swizzled
// (64, 64) weight at w.
__device__ __forceinline__ void dense64(const uint32_t (&a)[4][4], uint32_t w,
                                        float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float s[2][4] = {};
    bsa::abt16(a, w, c * 16, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * c][i] = s[0][i];
      acc[2 * c + 1][i] = s[1][i];
    }
  }
}

// The A fragments (16 x 64) of bf16(acc · f[h] + bias) for rows g + 8h,
// or of bf16(acc / f[h]) with DIV (the bias then unread).
template <bool DIV>
__device__ __forceinline__ void to_a(const float (&acc)[8][4],
                                     const float (&f)[2], const float* bias,
                                     uint32_t (&a)[4][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float b0 = 0.0f, b1 = 0.0f;
    if (!DIV) {
      b0 = bias[j * 8 + 2 * t];
      b1 = bias[j * 8 + 2 * t + 1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lo = DIV ? acc[j][2 * h] / f[h] : acc[j][2 * h] + b0;
      const float hi = DIV ? acc[j][2 * h + 1] / f[h] : acc[j][2 * h + 1] + b1;
      a[j >> 1][2 * (j & 1) + h] = bsa::pack(lo, hi);
    }
  }
}

__global__ void __launch_bounds__(32 * WARPS, 2)
bridge_attention_folded_kernel(const bf16* x, const bf16* res, const bf16* wq,
                               const float* bq, const bf16* k, const bf16* v,
                               const bf16* wp, const float* bp, bf16* out,
                               int N, int M, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = bsa::smem_addr(smem);
  const uint32_t wqs = ring + bsa::RING_BYTES, wps = wqs + W_BYTES;
  float* bs = reinterpret_cast<float*>(smem + bsa::RING_BYTES + 2 * W_BYTES);
  const int b = blockIdx.y, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * ROWS + w * 16;
  const size_t xo = (size_t)b * N * bsa::D, ko = (size_t)b * M * bsa::D;

  bsa::load_tile(wqs, wq, bsa::D, bsa::D);
  bsa::load_tile(wps, wp, bsa::D, bsa::D);
  bsa::cp_async_commit();
  if (threadIdx.x < 2 * bsa::D)
    bs[threadIdx.x] = threadIdx.x < bsa::D ? bq[threadIdx.x]
                                           : bp[threadIdx.x - bsa::D];
  uint32_t a[4][4];
  bsa::load_a(x + xo, r0, N, a);
  bsa::cp_async_wait<0>();
  __syncthreads();

  // q = bf16(x·Wqᵀ + bq), as A fragments.
  float o[8][4], rs[2];
  const float one[2] = {1.0f, 1.0f};
  dense64(a, wqs, o);
  to_a<false>(o, one, bs, a);

  bsa::softmax_av(a, k + ko, v + ko, M, scale * bsa::LOG2E, ring, o, rs);

  // proj = bf16(bf16(o / rs)·Wpᵀ + bp) into the warp's rows of the ring.
  to_a<true>(o, rs, nullptr, a);
  dense64(a, wps, o);
  const uint32_t st = ring + w * 16 * bsa::ROW_BYTES;
  {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b0 = bs[bsa::D + j * 8 + 2 * t];
      const float b1 = bs[bsa::D + j * 8 + 2 * t + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t pv = bsa::pack(o[j][2 * h] + b0, o[j][2 * h + 1] + b1);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                         st + bsa::swz(g + 8 * h, j) + 4 * t),
                     "r"(pv));
      }
    }
  }
  __syncwarp();

  // out = bf16(proj + res) for the rows below N, 16 bytes a lane.
#pragma unroll
  for (int i = lane; i < 16 * 8; i += 32) {
    const int r = i >> 3, c = i & 7;
    if (r0 + r >= N) continue;
    uint4 pv;
    asm volatile("ld.shared.v4.b32 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(pv.x), "=r"(pv.y), "=r"(pv.z), "=r"(pv.w)
                 : "r"(st + bsa::swz(r, c)));
    const size_t off = xo + (size_t)(r0 + r) * bsa::D + c * 8;
    const uint4 rv = *reinterpret_cast<const uint4*>(res + off);
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&pv);
    const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&rv);
    uint4 ov;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 pf = __bfloat1622float2(p2[e]);
      const float2 rf = __bfloat1622float2(r2[e]);
      o2[e] = __floats2bfloat162_rn(pf.x + rf.x, pf.y + rf.y);
    }
    *reinterpret_cast<uint4*>(out + off) = ov;
  }
}

// o (16 x 64, the accumulator layout) = the warp's rows at qs times the
// (64, 64) weight at ws (rows = output columns), + bias.
__device__ __forceinline__ void dense64_f32(uint32_t qs, uint32_t ws,
                                            const float* bias,
                                            float (&o)[8][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll  // o indexed by n: rolled, it would go to local memory
  for (int n = 0; n < 4; ++n) {
    float s[2][4];
    bsa::dots16_f32(qs, ws, n * 16, s);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[2 * n + j][i] = s[j][i] + bias[(2 * n + j) * 8 + 2 * t + (i & 1)];
  }
}

// o / f[h] for rows g + 8h into the warp's rows at qs (swizzled fp32), after
// every lane is done reading them.
__device__ __forceinline__ void put_rows32(const float (&o)[8][4],
                                           const float (&f)[2], uint32_t qs) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      asm volatile("st.shared.v2.f32 [%0], {%1,%2};\n" ::"r"(
                       qs + bsa::swz32(g + 8 * h, 2 * j + (t >> 1)) +
                       8 * (t & 1)),
                   "f"(o[j][2 * h] / f[h]), "f"(o[j][2 * h + 1] / f[h]));
  __syncwarp();
}

__global__ void __launch_bounds__(32 * WARPS, 2)
bridge_attention_folded_f32_kernel(const float* x, const float* res,
                                   const float* wq, const float* bq,
                                   const float* k, const float* v,
                                   const float* wp, const float* bp,
                                   float* out, int N, int M, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = bsa::smem_addr(smem);
  const int b = blockIdx.y, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * ROWS + w * 16;
  const uint32_t qs = ring + bsa::RING32 + w * bsa::Q32;
  float* bs = reinterpret_cast<float*>(smem + bsa::RING32 + WARPS * bsa::Q32);
  const size_t xo = (size_t)b * N * bsa::D, ko = (size_t)b * M * bsa::D;
  const float one[2] = {1.0f, 1.0f};

  bsa::load_tile32(ring, wq, bsa::D, bsa::D);
  for (int i = lane; i < 16 * 16; i += 32) {
    const int r = i >> 4, c = i & 15;
    const bool ok = r0 + r < N;
    bsa::cp_async16(qs + bsa::swz32(r, c),
                    x + xo + (size_t)(ok ? r0 + r : 0) * bsa::D + c * 4, ok);
  }
  bsa::cp_async_commit();
  if (threadIdx.x < 2 * bsa::D)
    bs[threadIdx.x] = threadIdx.x < bsa::D ? bq[threadIdx.x]
                                           : bp[threadIdx.x - bsa::D];
  bsa::cp_async_wait<0>();
  __syncthreads();

  // q = x·Wqᵀ + bq over the warp's x rows.
  float o[8][4], rs[2];
  dense64_f32(qs, ring, bs, o);
  put_rows32(o, one, qs);
  __syncthreads();  // every warp is done with Wq: the ring is softmax_av's

  bsa::softmax_av_f32(qs, k + ko, v + ko, M, scale * bsa::LOG2E, ring, o,
                      rs);

  // proj = (o / rs)·Wpᵀ + bp.
  bsa::load_tile32(ring, wp, bsa::D, bsa::D);
  bsa::cp_async_commit();
  put_rows32(o, rs, qs);
  bsa::cp_async_wait<0>();
  __syncthreads();
  dense64_f32(qs, ring, bs + bsa::D, o);
  put_rows32(o, one, qs);

  // out = proj + res for the rows below N, 16 bytes a lane.
#pragma unroll
  for (int i = lane; i < 16 * 16; i += 32) {
    const int r = i >> 4, c = i & 15;
    if (r0 + r >= N) continue;
    const float4 pv = lds128(qs + bsa::swz32(r, c));
    const size_t off = xo + (size_t)(r0 + r) * bsa::D + c * 4;
    const float4 rv = *reinterpret_cast<const float4*>(res + off);
    *reinterpret_cast<float4*>(out + off) =
        make_float4(pv.x + rv.x, pv.y + rv.y, pv.z + rv.z, pv.w + rv.w);
  }
}

}  // namespace

extern "C" int bridge_attention_folded(const bf16* x, const bf16* res,
                                       const bf16* wq, const float* bq,
                                       const bf16* k, const bf16* v,
                                       const bf16* wp, const float* bp,
                                       bf16* out, int B, int N, int M,
                                       float scale, void* stream) {
  cudaError_t e = set_smem((const void*)bridge_attention_folded_kernel, SMEM);
  if (e) return e;
  const dim3 grid((N + ROWS - 1) / ROWS, B);
  bridge_attention_folded_kernel<<<grid, 32 * WARPS, SMEM,
                                   static_cast<cudaStream_t>(stream)>>>(
      x, res, wq, bq, k, v, wp, bp, out, N, M, scale);
  return cudaGetLastError();
}

extern "C" int bridge_attention_folded_f32(const float* x, const float* res,
                                           const float* wq, const float* bq,
                                           const float* k, const float* v,
                                           const float* wp, const float* bp,
                                           float* out, int B, int N, int M,
                                           float scale, void* stream) {
  constexpr int SMEM32 = bsa::RING32 + WARPS * bsa::Q32 + 2 * bsa::D * 4;
  cudaError_t e =
      set_smem((const void*)bridge_attention_folded_f32_kernel, SMEM32);
  if (e) return e;
  const dim3 grid((N + ROWS - 1) / ROWS, B);
  bridge_attention_folded_f32_kernel<<<grid, 32 * WARPS, SMEM32,
                                       static_cast<cudaStream_t>(stream)>>>(
      x, res, wq, bq, k, v, wp, bp, out, N, M, scale);
  return cudaGetLastError();
}
