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
