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
// bridges and any fp32 model with bridge_attn_fold): K3's fp32 form
// (bridge_softmax.cuh attend32, 3xTF32 on the tensor cores, one pass) with
// the projections folded around it as 3xTF32 products too; nothing
// rounded to a narrower type, the rounding points the mirror's. The same
// block of 12 warps over 192 rows, one block an SM:
//   prologue  Wq (64 x 64 fp32, 16 KB) into the room of the split chunk
//             and the first K/V chunk into the ring, with cp.async; x's A
//             fragments split from device memory a channel step at a
//             time; q = x·Wqᵀ + bq split into the warp's q rows;
//   attention attend32 (64-key fp32 chunks of K and V, split once a
//             block; ex2.approx);
//   epilogue  Wp into the split chunk's room, now free; o / rowsum is the
//             A fragment of ·Wpᵀ in the channel order 2t, 2t + 1 (columns
//             t, t + 4), so the lane reads Wp's two neighbouring columns
//             at once; + bp, staged through the warp's q rows; + res in
//             fp32 with 16-byte coalesced reads, stored for the rows
//             below N.
// K3's 224 KB of shared memory and the biases. Bound: operations,
// 4·B·N·M·d + 4·B·N·d² flops as 3 TF32 products at 495 TFLOP/s.
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

constexpr int W32 = bsa::D * bsa::ROW32;  // one 64 x 64 fp32 weight
constexpr int SMEM32 = bsa::F32_SMEM + 2 * bsa::D * 4;
static_assert(bsa::F32_SPLIT >= W32, "a weight fits the split chunk's room");

__global__ void __launch_bounds__(32 * bsa::F32_WARPS, 1)
bridge_attention_folded_f32_kernel(const float* x, const float* res,
                                   const float* wq, const float* bq,
                                   const float* k, const float* v,
                                   const float* wp, const float* bp,
                                   float* out, int N, int M, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sm = bsa::smem_addr(smem);
  const uint32_t ws = sm + bsa::F32_RING;  // Wq, then Wp: the split room
  float* bs = reinterpret_cast<float*>(smem + bsa::F32_SMEM);
  const int b = blockIdx.y, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * bsa::F32_ROWS + w * 16;
  const uint32_t qs = sm + bsa::F32_RING + bsa::F32_SPLIT + w * bsa::F32_Q;
  const size_t xo = (size_t)b * N * bsa::D, ko = (size_t)b * M * bsa::D;

  bsa::load_tile32(ws, wq, bsa::D, bsa::D);
  bsa::cp_async_commit();
  bsa::prefetch_kv(sm, k + ko, v + ko, M);
  if (threadIdx.x < 2 * bsa::D)
    bs[threadIdx.x] = threadIdx.x < bsa::D ? bq[threadIdx.x]
                                           : bp[threadIdx.x - bsa::D];
  bsa::cp_async_wait<bsa::F32_STAGES - 1>();  // Wq landed
  __syncthreads();

  // q = x·Wqᵀ + bq, split into the warp's q rows: channel step kk's A
  // fragment split from x in device memory (rows past N zero), and lane
  // (g, t) reads Wq[8n + g][8kk + t] and [8kk + t + 4].
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + g + 8 * (i & 1);
      const float xv =
          r < N ? x[xo + (size_t)r * bsa::D + 8 * kk + t + 4 * (i >> 1)]
                : 0.0f;
      bsa::split(xv, ah[i], al[i]);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
      bsa::mma3(acc[n], ah, al,
                lds32(ws + bsa::swz32(8 * n + g, 2 * kk) + 4 * t),
                lds32(ws + bsa::swz32(8 * n + g, 2 * kk + 1) + 4 * t));
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float b0 = bs[8 * n + 2 * t], b1 = bs[8 * n + 2 * t + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t h0, l0, h1, l1;
      bsa::split(acc[n][2 * h] + b0, h0, l0);
      bsa::split(acc[n][2 * h + 1] + b1, h1, l1);
      const uint32_t at =
          qs + bsa::swz32(g + 8 * h, 2 * n + (t >> 1)) + 8 * (t & 1);
      bsa::sts64(at, h0, h1);
      bsa::sts64(at + bsa::Q32, l0, l1);
    }
  }
  __syncwarp();  // (attend32 opens with a barrier: Wq is then free)

  float o[8][4], rs[2];
  bsa::attend32(qs, k + ko, v + ko, M, scale * bsa::LOG2E, sm, o, rs);

  // proj = (o / rs)·Wpᵀ + bp: channel step c's A fragment holds the
  // output's channels 8c + 2t (column t) and 8c + 2t + 1 (column t + 4),
  // the accumulators' own pairs, so lane (g, t) reads Wp[8n + g][8c + 2t]
  // and its neighbour; Wp in the split room, now free.
  bsa::load_tile32(ws, wp, bsa::D, bsa::D);
  bsa::cp_async_commit();
  bsa::cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int n = 0; n < 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    uint32_t ph[4], pl[4];
    bsa::split(o[c][0] / rs[0], ph[0], pl[0]);
    bsa::split(o[c][2] / rs[1], ph[1], pl[1]);
    bsa::split(o[c][1] / rs[0], ph[2], pl[2]);
    bsa::split(o[c][3] / rs[1], ph[3], pl[3]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 wv =
          lds64(ws + bsa::swz32(8 * n + g, 2 * c + (t >> 1)) + 8 * (t & 1));
      bsa::mma3(acc[n], ph, pl, wv.x, wv.y);
    }
  }
  // + bp into the warp's (free) q rows.
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float b0 = bs[bsa::D + 8 * n + 2 * t];
    const float b1 = bs[bsa::D + 8 * n + 2 * t + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      asm volatile("st.shared.v2.f32 [%0], {%1,%2};\n" ::"r"(
                       qs + bsa::swz32(g + 8 * h, 2 * n + (t >> 1)) +
                       8 * (t & 1)),
                   "f"(acc[n][2 * h] + b0), "f"(acc[n][2 * h + 1] + b1));
  }
  __syncwarp();

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
  cudaError_t e =
      set_smem((const void*)bridge_attention_folded_f32_kernel, SMEM32);
  if (e) return e;
  const dim3 grid((N + bsa::F32_ROWS - 1) / bsa::F32_ROWS, B);
  bridge_attention_folded_f32_kernel<<<grid, 32 * bsa::F32_WARPS, SMEM32,
                                       static_cast<cudaStream_t>(stream)>>>(
      x, res, wq, bq, k, v, wp, bp, out, N, M, scale);
  return cudaGetLastError();
}
