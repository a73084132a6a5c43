// Bridge softmax cross-attention: out = softmax(Q·Kᵀ·scale) · V, d = 64.
// Replaces transception_tpu/ops/pallas/bridge_attention_kernel.py:256
// bridge_softmax_attention (rounding of its _kernel, :59-75). Design
// notes: ops/kernels/bridge_attention.py.
//
// Bound on the H100: operations. At the published shape (q (32, 1, 6076,
// 64) against k/v (32, 1, 784, 64)) 4·B·N·M·d = 3.9e10 flop is 0.039 ms at
// the bf16 peak against 56 MB of traffic, 0.017 ms: 690 flop a byte, above
// the card's ridge. The TPU's exact max costs a third product on top
// (pass 1 recomputes Q·Kᵀ), and 152 M exponentials run on the MUFU.
//
// One block of 8 warps per (128 query rows, batch·head). Each warp keeps
// its 16 rows of Q as mma A fragments in registers for the whole kernel
// and runs bridge_softmax.cuh's softmax_av: K and V reach the block once,
// through a 2-deep cp.async ring of 112-key chunks shared by all its
// warps, so L2 serves each K/V byte once per block, not once per warp, and
// the copy of the next chunk overlaps the products of this one; the logits
// and the probabilities stay in registers. The fp32 output is divided by the row sum, rounded, and
// written through shared memory as 16-byte rows. 57 KB of shared memory
// and at most 85 registers a thread let 3 blocks (24 warps) share an SM;
// a 3-deep ring (86 KB, 2 blocks) measured slower. Query rows past N load
// as zero and are never stored. No atomics: every run gives the same bits.
//
// The fp32 form (bridge_attention_f32, the fp32 eval forward's): the same
// block of 8 warps over 128 query rows and the same two passes, on the
// CUDA cores (bridge_softmax.cuh softmax_av_f32): each warp's 16 query rows
// in its 4 KB of shared memory, K and V through the ring in 64-key chunks
// of fp32 (96 KB a block with the rows: 2 blocks an SM where the
// registers allow, at most 128 a thread), nothing rounded;
// exp as ex2.approx (about 2 ulp, ~1e-7 relative against the 1e-4 limit of
// the card check). Bound: operations, 4·B·N·M·d flops at 67 TFLOP/s of
// FFMA (the kernel does 6·B·N·M·d: pass 1 forms Q·Kᵀ again).
#include "bridge_softmax.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int ROWS = 16 * WARPS;

__global__ void __launch_bounds__(32 * WARPS, 3)
bridge_attention_kernel(const bf16* q, const bf16* k, const bf16* v,
                        bf16* out, int N, int M, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = bsa::smem_addr(smem);
  const int bh = blockIdx.y, w = threadIdx.x >> 5;
  const int r0 = blockIdx.x * ROWS + w * 16;
  const bf16* qg = q + (size_t)bh * N * bsa::D;

  uint32_t qa[4][4];
  bsa::load_a(qg, r0, N, qa);
  float o[8][4], rs[2];
  bsa::softmax_av(qa, k + (size_t)bh * M * bsa::D,
                  v + (size_t)bh * M * bsa::D, M, scale * bsa::LOG2E, ring,
                  o, rs);
  bsa::store_rows<true>(o, rs, ring + w * 16 * bsa::ROW_BYTES,
                        out + (size_t)bh * N * bsa::D, r0, N);
}

__global__ void __launch_bounds__(32 * WARPS)
bridge_attention_f32_kernel(const float* q, const float* k, const float* v,
                            float* out, int N, int M, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = bsa::smem_addr(smem);
  const int bh = blockIdx.y, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * ROWS + w * 16;
  const uint32_t qs = ring + bsa::RING32 + w * bsa::Q32;
  const float* qg = q + (size_t)bh * N * bsa::D;
  // The warp's 16 query rows, zero past N (committed with the ring's first
  // chunk).
  for (int i = lane; i < 16 * 16; i += 32) {
    const int r = i >> 4, c = i & 15;
    const bool ok = r0 + r < N;
    bsa::cp_async16(qs + bsa::swz32(r, c),
                    qg + (size_t)(ok ? r0 + r : 0) * bsa::D + c * 4, ok);
  }
  float o[8][4], rs[2];
  bsa::softmax_av_f32(qs, k + (size_t)bh * M * bsa::D,
                      v + (size_t)bh * M * bsa::D, M, scale * bsa::LOG2E,
                      ring, o, rs);
  bsa::store_rows32(o, rs, qs, out + (size_t)bh * N * bsa::D, r0, N);
}

}  // namespace

extern "C" int bridge_attention(const bf16* q, const bf16* k, const bf16* v,
                                bf16* out, int BH, int N, int M, float scale,
                                void* stream) {
  cudaError_t e = set_smem((const void*)bridge_attention_kernel,
                           bsa::RING_BYTES);
  if (e) return e;
  const dim3 grid((N + ROWS - 1) / ROWS, BH);
  bridge_attention_kernel<<<grid, 32 * WARPS, bsa::RING_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, N, M, scale);
  return cudaGetLastError();
}

extern "C" int bridge_attention_f32(const float* q, const float* k,
                                    const float* v, float* out, int BH, int N,
                                    int M, float scale, void* stream) {
  constexpr int SMEM = bsa::RING32 + WARPS * bsa::Q32;
  cudaError_t e = set_smem((const void*)bridge_attention_f32_kernel, SMEM);
  if (e) return e;
  const dim3 grid((N + ROWS - 1) / ROWS, BH);
  bridge_attention_f32_kernel<<<grid, 32 * WARPS, SMEM,
                                static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, N, M, scale);
  return cudaGetLastError();
}
