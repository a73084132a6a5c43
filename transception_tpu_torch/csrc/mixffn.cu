// Fused MixFFN_skip with the caller's (grouped) LayerNorm folded in and the
// residual added:
//   out = x + fc2(GELU(LN_h(dwconv3x3(h) + h))),  h = fc1(LN(x)).
// Replaces transception_tpu/ops/pallas/mixffn_kernel.py:342
// fused_mixffn_ln_skip. The kernel body is in mixffn.cuh; design notes:
// ops/kernels/mixffn.py.
#include "mixffn.cuh"

extern "C" int mixffn_ln_skip(const bf16* x, const float* lts,
                              const float* ltb, const bf16* w1,
                              const float* b1, const bf16* dw,
                              const float* dwb, const float* ls,
                              const float* lb, const bf16* w2,
                              const float* b2, bf16* out, int B, int s, int C,
                              int hid, int groups, float eps_ln, float eps,
                              void* stream) {
  const size_t smem = mixffn::smem_bytes(s, C, hid);
  auto kernel = groups == 1 ? mixffn::mixffn_ln_skip_kernel<false>
                            : mixffn::mixffn_ln_skip_kernel<true>;
  cudaError_t e = set_smem((const void*)kernel, smem);
  if (e) return e;
  kernel<<<dim3(s, B), mixffn::THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(
      x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2, out, s, C, hid, groups,
      eps_ln, eps);
  return cudaGetLastError();
}
