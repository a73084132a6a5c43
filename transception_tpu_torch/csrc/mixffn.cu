// Fused MixFFN_skip with the caller's (grouped) LayerNorm folded in and the
// residual added (K2):
//   out = x + fc2(GELU(LN_h(dwconv3x3(h) + h))),  h = fc1(LN(x)),
// replacing transception_tpu/ops/pallas/mixffn_kernel.py:342
// fused_mixffn_ln_skip; and the unfolded MixFFN_skip alone (K9):
//   out = fc2(GELU(LN_h(dwconv3x3(h) + h))),  h = fc1(x),
// replacing mixffn_kernel.py:285 fused_mixffn_skip.
//
// Both are the forward chain of mixffn_stages.cuh (ffn::forward), three
// launches over the whole batch: fc1 as a tiled tensor-core product (K2
// normalises x into the product's A panel), the conv/LN/GELU stage a block
// per map row, fc2 with the bias and residual in the product's epilogue.
// Bound on the H100: near the ridge of bytes and operations; what it takes
// in practice is the hidden state (h and a in device memory for the length
// of one call). The design notes are in mixffn_stages.cuh and
// ops/kernels/mixffn.py.
#include "mixffn_stages.cuh"

// x, out: (B, s², C) bf16; w1 (hid, C), dw (hid, 9), w2 (C, hid) bf16;
// lts/ltb the (C,)-tiled group-LN scale and bias, the other vectors fp32;
// h, a: (B·s², hid) bf16 workspace; plan: ffn::FWD_PLAN_LEN ints.
extern "C" int mixffn_ln_skip(const bf16* x, const float* lts,
                              const float* ltb, const bf16* w1,
                              const float* b1, const bf16* dw,
                              const float* dwb, const float* ls,
                              const float* lb, const bf16* w2,
                              const float* b2, bf16* out, bf16* h, bf16* a,
                              const int* plan, int B, int s, int C, int hid,
                              int groups, float eps_ln, float eps,
                              void* stream) {
  return ffn::forward<2, false>(x, ffn::Norm{lts, ltb, C / groups, eps_ln},
                                w1, b1, dw, dwb, ls, lb, w2, b2, x, h, a, out,
                                plan, B, s, C, hid, eps,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int mixffn_skip(const bf16* x, const bf16* w1, const float* b1,
                           const bf16* dw, const float* dwb, const float* ls,
                           const float* lb, const bf16* w2, const float* b2,
                           bf16* out, bf16* h, bf16* a, const int* plan,
                           int B, int s, int C, int hid, float eps,
                           void* stream) {
  return ffn::forward<9, true>(x, ffn::Norm{}, w1, b1, dw, dwb, ls, lb, w2,
                               b2, nullptr, h, a, out, plan, B, s, C, hid,
                               eps, static_cast<cudaStream_t>(stream));
}
