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
// of one call). K2 and K9 also have fp32 forms (mixffn_ln_skip_f32, the
// fp32 eval forward's and train step's; mixffn_skip_f32, the fp32 train
// step's): the same stages at E = float, products on the CUDA cores (67
// TFLOP/s of FFMA bound them by operations at every shape). The design
// notes are in mixffn_stages.cuh and ops/kernels/mixffn.py.
#include "mixffn_stages.cuh"

// x, out: (B, s², C) E; w1 (hid, C), dw (hid, 9), w2 (C, hid) E; lts/ltb
// the (C,)-tiled group-LN scale and bias, the other vectors fp32; h, a:
// (B·s², hid) E workspace; plan: ffn::FWD_PLAN_LEN ints. E: bf16, or fp32
// for the entries named _f32.
template <typename E>
int ln_skip(const E* x, const float* lts, const float* ltb, const E* w1,
            const float* b1, const E* dw, const float* dwb, const float* ls,
            const float* lb, const E* w2, const float* b2, E* out, E* h, E* a,
            const int* plan, int B, int s, int C, int hid, int groups,
            float eps_ln, float eps, void* stream) {
  return ffn::forward<2, false, E>(x, ffn::Norm{lts, ltb, C / groups, eps_ln},
                                   w1, b1, dw, dwb, ls, lb, w2, b2, x, h, a,
                                   out, plan, B, s, C, hid, eps,
                                   static_cast<cudaStream_t>(stream));
}

#define LN_SKIP(NAME, E)                                                    \
  extern "C" int NAME(const E* x, const float* lts, const float* ltb,       \
                      const E* w1, const float* b1, const E* dw,            \
                      const float* dwb, const float* ls, const float* lb,   \
                      const E* w2, const float* b2, E* out, E* h, E* a,     \
                      const int* plan, int B, int s, int C, int hid,        \
                      int groups, float eps_ln, float eps, void* stream) {  \
    return ln_skip<E>(x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2, out, h, \
                      a, plan, B, s, C, hid, groups, eps_ln, eps, stream);  \
  }
LN_SKIP(mixffn_ln_skip, bf16)
LN_SKIP(mixffn_ln_skip_f32, float)
#undef LN_SKIP

// K9: x, out (B, s², C) E; w1, dw, w2 E; the vectors fp32; h, a the
// (B·s², hid) E workspace. E: bf16, or fp32 for mixffn_skip_f32 (the fp32
// train step's), the BARE chain at E = float.
#define SKIP(NAME, E)                                                        \
  extern "C" int NAME(const E* x, const E* w1, const float* b1, const E* dw, \
                      const float* dwb, const float* ls, const float* lb,    \
                      const E* w2, const float* b2, E* out, E* h, E* a,      \
                      const int* plan, int B, int s, int C, int hid,         \
                      float eps, void* stream) {                             \
    return ffn::forward<9, true, E>(x, ffn::Norm{}, w1, b1, dw, dwb, ls, lb, \
                                    w2, b2, nullptr, h, a, out, plan, B, s,  \
                                    C, hid, eps,                             \
                                    static_cast<cudaStream_t>(stream));      \
  }
SKIP(mixffn_skip, bf16)
SKIP(mixffn_skip_f32, float)
#undef SKIP
