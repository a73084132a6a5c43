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

// x, out: (B, R·s, C) E, B maps of R rows and s columns (R = s: a whole
// square map; R != s: a block of a map's rows with its halo rows, whose
// interior rows the caller keeps); w1 (hid, C), dw (hid, 9), w2 (C, hid)
// E; lts/ltb the (C,)-tiled group-LN scale and bias, the other vectors
// fp32; h, a: (B·R·s, hid) E workspace; plan: ffn::FWD_PLAN_LEN ints. E:
// bf16, or fp32 for the entries named _f32.
template <typename E>
int ln_skip(const E* x, const float* lts, const float* ltb, const E* w1,
            const float* b1, const E* dw, const float* dwb, const float* ls,
            const float* lb, const E* w2, const float* b2, E* out, E* h, E* a,
            const int* plan, int B, int R, int s, int C, int hid,
            int groups, float eps_ln, float eps, void* stream) {
  return ffn::forward<2, false, E>(x, ffn::Norm{lts, ltb, C / groups, eps_ln},
                                   w1, b1, dw, dwb, ls, lb, w2, b2, x, h, a,
                                   out, plan, B, R, s, C, hid, eps,
                                   static_cast<cudaStream_t>(stream));
}

#define LN_SKIP(NAME, E)                                                    \
  extern "C" int NAME(const E* x, const float* lts, const float* ltb,       \
                      const E* w1, const float* b1, const E* dw,            \
                      const float* dwb, const float* ls, const float* lb,   \
                      const E* w2, const float* b2, E* out, E* h, E* a,     \
                      const int* plan, int B, int R, int s, int C,          \
                      int hid, int groups, float eps_ln, float eps,         \
                      void* stream) {                                       \
    return ln_skip<E>(x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2, out, h, \
                      a, plan, B, R, s, C, hid, groups, eps_ln, eps,        \
                      stream);                                              \
  }
LN_SKIP(mixffn_ln_skip, bf16)
LN_SKIP(mixffn_ln_skip_f32, float)
#undef LN_SKIP

// K9: x, out (B, R·s, C) E (maps of R rows, s columns, as K2's); w1, dw,
// w2 E; the vectors fp32; h, a the (B·R·s, hid) E workspace. E: bf16, or
// fp32 for mixffn_skip_f32 (the fp32 train step's), the BARE chain at
// E = float.
#define SKIP(NAME, E)                                                        \
  extern "C" int NAME(const E* x, const E* w1, const float* b1, const E* dw, \
                      const float* dwb, const float* ls, const float* lb,    \
                      const E* w2, const float* b2, E* out, E* h, E* a,      \
                      const int* plan, int B, int R, int s, int C,           \
                      int hid, float eps, void* stream) {                    \
    return ffn::forward<9, true, E>(x, ffn::Norm{}, w1, b1, dw, dwb, ls, lb, \
                                    w2, b2, nullptr, h, a, out, plan, B, R,  \
                                    s, C, hid, eps,                          \
                                    static_cast<cudaStream_t>(stream));      \
  }
SKIP(mixffn_skip, bf16)
SKIP(mixffn_skip_f32, float)
#undef SKIP

// K2's hidden-sharded form, for a MixFFN whose fc1 rows, conv, hidden LN
// and fc2 columns are sharded over the model axis (hid of its hid_all
// channels on this rank): three entries, between which the caller sums
// over the ranks (parallel/tensor.py):
//   mixffn_tp_fc1   h = E(groupLN(x)·w1ᵀ + b1), then each token's
//                   partial (Σ y, Σ y²) of y = E(conv3x3(h) + dwb) + h
//                   into st (B·s², 2) fp32;
//   mixffn_tp_fc2   with st summed: z = E(LN(y)) over hid_all channels,
//                   a = E(GELU(z)) (workspace), p = a·w2ᵀ (B·s², C) fp32;
//   mixffn_tp_out   with p summed: out = E(E(p + b2) + x).
// The unsharded K2's rounding points; only the order of the fp32 sums
// moves. x, out (B, s², C) E; w1 (hid, C), dw (hid, 9), w2 (C, hid) E;
// the vectors fp32; h, a (B·s², hid) E. E: bf16, or fp32 (_f32).
#define TP_FWD(SUF, E)                                                       \
  extern "C" int mixffn_tp_fc1##SUF(                                         \
      const E* x, const float* lts, const float* ltb, const E* w1,           \
      const float* b1, const E* dw, const float* dwb, E* h, float* st,       \
      const int* plan, int B, int s, int C, int hid, int groups,             \
      float eps_ln, void* stream) {                                          \
    return ffn::fc1_stats<2, E>(x, ffn::Norm{lts, ltb, C / groups, eps_ln},  \
                                w1, b1, dw, dwb, h,                          \
                                reinterpret_cast<float2*>(st), plan, B, s,   \
                                C, hid, static_cast<cudaStream_t>(stream));  \
  }                                                                          \
  extern "C" int mixffn_tp_fc2##SUF(                                         \
      const E* h, const E* dw, const float* dwb, const float* ls,            \
      const float* lb, const E* w2, const float* st, float* p, E* a,         \
      const int* plan, int B, int s, int C, int hid, int hid_all, float eps, \
      void* stream) {                                                        \
    return ffn::act_fc2<2, E>(h, dw, dwb, ls, lb, w2,                        \
                              reinterpret_cast<const float2*>(st), a, p,     \
                              plan, B, s, C, hid, hid_all, eps,              \
                              static_cast<cudaStream_t>(stream));            \
  }
TP_FWD(, bf16)
TP_FWD(_f32, float)
#undef TP_FWD

// K9's hidden-sharded form (the unfolded MHCA FFN of a drop-path block in
// the per-path MHCA layout, whose FFN the TP rules shard): K2's sharded
// stages without the caller's LN and the residual,
//   mixffn_skip_tp_fc1  h = E(x·w1ᵀ + b1) (BARE), the partial (Σ y, Σ y²);
//   mixffn_tp_fc2       (above) with st summed;
//   mixffn_skip_tp_out  with p summed: out = E(p + b2).
#define SKIP_TP_FC1(SUF, E)                                                  \
  extern "C" int mixffn_skip_tp_fc1##SUF(                                    \
      const E* x, const E* w1, const float* b1, const E* dw,                 \
      const float* dwb, E* h, float* st, const int* plan, int B, int s,      \
      int C, int hid, void* stream) {                                        \
    return ffn::fc1_stats<9, E, true>(x, ffn::Norm{}, w1, b1, dw, dwb, h,    \
                                      reinterpret_cast<float2*>(st), plan,   \
                                      B, s, C, hid,                          \
                                      static_cast<cudaStream_t>(stream));    \
  }
SKIP_TP_FC1(, bf16)
SKIP_TP_FC1(_f32, float)
#undef SKIP_TP_FC1

// out = E(E(p + b2) + x) (RES) or E(p + b2) over n = T·C elements, C
// channels a token: a thread a pair of elements (C even).
template <typename E, bool RES>
__global__ void __launch_bounds__(256)
mixffn_tp_out_kernel(const float* p, const float* b2, const E* x, E* out,
                     size_t n, int C) {
  for (size_t i = 2 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x); i < n;
       i += 2 * (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const float2 v = *reinterpret_cast<const float2*>(p + i);
    if constexpr (RES) {
      const float2 r = ld2<E>(x + i);
      st2<E>(out + i, rnd<E>(v.x + b2[c]) + r.x,
             rnd<E>(v.y + b2[c + 1]) + r.y);
    } else {
      st2<E>(out + i, v.x + b2[c], v.y + b2[c + 1]);
    }
  }
}

template <typename E, bool RES>
int tp_out(const float* p, const float* b2, const E* x, E* out, int T, int C,
           void* stream) {
  const size_t n = (size_t)T * C;
  const size_t want = (n / 2 + 255) / 256;
  const int blocks = (int)(want < 8192 ? want : 8192);
  mixffn_tp_out_kernel<E, RES>
      <<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(p, b2, x, out,
                                                               n, C);
  return cudaGetLastError();
}

#define TP_OUT(SUF, E)                                                     \
  extern "C" int mixffn_tp_out##SUF(const float* p, const float* b2,       \
                                    const E* x, E* out, int T, int C,      \
                                    void* stream) {                        \
    return tp_out<E, true>(p, b2, x, out, T, C, stream);                   \
  }                                                                        \
  extern "C" int mixffn_skip_tp_out##SUF(const float* p, const float* b2,  \
                                         E* out, int T, int C,             \
                                         void* stream) {                   \
    return tp_out<E, false>(p, b2, nullptr, out, T, C, stream);            \
  }
TP_OUT(, bf16)
TP_OUT(_f32, float)
#undef TP_OUT
