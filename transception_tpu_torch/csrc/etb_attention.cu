// Folded EfficientTransformerBlock attention (head_count 1):
//   out = x + reproj(softmax_C(Q) · (softmax_N(K)ᵀ · V)),  Q/K/V = Dense(LN(x)).
// Replaces transception_tpu/ops/pallas/linear_attention_kernel.py:131
// efficient_attention_block_folded. Design notes: ops/kernels/etb_attention.py.
//
// Five stages over the whole batch on one stream (six CUDA launches with
// the core's sum of segment partials), each of which fills the card:
//   1. qkv   [q | k | v] = bf16(LN(x)·[Wq; Wk; Wv]ᵀ + [bq; bk; bv]): the
//            tiled product of mixffn_stages.cuh over all B·N rows, with the
//            LN folded into its A panel (one group of C channels) and the
//            bias epilogue, into a (B·N, 3C) bf16 workspace;
//   2-4.     the linear-attention core (linear_attention.cuh) on the
//            workspace's column slices, one head, the softmax of Q over
//            all C channels (the head_count 1 quirk,
//            linear_attention_kernel.py:100-111): att = bf16(Q'·ctx),
//            (B·N, C);
//   5. proj  out = bf16(bf16(att·Wpᵀ + bp) + x), the same product with the
//            residual epilogue.
// The plan of tiles and segments is the wrapper's (ops/kernels/
// etb_attention.py plan).
#include "linear_attention.cuh"

namespace {
constexpr int KID = 1;
}  // namespace

// Indices into the wrapper's plan.
enum Plan { QKV_BM, QKV_BN, PROJ_BM, PROJ_BN, SEGMENTS, SEGMENT_ROWS,
            PLAN_LEN };

extern "C" int etb_attention(const bf16* x, const float* ls, const float* lb,
                             const bf16* wqkv, const float* bqkv,
                             const bf16* wp, const float* bp, bf16* qkv,
                             float2* part, float* pctx, bf16* ctx, bf16* att,
                             bf16* out, const int* plan, int B, int N, int C,
                             float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % 64) return cudaErrorInvalidValue;  // the folded LN's groups
  const int T = B * N;
  cudaError_t e = ffn::gemm<KID, true, true, true, ffn::EPI_BIAS>(
      plan[QKV_BM], plan[QKV_BN], x, C, wqkv, C, qkv, 3 * C, bqkv, nullptr,
      ffn::Norm{ls, lb, C, eps}, T, 3 * C, C, ffn::depth(C), 0, st);
  if (e) return e;
  const size_t bs = (size_t)N * 3 * C;
  e = lin::attention<KID>(lin::View{qkv, 3 * C, bs},
                          lin::View{qkv + C, 3 * C, bs},
                          lin::View{qkv + 2 * C, 3 * C, bs},
                          lin::View{att, C, (size_t)N * C}, part, pctx, ctx,
                          B, N, C, C, plan[SEGMENTS], plan[SEGMENT_ROWS], 1,
                          1.0f, st);
  if (e) return e;
  return ffn::gemm<KID, true, true, false, ffn::EPI_RESID>(
      plan[PROJ_BM], plan[PROJ_BN], att, C, wp, C, out, C, bp, x,
      ffn::Norm{}, T, C, C, ffn::depth(C), 0, st);
}
