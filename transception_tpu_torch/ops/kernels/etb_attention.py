"""Folded EfficientTransformerBlock attention: x + reproj(attn(LN(x))).

Replaces transception_tpu/ops/pallas/linear_attention_kernel.py:131
`efficient_attention_block_folded` (pallas_call at :175): LN1 -> Q/K/V
Dense -> softmax_C(Q)·(softmax_N(K)ᵀ·V) -> reprojection -> + residual,
head_count 1, on (B, N, C) with N = 3136/784/196 and C = 64/128/320.

Bound on the H100: bytes. The block reads x once and writes it once
(2·B·N·C·2 bytes, ~26 MB at (32, 3136, 64)) against ~12·B·N·C² flops,
which at C ≤ 320 sits below the card's ~295 flop/byte ridge.

Design (csrc/etb_attention.cu): the TPU kernel holds a whole (N, C) row
in VMEM; on Hopper that does not fit at N = 3136, and the column softmax
of K and ctx = Ksᵀ·V are reductions over N that blocks running in no
order cannot carry. So the block runs as five stages over the whole
batch, each of which fills the card, with q, k, v and the attention
output in device memory for the length of one call:
  1. qkv: the tiled tensor-core product of the MixFFN stages
     (csrc/mixffn_stages.cuh: cp.async ring of swizzled panels, ldmatrix,
     mma.sync) over all B·N rows, with LN1 folded into its A panel
     (E[x²]−E[x]², rounded to bf16 as the Pallas kernel rounds it) and the
     bias epilogue: [q | k | v] = bf16(LN(x)·[Wq; Wk; Wv]ᵀ + b), one
     (B·N, 3C) workspace. The stacked weight is concatenated per call (a
     3C x C bf16 copy, 24 KB at C = 64 and 600 KB at C = 320, one small
     kernel) rather than running the product three times over three
     normalisations of the same rows;
  2-4. the linear-attention core that K6 shares (csrc/linear_attention.cuh,
     see ops/kernels/linear_attention.py): per segment of N the column
     statistics of K, per (64 x 64 context tile, segment) Ks =
     bf16(exp(K − m) / S) and the fp32 partial of Ksᵀ·V on the tensor
     cores, the partials added in a fixed order and rounded to bf16, then
     Q' = bf16(softmax_C(Q)) times the context per (64 columns, 64 rows):
     att = bf16(Q'·ctx);
  5. proj: the same product with the residual epilogue, out =
     bf16(bf16(att·Wpᵀ + bp) + x).
No atomics: the same bits in every launch. `plan` picks the product tiles
and the segments and sizes the workspace (51.4 MB of q|k|v and att at
(32, 3136, 64), plus 5.1 MB of statistics, partials and context). Every
rounding point is the Pallas kernel's; only the segments' exp sums are
combined in another order than on the TPU (a ~1e-7 relative change
before the bf16 rounding of Ks).

The fp32 form (csrc/etb_attention.cu etb_attention_f32, the published eval
protocol's dtype): the same five stages with fp32 activations, weights and
workspace and no rounding points, the products on the CUDA cores
(mixffn_stages.cuh's fp32 step); bound: operations at 67 TFLOP/s of FFMA.
At fp32 the folded LN's panel is C x 128 fp32 rows, so C goes up to 320
(`_check`).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from transception_tpu_torch.ops.kernels import _build
from transception_tpu_torch.ops.kernels import linear_attention as la
from transception_tpu_torch.ops.kernels import mixffn

NAME = "etb_attention"
REPLACES = "transception_tpu/ops/pallas/linear_attention_kernel.py:131"
MAX_C = 512  # the qkv product's normalised panel (C x 128 rows) and the core
launches = 0


def etb_attention_plain(x, ls, lb, wq, bq, wk, bk, wv, bv, wp, bp,
                        eps: float = 1e-5):
    """Plain version with the Pallas kernel's rounding points
    (linear_attention.py:83 _reference_etb_folded). Weights are torch
    Linear (out, in); vectors fp32."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    hn = ((xf - mu) * torch.rsqrt(var + eps) * ls.float()
          + lb.float()).to(dt)

    def dense(h, w, b):
        return F.linear(h.float(), w.to(dt).float(), b.float()).to(dt)

    k = dense(hn, wk, bk)
    q = dense(hn, wq, bq)
    v = dense(hn, wv, bv)
    ks = torch.softmax(k.float(), dim=1).to(dt)
    qs = torch.softmax(q.float(), dim=2).to(dt)
    ctx = torch.matmul(ks.float().transpose(1, 2), v.float()).to(dt)
    att = torch.matmul(qs.float(), ctx.float()).to(dt)
    proj = dense(att, wp, bp)
    return (proj.float() + xf).to(dt)


def plan(B: int, N: int, C: int, sms: int, es: int = 2) -> dict:
    """K1's launch plan for x (B, N, C) on a card of `sms` SMs: the qkv
    (T, 3C, C) and proj (T, C, C) product tiles (mixffn.token_tile, T =
    B·N), the core's segments (linear_attention.core_plan, one head of C
    channels a batch row), the blocks of each stage, the workspace bytes
    in the entry's order (q|k|v, the statistics, the fp32 partials, the
    context, att; elements of es bytes) and each stage's shared memory.
    `plan` is the int list the CUDA entry takes."""
    T = B * N
    gemms = {"qkv": (T, 3 * C, C) + mixffn.token_tile(T, 3 * C, sms),
             "proj": (T, C, C) + mixffn.token_tile(T, C, sms)}
    core = la.core_plan(B, N, C, C, sms, es)
    blocks = {k: mixffn._blocks(*g[:2], *g[3:]) for k, g in gemms.items()}
    blocks.update(core["blocks"])
    smem = {"qkv": mixffn.gemm_smem(True, *gemms["qkv"][3:], C, es),
            **core["smem"],
            "proj": mixffn.gemm_smem(False, *gemms["proj"][3:], C, es)}
    return dict(gemms=gemms, core=core, blocks=blocks,
                workspace={"qkv": T * 3 * C * es, **core["workspace"],
                           "att": T * C * es},
                smem=smem,
                plan=[*gemms["qkv"][3:], *gemms["proj"][3:],
                      core["segments"], core["segment_rows"]])


@functools.lru_cache(maxsize=None)
def _launch_plan(B, N, C, sms, es=2):
    """plan's workspace sizes and its int list as the entry takes it (a
    ctypes array, read only), kept per shape, card and element size."""
    pl = plan(B, N, C, sms, es)
    return (tuple(pl["workspace"].values()),
            (ctypes.c_int * len(pl["plan"]))(*pl["plan"]))


def _check(x, weights):
    _build.element_dtype(NAME, x)
    if x.dim() != 3:
        raise ValueError(f"{NAME} kernel takes a (B, N, C) tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    C, es = x.shape[-1], x.element_size()
    big = mixffn.BWD_TILES[0]
    if C % 64 or C > MAX_C or \
            mixffn.gemm_smem(True, big, big, C, es) > mixffn.SMEM_LIMIT or \
            la.out_smem(C, es) > la.SMEM_LIMIT:
        raise ValueError(f"{NAME} kernel needs C % 64 == 0 (the folded "
                         f"LN's groups) and C <= {MAX_C} (320 at fp32), got "
                         f"C={C}")
    for w in weights:
        if tuple(w.shape) != (C, C):
            raise ValueError(f"{NAME} kernel needs (C, C) weights")


def etb_attention(x, ls, lb, wq, bq, wk, bk, wv, bv, wp, bp,
                  eps: float = 1e-5):
    """Wrapper: plain version with the kernels off or where autograd
    records on the CPU, else the operator (the CUDA kernel, whose backward
    is autograd of the plain version)."""
    if _build.plain(NAME, x):
        return etb_attention_plain(x, ls, lb, wq, bq, wk, bk, wv, bv, wp, bp,
                                   eps)
    return _build.with_plain_backward(
        lambda *a: OP(*a, eps), lambda *a: etb_attention_plain(*a, eps),
        x, ls, lb, wq, bq, wk, bk, wv, bv, wp, bp)


def _launch(x, ls, lb, wq, bq, wk, bk, wv, bv, wp, bp, eps):
    """One counted launch: the five stages of the plan (plan)."""
    _check(x, (wq, wk, wv, wp))
    global launches
    x = _build.aligned(x)
    B, N, C = x.shape
    sizes, ints = _launch_plan(B, N, C, _build.sms(x), x.element_size())
    wqkv = _build.weight(torch.cat((wq, wk, wv)), x.dtype)
    bqkv = _build.f32(torch.cat((bq, bk, bv)))
    held = (x, _build.f32(ls), _build.f32(lb), wqkv, bqkv,
            _build.weight(wp, x.dtype), _build.f32(bp))
    out = torch.empty_like(x)
    ws, work = _build.workspace(sizes, x.device)
    fn = _build.entry(NAME, _build.symbol("etb_attention", x.dtype),
                      [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3
                      + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(*[_build.ptr(t) for t in held], *work, _build.ptr(out), ints,
            B, N, C, eps, _build.stream_of(x))
    _build.check(rc, NAME)
    launches += 1
    _build.tally(NAME, tuple(x.shape), _build.tag(x))
    return out


OP = _build.define(
    NAME, "(Tensor x, Tensor ls, Tensor lb, Tensor wq, Tensor bq, Tensor wk, "
    "Tensor bk, Tensor wv, Tensor bv, Tensor wp, Tensor bp, float eps) -> "
    "Tensor", _launch, etb_attention_plain, lambda x, *a: x.new_empty(x.shape))
