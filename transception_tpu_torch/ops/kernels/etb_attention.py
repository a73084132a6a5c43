"""Folded EfficientTransformerBlock attention: x + reproj(attn(LN(x))).

Replaces transception_tpu/ops/pallas/linear_attention_kernel.py:131
`efficient_attention_block_folded` (pallas_call at :175): LN1 -> Q/K/V
Dense -> softmax_C(Q)·(softmax_N(K)ᵀ·V) -> reprojection -> + residual,
head_count 1, on (B, N, C) with N = 3136/784/196 and C = 64/128/320.

Bound on the H100: bytes. The block reads x once and writes it once
(2·B·N·C·2 bytes, ~26 MB at (32, 3136, 64)) against ~10·B·N·C² flops,
which at C ≤ 320 sits far below the card's ~295 flop/byte ridge.

Design (csrc/etb_attention.cu): the TPU kernel holds a whole (N, C) row
in VMEM; on Hopper that does not fit at N = 3136, and the column softmax
of K and ctx = Ksᵀ·V are reductions over N. So the work is cut into
64-token tiles over a (tiles, B) grid and three passes that recompute
LN -> K (and V) per tile instead of storing them: (1) per-tile column
max and sum of exp of K; (2) the tiles combine those into the softmax
statistics, form Ks exactly as the TPU rounds it and add their Ksᵀ·V
partial into an fp32 (B, C, C) context with atomics, which is then rounded
to bf16; (3) Q, its channel softmax, ·ctx, the reprojection and the
residual. Products run on the tensor cores (WMMA bf16, fp32 accumulate);
every Dense rounds its fp32 accumulator plus fp32 bias to bf16 as the
Pallas kernel does. Only the sum of exp(K) is combined across tiles in
another order than on the TPU (a ~1e-7 relative change before the bf16
rounding of Ks).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from transception_tpu_torch.ops.kernels import _build

NAME = "etb_attention"
REPLACES = "transception_tpu/ops/pallas/linear_attention_kernel.py:131"
TILE = 64
MAX_C = 384
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


def _check(x, weights):
    if x.dtype != torch.bfloat16 or x.dim() != 3:
        raise ValueError(f"{NAME} kernel takes a (B, N, C) bf16 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    C = x.shape[-1]
    if C % 16 or C > MAX_C:
        raise ValueError(f"{NAME} kernel needs C % 16 == 0 and C <= "
                         f"{MAX_C}, got C={C}")
    for w in weights:
        if tuple(w.shape) != (C, C):
            raise ValueError(f"{NAME} kernel needs (C, C) weights")


def etb_attention(x, ls, lb, wq, bq, wk, bk, wv, bv, wp, bp,
                  eps: float = 1e-5):
    """Wrapper: plain version for a CPU tensor or with the kernels off,
    the CUDA kernel otherwise, whose backward is autograd of the plain
    version."""
    if _build.plain(NAME, x):
        return etb_attention_plain(x, ls, lb, wq, bq, wk, bk, wv, bv, wp, bp,
                                   eps)
    return _build.with_plain_backward(
        lambda *a: _launch(*a, eps), lambda *a: etb_attention_plain(*a, eps),
        x, ls, lb, wq, bq, wk, bk, wv, bv, wp, bp)


def _launch(x, ls, lb, wq, bq, wk, bk, wv, bv, wp, bp, eps):
    _check(x, (wq, wk, wv, wp))
    global launches
    x = _build.aligned(x)
    B, N, C = x.shape
    ntiles = -(-N // TILE)
    dev = x.device
    stats = torch.empty((B, ntiles, 2, C), dtype=torch.float32, device=dev)
    ctx32 = torch.zeros((B, C, C), dtype=torch.float32, device=dev)
    ctx16 = torch.empty((B, C, C), dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(x)
    w = [_build.bf16(t) for t in (wq, wk, wv, wp)]
    v = [_build.f32(t) for t in (ls, lb, bq, bk, bv, bp)]
    lib = _build.load(NAME)
    fn = lib.etb_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    P = _build.ptr
    rc = fn(P(x), P(v[0]), P(v[1]), P(w[0]), P(v[2]), P(w[1]), P(v[3]),
            P(w[2]), P(v[4]), P(w[3]), P(v[5]), P(stats), P(ctx32),
            P(ctx16), P(out), B, N, C, eps, _build.stream_of(x))
    _build.check(rc, NAME)
    launches += 1
    _build.tally(NAME, tuple(x.shape))
    return out
