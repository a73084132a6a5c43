"""One whole MHCA block: CPE -> LN1 -> factorized attention + CRPE -> proj
-> residual -> LN2 -> MixFFN_skip -> residual.

Replaces transception_tpu/ops/pallas/mhca_block_kernel.py:200
`fused_mhca_block` (pallas_call at :285). On the serving path: every
block of MHCA stages 2 and 3, (B, 28², 64) 8 heads hidden 256 (9 blocks
per forward) and (B, 14², 128) 8 heads hidden 512 (24 blocks). Like the
TPU kernel it runs where the map side is even; stage 4 (7²) runs the
block's modules, with the linear-attention kernel for its attention.

Bound on the H100: bytes (x in and out once, ~13 MB per stage-2 block at
B = 32, against ~8 GFLOP, of which the four products are tensor-core work).

Design (csrc/mhca_block.cu): the TPU kernel holds one whole (s², C) map
and its 4x hidden state in VMEM; on Hopper that does not fit one block's
shared memory (a stage-2 map's fp32 hidden state alone is 800 KB), and
softmax(K) and the per-head contexts reduce over all tokens. So the block
runs as four kernels on one stream, one counted launch: (1) per 32
tokens, CPE, LN1 and the q|k|v product on the tensor cores, written as
bf16 rows; (2) per (head, batch), the column softmax of K over the tokens
and the d x d context, from shared memory (the TPU's block-diagonal mask
of the full C x C Gram becomes a per-head product); (3) per 32 tokens,
Q · context, the 3/5/7 CRPE windows over V read straight from the q|k|v
rows, the proj product on the tensor cores and the residual; (4) the
MixFFN kernel (csrc/mixffn.cuh) with LN2 (eps 1e-6) and the residual.
Rounding follows the Pallas kernel: weights rounded to bf16, fp32
accumulation, bf16 wherever a flax Dense or Conv emits its output.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from transception_tpu_torch.ops.common import group_ln
from transception_tpu_torch.ops.kernels import _build, mixffn

NAME = "mhca_block"
REPLACES = "transception_tpu/ops/pallas/mhca_block_kernel.py:200"
SMEM_LIMIT = 232448  # bytes a block may opt into on sm_90
THREADS = 256        # threads per block of the context kernel
launches = 0


def _dwconv(xm, w, b, dt):
    """Depthwise conv of an NCHW fp32 map with the weight rounded to dt,
    'same' padding, fp32 bias; fp32 out."""
    k = w.shape[-1]
    return F.conv2d(xm, w.to(dt).float(), b.float(), padding=k // 2,
                    groups=xm.shape[1])


def _dense(t, w, b):
    """flax Dense rounding: bf16(bf16(t · w) + bf16(b)) in t's dtype."""
    dt = t.dtype
    o = F.linear(t.float(), w.to(dt).float()).to(dt)
    return (o.float() + b.to(dt).float()).to(dt)


def mhca_block_plain(x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, crpe_ws,
                     crpe_bs, wp, bp, ln2_s, ln2_b, w1, b1, dw, dwb, ls, lb,
                     w2, b2, *, s: int, heads: int, eps1: float = 1e-6,
                     eps2: float = 1e-6, eps: float = 1e-5):
    """Plain version with the Pallas kernel's rounding points
    (mhca_block.py:41 _reference_impl). x (B, s², C); torch layouts:
    cpe_w (C, 1, 3, 3), wqkv (3C, C), crpe_ws per window (chs, 1, k, k)
    in head-major channel order, wp (C, C); w1 .. b2 as MixFFNSkip.params().
    """
    dt = x.dtype
    B, N, C = x.shape
    d = C // heads
    xm = x.reshape(B, s, s, C).permute(0, 3, 1, 2).float()
    y = _dwconv(xm, cpe_w, cpe_b, dt).to(dt).float()
    x1 = (y + xm).to(dt).permute(0, 2, 3, 1).reshape(B, N, C)
    cur = group_ln(x1, ln1_s, ln1_b, 1, eps1)
    q, k, v = _dense(cur, wqkv, bqkv).split(C, dim=-1)
    ks = torch.softmax(k.float(), dim=1).to(dt)
    heads_of = (lambda t: t.float().reshape(B, N, heads, d))  # noqa: E731
    ctx = torch.einsum("bnhi,bnhj->bhij", heads_of(ks), heads_of(v)).to(dt)
    att = torch.einsum("bnhi,bhij->bnhj", heads_of(q), ctx.float())
    att = (att * d ** -0.5).to(dt).reshape(B, N, C)
    vm = v.reshape(B, s, s, C).permute(0, 3, 1, 2).float()
    segs = torch.split(vm, [w.shape[0] for w in crpe_ws], dim=1)
    conv_v = torch.cat([_dwconv(t, w, b, dt) for t, w, b in
                        zip(segs, crpe_ws, crpe_bs)], dim=1).to(dt)
    conv_v = conv_v.permute(0, 2, 3, 1).reshape(B, N, C)
    crpe = (q.float() * conv_v.float()).to(dt)
    a = (att.float() + crpe.float()).to(dt)
    x2 = (x1.float() + _dense(a, wp, bp).float()).to(dt)
    return mixffn.mixffn_ln_skip_plain(x2, ln2_s, ln2_b, w1, b1, dw, dwb, ls,
                                       lb, w2, b2, s=s, eps_ln=eps2, eps=eps)


def _check(x, s, heads, hid, crpe_ws):
    if x.dtype != torch.bfloat16 or x.dim() != 3:
        raise ValueError(f"{NAME} kernel takes a (B, N, C) bf16 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    B, N, C = x.shape
    if N != s * s or C % heads:
        raise ValueError(f"{NAME} kernel needs a square s*s map and C % "
                         f"heads == 0, got N={N}, s={s}, C={C}")
    d = C // heads
    if C % 16 or d > THREADS or len(crpe_ws) != 3 or \
            sum(w.shape[0] for w in crpe_ws) != C:
        raise ValueError(f"{NAME} kernel needs C % 16 == 0, a head dim of "
                         f"at most {THREADS} and three CRPE windows over "
                         f"all C channels")
    if (2 * N * d + THREADS) * 4 > SMEM_LIMIT or \
            32 * C * 6 + C * d * 4 > SMEM_LIMIT:
        raise ValueError(f"{NAME} kernel: (N={N}, C={C}, heads={heads}) "
                         f"exceeds shared memory")
    mixffn._check(x, s, hid, 1)


def mhca_block(x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, crpe_ws, crpe_bs,
               wp, bp, ln2_s, ln2_b, w1, b1, dw, dwb, ls, lb, w2, b2, *,
               s: int, heads: int, eps1: float = 1e-6, eps2: float = 1e-6,
               eps: float = 1e-5):
    """Wrapper: plain version for a CPU tensor or with the kernels off,
    the CUDA kernels otherwise (one counted launch per block), whose
    backward is autograd of the plain version."""
    kw = dict(s=s, heads=heads, eps1=eps1, eps2=eps2, eps=eps)
    if _build.plain(NAME, x):
        return mhca_block_plain(
            x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, crpe_ws, crpe_bs, wp,
            bp, ln2_s, ln2_b, w1, b1, dw, dwb, ls, lb, w2, b2, **kw)
    nw = len(crpe_ws)

    def unflat(fn):
        # The flat tensors back into the wrapper's arguments (the CRPE
        # weights and biases are lists).
        def call(*a):
            return fn(*a[:7], list(a[7:7 + nw]), list(a[7 + nw:7 + 2 * nw]),
                      *a[7 + 2 * nw:], **kw)
        return call

    return _build.with_plain_backward(
        unflat(_launch), unflat(mhca_block_plain),
        x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, *crpe_ws, *crpe_bs, wp,
        bp, ln2_s, ln2_b, w1, b1, dw, dwb, ls, lb, w2, b2)


def _launch(x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, crpe_ws, crpe_bs, wp,
            bp, ln2_s, ln2_b, w1, b1, dw, dwb, ls, lb, w2, b2, *, s, heads,
            eps1, eps2, eps):
    hid = w1.shape[0]
    _check(x, s, heads, hid, crpe_ws)
    global launches
    x = _build.aligned(x)
    B, N, C = x.shape
    d = C // heads
    bf, f32 = _build.bf16, _build.f32
    x1, x2, out = (torch.empty_like(x) for _ in range(3))
    qkv = torch.empty((B, N, 3 * C), dtype=x.dtype, device=x.device)
    ctx = torch.empty((B, heads, d, d), dtype=torch.float32, device=x.device)
    ptrs = (x, f32(cpe_w), f32(cpe_b), f32(ln1_s), f32(ln1_b), bf(wqkv),
            f32(bqkv), *(f32(w) for w in crpe_ws), *(f32(b) for b in crpe_bs),
            bf(wp), f32(bp), f32(ln2_s), f32(ln2_b), bf(w1), f32(b1),
            bf(dw.reshape(hid, 9)), f32(dwb), f32(ls), f32(lb), bf(w2),
            f32(b2), x1, qkv, ctx, x2, out)
    fn = _build.load(NAME).mhca_block
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 10 + [
        ctypes.c_float] * 4 + [ctypes.c_void_p]
    rc = fn(*[_build.ptr(t) for t in ptrs], B, s, C, heads, hid,
            *(w.shape[-1] for w in crpe_ws), crpe_ws[0].shape[0],
            crpe_ws[1].shape[0], eps1, eps2, eps, d ** -0.5,
            _build.stream_of(x))
    _build.check(rc, NAME)
    launches += 1
    _build.tally(NAME, tuple(x.shape))
    return out
