"""Fused x4 patch expand + grouped LayerNorm + 1x1 head + argmax.

Replaces transception_tpu/ops/pallas/expand_kernel.py:159
`fused_patch_expand_argmax` (pallas_call at :191): x (B, 3136, 64) @ W
(64 -> 16·64), bf16 rounding, LN per 64-wide group, bf16 head (64 -> 9)
plus bias, logits rounded to bf16, argmax with ties to the first class ->
(B, 3136, 16) class ids in pre-shuffle order. bf16 only, as in JAX
(decoder.py:165): fp32 models take the plain conv + argmax.

Bound on the H100: bytes for what must move (x in, 16 ids per token out,
~7 MB at B = 32) against ~13 GFLOP of useful products, which puts the
operation bound (~13 µs) above the byte bound.

Design (csrc/expand_head.cu): one block per 64 tokens walks the 16 groups;
each group's (64, 64) expansion and its head product (against the head
weight zero-padded from 9 to 16 classes) run on the tensor cores, the LN
per token in fp32 between them. The argmax that JAX runs after the
kernel is fused, so the (B, N, 16·9) logits never reach device memory;
ids leave as one uint8 tile per block.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from transception_tpu_torch.ops.kernels import _build

NAME = "expand_head"
REPLACES = "transception_tpu/ops/pallas/expand_kernel.py:159"
MAX_CLASSES = 16
launches = 0


def expand_head_plain(x, w, ls, lb, hw, hb, *, p: int, c: int,
                      eps: float = 1e-5):
    """Plain version with the Pallas kernel's rounding points. x (B, N, C);
    w (p²·c, C) torch Linear layout; hw (n_class, c); -> (B, N, p²) uint8."""
    dt = x.dtype
    B, N, C = x.shape
    y = F.linear(x.float(), w.to(dt).float()).to(dt).float()
    y = y.reshape(B, N, p * p, c)
    mean = y.mean(-1, keepdim=True)
    var = (y * y).mean(-1, keepdim=True) - mean * mean
    yn = ((y - mean) * torch.rsqrt(var + eps) * ls.float()
          + lb.float()).to(dt)
    logits = F.linear(yn.float(), hw.to(dt).float(), hb.float()).to(dt)
    return logits.float().argmax(-1).to(torch.uint8)


def _check(x, w, hw, p, c):
    if x.dtype != torch.bfloat16 or x.dim() != 3:
        raise ValueError(f"{NAME} kernel takes a (B, N, C) bf16 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    C = x.shape[-1]
    if C % 16 or c % 16 or tuple(w.shape) != (p * p * c, C):
        raise ValueError(f"{NAME} kernel needs C % 16 == c % 16 == 0 and "
                         f"w of shape (p²c, C), got C={C}, c={c}, "
                         f"w {tuple(w.shape)}")
    if hw.shape[0] > MAX_CLASSES or hw.shape[1] != c:
        raise ValueError(f"{NAME} kernel needs at most {MAX_CLASSES} "
                         f"classes and a (n_class, c) head")


def expand_head(x, w, ls, lb, hw, hb, *, p: int, c: int,
                eps: float = 1e-5):
    """Wrapper: plain version for a CPU tensor or with the kernels off,
    the CUDA kernel otherwise."""
    if _build.plain(NAME, x):
        return expand_head_plain(x, w, ls, lb, hw, hb, p=p, c=c, eps=eps)
    _build.forward_only(NAME, x, w, ls, lb, hw, hb)
    _check(x, w, hw, p, c)
    global launches
    x = _build.aligned(x)
    B, N, C = x.shape
    ncls = hw.shape[0]
    ids = torch.empty((B, N, p * p), dtype=torch.uint8, device=x.device)
    bf, f32 = _build.bf16, _build.f32
    args = (x, bf(w), f32(ls), f32(lb), bf(hw), f32(hb), ids)
    fn = _build.load(NAME).expand_head
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    rc = fn(*[_build.ptr(t) for t in args], B * N, C, c, p * p, ncls, eps,
            _build.stream_of(x))
    _build.check(rc, NAME)
    launches += 1
    return ids
