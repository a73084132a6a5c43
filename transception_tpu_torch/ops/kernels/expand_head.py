"""Fused x4 patch expand + grouped LayerNorm + 1x1 head + argmax.

Replaces transception_tpu/ops/pallas/expand_kernel.py:159
`fused_patch_expand_argmax` (pallas_call at :191): x (B, 3136, 64) @ W
(64 -> 16·64), bf16 rounding, LN per 64-wide group, bf16 head (64 -> 9)
plus bias, logits rounded to bf16, argmax with ties to the first class ->
class ids in pre-shuffle order (B, 3136, 16), or with `shuffle=(H, W)`
the pixel-shuffled class map (B, 4H, 4W) that the decoder returns
(decoder.py:196-201). bf16 only, as in JAX (decoder.py:165): fp32 models
take the plain conv + argmax.

Bound on the H100: operations. It writes 16 ids a token (~7 MB in all at
B = 32) against ~16 GFLOP of tensor-core products (~13 GFLOP useful) and
~1 G CUDA-core operations of LN.

Design (csrc/expand_head.cu): K7's expand body (csrc/expand_stages.cuh)
at c = 64 with a head epilogue in registers: each warp owns 16-token
strips over the whole group, the LN is the quad's shuffles, the
normalised bf16 y is re-packed into A fragments for the head product
against the bf16 head weight zero-padded to 16 classes (its fragments
loaded once per warp), and the argmax is taken in the quad. A token's ids
stay in registers until its last group and leave as four 4-byte stores,
in either layout. The argmax that JAX runs after the kernel and the
shuffle after that are fused, so neither the (B, N, 16·9) logits nor the
pre-shuffle ids reach device memory. The LN vectors and the head are read
in their own dtype (bf16 or fp32; the head weight rounded to bf16 on
load, as `.to(bf16)` rounds), so no cast is launched per call.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from transception_tpu_torch.ops.kernels import _build
from transception_tpu_torch.ops.kernels import patch_expand as pe

NAME = "expand_head"
REPLACES = "transception_tpu/ops/pallas/expand_kernel.py:159"
MAX_CLASSES = 16
P, WIDTH = 4, 64  # the x4 expand of 64-wide groups csrc/expand_head.cu takes
launches = 0


def shuffle_ids(ids, H: int, W: int, p: int = P):
    """(B, H·W, p²) ids in pre-shuffle order -> the (B, p·H, p·W) map."""
    B = ids.shape[0]
    return ids.reshape(B, H, W, p, p).permute(0, 1, 3, 2, 4).reshape(
        B, p * H, p * W)


def expand_head_plain(x, w, ls, lb, hw, hb, *, p: int, c: int,
                      eps: float = 1e-5, shuffle=None):
    """Plain version with the Pallas kernel's rounding points. x (B, N, C);
    w (p²·c, C) torch Linear layout; hw (n_class, c); -> (B, N, p²) uint8,
    or with shuffle=(H, W) (H·W = N) the (B, p·H, p·W) map."""
    dt = x.dtype
    B, N, C = x.shape
    y = F.linear(x.float(), w.to(dt).float()).to(dt).float()
    y = y.reshape(B, N, p * p, c)
    mean = y.mean(-1, keepdim=True)
    var = (y * y).mean(-1, keepdim=True) - mean * mean
    yn = ((y - mean) * torch.rsqrt(var + eps) * ls.float()
          + lb.float()).to(dt)
    logits = F.linear(yn.float(), hw.to(dt).float(), hb.float()).to(dt)
    ids = logits.float().argmax(-1).to(torch.uint8)
    return ids if shuffle is None else shuffle_ids(ids, *shuffle, p)


def plan(B: int, N: int, C: int, sm_count: int) -> dict:
    """K4's launch for x (B, N, C): K7's plan at p = 4, c = 64 with the
    groups split only in whole quads (patch_expand.plan, head=True)."""
    return pe.plan(B, N, C, WIDTH, P, sm_count, head=True)


def _check(x, w, hw, p, c, ls=None, lb=None, hb=None, shuffle=None):
    if x.dtype != torch.bfloat16 or x.dim() != 3:
        raise ValueError(f"{NAME} kernel takes a (B, N, C) bf16 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    C = x.shape[-1]
    if C % pe.DEPTH or C > pe.MAX_CIN or (p, c) != (P, WIDTH) or \
            tuple(w.shape) != (p * p * c, C):
        raise ValueError(f"{NAME} kernel needs p = {P}, c = {WIDTH}, C a "
                         f"multiple of {pe.DEPTH} up to {pe.MAX_CIN} and w "
                         f"of shape (p²c, C), got p={p}, C={C}, c={c}, "
                         f"w {tuple(w.shape)}")
    if hw.shape[0] > MAX_CLASSES or hw.shape[1] != c:
        raise ValueError(f"{NAME} kernel needs at most {MAX_CLASSES} "
                         f"classes and a (n_class, c) head")
    pe._check(x, w, p, c, ls, lb, shuffle)
    if hb is not None and (hw.dtype not in pe.LN_DTYPES or
                           hb.dtype != hw.dtype or
                           tuple(hb.shape) != (hw.shape[0],)):
        raise ValueError(f"{NAME} kernel takes a head weight and bias both "
                         f"bf16 or both fp32")


def expand_head(x, w, ls, lb, hw, hb, *, p: int, c: int,
                eps: float = 1e-5, shuffle=None):
    """Wrapper: plain version with the kernels off or where autograd
    records on the CPU, else the operator (the CUDA kernel; it has no
    backward). shuffle=(H, W): the (B, p·H, p·W) map."""
    if _build.plain(NAME, x):
        return expand_head_plain(x, w, ls, lb, hw, hb, p=p, c=c, eps=eps,
                                 shuffle=shuffle)
    _build.forward_only(NAME, x, w, ls, lb, hw, hb)
    return OP(x, w, ls, lb, hw, hb, p, c, eps,
              None if shuffle is None else list(shuffle))


def out_shape(x, p: int, shuffle=None) -> tuple:
    """K4's ids for x (B, N, C): pre-shuffle (B, N, p²), or the shuffled
    (B, p·H, p·W) map."""
    B, N, _ = x.shape
    return (B, N, p * p) if shuffle is None else (B, p * shuffle[0],
                                                  p * shuffle[1])


def _launch(x, w, ls, lb, hw, hb, p, c, eps, shuffle=None):
    """One counted launch of K4."""
    _check(x, w, hw, p, c, ls, lb, hb, shuffle)
    global launches
    x = _build.aligned(x)
    B, N, C = x.shape
    pl = plan(B, N, C, _build.sms(x))
    ids = torch.empty(out_shape(x, p, shuffle), dtype=torch.uint8,
                      device=x.device)
    args = (x, _build.weight(w, torch.bfloat16), ls.contiguous(),
            lb.contiguous(), hw.contiguous(), hb.contiguous(), ids)
    fn = _build.entry(NAME, "expand_head", [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
    f32 = torch.float32
    rc = fn(*[_build.ptr(t) for t in args], B * N, C, pl["splits"],
            hw.shape[0], N, N if shuffle is None else shuffle[1],
            int(shuffle is not None), int(ls.dtype == f32),
            int(hw.dtype == f32), eps, _build.stream_of(x))
    _build.check(rc, NAME)
    launches += 1
    _build.tally(NAME, tuple(x.shape), pe.layout(shuffle))
    return ids


OP = _build.define(
    NAME, "(Tensor x, Tensor w, Tensor ls, Tensor lb, Tensor hw, Tensor hb, "
    "int p, int c, float eps, int[]? shuffle) -> Tensor", _launch,
    lambda x, w, ls, lb, hw, hb, p, c, eps, shuffle: expand_head_plain(
        x, w, ls, lb, hw, hb, p=p, c=c, eps=eps, shuffle=shuffle),
    lambda x, w, ls, lb, hw, hb, p, c, eps, shuffle: x.new_empty(
        out_shape(x, p, shuffle), dtype=torch.uint8))
