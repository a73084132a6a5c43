"""Fused patch expand + grouped LayerNorm (pre-shuffle order).

Replaces transception_tpu/ops/pallas/expand_kernel.py:233
`fused_patch_expand` (pallas_call at :255): y = x @ W (C -> p²·c), rounded
to bf16, then a LayerNorm per c-wide group, out (B, N, p²·c) before the
pixel shuffle, which stays a PyTorch reshape as it stays XLA on the TPU.
On the serving path: the p = 2 expanders of decoders 3/2/1, (B, 49, 512)
-> 1024, (B, 196, 320) -> 640 and (B, 784, 128) -> 256; the x4 expander
of decoder 0 takes it too when logits are asked for.

Bound on the H100: bytes at these shapes (x in, twice its width out; ~2
FLOP per weight per token is far below the tensor cores' rate).

Design (csrc/patch_expand.cu): one block per (32 tokens, group). The
group's (32, c) product runs on the tensor cores into fp32 shared memory;
one warp per token rounds, normalises (fp32 statistics, flax's E[y²] −
E[y]² variance) and writes its c-wide output slice. x is read once per
group (p² = 4 times, from L2); the output leaves once.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from transception_tpu_torch.ops.kernels import _build

NAME = "patch_expand"
REPLACES = "transception_tpu/ops/pallas/expand_kernel.py:233"
SMEM_LIMIT = 232448  # bytes a block may opt into on sm_90
launches = 0


def patch_expand_plain(x, w, ls, lb, *, p: int, c: int, eps: float = 1e-5):
    """Plain version with the Pallas kernel's rounding points. x (B, N, C);
    w (p²·c, C) torch Linear layout; -> (B, N, p²·c) in x's dtype."""
    dt = x.dtype
    B, N, C = x.shape
    y = F.linear(x.float(), w.to(dt).float()).to(dt).float()
    y = y.reshape(B, N, p * p, c)
    mean = y.mean(-1, keepdim=True)
    var = (y * y).mean(-1, keepdim=True) - mean * mean
    yn = (y - mean) * torch.rsqrt(var + eps) * ls.float() + lb.float()
    return yn.to(dt).reshape(B, N, p * p * c)


def _check(x, w, p, c):
    if x.dtype != torch.bfloat16 or x.dim() != 3:
        raise ValueError(f"{NAME} kernel takes a (B, N, C) bf16 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    C = x.shape[-1]
    if C % 16 or c % 16 or tuple(w.shape) != (p * p * c, C):
        raise ValueError(f"{NAME} kernel needs C % 16 == c % 16 == 0 and "
                         f"w of shape (p²c, C), got C={C}, c={c}, "
                         f"w {tuple(w.shape)}")
    if 32 * (2 * C + 4 * c) > SMEM_LIMIT:
        raise ValueError(f"{NAME} kernel: C={C}, c={c} exceed shared memory")


def patch_expand(x, w, ls, lb, *, p: int, c: int, eps: float = 1e-5):
    """Wrapper: plain version for a CPU tensor or with the kernels off,
    the CUDA kernel otherwise."""
    if _build.plain(NAME, x):
        return patch_expand_plain(x, w, ls, lb, p=p, c=c, eps=eps)
    _build.forward_only(NAME, x, w, ls, lb)
    _check(x, w, p, c)
    global launches
    x = _build.aligned(x)
    B, N, C = x.shape
    out = torch.empty((B, N, p * p * c), dtype=x.dtype, device=x.device)
    args = (x, _build.bf16(w), _build.f32(ls), _build.f32(lb), out)
    fn = _build.load(NAME).patch_expand
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    rc = fn(*[_build.ptr(t) for t in args], B * N, C, c, p * p, eps,
            _build.stream_of(x))
    _build.check(rc, NAME)
    launches += 1
    return out
