"""Fused MixFFN_skip with the caller's LayerNorm and the residual folded in.

Replaces transception_tpu/ops/pallas/mixffn_kernel.py:342
`fused_mixffn_ln_skip` (pallas_call at :361): x + fc2(GELU(LN(dw3x3(h) +
h))), h = fc1(LN(x)), groups = 1, on the ETB maps (B, 56², 64) hidden 256,
(B, 28², 128) hidden 512 and (B, 14², 320) hidden 1280. (On the TPU the 14²
pair runs in XLA, mixffn_kernel.py:35-70; Hopper has no such limit.)

Bound on the H100: bytes. HBM sees x once in and once out (~26 MB at
(32, 3136, 64)); the 4x hidden state never leaves the chip.

Design (csrc/mixffn.cu): one block per (map row, batch) keeps the row's
hidden state in shared memory. fc1 is recomputed over a one-row halo
(three normalised map rows) in 64-channel chunks instead of exchanged
between blocks, which makes the rows independent; h is rounded to bf16
before the depthwise taps as on the TPU (so the halo is exact), the conv
output is rounded, y = d + h is summed in fp32, LN over hidden and an
exact-erf GELU (erfc form, as jax.nn.gelu) follow, then fc2 on the tensor
cores, the bias, one rounding and the residual. The depthwise weight is
rounded to bf16 as the Pallas kernel does.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from transception_tpu_torch.ops.common import gelu, group_ln
from transception_tpu_torch.ops.kernels import _build

NAME = "mixffn"
REPLACES = "transception_tpu/ops/pallas/mixffn_kernel.py:342"
SMEM_LIMIT = 232448  # bytes a block may opt into on sm_90
launches = 0


def mixffn_plain(x, w1, b1, dw, dwb, ls, lb, w2, b2, *, s: int,
                 pre_ln=None, residual: bool = False, eps: float = 1e-5):
    """Plain MixFFN_skip with the Pallas kernel's rounding points
    (mixffn.py:33 _reference_impl, :122 _reference_impl_ln; the depthwise
    weight rounded to the compute dtype as in mixffn_kernel.py:333).
    Weights are torch layouts: w1 (hidden, C), dw (hidden, 1, 3, 3),
    w2 (C, hidden). pre_ln = (scale, bias, groups, eps) or None."""
    dt = x.dtype
    B, N, C = x.shape
    hid = w1.shape[0]
    xin = x
    if pre_ln is not None:
        pls, plb, groups, peps = pre_ln
        xin = group_ln(x, pls.repeat(groups), plb.repeat(groups), groups,
                        peps)
    h = F.linear(xin.float(), w1.to(dt).float(), b1.float()).to(dt)
    hm = h.float().reshape(B, s, s, hid).permute(0, 3, 1, 2)
    d = F.conv2d(hm, dw.to(dt).float(), dwb.float(), padding=1, groups=hid)
    d = d.permute(0, 2, 3, 1).reshape(B, N, hid).to(dt)
    y = d.float() + h.float()
    mean = y.mean(-1, keepdim=True)
    var = (y * y).mean(-1, keepdim=True) - mean * mean
    a = ((y - mean) * torch.rsqrt(var + eps) * ls.float()
         + lb.float()).to(dt)
    a = gelu(a)
    out = F.linear(a.float(), w2.to(dt).float(), b2.float()).to(dt)
    if residual:
        out = (out.float() + x.float()).to(dt)
    return out


def mixffn_ln_skip_plain(x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2, *,
                         s: int, groups: int = 1, eps_ln: float = 1e-5,
                         eps: float = 1e-5):
    """Plain version of the folded kernel: x + mixffn(groupLN(x))."""
    return mixffn_plain(x, w1, b1, dw, dwb, ls, lb, w2, b2, s=s,
                        pre_ln=(lts, ltb, groups, eps_ln), residual=True,
                        eps=eps)


def smem_bytes(s: int, C: int, hid: int) -> int:
    """Shared memory of one block (mirrors mixffn_smem_bytes in the .cu)."""
    sp = -(-s // 16) * 16
    return 3 * sp * C * 2 + max(3 * sp * 64, sp * C) * 4 + sp * hid * 6


def _check(x, s, hid, groups):
    if x.dtype != torch.bfloat16 or x.dim() != 3:
        raise ValueError(f"{NAME} kernel takes a (B, N, C) bf16 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    B, N, C = x.shape
    if N != s * s:
        raise ValueError(f"{NAME} kernel needs a square s*s map, N={N}")
    if groups != 1:
        raise ValueError(f"{NAME} kernel folds a groups=1 LayerNorm only")
    if C % 16 or hid % 64:
        raise ValueError(f"{NAME} kernel needs C % 16 == 0 and "
                         f"hidden % 64 == 0, got C={C}, hidden={hid}")
    if smem_bytes(s, C, hid) > SMEM_LIMIT:
        raise ValueError(f"{NAME} kernel: map row (s={s}, C={C}, "
                         f"hidden={hid}) exceeds shared memory")


def mixffn_ln_skip(x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2, *, s: int,
                   groups: int = 1, eps_ln: float = 1e-5, eps: float = 1e-5):
    """x + mixffn(LN(x)): plain version for a CPU tensor or with the
    kernels off, the CUDA kernel otherwise. lts/ltb are the caller's
    (C/groups,) LN scale and bias."""
    if _build.plain(x):
        return mixffn_ln_skip_plain(x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2,
                                    b2, s=s, groups=groups, eps_ln=eps_ln,
                                    eps=eps)
    hid = w1.shape[0]
    _check(x, s, hid, groups)
    global launches
    x = _build.aligned(x)
    B, N, C = x.shape
    out = torch.empty_like(x)
    bf, f32 = _build.bf16, _build.f32
    args = (x, f32(lts), f32(ltb), bf(w1), f32(b1),
            bf(dw.reshape(hid, 9)), f32(dwb), f32(ls), f32(lb), bf(w2),
            f32(b2), out)
    fn = _build.load(NAME).mixffn_ln_skip
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    rc = fn(*[_build.ptr(t) for t in args], B, s, C, hid, eps_ln, eps,
            _build.stream_of(x))
    _build.check(rc, NAME)
    launches += 1
    return out
