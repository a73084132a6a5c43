"""Fused MixFFN_skip with the caller's LayerNorm and the residual folded in,
and its backward.

K2 replaces transception_tpu/ops/pallas/mixffn_kernel.py:342
`fused_mixffn_ln_skip` (pallas_call at :361): x + fc2(GELU(LN(dw3x3(h) +
h))), h = fc1(groupLN(x)), on the ETB maps (B, 56², 64) hidden 256,
(B, 28², 128) hidden 512 and (B, 14², 320) hidden 1280 (groups = 1), and in
the flash train mode also on the MHCA maps and the bridge scales, where the
bridge's norm2 folds in as a grouped LN (groups 2 and 5, 64 channels each).
(On the TPU the 14² pair runs in XLA, mixffn_kernel.py:35-70; Hopper has
no such limit.) K11 replaces its backward, mixffn_kernel.py:659
`fused_mixffn_ln_skip_bwd` (pallas_call at :682). The two form one
torch.autograd.Function.

K2 bound on the H100: bytes. HBM sees x once in and once out (~26 MB at
(32, 3136, 64)); the 4x hidden state never leaves the chip.

K2 design (csrc/mixffn.cu): one block per (map row, batch) keeps the row's
hidden state in shared memory. fc1 is recomputed over a one-row halo
(three normalised map rows) in 64-channel chunks instead of exchanged
between blocks, which makes the rows independent; h is rounded to bf16
before the depthwise taps as on the TPU (so the halo is exact), the conv
output is rounded, y = d + h is summed in fp32, LN over hidden and an
exact-erf GELU (erfc form, as jax.nn.gelu) follow, then fc2 on the tensor
cores, the bias, one rounding and the residual. The depthwise weight is
rounded to bf16 as the Pallas kernel does. The caller's LN is taken per
group of C/groups channels.

K11 bound on the H100: operations at the train shapes (at (24, 56², 64,
256): ≈ 12·N·C·hidden = 1.5e10 flops, 0.015 ms, against ≈ 29 MB of bf16
traffic, 0.009 ms).

K11 design (csrc/mixffn_bwd.cu): one block per (2 map rows, group of batch
rows) recomputes the forward over a two-row halo (dx at row r needs dd at
r±1, which needs h at r±2) from x alone, and walks the hidden width in
32-channel chunks three times: the hidden LN's statistics, the statistics
of its backward, then dd, dh (the conv transpose as a correlation of dd
with the same taps) and the chunk's weight gradients. The hidden state
stays in shared memory. Blocks run in parallel, so the TPU's accumulation
of the weight gradients across its sequential grid becomes one fp32
partial per block, added in a fixed order by a second kernel (no atomics,
the same result in every run); the batch rows per block are chosen so the
partials stay under BWD_PARTIAL_BYTES. The products run on the tensor
cores with bf16 operands (h, a and the LN output are bf16 in the forward
too; dh is rounded to bf16 as an operand), accumulation is fp32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from transception_tpu_torch.ops.common import gelu, group_ln
from transception_tpu_torch.ops.kernels import _build

NAME = "mixffn"
REPLACES = "transception_tpu/ops/pallas/mixffn_kernel.py:342"
BWD_NAME = "mixffn_bwd"
BWD_REPLACES = "transception_tpu/ops/pallas/mixffn_kernel.py:659"
SMEM_LIMIT = 232448  # bytes a block may opt into on sm_90
BWD_PARTIAL_BYTES = 256 << 20  # K11's per-block weight-gradient partials
launches = 0
bwd_launches = 0


def mixffn_plain(x, w1, b1, dw, dwb, ls, lb, w2, b2, *, s: int,
                 pre_ln=None, residual: bool = False, eps: float = 1e-5):
    """Plain MixFFN_skip with the Pallas kernel's rounding points
    (mixffn.py:33 _reference_impl, :122 _reference_impl_ln; the depthwise
    weight rounded to the compute dtype as in mixffn_kernel.py:333).
    Weights are torch layouts: w1 (hidden, C), dw (hidden, 1, 3, 3),
    w2 (C, hidden). pre_ln = (scale, bias, groups, eps) with the (C,)-tiled
    scale and bias, or None."""
    dt = x.dtype
    B, N, C = x.shape
    hid = w1.shape[0]
    xin = x
    if pre_ln is not None:
        lts, ltb, groups, peps = pre_ln
        xin = group_ln(x, lts, ltb, groups, peps)
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
    """Plain version of the folded kernel: x + mixffn(groupLN(x)), with the
    caller's (C/groups,) LN scale and bias."""
    return mixffn_plain(x, w1, b1, dw, dwb, ls, lb, w2, b2, s=s,
                        pre_ln=(lts.repeat(groups), ltb.repeat(groups),
                                groups, eps_ln),
                        residual=True, eps=eps)


def mixffn_ln_skip_bwd_plain(x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2,
                             g, *, s: int, groups: int = 1,
                             eps_ln: float = 1e-5, eps: float = 1e-5):
    """Plain backward of x + mixffn(groupLN(x)) for cotangent g, with the
    Pallas backward's math (mixffn_kernel.py:479-653): fp32 throughout, the
    dtype casts passed straight through, the forward recomputed with h, d
    and the LN output rounded where the kernel rounds them and the
    depthwise weight in the compute dtype (:735). lts/ltb are the (C,)-
    tiled scale and bias. Returns the grads of (x, lts, ltb, w1, b1, dw,
    dwb, ls, lb, w2, b2) in their torch layouts: dx in x's dtype, the rest
    in the parameters' dtypes."""
    f32, dt = torch.float32, x.dtype
    B, N, C = x.shape
    hid = w1.shape[0]
    gsz = C // groups
    xf, gf = x.to(f32), g.to(f32)
    w1f, w2f = w1.to(dt).to(f32), w2.to(dt).to(f32)
    dwk = dw.to(dt).to(f32)
    lsf, lbf, ltsf = ls.to(f32), lb.to(f32), lts.to(f32)

    # Forward recompute.
    xr = xf.reshape(B, N, groups, gsz)
    mu = xr.mean(-1, keepdim=True)
    inv = torch.rsqrt((xr * xr).mean(-1, keepdim=True) - mu * mu + eps_ln)
    yhx = (xr - mu) * inv
    xn = (yhx.reshape(B, N, C) * ltsf + ltb.to(f32)).to(dt).to(f32)
    h = (xn @ w1f.t() + b1.to(f32)).to(dt).to(f32)
    hm = h.reshape(B, s, s, hid).permute(0, 3, 1, 2)
    d = F.conv2d(hm, dwk, dwb.to(f32), padding=1, groups=hid)
    d = d.permute(0, 2, 3, 1).reshape(B, N, hid).to(dt).to(f32)
    y = d + h
    muy = y.mean(-1, keepdim=True)
    invy = torch.rsqrt((y * y).mean(-1, keepdim=True) - muy * muy + eps)
    yh = (y - muy) * invy
    z = (yh * lsf + lbf).to(dt).to(f32)
    half1e = 0.5 * (1.0 + torch.erf(z * 2.0 ** -0.5))
    a = (z * half1e).to(dt).to(f32)
    gp = half1e + z * torch.exp(-0.5 * z * z) * (2.0 * torch.pi) ** -0.5

    # Backward through fc2, GELU and the hidden LN.
    da = gf @ w2f
    dz = da * gp
    dyh = dz * lsf
    dy = invy * (dyh - dyh.mean(-1, keepdim=True)
                 - yh * (dyh * yh).mean(-1, keepdim=True))
    # The conv transpose: a correlation of the padded dd with the taps.
    ddp = F.pad(dy.reshape(B, s, s, hid).permute(0, 3, 1, 2), (1, 1, 1, 1))
    hp = F.pad(hm, (1, 1, 1, 1))
    dhc = torch.zeros_like(hm)
    ddw = torch.zeros(hid, 3, 3, dtype=f32, device=x.device)
    ddm = ddp[:, :, 1:1 + s, 1:1 + s]
    for di in range(3):
        for dj in range(3):
            tap = dwk[:, 0, di, dj].reshape(1, hid, 1, 1)
            dhc += ddp[:, :, 2 - di:2 - di + s, 2 - dj:2 - dj + s] * tap
            ddw[:, di, dj] = (ddm * hp[:, :, di:di + s, dj:dj + s]).sum(
                (0, 2, 3))
    dh = dy + dhc.permute(0, 2, 3, 1).reshape(B, N, hid)

    # Backward through fc1 and the group LN, plus the residual path.
    dxn = dh @ w1f
    dyhx = (dxn * ltsf).reshape(B, N, groups, gsz)
    dx = inv * (dyhx - dyhx.mean(-1, keepdim=True)
                - yhx * (dyhx * yhx).mean(-1, keepdim=True))
    dx = dx.reshape(B, N, C) + gf

    def flat(t):
        return t.reshape(-1, t.shape[-1])

    grads = (dx.to(dt),
             (dxn * yhx.reshape(B, N, C)).sum((0, 1)), dxn.sum((0, 1)),
             flat(dh).t() @ flat(xn), dh.sum((0, 1)),
             ddw.reshape(hid, 1, 3, 3), dy.sum((0, 1)),
             (dz * yh).sum((0, 1)), dz.sum((0, 1)),
             flat(gf).t() @ flat(a), gf.sum((0, 1)))
    params = (x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2)
    return tuple(gr.to(p.dtype) for gr, p in zip(grads, params))


def smem_bytes(s: int, C: int, hid: int) -> int:
    """Shared memory of one K2 block (mirrors mixffn_smem_bytes in the .cu)."""
    sp = -(-s // 16) * 16
    return 3 * sp * C * 2 + max(3 * sp * 64, sp * C) * 4 + sp * hid * 6


def bwd_smem_bytes(s: int, C: int) -> int:
    """Shared memory of one K11 block (mirrors make_geo in mixffn_bwd.cu:
    2 centre rows, 32-channel chunks, 8 warps)."""
    def pad16(n):
        return -(-n // 16) * 16

    def up(b):
        return -(-b // 128) * 128

    R, HC, NW = 2, 32, 8
    th, ty, tcp = (R + 4) * s, (R + 2) * s, pad16(R * s)
    thp, typ = pad16(max(th, 2 * s + tcp)), pad16(max(ty, s + tcp))
    return (up(thp * C * 2) + up(typ * C * 2) + up(thp * HC * 2)
            + up(typ * HC * 4) + up(tcp * C * 4) + 2 * up(tcp * HC * 2)
            + up(typ * 16) + up(NW * 256 * 4)
            + up(max(13 * NW * 32, 3 * NW * C) * 4))


def partial_floats(C: int, hid: int) -> int:
    """Floats of one K11 block's gradient partial (mixffn_bwd.cu)."""
    return (2 * hid * C + 13 * hid + 3 * C + 63) // 64 * 64


def _check(x, s, hid, groups):
    if x.dtype != torch.bfloat16 or x.dim() != 3:
        raise ValueError(f"{NAME} kernel takes a (B, N, C) bf16 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    B, N, C = x.shape
    if N != s * s:
        raise ValueError(f"{NAME} kernel needs a square s*s map, N={N}")
    if groups < 1 or C % groups:
        raise ValueError(f"{NAME} kernel: {groups} LN groups do not divide "
                         f"C={C}")
    if C % 16 or hid % 64:
        raise ValueError(f"{NAME} kernel needs C % 16 == 0 and "
                         f"hidden % 64 == 0, got C={C}, hidden={hid}")
    if smem_bytes(s, C, hid) > SMEM_LIMIT:
        raise ValueError(f"{NAME} kernel: map row (s={s}, C={C}, "
                         f"hidden={hid}) exceeds shared memory")


def _launch(x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2, s, groups, eps_ln,
            eps):
    """K2 on the card; lts/ltb are (C,)-tiled."""
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
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    rc = fn(*[_build.ptr(t) for t in args], B, s, C, hid, groups, eps_ln,
            eps, _build.stream_of(x))
    _build.check(rc, NAME)
    launches += 1
    return out


def _launch_bwd(x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2, g, s, groups,
                eps_ln, eps):
    """K11 on the card; lts/ltb are (C,)-tiled."""
    hid = w1.shape[0]
    _check(x, s, hid, groups)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"{BWD_NAME} kernel needs g like x, got "
                         f"{tuple(g.shape)} {g.dtype}")
    B, N, C = x.shape
    if bwd_smem_bytes(s, C) > SMEM_LIMIT:
        raise ValueError(f"{BWD_NAME} kernel: map rows (s={s}, C={C}) "
                         f"exceed shared memory")
    global bwd_launches
    x, g = _build.aligned(x), _build.aligned(g)
    pf = partial_floats(C, hid)
    rows = -(-s // 2)
    per_group = rows * pf * 4
    bpb = -(-B // max(1, min(B, BWD_PARTIAL_BYTES // per_group)))
    blocks = rows * -(-B // bpb)
    dx = torch.empty_like(x)
    part = torch.empty(blocks, pf, device=x.device, dtype=torch.float32)
    out = torch.empty(pf, device=x.device, dtype=torch.float32)
    bf, f32 = _build.bf16, _build.f32
    args = (x, g, f32(lts), f32(ltb), bf(w1), f32(b1),
            bf(dw.reshape(hid, 9)), f32(dwb), f32(ls), f32(lb), bf(w2), dx,
            part, out)
    fn = _build.load(BWD_NAME).mixffn_ln_skip_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    rc = fn(*[_build.ptr(t) for t in args], B, s, C, hid, groups, bpb,
            eps_ln, eps, _build.stream_of(x))
    _build.check(rc, BWD_NAME)
    bwd_launches += 1
    sizes = (hid * C, C * hid, hid, 9 * hid, hid, hid, hid, C, C, C)
    dw1, dw2, db1, ddw, ddwb, dls, dlb, db2, dlts, dltb = torch.split(
        out[:sum(sizes)], sizes)
    grads = (dlts, dltb, dw1.view(hid, C), db1, ddw.view(hid, 1, 3, 3), ddwb,
             dls, dlb, dw2.view(C, hid), db2)
    params = (lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2)
    return (dx,) + tuple(gr.to(p.dtype) for gr, p in zip(grads, params))


def mixffn_ln_skip_bwd(x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2, g, *,
                       s: int, groups: int = 1, eps_ln: float = 1e-5,
                       eps: float = 1e-5):
    """K11 wrapper: the grads of (x, lts, ltb, w1, ..., b2) for cotangent g,
    lts/ltb (C,)-tiled; the plain version for a CPU tensor or with the
    kernel off."""
    if _build.plain(NAME, x):
        return mixffn_ln_skip_bwd_plain(x, lts, ltb, w1, b1, dw, dwb, ls, lb,
                                        w2, b2, g, s=s, groups=groups,
                                        eps_ln=eps_ln, eps=eps)
    return _launch_bwd(x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2, g, s,
                       groups, eps_ln, eps)


class MixFFN(torch.autograd.Function):
    """K2 forward and K11 backward (the plain versions on the CPU) of
    x + mixffn(groupLN(x)) with the (C,)-tiled LN scale and bias."""

    @staticmethod
    def forward(ctx, x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2, s, groups,
                eps_ln, eps):
        params = (lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2)
        if x.device.type == "cpu":
            out = mixffn_plain(x, *params[2:], s=s,
                               pre_ln=(lts, ltb, groups, eps_ln),
                               residual=True, eps=eps)
        else:
            out = _launch(x, *params, s, groups, eps_ln, eps)
        ctx.save_for_backward(x, *params)
        ctx.cfg = (s, groups, eps_ln, eps)
        return out

    @staticmethod
    def backward(ctx, g):
        s, groups, eps_ln, eps = ctx.cfg
        saved = ctx.saved_tensors
        if saved[0].device.type == "cpu":
            grads = mixffn_ln_skip_bwd_plain(*saved, g, s=s, groups=groups,
                                             eps_ln=eps_ln, eps=eps)
        else:
            grads = _launch_bwd(*saved, g, s, groups, eps_ln, eps)
        return grads + (None,) * 4


def mixffn_ln_skip(x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2, *, s: int,
                   groups: int = 1, eps_ln: float = 1e-5, eps: float = 1e-5):
    """x + mixffn(LN(x)): plain version for a CPU tensor or with the kernel
    off, else K2 forward and K11 backward (MixFFN). lts/ltb are the
    caller's (C/groups,) LN scale and bias."""
    if _build.plain(NAME, x):
        return mixffn_ln_skip_plain(x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2,
                                    b2, s=s, groups=groups, eps_ln=eps_ln,
                                    eps=eps)
    return MixFFN.apply(x, lts.repeat(groups), ltb.repeat(groups), w1, b1,
                        dw, dwb, ls, lb, w2, b2, s, groups, eps_ln, eps)
