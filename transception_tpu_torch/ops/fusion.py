"""Intra-stage feature fusion (IFF), PyTorch port of
transception_tpu/ops/fusion.py: CoordAtt, the published default ('coord'),
and the ablations' blocks (SE, SK, CBAM and its casa form, the CAM
modules, the Conv3d concatenations).

Behavioral reference: networks/MSTr.py — CoordAtt :1304-1348 (without the
hardcoded .cuda() of :1276), SE_Block :571-594, SK_Block :1054-1107, CBAM
:1128-1267, CAM modules :464-568, Conv3d concat variants :406-462,
:597-666. Maps are NHWC, the path axis of the 3-D variants explicit
(B, P, H, W, C). Parameter names are the reference torch keys the JAX
converter (convert/torch2flax.py) reads: SE's excitation.0/2, CBAM's
ca.se.0/2 and conv2d_bn_act.0/1, SK's fcs.i and conv_bn_ac.0/2, CAM's
channelAttention; the Conv3d kernels keep the JAX names conv3d_kernel
(O, C, P, 1, 1 as a torch Conv3d's) and conv3d_bias, which the converter
reads first.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from transception_tpu_torch.ops.common import Conv2d, Linear, gelu
from transception_tpu_torch.ops.conv import BatchNorm


def silu_sigmoid(x):
    """min(silu(x+3)/6, 1) — the reference's h-sigmoid (MSTr.py:1270-1277)."""
    return torch.clamp_max(F.silu(x + 3.0) / 6.0, 1.0)


def silu_swish(x):
    """x * silu_sigmoid(x) (MSTr.py:1279-1286)."""
    return x * silu_sigmoid(x)


class CoordAtt(nn.Module):
    """Coordinate attention (MSTr.py:1304-1348): pool along H and along W,
    a shared 1x1+BN+silu_swish trunk, per-axis sigmoid gates, then a 1x1
    out-projection to the next stage's width."""

    def __init__(self, inp: int, oup: int, reduction: int = 16,
                 dtype=torch.bfloat16):
        super().__init__()
        mip = max(8, inp // reduction)
        self.conv1 = Conv2d(inp, mip, 1, dtype=dtype)
        self.bn1 = BatchNorm(mip, dtype=dtype)
        self.conv_h = Conv2d(mip, inp, 1, dtype=dtype)
        self.conv_w = Conv2d(mip, inp, 1, dtype=dtype)
        self.conv_in_out = Conv2d(inp, oup, 1, dtype=dtype)

    def forward(self, x):
        B, H, W, C = x.shape
        x_h = x.mean(dim=2)  # (B, H, C), pooled over W
        x_w = x.mean(dim=1)  # (B, W, C), pooled over H
        y = torch.cat([x_h, x_w], dim=1)[:, :, None, :]
        y = silu_swish(self.bn1(self.conv1(y)))
        a_h = torch.sigmoid(self.conv_h(y[:, :H]))  # (B, H, 1, C)
        a_w = torch.sigmoid(self.conv_w(y[:, H:]))  # (B, W, 1, C)
        out = x * a_h * a_w[:, :, 0, :][:, None, :, :]
        return self.conv_in_out(out)


class SEBlock(nn.Module):
    """Squeeze-excitation and a 1x1 conv (MSTr.py:571-594): GAP -> fc/ReLU/
    fc/sigmoid scale -> conv1x1 -> ReLU(BN(.)) on the concatenated paths."""

    def __init__(self, in_ch: int, out_ch: int, r: int = 16,
                 dtype=torch.bfloat16):
        super().__init__()
        self.excitation = nn.Sequential(
            Linear(in_ch, in_ch // r, bias=False, dtype=dtype), nn.ReLU(),
            Linear(in_ch // r, in_ch, bias=False, dtype=dtype))
        self.conv = Conv2d(in_ch, out_ch, 1, dtype=dtype)
        self.bn = BatchNorm(out_ch, dtype=dtype)

    def forward(self, x):
        s = torch.sigmoid(self.excitation(x.mean(dim=(1, 2))))
        return F.relu(self.bn(self.conv(x * s[:, None, None, :])))


class SKBlock(nn.Module):
    """Selective-kernel fusion over the paths (MSTr.py:1054-1107): sum ->
    GAP -> fc -> per-path fc -> softmax over the paths -> weighted sum ->
    conv1x1 -> ReLU -> BN (conv_bn_ac, the reference's Sequential)."""

    def __init__(self, in_ch: int, out_ch: int, num_path: int = 3,
                 reduction: int = 16, L: int = 32, dtype=torch.bfloat16):
        super().__init__()
        d = max(L, in_ch // reduction)
        self.fc = Linear(in_ch, d, dtype=dtype)
        self.fcs = nn.ModuleList(Linear(d, in_ch, dtype=dtype)
                                 for _ in range(num_path))
        self.conv_bn_ac = nn.Sequential(
            Conv2d(in_ch, out_ch, 1, dtype=dtype), nn.ReLU(),
            BatchNorm(out_ch, dtype=dtype))

    def forward(self, xs: Sequence[torch.Tensor]):
        feats = torch.stack(list(xs), dim=0)  # (P, B, H, W, C)
        z = self.fc(feats.sum(0).mean(dim=(1, 2)))
        w = torch.stack([fc(z) for fc in self.fcs], dim=0)  # (P, B, C)
        w = torch.softmax(w.float(), dim=0).to(feats.dtype)
        v = (w[:, :, None, None, :] * feats).sum(0)
        return self.conv_bn_ac(v)


class ChannelAttentionCBAM(nn.Module):
    """CBAM channel gate (MSTr.py:1128-1146): one MLP (se) on the max- and
    the average-pooled vectors, summed, sigmoid."""

    def __init__(self, ch: int, reduction: int = 16, dtype=torch.bfloat16):
        super().__init__()
        self.se = nn.Sequential(
            Linear(ch, ch // reduction, bias=False, dtype=dtype), nn.ReLU(),
            Linear(ch // reduction, ch, bias=False, dtype=dtype))

    def forward(self, x):
        out = self.se(x.amax(dim=(1, 2))) + self.se(x.mean(dim=(1, 2)))
        return torch.sigmoid(out)[:, None, None, :]


class SpatialAttentionCBAM(nn.Module):
    """CBAM spatial gate (MSTr.py:1148-1165): channel max and mean, a k x k
    conv to one channel, sigmoid."""

    def __init__(self, kernel_size: int = 7, dtype=torch.bfloat16):
        super().__init__()
        self.conv = Conv2d(2, 1, kernel_size, padding=kernel_size // 2,
                           dtype=dtype)

    def forward(self, x):
        y = torch.cat([x.amax(-1, keepdim=True), x.mean(-1, keepdim=True)],
                      dim=-1)
        return torch.sigmoid(self.conv(y))


class CBAMBlock(nn.Module):
    """CBAM IFF (MSTr.py:1169-1211): x·ca -> (·sa) -> + x -> conv (no bias)
    -> BN -> ReLU (conv2d_bn_act)."""

    def __init__(self, in_ch: int, out_ch: int, use_sa: bool = True,
                 reduction: int = 16, kernel_size: int = 7,
                 dtype=torch.bfloat16):
        super().__init__()
        self.ca = ChannelAttentionCBAM(in_ch, reduction, dtype)
        self.sa = SpatialAttentionCBAM(kernel_size, dtype) if use_sa else None
        self.conv2d_bn_act = nn.Sequential(
            Conv2d(in_ch, out_ch, 1, bias=False, dtype=dtype),
            BatchNorm(out_ch, dtype=dtype), nn.ReLU())

    def forward(self, x):
        out = x * self.ca(x)
        if self.sa is not None:
            out = out * self.sa(out)
        return self.conv2d_bn_act(out + x)


class CBAMBlockCasa(CBAMBlock):
    """CBAM with the 'res'/'out' spatial-gate interface of the casa
    backbone (MSTr.py:1213-1267): on the concatenated paths, the spatial
    gate of path 0 (the residual path, 'res') or of the gated output
    ('out'). Takes the list of paths."""

    def __init__(self, in_ch: int, out_ch: int, use_sa: bool = True,
                 reduction: int = 16, kernel_size: int = 7,
                 inter: str = "res", dtype=torch.bfloat16):
        super().__init__(in_ch, out_ch, use_sa and inter in ("res", "out"),
                         reduction, kernel_size, dtype)
        self.inter = inter

    def forward(self, xs: Sequence[torch.Tensor]):
        cat = torch.cat(list(xs), dim=-1)
        out = cat * self.ca(cat)
        if self.sa is not None:
            out = out * self.sa(xs[0] if self.inter == "res" else out)
        return self.conv2d_bn_act(out + cat)


class CAMModule(nn.Module):
    """Channel attention across the paths (MSTr.py:464-509), the
    max-energy form: per (batch, channel) a P x P softmax over the
    flattened map. x (B, P, H, W, C)."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.zeros_(self.gamma)

    def forward(self, x):
        B, P, H, W, C = x.shape
        dt = x.dtype
        q = x.permute(0, 4, 1, 2, 3).reshape(B, C, P, H * W).float()
        energy = torch.matmul(q, q.transpose(-1, -2))  # fp32 accumulation
        energy = energy.amax(-1, keepdim=True) - energy
        attn = torch.softmax(energy, dim=-1).to(dt).float()
        out = torch.matmul(attn, q).to(dt)
        out = out.reshape(B, C, P, H, W).permute(0, 2, 3, 4, 1)
        return self.gamma.to(dt) * out + x


class CAMFactorizedModule(nn.Module):
    """Factorized (linear) channel attention over the flattened path axis
    (MSTr.py:512-568), 8 heads: the tokens are the P·H·W positions of
    x.reshape(B, C, -1), k softmaxed over the tokens, out = scale·q·(kᵀv),
    a projection, gamma·out + x. The reference's unused crpe member is
    left out."""

    def __init__(self, ch: int, num_heads: int = 8, dtype=torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.gamma = nn.Parameter(torch.zeros(1))
        self.qkv = Linear(ch, 3 * ch, dtype=dtype)
        self.proj = Linear(ch, ch, dtype=dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.zeros_(self.gamma)

    def forward(self, x):
        B, P, H, W, C = x.shape
        h = self.num_heads
        t = x.permute(0, 4, 1, 2, 3).reshape(B, C, P * H * W).transpose(1, 2)
        N = t.shape[1]
        qkv = self.qkv(t).reshape(B, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        ks = torch.softmax(k.float(), dim=2).to(k.dtype)
        ctx = torch.matmul(ks.transpose(-1, -2), v)
        att = torch.matmul(q.float(), ctx.float())  # fp32 before the scale
        out = (att * (C // h) ** -0.5).to(x.dtype)
        out = self.proj(out.transpose(1, 2).reshape(B, N, C))
        out = out.transpose(1, 2).reshape(B, C, P, H, W)
        return self.gamma.to(x.dtype) * out.permute(0, 2, 3, 4, 1) + x


class _Conv3dPaths(nn.Module):
    """The (P, 1, 1) Conv3d over the stacked paths (the reference's
    interact_concat.0): weight (O, C, P, 1, 1), bias (O,)."""

    def __init__(self, in_ch: int, out_ch: int, num_path: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.conv3d_kernel = nn.Parameter(
            torch.empty(out_ch, in_ch, num_path, 1, 1))
        self.conv3d_bias = nn.Parameter(torch.zeros(out_ch))

    def reset_parameters(self, gen: torch.Generator) -> None:
        o, c, p = self.conv3d_kernel.shape[:3]
        # flax xavier_uniform of the (O, C·P) kernel (JAX ops/fusion.py:295)
        bound = math.sqrt(6.0 / (o + c * p))
        with torch.no_grad():
            self.conv3d_kernel.copy_(
                torch.rand(self.conv3d_kernel.shape, generator=gen)
                * (2 * bound) - bound)
        nn.init.zeros_(self.conv3d_bias)

    def conv(self, x):
        """x (B, P, H, W, C) -> (B, H, W, O) + bias, in the compute dtype."""
        dt = self.dtype
        w = self.conv3d_kernel[..., 0, 0].to(dt)  # (O, C, P)
        y = torch.einsum("bphwc,ocp->bhwo", x.to(dt), w)
        return y + self.conv3d_bias.to(dt)


class Conv3dBNConcat(_Conv3dPaths):
    """IFF variant '3d' (MSTr.py:406-462): the paths stacked on a depth
    axis, Conv3d(k = (P, 1, 1)) + ReLU, then BN."""

    def __init__(self, in_ch: int, out_ch: int, num_path: int,
                 dtype=torch.bfloat16):
        super().__init__(in_ch, out_ch, num_path, dtype)
        self.bn = BatchNorm(out_ch, dtype=dtype)

    def forward(self, xs: Sequence[torch.Tensor]):
        return self.bn(F.relu(self.conv(torch.stack(list(xs), dim=1))))


class Conv3dBNChannelAttentionConcat(_Conv3dPaths):
    """IFF variants 'cam' / 'cam_fact' (MSTr.py:597-666): BN3d -> CAM (the
    max-energy form for 'cam', the factorized one otherwise) -> the same
    BN3d again -> Conv3d(P, 1, 1) + GELU -> BN2d."""

    def __init__(self, in_ch: int, out_ch: int, num_path: int,
                 cam: str = "cam", dtype=torch.bfloat16):
        super().__init__(in_ch, out_ch, num_path, dtype)
        self.bn3d = BatchNorm(in_ch, dtype=dtype)
        self.channelAttention = (CAMModule() if cam == "cam"
                                 else CAMFactorizedModule(in_ch, dtype=dtype))
        self.bn = BatchNorm(out_ch, dtype=dtype)

    def forward(self, xs: Sequence[torch.Tensor]):
        x = self.bn3d(torch.stack(list(xs), dim=1))
        x = self.bn3d(self.channelAttention(x))
        return self.bn(gelu(self.conv(x)))
