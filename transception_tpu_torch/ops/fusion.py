"""Intra-stage feature fusion: CoordAtt, the published default ('coord'),
PyTorch port of transception_tpu/ops/fusion.py:28-72.

Behavioral reference: networks/MSTr.py:1270-1348 (without the hardcoded
.cuda() of :1276). Maps are NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from transception_tpu_torch.ops.common import Conv2d
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
