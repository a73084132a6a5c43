"""MultiRes inception-conv token branches, PyTorch port of
transception_tpu/ops/multires.py (the reference's EffSegformer.py:175-691).

The ResInception encoder's second branch (models/legacy.py
MiTResInception): a conv chain 1x1-res -> 3x3 -> 5x5 (3x3 on the 3x3) ->
7x7 (3x3 on the 5x5), a subset of its outputs max-pooled, flattened to
tokens, concatenated and LayerNormed. Every conv is followed by the port's
BatchNorm (ops/conv.py: flax's momentum 0.9 and biased running variance,
the global batch's moments under data parallelism).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from transception_tpu_torch.ops.common import Conv2d, LayerNorm
from transception_tpu_torch.ops.conv import BatchNorm


class ConvBlock(nn.Module):
    """conv -> [act] -> BN in the reference conv_block's orders
    (EffSegformer.py:175-200; JAX ops/multires.py:24-49): act 'none' ->
    conv + BN; 'relu' -> conv + ReLU + BN; 'sigmoid' -> conv + BN +
    sigmoid."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, act: str = "relu",
                 dtype=torch.bfloat16):
        super().__init__()
        self.act = act
        self.conv = Conv2d(in_ch, out_ch, kernel_size, stride, padding,
                           dtype=dtype)
        self.bn = BatchNorm(out_ch, dtype=dtype)

    def forward(self, x):
        y = self.conv(x)
        if self.act == "relu":
            return self.bn(F.relu(y))
        if self.act == "sigmoid":
            return torch.sigmoid(self.bn(y))
        return self.bn(y)


class ResConvBlock(nn.Module):
    """1x1-res + 3x3-main, ReLU, BN (EffSegformer.py:204-222; JAX
    ops/multires.py:52-64)."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.bfloat16):
        super().__init__()
        self.res = ConvBlock(in_ch, out_ch, 1, 1, 0, act="none", dtype=dtype)
        self.main = ConvBlock(in_ch, out_ch, dtype=dtype)
        self.bn = BatchNorm(out_ch, dtype=dtype)

    def forward(self, x):
        return self.bn(F.relu(self.res(x) + self.main(x)))


class MultiResBlock(nn.Module):
    """The parametric MultiResBlock (EffSegformer.py:407-691; JAX
    ops/multires.py:67-108): `branches` picks the outputs emitted as
    token streams, 'res' (1x1), '3', '5' and '7' (3x3 chains), each
    max-pooled by `downsample`; the streams are concatenated along the
    tokens and LayerNormed. (B, H, W, in_ch) -> (B, k·(H/d)·(W/d), U)."""

    def __init__(self, in_ch: int, U: int,
                 branches: Tuple[str, ...] = ("res", "3", "5"),
                 downsample: int = 2, alpha: int = 1, dtype=torch.bfloat16):
        super().__init__()
        W = alpha * U
        self.branches, self.downsample = tuple(branches), downsample
        need = set(self.branches)
        self.residual_layer = ConvBlock(in_ch, W, 1, 1, 0, act="none",
                                        dtype=dtype)
        self.conv3x3 = ConvBlock(in_ch, W, dtype=dtype)
        if need & {"5", "7"}:
            self.conv5x5 = ConvBlock(W, W, dtype=dtype)
        if "7" in need:
            self.conv7x7 = ConvBlock(W, W, dtype=dtype)
        self.norm = LayerNorm(W, dtype=dtype)

    def _tokens(self, m):
        d = self.downsample
        B, H, W, C = m.shape
        p = F.max_pool2d(m.permute(0, 3, 1, 2), d, d)
        return p.permute(0, 2, 3, 1).reshape(B, -1, C)

    def forward(self, x):
        need = set(self.branches)
        outs = []
        res = self.residual_layer(x)
        if "res" in need:
            outs.append(self._tokens(res))
        c = self.conv3x3(x)
        if "3" in need:
            outs.append(self._tokens(c))
        if need & {"5", "7"}:
            c = self.conv5x5(c)
            if "5" in need:
                outs.append(self._tokens(c))
            if "7" in need:
                outs.append(self._tokens(self.conv7x7(c)))
        return self.norm(torch.cat(outs, dim=1))
