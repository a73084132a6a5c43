"""Decoder cascade (MyDecoderLayer, networks/MSTr.py:230-290), PyTorch port
of transception_tpu/models/decoder.py:58.

Each stage concatenates the skip map channel-wise, projects, runs two
EfficientTransformerBlocks, then 2x patch-expands; the last stage uses the
4x expander and a 1x1 conv head. The argmax head (:154-201) computes the
class ids in pre-shuffle order and pixel-shuffles the uint8 map (in bf16
one kernel writes the shuffled map); the wide head (training, :124-153)
returns the logits in pre-shuffle order.
"""

from __future__ import annotations

import torch
from torch import nn

from transception_tpu_torch.core.config import DEFAULT_FOLDS, Folds
from transception_tpu_torch.ops import kernels
from transception_tpu_torch.ops.attention import EfficientTransformerBlock
from transception_tpu_torch.ops.common import (
    Conv2d,
    FinalPatchExpandX4,
    Linear,
    PatchExpand,
)


class DecoderLayer(nn.Module):
    """One decoder stage. in_dim is the reference's in_out_chan[0]: the
    [tokens from below, skip map] concatenation is 2·in_dim wide (4·in_dim
    at the last stage). bottom=True builds the bottom stage, which only
    patch-expands (MSTr.py:284-289). `folds` and the token_mlp switch
    reach the two blocks."""

    def __init__(self, in_dim: int, out_dim: int, n_class: int = 9,
                 is_last: bool = False, bottom: bool = False,
                 dtype=torch.bfloat16, folds: Folds = DEFAULT_FOLDS,
                 token_mlp: str = "mix_skip"):
        super().__init__()
        self.out_dim = out_dim
        self.is_last, self.bottom, self.dtype = is_last, bottom, dtype
        if bottom:
            self.layer_up = PatchExpand(out_dim, dtype)
            return
        cat_dim = in_dim * (4 if is_last else 2)
        self.concat_linear = Linear(cat_dim, out_dim, dtype=dtype)
        self.layer_former_1 = EfficientTransformerBlock(out_dim, dtype, folds,
                                                        token_mlp)
        self.layer_former_2 = EfficientTransformerBlock(out_dim, dtype, folds,
                                                        token_mlp)
        if is_last:
            self.layer_up = FinalPatchExpandX4(out_dim, dtype)
            # fp32 head (logits policy of the JAX package).
            self.last_layer = Conv2d(out_dim, n_class, 1,
                                     dtype=torch.float32)
        else:
            self.layer_up = PatchExpand(out_dim, dtype)

    def forward(self, x1, x2=None, argmax_head: bool = False,
                wide_head: bool = False):
        """x1: (B, N, C) tokens from below; x2: (B, H, W, C) skip map.
        The last stage returns (B, 4H, 4W, n_class) fp32 logits, with
        argmax_head (B, 4H, 4W) uint8 class ids, with wide_head
        (B, H·W, 16, n_class) fp32 logits in pre-shuffle order."""
        if self.bottom:
            side = int(round(x1.shape[1] ** 0.5))
            return self.layer_up(x1, side, side)
        B, H, W, C = x2.shape
        t = self.concat_linear(torch.cat([x1, x2.reshape(B, H * W, C)], -1))
        t = self.layer_former_1(t, H, W)
        t = self.layer_former_2(t, H, W)
        if not self.is_last:
            return self.layer_up(t, H, W)
        p = 4
        if wide_head:
            return self.wide_head(t)
        if not argmax_head:
            m = self.layer_up(t, H, W).reshape(B, p * H, p * W, -1)
            return self.last_layer(m)
        if self.dtype == torch.bfloat16:
            # Expand + grouped LN + bf16 head + argmax in one kernel,
            # which writes the shuffled class map.
            up, hl = self.layer_up, self.last_layer
            return kernels.expand_head.expand_head(
                t, up.expand.weight, up.norm.weight, up.norm.bias,
                hl.weight.reshape(hl.weight.shape[0], -1), hl.bias, p=p,
                c=self.out_dim, eps=up.norm.eps, shuffle=(H, W))
        # fp32: the expansion in pre-shuffle order, the fp32 1x1 conv per
        # c-vector, argmax (decoder.py:192-201), then the shuffle.
        y = self.layer_up(t, H, W, pre_shuffle=True)
        ids = self.last_layer(y).argmax(-1).to(torch.uint8)
        return kernels.expand_head.shuffle_ids(ids, H, W, p)

    def wide_head(self, t):
        """Logits in pre-pixel-shuffle token order (decoder.py:124-153):
        the Dense expand born c-minor, LN over c with the fast-variance
        formula and fp32 stats, the fp32 1x1 head on (N, p²) as a map.
        (B, N, C) -> (B, N, 16, n_class); the loss permutes the labels
        instead (train.losses.shuffle_labels_wide)."""
        up, dt, c = self.layer_up, self.dtype, self.out_dim
        B, N, _ = t.shape
        y = up.expand(t).reshape(B, N, up.p * up.p, c).float()
        mean = y.mean(-1, keepdim=True)
        var = (y * y).mean(-1, keepdim=True) - mean * mean
        xn = (y - mean) * (torch.rsqrt(var + up.norm.eps)
                           * up.norm.weight.float()) + up.norm.bias.float()
        return self.last_layer(xn.to(dt))
