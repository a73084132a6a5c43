"""BatchNorm conv blocks (MSViT building blocks), PyTorch port of
transception_tpu/ops/conv.py.

Behavioral reference: networks/MSTr.py:309-404 (Conv2d_BN / DWConv2d_BN),
:670-732 (DWCPatchEmbed / Patch_Embed_stage), :996-1050 (ResBlock).
BatchNorm normalises with batch statistics in train mode and applies its
running statistics in eval mode (nn.Module.train() / .eval()).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from transception_tpu_torch.ops.common import Conv2d, DepthwiseConv
from transception_tpu_torch.parallel.mesh import active, global_sum


class BatchNorm(nn.Module):
    """BatchNorm (eps 1e-5) on NHWC maps, as the JAX package's
    (ops/conv.py:41-80).

    Train mode is flax nn.BatchNorm(momentum=0.9) in fp32: the batch mean
    over (B, H, W) and the fast biased variance E[x²] − E[x]² (clamped at
    0), y = (x − mean)·(rsqrt(var + eps)·scale) + bias cast to the compute
    dtype, and the running stats updated as 0.9·r + 0.1·batch with the
    biased variance (F.batch_norm would store the unbiased one). Under
    data parallelism (parallel.mesh.data_parallel) the moments are of the
    global batch: the per-channel sums of x and x² and the count are
    summed over the ranks (global_sum, differentiable), so every rank
    normalises and updates its running stats as the one-process step.

    Eval mode: fp32 computes the same affine with the running stats; other
    compute dtypes follow _EvalBNAffine (ops/conv.py:57-80): the rsqrt
    coefficient is computed in fp32 and rounded once, everything per pixel
    stays in the compute dtype."""

    def __init__(self, ch: int, scale_init: float = 1.0,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype, self.scale_init = dtype, scale_init
        self.weight = nn.Parameter(torch.full((ch,), float(scale_init)))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.constant_(self.weight, self.scale_init)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        if self.training:
            xf = x.float()
            axes = tuple(range(xf.dim() - 1))
            if active() is None:
                mean = xf.mean(axes)
                var = torch.clamp_min((xf * xf).mean(axes) - mean * mean,
                                      0.0)
            else:
                c = xf.shape[-1]
                s = global_sum(torch.cat([
                    xf.sum(axes), (xf * xf).sum(axes),
                    xf.new_full((1,), xf.numel() // c)]))
                mean = s[:c] / s[-1]
                var = torch.clamp_min(s[c:2 * c] / s[-1] - mean * mean, 0.0)
            with torch.no_grad():
                self.running_mean.copy_(0.9 * self.running_mean + 0.1 * mean)
                self.running_var.copy_(0.9 * self.running_var + 0.1 * var)
            y = (xf - mean) * (torch.rsqrt(var + 1e-5) * self.weight) \
                + self.bias
            return y.to(self.dtype)
        mul = torch.rsqrt(self.running_var + 1e-5) * self.weight
        if self.dtype == torch.float32:
            return (x.float() - self.running_mean) * mul + self.bias
        dt = self.dtype
        return ((x.to(dt) - self.running_mean.to(dt)) * mul.to(dt)
                + self.bias.to(dt))


def hardswish(x):
    return F.hardswish(x)


class Conv2dBN(nn.Module):
    """conv(no bias) -> BN -> optional hardswish (MSTr.py:364-404)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1,
                 stride: int = 1, pad: int = 0, groups: int = 1,
                 bn_weight_init: float = 1.0, act: bool = False,
                 dtype=torch.bfloat16):
        super().__init__()
        self.act = act
        self.conv = Conv2d(in_ch, out_ch, kernel_size, stride, pad, groups,
                           bias=False, dtype=dtype)
        self.bn = BatchNorm(out_ch, bn_weight_init, dtype=dtype)

    def forward(self, x):
        y = self.bn(self.conv(x))
        return hardswish(y) if self.act else y


class DWConv2dBN(nn.Module):
    """Depthwise kxk -> pointwise 1x1 -> BN -> hardswish (MSTr.py:309-362),
    as the reference instantiates it (in_ch == out_ch)."""

    def __init__(self, ch: int, kernel_size: int = 1, stride: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dwconv = DepthwiseConv(ch, kernel_size, stride, bias=False,
                                    dtype=dtype)
        self.pwconv = Conv2d(ch, ch, 1, bias=False, dtype=dtype)
        self.bn = BatchNorm(ch, dtype=dtype)

    def forward(self, x):
        return hardswish(self.bn(self.pwconv(self.dwconv(x))))


class DWCPatchEmbed(nn.Module):
    """Depthwise-conv patch embedding, 3x3 stride 1 or 2 (MSTr.py:670-702)."""

    def __init__(self, embed_dim: int, patch_size: int = 3, stride: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.patch_conv = DWConv2dBN(embed_dim, patch_size, stride, dtype)

    def forward(self, x):
        return self.patch_conv(x)


class PatchEmbedStage(nn.Module):
    """RIPM core: num_path patch embeds applied sequentially, the first
    strided 2 when is_pool; every intermediate result is one branch input
    (MSTr.py:704-732)."""

    def __init__(self, embed_dim: int, num_path: int = 3,
                 is_pool: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self.patch_embeds = nn.ModuleList(
            DWCPatchEmbed(embed_dim, 3, 2 if (is_pool and i == 0) else 1,
                          dtype)
            for i in range(num_path))

    def forward(self, x):
        outs = []
        for pe in self.patch_embeds:
            x = pe(x)
            outs.append(x)
        return outs


class ResBlock(nn.Module):
    """Inverted-residual conv branch of each MHCA stage (MSTr.py:996-1050):
    Conv2d_BN(1x1, hswish) -> dw3x3 -> BN -> hswish -> Conv2d_BN(1x1) + id."""

    def __init__(self, dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.conv1 = Conv2dBN(dim, dim, act=True, dtype=dtype)
        self.dwconv = DepthwiseConv(dim, 3, bias=False, dtype=dtype)
        self.norm = BatchNorm(dim, dtype=dtype)
        self.conv2 = Conv2dBN(dim, dim, dtype=dtype)

    def forward(self, x):
        h = self.conv1(x)
        h = hardswish(self.norm(self.dwconv(h)))
        return x + self.conv2(h)
