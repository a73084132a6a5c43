"""Common token-sequence ops (NHWC / (B, N, C) layouts), PyTorch port of
transception_tpu/ops/common.py.

Behavioral reference: networks/MSTr.py:21-77 (DWConv/MixFFN family),
:176-227 (patch expanders), :292-304 (overlap patch embed), :734-752 (CPE).
Parameters are fp32 and named after the reference torch state_dict; every
matmul/conv rounds its operands and its output to the compute dtype, and
LayerNorm keeps fp32 statistics (flax's fast-variance form E[x²]−E[x]²).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from transception_tpu_torch.parallel.mesh import global_rand


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, evaluated in fp32 and returned in x's dtype."""
    return F.gelu(x.float()).to(x.dtype)


def _xavier_(t: torch.Tensor, fan_in: int, fan_out: int,
             gen: torch.Generator) -> None:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=gen) * (2 * bound) - bound)


def _keep(t: torch.Tensor, dim: int, blk: slice) -> nn.Parameter:
    """A parameter of t's block `blk` along `dim`."""
    return nn.Parameter(t.detach()[(slice(None),) * dim + (blk,)].clone())


class Linear(nn.Module):
    """flax nn.Dense in the compute dtype: weight (out, in) fp32, operands
    rounded to `dtype`, fp32 accumulation, output rounded to `dtype`.

    Sharded over a model axis (shard_, parallel.tensor.ModelAxis): "col"
    keeps the rank's output features (and bias) and takes its input
    through the axis's copy; "gather" also gathers the output features
    for the replicated code that reads them; "row" keeps the rank's input
    features, sums the fp32 partial products over the ranks, then rounds
    and adds the whole bias: the unsharded values up to the order of the
    fp32 sums."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features)) if bias
                     else None)
        self.tp = None

    def shard_(self, axis, mode: str) -> None:
        """Keep this rank's shard of the weights (mode "col", "gather" or
        "row") and run sharded."""
        if mode == "row":
            self.weight = _keep(self.weight, 1,
                                axis.block(self.weight.shape[1]))
        else:
            blk = axis.block(self.weight.shape[0])
            self.weight = _keep(self.weight, 0, blk)
            if self.bias is not None:
                self.bias = _keep(self.bias, 0, blk)
        self.tp = (axis, mode)

    def reset_parameters(self, gen: torch.Generator) -> None:
        out_f, in_f = self.weight.shape
        _xavier_(self.weight, in_f, out_f, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.tp is not None:
            axis, mode = self.tp
            if mode == "row":
                y = axis.reduce(F.linear(x.to(dt).float(),
                                         self.weight.to(dt).float())).to(dt)
                return y + self.bias.to(dt) if self.bias is not None else y
            # The input gradient's partials are summed in fp32.
            x = axis.copy(x.float())
        y = F.linear(x.to(dt), self.weight.to(dt))
        if self.bias is not None:
            y = y + self.bias.to(dt)
        if self.tp is not None and self.tp[1] == "gather":
            y = self.tp[0].gather(y)
        return y


class Conv2d(nn.Module):
    """flax nn.Conv on NHWC maps: weight (O, I/groups, kh, kw) fp32,
    operands and output in the compute dtype; `dilation` is flax's
    kernel_dilation."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 bias: bool = True, dtype=torch.bfloat16, dilation: int = 1):
        super().__init__()
        self.dtype = dtype
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dilation = dilation
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        o, i, kh, kw = self.weight.shape
        _xavier_(self.weight, kh * kw * i, kh * kw * o, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.weight.to(dt),
                     None, self.stride, self.padding, self.dilation,
                     self.groups)
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


def shard_depthwise_(conv: Conv2d, axis) -> None:
    """Keep this rank's channels of a depthwise conv (a conv per channel:
    no collective)."""
    blk = axis.block(conv.weight.shape[0])
    conv.weight = _keep(conv.weight, 0, blk)
    if conv.bias is not None:
        conv.bias = _keep(conv.bias, 0, blk)
    conv.groups = conv.weight.shape[0]


def DepthwiseConv(ch: int, k: int, stride: int = 1, bias: bool = True,
                  dtype=torch.bfloat16) -> Conv2d:
    """k×k depthwise conv with 'same' padding (k odd)."""
    return Conv2d(ch, ch, k, stride=stride, padding=k // 2, groups=ch,
                  bias=bias, dtype=dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """fp32 LayerNorm over the last axis (flax form), returned in x.dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp_min((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * weight.float()) \
        + bias.float()
    return y.to(x.dtype)


class LayerNorm(nn.Module):
    """fp32 LayerNorm returning the compute dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.bfloat16):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps).to(self.dtype)


def group_ln(x: torch.Tensor, lts: torch.Tensor, ltb: torch.Tensor,
             groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Grouped LayerNorm on the wide (B, N, C) layout: each C-wide row
    holds `groups` tokens of width C/groups, normalized independently
    (ops/pallas/mixffn.py:105). lts/ltb are the (C,)-tiled scale/bias."""
    B, N, C = x.shape
    xr = x.float().reshape(B, N, groups, C // groups)
    mean = xr.mean(-1, keepdim=True)
    var = (xr * xr).mean(-1, keepdim=True) - mean * mean
    xn = ((xr - mean) * torch.rsqrt(var + eps)).reshape(B, N, C)
    return (xn * lts.float() + ltb.float()).to(x.dtype)


class DWConv(nn.Module):
    """The 3x3 depthwise conv of MixFFN (MSTr.py:21-31), kept as a module
    for the reference key `dwconv.dwconv`; mixffn_plain applies it."""

    def __init__(self, dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.dwconv = DepthwiseConv(dim, 3, dtype=dtype)


def on_row_block(fn, x: torch.Tensor, s: int, rows) -> torch.Tensor:
    """fn on the block of map rows rows = (r0, r1) of the maps x (B, n·s,
    C) of s columns: fn gets the block with its halo rows
    (ops.kernels.mixffn.halo_rows) and the result keeps the block's rows,
    (B, (r1 - r0)·s, C'). Under autograd the halo rows' outputs get a zero
    cotangent, and x's gradient holds the block's share of every row it
    read, the halo rows' included."""
    from transception_tpu_torch.ops.kernels.mixffn import halo_rows
    r0, r1 = rows
    a, b = halo_rows(x.shape[1] // s, r0, r1)
    return fn(x[:, a * s:b * s])[:, (r0 - a) * s:(r1 - a) * s]


class MixFFNSkip(nn.Module):
    """fc1 -> (DWConv + fc1 skip) -> LN -> GELU -> fc2 (MSTr.py:889-902).

    The math is the plain version of the fused MixFFN kernels
    (ops/kernels/mixffn.py). `folded` runs the caller's LayerNorm, this
    FFN and the residual as K2 (the ETB, MHCA and bridge FFN folds);
    calling the module runs the FFN alone, as K9 when asked (the unfolded
    MHCA FFN with mhca_ffn_fold, JAX ops/common.py:294-319), else
    plain."""

    def __init__(self, c1: int, c2: int, dtype=torch.bfloat16):
        super().__init__()
        self.fc1 = Linear(c1, c2, dtype=dtype)
        self.dwconv = DWConv(c2, dtype=dtype)
        self.norm1 = LayerNorm(c2, dtype=dtype)
        self.fc2 = Linear(c2, c1, dtype=dtype)
        self.hidden = c2  # the whole hidden width, sharded or not
        self.tp = None

    def shard_(self, axis) -> None:
        """Keep this rank's hidden channels (fc1's rows, the conv's and
        the hidden LN's channels, fc2's columns): the hidden-sharded forms
        of K2, K11 and K9 (ops/kernels/mixffn.py) then run it, with the
        hidden width's sums over the model axis."""
        self.fc1.shard_(axis, "col")
        shard_depthwise_(self.dwconv.dwconv, axis)
        blk = axis.block(self.hidden)
        self.norm1.weight = _keep(self.norm1.weight, 0, blk)
        self.norm1.bias = _keep(self.norm1.bias, 0, blk)
        self.fc2.shard_(axis, "row")
        self.tp = axis

    def params(self):
        return (self.fc1.weight, self.fc1.bias, self.dwconv.dwconv.weight,
                self.dwconv.dwconv.bias, self.norm1.weight, self.norm1.bias,
                self.fc2.weight, self.fc2.bias)

    def forward(self, x: torch.Tensor, H: int, W: int,
                kernel: bool = False, rows=None) -> torch.Tensor:
        """The FFN on a (B, H·W, C) map: with `kernel`, through the K9
        wrapper on an even-sided map (mixffn.takes on the side W: the K2
        rule), else the plain version; sharded (shard_), through K9's
        sharded form on an even-sided square map (the unfolded MHCA FFN of
        the per-path layout), else the sharded plain version (any H x W
        map: the legacy models' branch maps). A routing by shape, made
        before the call. rows = (r0, r1): the map rows [r0, r1) of the
        result alone, computed on the block with its halo rows
        (on_row_block)."""
        from transception_tpu_torch.ops.kernels import mixffn
        if rows is not None:
            return on_row_block(
                lambda xe: self.forward(xe, xe.shape[1] // W, W, kernel), x,
                W, rows)
        if self.tp is not None:
            fn = (mixffn.mixffn_skip_tp if kernel and H == W and
                  mixffn.takes(W) else mixffn.mixffn_tp_plain)
            return fn(x.to(self.fc1.dtype), *self.params(), s=W,
                      hid_all=self.hidden, axis=self.tp, eps=self.norm1.eps)
        fn = (mixffn.mixffn_skip if kernel and mixffn.takes(W)
              else mixffn.mixffn_skip_plain)
        return fn(x.to(self.fc1.dtype), *self.params(), s=W,
                  eps=self.norm1.eps)

    def folded(self, x: torch.Tensor, s: int, ln: "LayerNorm",
               groups: int = 1, rows=None) -> torch.Tensor:
        """x + self(groupLN(x)) on a (B, s², C) map, `ln` the caller's
        LayerNorm of C/groups channels (or anything with its weight, bias
        and eps), through the MixFFN kernel wrapper on an even-sided map
        (mixffn.takes, where the JAX package runs its kernel), else through
        the plain version: the 7x7 MHCA stage-4 and bridge scale-4 folds at
        224, in eval and in training. A routing by the map's side, made
        before the call. rows = (r0, r1): the map rows [r0, r1) of the
        result alone, K2 (or its plain version) on the block with its halo
        rows (on_row_block), routed by the whole map's side."""
        from transception_tpu_torch.ops.kernels import mixffn
        if rows is not None:
            return on_row_block(
                lambda xe: self.folded(xe, s, ln, groups), x, s, rows)
        if self.tp is not None:
            return mixffn.mixffn_ln_skip_tp(
                x.to(self.fc1.dtype), ln.weight, ln.bias, *self.params(),
                s=s, hid_all=self.hidden, axis=self.tp, groups=groups,
                eps_ln=ln.eps, eps=self.norm1.eps)
        fn = (mixffn.mixffn_ln_skip if mixffn.takes(s)
              else mixffn.mixffn_ln_skip_plain)
        return fn(x.to(self.fc1.dtype), ln.weight, ln.bias, *self.params(),
                  s=s, groups=groups, eps_ln=ln.eps, eps=self.norm1.eps)


class MixFFN(nn.Module):
    """fc1 -> DWConv -> GELU -> fc2 (MSTr.py:35-46; JAX ops/common.py:209),
    the FFN of token_mlp='mix'."""

    def __init__(self, c1: int, c2: int, dtype=torch.bfloat16):
        super().__init__()
        self.fc1 = Linear(c1, c2, dtype=dtype)
        self.dwconv = DWConv(c2, dtype=dtype)
        self.fc2 = Linear(c2, c1, dtype=dtype)

    def shard_(self, axis) -> None:
        """Keep this rank's hidden channels: fc1 column-parallel, the conv
        per channel, fc2 row-parallel."""
        self.fc1.shard_(axis, "col")
        shard_depthwise_(self.dwconv.dwconv, axis)
        self.fc2.shard_(axis, "row")

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, _ = x.shape
        h = self.fc1(x)
        h = self.dwconv.dwconv(h.reshape(B, H, W, -1)).reshape(B, N, -1)
        return self.fc2(gelu(h))


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator
            ) -> torch.Tensor:
    """flax nn.Dropout in training: each element kept with probability
    1 - rate (a Bernoulli mask drawn from `gen`, on x's device; this
    rank's rows of the global batch's under data parallelism) and divided
    by it, else 0."""
    if gen is None:
        raise ValueError("dropout in training needs a torch.Generator (the "
                         "train step's gen)")
    keep = 1.0 - rate
    mask = global_rand(x.shape, gen, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class MLPFFN(nn.Module):
    """fc1 -> GELU -> dropout -> fc2 -> dropout, rate 0.1 (MSTr.py:63-77;
    JAX ops/common.py:338): the FFN of token_mlp='mlp' and of the sp
    bridge's InterTransBlock. The masks are drawn from the caller's
    generator where `deterministic` is False."""

    def __init__(self, c1: int, c2: int, drop_rate: float = 0.1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.drop_rate = drop_rate
        self.fc1 = Linear(c1, c2, dtype=dtype)
        self.fc2 = Linear(c2, c1, dtype=dtype)

    def shard_(self, axis) -> None:
        """Keep this rank's hidden channels: fc1 column-parallel, fc2
        row-parallel."""
        self.fc1.shard_(axis, "col")
        self.fc2.shard_(axis, "row")

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.fc1.tp is not None and not deterministic and \
                self.drop_rate > 0.0:
            raise NotImplementedError(
                "dropout on a hidden-sharded MLP FFN: the TP rules shard "
                "none that drops (the bridge's are replicated)")

        def drop(t):
            return t if deterministic or self.drop_rate == 0.0 else \
                dropout(t, self.drop_rate, gen)

        return drop(self.fc2(drop(gelu(self.fc1(x)))))


def make_ffn(token_mlp: str, dim: int, hidden: int, dtype=torch.bfloat16
             ) -> nn.Module:
    """The FFN of the token_mlp switch (MSTr.py:157-162; JAX ops/common.py
    357): MixFFN ('mix'), MixFFNSkip ('mix_skip'), MLPFFN (any other)."""
    if token_mlp == "mix":
        return MixFFN(dim, hidden, dtype)
    if token_mlp == "mix_skip":
        return MixFFNSkip(dim, hidden, dtype)
    return MLPFFN(dim, hidden, dtype=dtype)


class OverlapPatchEmbed(nn.Module):
    """Conv(k=7, s=4, p=3) stem + LN, returns tokens (MSTr.py:292-304)."""

    def __init__(self, in_ch: int, dim: int, patch_size: int = 7,
                 stride: int = 4, padding: int = 3, dtype=torch.bfloat16):
        super().__init__()
        self.proj = Conv2d(in_ch, dim, patch_size, stride, padding,
                           dtype=dtype)
        self.norm = LayerNorm(dim, dtype=dtype)

    def forward(self, x: torch.Tensor):
        y = self.proj(x)
        B, H, W, C = y.shape
        return self.norm(y.reshape(B, H * W, C)), H, W


class _ExpandBase(nn.Module):
    """Dense(expand, no bias) -> LN(c) -> pixel shuffle, shared body of
    PatchExpand/FinalPatchExpandX4 (ops/common.py:423-467 in the JAX
    package). LN is applied per c-vector before the shuffle (they commute);
    expansion, LN and the shuffle are the patch-expand kernel
    (ops/kernels), which writes each c-vector to its shuffled place."""

    def __init__(self, dim: int, p: int, c: int, dtype):
        super().__init__()
        self.p, self.c = p, c
        self.expand = Linear(dim, p * p * c, bias=False, dtype=dtype)
        self.norm = LayerNorm(c, dtype=dtype)

    def forward(self, x: torch.Tensor, H: int, W: int,
                pre_shuffle: bool = False) -> torch.Tensor:
        from transception_tpu_torch.ops.kernels.patch_expand import (
            patch_expand,
        )
        B, N, C = x.shape
        p, c = self.p, self.c
        y = patch_expand(x.to(self.expand.dtype), self.expand.weight,
                         self.norm.weight, self.norm.bias, p=p, c=c,
                         eps=self.norm.eps,
                         shuffle=None if pre_shuffle else (H, W))
        return y.reshape(B, N, p * p, c) if pre_shuffle else y


class PatchExpand(_ExpandBase):
    """2x pixel-shuffle upsample: Linear(dim->2dim) + rearrange + LN
    (MSTr.py:176-201), einops 'b h w (p1 p2 c) -> b (h p1) (w p2) c'."""

    def __init__(self, dim: int, dtype=torch.bfloat16):
        super().__init__(dim, 2, dim // 2, dtype)


class FinalPatchExpandX4(_ExpandBase):
    """4x upsample: Linear(dim->16dim) + rearrange + LN (MSTr.py:203-227)."""

    def __init__(self, dim: int, dtype=torch.bfloat16):
        super().__init__(dim, 4, dim, dtype)


class ConvPosEnc(nn.Module):
    """CPVT conditional position encoding: 3x3 depthwise conv + residual
    on the token map (MSTr.py:734-752)."""

    def __init__(self, dim: int, k: int = 3, dtype=torch.bfloat16):
        super().__init__()
        self.proj = DepthwiseConv(dim, k, dtype=dtype)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, C = x.shape
        t = x.reshape(B, H, W, C)
        return (self.proj(t) + t).reshape(B, N, C)


def init_weights(model: nn.Module, gen: Optional[torch.Generator]) -> None:
    """Flax-equivalent init (xavier-uniform kernels, zero biases, unit
    norms) drawn from `gen` in module order."""
    for m in model.modules():
        if hasattr(m, "reset_parameters") and m is not model:
            m.reset_parameters(gen)
