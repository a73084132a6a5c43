"""Dual Transformer Bridge ('original', br_config 2), PyTorch port of
transception_tpu/models/bridge.py:81-472.

Behavioral reference: networks/MSTr.py:2209-2442 — Scale_reduce,
M_EfficientSelfAtten, M_EfficientChannelAtten (raw (B,N,C)->(B,C,N)
reshape, not a transpose), BridgLayer_4 and BridgeBlock_4. Token splits
derive from img_size. The fused stream is not padded (a TPU tiling trick);
the spatial attention kernel masks its own ragged tile.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from transception_tpu_torch.core.config import DEFAULT_FOLDS, Folds
from transception_tpu_torch.ops import kernels
from transception_tpu_torch.ops.attention import efficient_linear_attention
from transception_tpu_torch.ops.common import (
    Conv2d,
    LayerNorm,
    Linear,
    MixFFNSkip,
)


class BridgeGeometry:
    """Static geometry of the fused multi-scale sequence."""

    def __init__(self, img_size: int, dims: Sequence[int], bridge_dim: int):
        self.c = bridge_dim
        self.sides = tuple(img_size // 4 // (1 << i) for i in range(4))
        self.mults = tuple(d // bridge_dim for d in dims)  # (1, 2, 5, 8)
        self.tokens = tuple(s * s * m for s, m in zip(self.sides, self.mults))
        self.offsets = [0]
        for t in self.tokens:
            self.offsets.append(self.offsets[-1] + t)
        self.total = self.offsets[-1]

    def split(self, x) -> List[torch.Tensor]:
        return [x[:, self.offsets[i]:self.offsets[i + 1]] for i in range(4)]


def fuse_scales(maps: Sequence[torch.Tensor], c: int) -> torch.Tensor:
    """4 NHWC maps -> one (B, N, c) sequence (MSTr.py:2380-2386): a map
    with C = k·c channels contributes H·W·k tokens by row-major reshape."""
    B = maps[0].shape[0]
    return torch.cat([m.reshape(B, -1, c) for m in maps], dim=1)


def split_scales(x: torch.Tensor, geo: BridgeGeometry) -> List[torch.Tensor]:
    """Inverse of fuse_scales (MSTr.py:2432-2435)."""
    B = x.shape[0]
    return [part.reshape(B, s, s, geo.c * m)
            for part, s, m in zip(geo.split(x), geo.sides, geo.mults)]


class ScaleReduce(nn.Module):
    """Strided-conv KV reduction (MSTr.py:2209-2249): scales 0-2 are
    reassembled into maps, reduced by ratios [3], [2], [1] with
    kernel = stride convs and regrouped through NCHW as the reference's
    (B, C, -1) reshape does; scale 3 is kept; then LN."""

    def __init__(self, geo: BridgeGeometry, reduction_ratio: Tuple[int, ...],
                 dtype=torch.bfloat16):
        super().__init__()
        self.geo = geo
        C = geo.c
        ratios = (reduction_ratio[3], reduction_ratio[2], reduction_ratio[1])
        for i, r in enumerate(ratios):
            ch = C * geo.mults[i]
            self.add_module(f"sr{i}", Conv2d(ch, ch, r, stride=r,
                                             dtype=dtype))
        self.norm = LayerNorm(C, dtype=dtype)

    def forward(self, x):
        geo = self.geo
        B, N, C = x.shape
        parts = geo.split(x)
        outs = []
        for i in range(3):
            s, ch = geo.sides[i], C * geo.mults[i]
            m = getattr(self, f"sr{i}")(parts[i].reshape(B, s, s, ch))
            outs.append(m.permute(0, 3, 1, 2).reshape(B, C, -1)
                        .transpose(1, 2))
        outs.append(parts[3])
        return self.norm(torch.cat(outs, dim=1))


class MEfficientSelfAtten(nn.Module):
    """Bridge spatial attention (MSTr.py:2254-2292): softmax attention of
    the full stream against the Scale_reduce'd KV, through the bridge
    attention kernel; with bridge_attn_fold and a residual given, the q
    projection, the attention, the out projection and the residual as one
    call of the folded kernel (JAX models/bridge.py:193-207)."""

    def __init__(self, dim: int, head: int, geo: BridgeGeometry,
                 reduction_ratio: Tuple[int, ...], dtype=torch.bfloat16,
                 folds: Folds = DEFAULT_FOLDS):
        super().__init__()
        self.head, self.folds = head, folds
        self.q = Linear(dim, dim, dtype=dtype)
        self.kv = Linear(dim, 2 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.scale_reduce = ScaleReduce(geo, reduction_ratio, dtype)

    def forward(self, x, residual=None):
        B, N, C = x.shape
        h = self.head
        d = C // h
        xr = self.scale_reduce(x)
        M = xr.shape[1]
        kv = self.kv(xr).reshape(B, M, 2, h, d).permute(2, 0, 3, 1, 4)
        if residual is not None and self.folds[self.training].bridge_attn:
            return kernels.bridge_attention.bridge_attention_folded(
                x, residual, self.q.weight, self.q.bias, kv[0], kv[1],
                self.proj.weight, self.proj.bias, d ** -0.5)
        q = self.q(x).reshape(B, N, h, d).transpose(1, 2)
        out = kernels.bridge_attention.bridge_attention(q, kv[0], kv[1],
                                                        d ** -0.5)
        out = self.proj(out.transpose(1, 2).reshape(B, N, C))
        return out if residual is None else out + residual


class MEfficientChannelAtten(nn.Module):
    """Bridge channel attention (MSTr.py:2295-2353): Shen linear attention
    on the raw (B, N, C) -> (B, C, N) reshape (a view, not a transpose)."""

    def __init__(self, dim: int, head: int, dtype=torch.bfloat16):
        super().__init__()
        self.head = head
        self.k = Linear(dim, dim, dtype=dtype)
        self.q = Linear(dim, dim, dtype=dtype)
        self.v = Linear(dim, dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x):
        B, N, C = x.shape
        h = self.head

        def to_heads(t):  # (B, C, N) -> (B, h, N, C/h)
            return t.reshape(B, C, N).reshape(B, h, C // h, N).transpose(2, 3)

        out = efficient_linear_attention(to_heads(self.q(x)),
                                         to_heads(self.k(x)),
                                         to_heads(self.v(x)))
        out = out.transpose(2, 3).reshape(B, C, N).transpose(1, 2)
        return self.proj(out)


class BridgeLayer4(nn.Module):
    """One bridge layer (MSTr.py:2356-2409): LN -> attention ->
    residual -> LN -> per-scale MixFFN_skip at native widths -> residual.
    With bridge_ffn_use_pallas (in eval, or in the flash train mode) norm2
    and the residual fold into the per-scale FFNs, norm2 as a grouped LN on
    each scale's wide layout (JAX models/bridge.py:353-408): the MixFFN
    kernel at scales 1-3, its plain version at the 7x7 scale."""

    def __init__(self, geo: BridgeGeometry, head: int, ch_att: bool,
                 reduction_ratio: Tuple[int, ...], dtype=torch.bfloat16,
                 folds: Folds = DEFAULT_FOLDS):
        super().__init__()
        self.geo, self.ch_att, self.folds = geo, ch_att, folds
        C = geo.c
        self.norm1 = LayerNorm(C, dtype=dtype)
        if ch_att:
            self.attn = MEfficientChannelAtten(C, head, dtype)
        else:
            self.attn = MEfficientSelfAtten(C, head, geo, reduction_ratio,
                                            dtype, folds)
        self.norm2 = LayerNorm(C, dtype=dtype)
        for i, m in enumerate(geo.mults):
            self.add_module(f"mixffn{i + 1}",
                            MixFFNSkip(C * m, C * m * 4, dtype=dtype))

    def forward(self, inputs):
        """inputs: the fused (B, N, C) stream."""
        geo = self.geo
        B, N, C = inputs.shape
        h = self.norm1(inputs)
        if self.ch_att:
            tx1 = inputs + self.attn(h)
        else:
            tx1 = self.attn(h, residual=inputs)
        if self.folds[self.training].bridge_ffn:
            outs = []
            for i, (s, m, part) in enumerate(zip(geo.sides, geo.mults,
                                                 geo.split(tx1))):
                f = getattr(self, f"mixffn{i + 1}").folded(
                    part.reshape(B, s * s, C * m), s, self.norm2, groups=m)
                outs.append(f.reshape(B, -1, C))
            return torch.cat(outs, dim=1)
        parts = geo.split(self.norm2(tx1))
        outs = []
        for i, (s, m) in enumerate(zip(geo.sides, geo.mults)):
            t = parts[i].reshape(B, s * s, C * m)
            f = getattr(self, f"mixffn{i + 1}")(t, s, s)
            outs.append(f.reshape(B, -1, C))
        return tx1 + torch.cat(outs, dim=1)


class BridgeBlock4(nn.Module):
    """Default 'original' Dual Transformer Bridge (MSTr.py:2413-2442): four
    layers with per-layer channel/spatial selection, then split back into
    the four skip maps."""

    def __init__(self, geo: BridgeGeometry, head: int,
                 br_ch_att_list: Tuple[bool, ...],
                 reduction_ratio: Tuple[int, ...], dtype=torch.bfloat16,
                 folds: Folds = DEFAULT_FOLDS):
        super().__init__()
        self.geo = geo
        for i, ch_att in enumerate(br_ch_att_list):
            self.add_module(f"bridge_layer{i + 1}", BridgeLayer4(
                geo, head, ch_att, reduction_ratio, dtype, folds))
        self.n_layers = len(br_ch_att_list)

    def forward(self, maps: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        x = fuse_scales(maps, self.geo.c)
        for i in range(self.n_layers):
            x = getattr(self, f"bridge_layer{i + 1}")(x)
        return split_scales(x, self.geo)
