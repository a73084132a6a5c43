"""The bridges, PyTorch port of transception_tpu/models/bridge.py: the
Dual Transformer Bridge ('original', br_config 2), the 'para' bridge and
the 'sp' bridge with its window-partitioned SpatialAwareTrans.

Behavioral reference: networks/MSTr.py:2209-2757 — Scale_reduce,
M_EfficientSelfAtten, M_EfficientChannelAtten (raw (B,N,C)->(B,C,N)
reshape, not a transpose), BridgLayer_4 and BridgeBlock_4, BridgeBlock_para,
SpatialAwareTrans and BridgeBlock_sp. Token splits derive from img_size.
The fused stream is not padded (a TPU tiling trick); the spatial attention
kernels mask their own ragged tile. The sp and para bridges' layers fold
their spatial attention (K8) and their per-scale FFNs (K2) by the bridge's
kernel switch (FoldSwitches.sp_bridge), as the JAX package builds them
without its attn_fold and ffn_use_pallas knobs (transception.py:63-73).

The original bridge's sequence sharding (BridgeBlock4.seq_shard_, JAX
bridge_seq_shard_axis, models/bridge.py:155-237, 277-472): on a model axis
of tp ranks each layer keeps the fused stream whole at its edges and
splits its two per-token computations, the spatial attention's query rows
(N % tp == 0) and each scale's FFN input on whole map rows (s % tp == 0,
the block with its halo rows); the blocks are gathered. Each block runs
the fold structure the layer runs unsharded (K8, or q, K3 and proj; K2 or
the plain FFN), so the kernels and their launch counts are those of the
unsharded layer and only the launch shapes change. Whatever is computed
whole from a replicated input (the Scale_reduce'd K and V, norm1, the
channel attention, a scale that does not divide) gets its whole
gradient on every rank; a block's input enters through the model axis's
copy, which sums the blocks' partial input gradients; the weights used on
a block alone (q, proj, the split scales' FFNs) get partial gradients,
which the train state sums over the model axis after the backward
(seq_shard_ returns them). norm2 feeds split and whole scales alike in the
FFN fold: its weights enter the split scales through copy.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from transception_tpu_torch.core.config import DEFAULT_FOLDS, Folds
from transception_tpu_torch.ops import kernels
from transception_tpu_torch.ops.attention import efficient_linear_attention
from transception_tpu_torch.ops.common import (
    MLPFFN,
    Conv2d,
    LayerNorm,
    Linear,
    MixFFNSkip,
    gelu,
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
    call of the folded kernel (JAX models/bridge.py:193-207); in the sp
    and para bridges (sp_bridge) by their kernel switch instead."""

    def __init__(self, dim: int, head: int, geo: BridgeGeometry,
                 reduction_ratio: Tuple[int, ...], dtype=torch.bfloat16,
                 folds: Folds = DEFAULT_FOLDS, sp_bridge: bool = False):
        super().__init__()
        self.head, self.folds, self.sp_bridge = head, folds, sp_bridge
        self.q = Linear(dim, dim, dtype=dtype)
        self.kv = Linear(dim, 2 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.scale_reduce = ScaleReduce(geo, reduction_ratio, dtype)

    def forward(self, x, residual=None, axis=None):
        """axis (parallel.tensor.ModelAxis): the sequence sharding, this
        rank's block of the query rows (where N divides by the axis's
        size, else the whole stream, as JAX) and the blocks gathered; K
        and V computed whole from the whole stream and taken through the
        axis's copy, as are the blocks' x and residual, so that the
        blocks' partial gradients of them are summed."""
        B, N, C = x.shape
        h = self.head
        d = C // h
        xr = self.scale_reduce(x)
        M = xr.shape[1]
        kv = self.kv(xr)
        shard = axis is not None and N % axis.size == 0
        if shard:
            kv = axis.copy(kv)
            x = axis.rows(axis.copy(x))
            if residual is not None:
                residual = axis.rows(axis.copy(residual))
        kv = kv.reshape(B, M, 2, h, d).permute(2, 0, 3, 1, 4)
        out = self._attend(x, residual, kv)
        return axis.gather(out, 1) if shard else out

    def _attend(self, x, residual, kv):
        B, N, C = x.shape
        h = self.head
        d = C // h
        sw = self.folds[self.training]
        if residual is not None and (sw.sp_bridge if self.sp_bridge
                                     else sw.bridge_attn):
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
    kernel at scales 1-3, its plain version at the 7x7 scale. In the sp
    and para bridges (sp_bridge) both folds follow the bridge's kernel
    switch (FoldSwitches.sp_bridge)."""

    def __init__(self, geo: BridgeGeometry, head: int, ch_att: bool,
                 reduction_ratio: Tuple[int, ...], dtype=torch.bfloat16,
                 folds: Folds = DEFAULT_FOLDS, sp_bridge: bool = False):
        super().__init__()
        self.geo, self.ch_att, self.folds = geo, ch_att, folds
        self.sp_bridge = sp_bridge
        self.seq = None  # the model axis of the sequence sharding
        C = geo.c
        self.norm1 = LayerNorm(C, dtype=dtype)
        if ch_att:
            self.attn = MEfficientChannelAtten(C, head, dtype)
        else:
            self.attn = MEfficientSelfAtten(C, head, geo, reduction_ratio,
                                            dtype, folds, sp_bridge)
        self.norm2 = LayerNorm(C, dtype=dtype)
        for i, m in enumerate(geo.mults):
            self.add_module(f"mixffn{i + 1}",
                            MixFFNSkip(C * m, C * m * 4, dtype=dtype))

    def split_scales(self, size: int) -> List[int]:
        """The scales whose FFN a model axis of `size` ranks splits: map
        sides divisible by it (JAX bridge.py:371-382)."""
        return [i for i, s in enumerate(self.geo.sides) if s % size == 0]

    def forward(self, inputs):
        """inputs: the fused (B, N, C) stream or the four scale maps."""
        geo = self.geo
        if isinstance(inputs, (list, tuple)):
            inputs = fuse_scales(inputs, geo.c)
        B, N, C = inputs.shape
        sp = self.seq
        h = self.norm1(inputs)
        if self.ch_att:
            tx1 = inputs + self.attn(h)
        else:
            tx1 = self.attn(h, residual=inputs, axis=sp)
        sw = self.folds[self.training]
        fold = sw.sp_bridge if self.sp_bridge else sw.bridge_ffn
        split = self.split_scales(sp.size) if sp is not None else []
        ln = ln_split = self.norm2
        if fold and split:
            ln_split = SimpleNamespace(weight=sp.copy(ln.weight),
                                       bias=sp.copy(ln.bias), eps=ln.eps)
        outs = []
        for i, (s, m, part) in enumerate(zip(
                geo.sides, geo.mults, geo.split(tx1 if fold
                                                else self.norm2(tx1)))):
            ffn = getattr(self, f"mixffn{i + 1}")
            t = part.reshape(B, s * s, C * m)
            rows = None
            if i in split:  # this rank's block of map rows
                blk = sp.block(s)
                rows, t = (blk.start, blk.stop), sp.copy(t)
            if fold:
                f = ffn.folded(t, s, ln_split if rows else ln, groups=m,
                               rows=rows)
            else:
                f = ffn(t, s, s, rows=rows)
            if rows is not None:
                f = sp.gather(f, 1)
            outs.append(f.reshape(B, -1, C))
        out = torch.cat(outs, dim=1)
        return out if fold else tx1 + out


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

    def seq_shard_(self, axis) -> List[str]:
        """Shard the bridge's sequence over the model axis `axis`
        (parallel.tensor.ModelAxis; a no-op at size 1): each layer's
        attention query rows and its divisible scales' FFN map rows.
        Returns the names (under this module) of the parameters whose
        gradient a rank then gets from its block alone, to be summed over
        the axis after the backward: the spatial layers' q and proj where
        the stream divides, the split scales' FFNs."""
        if axis.size <= 1:
            return []
        partial = []
        for i in range(self.n_layers):
            name = f"bridge_layer{i + 1}"
            layer = getattr(self, name)
            layer.seq = axis
            mods = [f"mixffn{j + 1}" for j in layer.split_scales(axis.size)]
            if not layer.ch_att and self.geo.total % axis.size == 0:
                mods += ["attn.q", "attn.proj"]
            partial += [f"{name}.{m}.{n}" for m in mods
                        for n, _ in layer.get_submodule(m).named_parameters()]
        return partial

    def forward(self, maps: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        x = fuse_scales(maps, self.geo.c)
        for i in range(self.n_layers):
            x = getattr(self, f"bridge_layer{i + 1}")(x)
        return split_scales(x, self.geo)


class BridgeBlockPara(nn.Module):
    """'para' bridge (MSTr.py:2500-2538; JAX models/bridge.py:475): a
    channel- and a spatial-attention layer on the input side by side,
    concatenated, Linear + LN + GELU (proj_act), then two spatial layers."""

    def __init__(self, geo: BridgeGeometry, head: int,
                 reduction_ratio: Tuple[int, ...], dtype=torch.bfloat16,
                 folds: Folds = DEFAULT_FOLDS):
        super().__init__()
        self.geo = geo
        for i, ch_att in enumerate((True, False, False, False)):
            self.add_module(f"bridge_layer{i + 1}", BridgeLayer4(
                geo, head, ch_att, reduction_ratio, dtype, folds, True))
        self.proj_act = nn.Sequential(Linear(2 * geo.c, geo.c, dtype=dtype),
                                      LayerNorm(geo.c, dtype=dtype))

    def forward(self, maps: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        x = fuse_scales(maps, self.geo.c)
        dual = torch.cat([self.bridge_layer1(x), self.bridge_layer2(x)], -1)
        x = gelu(self.proj_act(dual))
        return split_scales(self.bridge_layer4(self.bridge_layer3(x)),
                            self.geo)


class MultiScaleAtten(nn.Module):
    """Window-group multi-head attention from ScaleFormer (MSTr.py:
    2542-2559; JAX models/bridge.py:503), 8 heads on (B, gh, gw, N, C). The
    reference defines a scale factor and never applies it; neither does
    this."""

    def __init__(self, dim: int, num_head: int = 8, dtype=torch.bfloat16):
        super().__init__()
        self.num_head = num_head
        self.qkv_linear = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x):
        B, gh, gw, N, C = x.shape
        h = self.num_head
        qkv = self.qkv_linear(x).reshape(B, gh, gw, N, 3, h, C // h)
        q, k, v = qkv.permute(4, 0, 1, 2, 5, 3, 6)
        att = torch.matmul(q.float(), k.float().transpose(-1, -2))
        att = torch.softmax(att, dim=-1).to(v.dtype)
        out = torch.matmul(att, v)
        return self.proj(out.transpose(3, 4).reshape(B, gh, gw, N, C))


class InterTransBlock(nn.Module):
    """LN -> MultiScaleAtten -> res -> LN -> MLP FFN -> res, LN eps 1e-6
    (MSTr.py:2562-2583; JAX models/bridge.py:530). The FFN's dropout runs
    in training, its masks drawn from `gen`."""

    def __init__(self, dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.SlayerNorm_1 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.Attention = MultiScaleAtten(dim, dtype=dtype)
        self.SlayerNorm_2 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.mlp = MLPFFN(dim, 4 * dim, dtype=dtype)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        x = x + self.Attention(self.SlayerNorm_1(x))
        return x + self.mlp(self.SlayerNorm_2(x), not self.training, gen)


WINDOWS = (8, 4, 2, 1)  # SpatialAwareTrans's window side per scale


class SpatialAwareTrans(nn.Module):
    """Window-partitioned cross-scale attention (MSTr.py:2586-2663; JAX
    models/bridge.py:547): each scale projected to `dim` (fc1-fc4) and
    cut into windows of side 8, 4, 2, 1 so that all four land on one
    block grid (7 x 7 at 224²), num InterTransBlocks over each block's
    concatenated tokens, then the windows put back and each scale
    projected to its width (fc_back)."""

    def __init__(self, dims: Sequence[int], dim: int = 64, num: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        for j, c in enumerate(dims):
            self.add_module(f"fc{j + 1}", Linear(c, dim, dtype=dtype))
        self.group_attention = nn.ModuleList(InterTransBlock(dim, dtype)
                                             for _ in range(num))
        self.fc_back = nn.ModuleList(Linear(dim, c, dtype=dtype)
                                     for c in dims)

    def forward(self, maps: Sequence[torch.Tensor],
                gen: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        xs = []
        for j, (m, w) in enumerate(zip(maps, WINDOWS)):
            t = getattr(self, f"fc{j + 1}")(m)
            B, H, W, C = t.shape
            xs.append(t.reshape(B, H // w, w, W // w, w, C).transpose(2, 3)
                      .reshape(B, H // w, W // w, w * w, C))
        x = torch.cat(xs, dim=-2)
        for blk in self.group_attention:
            x = blk(x, gen)
        outs, off = [], 0
        for fc, w in zip(self.fc_back, WINDOWS):
            t = x[..., off:off + w * w, :]
            off += w * w
            B, gh, gw, _, C = t.shape
            t = t.reshape(B, gh, gw, w, w, C).transpose(2, 3)
            outs.append(fc(t.reshape(B, gh * w, gw * w, C)))
        return outs


class BridgeBlockSp(nn.Module):
    """'sp' bridge (MSTr.py:2668-2757; JAX models/bridge.py:591): with
    num_sp > 0 a SpatialAwareTrans of num_sp blocks first (the reference's
    bridge_layer1.scale_fuse_att), then four spatial-attention layers."""

    def __init__(self, geo: BridgeGeometry, dims: Sequence[int], head: int,
                 num_sp: int, reduction_ratio: Tuple[int, ...],
                 dtype=torch.bfloat16, folds: Folds = DEFAULT_FOLDS):
        super().__init__()
        self.geo = geo
        for i in range(4):
            self.add_module(f"bridge_layer{i + 1}", BridgeLayer4(
                geo, head, False, reduction_ratio, dtype, folds, True))
        if num_sp > 0:
            self.bridge_layer1.scale_fuse_att = SpatialAwareTrans(
                dims, geo.c, num_sp, dtype)

    def forward(self, maps: Sequence[torch.Tensor],
                gen: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        x = list(maps)
        sat = getattr(self.bridge_layer1, "scale_fuse_att", None)
        if sat is not None:
            x = sat(x, gen)
        for i in range(4):
            x = getattr(self, f"bridge_layer{i + 1}")(x)
        return split_scales(x, self.geo)
