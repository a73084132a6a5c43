"""The legacy model family, PyTorch port of transception_tpu/models/legacy.py.

  * Transception (networks/Transception.py:1010-1057): the earlier
    two-branch inception encoder (MiT3Inception; the three-branch
    MiT3Inception3Branches) with joint linear attention over the fused
    branch sequences, and the 4-stage decoder cascade, no bridge. The
    4-stage inception encoder (MiTInception4Stage) is built by no registry
    name.
  * MISSFormer (networks/MISSFormer.py:357-405): the rebuilt SegFormer MiT
    encoder (spatial-reduction softmax attention, heads (1, 2, 5, 8),
    ratios (8, 4, 2, 1)), four all-spatial bridge layers, SegFormer
    decoder stages.
  * EffMISSFormer (networks/EfficientMISSFormer.py:302-340): MiT with
    EfficientAttention blocks, the standard decoders, no bridge.
  * ResInceptionTransception (the reference's comment.py, rebuilt): a
    strided patch-embed branch and a MultiRes inception-conv branch fused
    into one token sequence per stage.

NHWC in, (B, H, W, num_classes) fp32 logits out; gray inputs repeated to 3
channels. The JAX package builds these models' transformer blocks and
decoders without use_pallas, so every block runs unfolded here too
(legacy_folds), whatever use_kernels says: the linear attentions through
the linear-attention kernel (K6, a port choice, as the MSTransception
blocks' unfolded path), the expands through the patch-expand kernel (K7).
MISSFormer's bridge keeps the JAX model's use_pallas (legacy.py:593-598),
the sp and para bridges' kernel switch here (sp_bridge_fold): the folded
bridge attention (K8) and the per-scale FFN folds (K2, K11 in training).
In training every kernel stays on (kernel_set), as JAX train_step_model
leaves these models as they are; the kernels without a backward kernel
are differentiated through their plain versions. BatchNorm (MultiRes
branches, SK fusion) takes batch statistics in .train() mode.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from transception_tpu_torch.core.config import (
    FoldSwitches,
    Folds,
    TransceptionConfig,
    fold_switches,
)
from transception_tpu_torch.core.device import DeviceLike
from transception_tpu_torch.models.bridge import (
    BridgeGeometry,
    BridgeLayer4,
    split_scales,
)
from transception_tpu_torch.models.decoder import DecoderLayer
from transception_tpu_torch.models.transception import model_device
from transception_tpu_torch.ops import kernels
from transception_tpu_torch.ops.attention import EfficientTransformerBlock
from transception_tpu_torch.ops.common import (
    MLPFFN,
    Conv2d,
    LayerNorm,
    Linear,
    OverlapPatchEmbed,
    init_weights,
    make_ffn,
)
from transception_tpu_torch.ops.fusion import SKBlock
from transception_tpu_torch.ops.multires import MultiResBlock

LAYERS = (2, 2, 2, 2)  # transformer blocks per stage (legacy.py:213)


def legacy_folds(cfg: TransceptionConfig) -> Folds:
    """Every fold off in eval and training (the JAX legacy blocks take no
    use_pallas), except the bridge switch of fold_switches, which
    MISSFormer's bridge layers follow."""
    return tuple(FoldSwitches(False, False, False, False, False, False,
                              fold_switches(cfg, t).sp_bridge)
                 for t in (False, True))


def kernel_set(cfg: TransceptionConfig) -> frozenset:
    """The kernels a legacy model runs, in eval and in training alike:
    all with use_kernels, else none."""
    return kernels.SWITCHES if cfg.use_kernels else frozenset()


def torch_nearest_resize(x: torch.Tensor, out_h: int, out_w: int):
    """F.interpolate(mode='nearest') with torch's floor index convention
    on a (B, H, W, C) map (legacy.py:52-58)."""
    B, H, W, C = x.shape
    rows = torch.arange(out_h, device=x.device) * H // out_h
    cols = torch.arange(out_w, device=x.device) * W // out_w
    return x[:, rows][:, :, cols]


def _ffn(mlp, h, H, W):
    """A block's FFN of token_mlp on (B, H·W, C) tokens: the 'mlp' FFN on
    the tokens alone, without dropout (ops.attention
    EfficientTransformerBlock), the MixFFNs on the map, plain (the JAX
    blocks build them without use_pallas)."""
    return mlp(h) if isinstance(mlp, MLPFFN) else mlp(h, H, W)


class FuseEfficientAttention(nn.Module):
    """Linear attention over the fused multi-branch sequence
    (Transception.py:18-87; legacy.py:61-92): each projection of
    (B, N, D) raw-reshaped to (B, D, N), a view, not a transpose, as the
    reference does; head_count heads of D/h channels through the
    linear-attention kernel (the softmax of Q); the heads merged back the
    same raw way, then the reprojection."""

    def __init__(self, dim: int, key_channels: int, value_channels: int,
                 head_count: int = 1, dtype=torch.bfloat16):
        super().__init__()
        self.kc, self.vc, self.heads = key_channels, value_channels, \
            head_count
        self.keys = Linear(dim, key_channels, dtype=dtype)
        self.queries = Linear(dim, key_channels, dtype=dtype)
        self.values = Linear(dim, value_channels, dtype=dtype)
        self.reprojection = Linear(value_channels, dim, dtype=dtype)

    def forward(self, x):
        B, N, _ = x.shape
        h = self.heads

        def to_heads(t, ch):  # (B, N, ch) viewed (B, ch, N) -> (B, h, N, ch/h)
            return t.reshape(B, h, ch // h, N).transpose(2, 3)

        out = kernels.linear_attention.linear_attention(
            to_heads(self.queries(x), self.kc),
            to_heads(self.keys(x), self.kc),
            to_heads(self.values(x), self.vc), q_softmax=True)
        out = out.transpose(2, 3).reshape(B, self.vc, N).transpose(1, 2)
        return self.reprojection(out)


class EfficientTransformerBlockFuse(nn.Module):
    """Joint attention over 2-3 branch sequences, then per branch norm2,
    MixFFN and residual (Transception.py:188-251; legacy.py:95-126); the
    third branch reuses mlp2."""

    def __init__(self, dim: int, head_count: int = 1,
                 token_mlp: str = "mix_skip", dtype=torch.bfloat16):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = FuseEfficientAttention(dim, dim, dim, head_count, dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp1 = make_ffn(token_mlp, dim, dim * 4, dtype)
        self.mlp2 = make_ffn(token_mlp, dim, dim * 4, dtype)

    def forward(self, x, lens: Sequence[int],
                sizes: Sequence[Tuple[int, int]]):
        tx = x + self.attn(self.norm1(x))
        mlps = (self.mlp1, self.mlp2, self.mlp2)
        outs, off = [], 0
        for mlp, n, (hh, ww) in zip(mlps, lens, sizes):
            z = tx[:, off:off + n]
            off += n
            outs.append(z + _ffn(mlp, self.norm2(z), hh, ww))
        return torch.cat(outs, dim=1)


class EfficientTransformerBlockFuseRes(nn.Module):
    """Joint attention (one head), then one shared FFN without a norm over
    chunks of chunk_len tokens (Transception.py:253-304;
    legacy.py:129-153)."""

    def __init__(self, dim: int, token_mlp: str = "mix_skip",
                 dtype=torch.bfloat16):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = FuseEfficientAttention(dim, dim, dim, 1, dtype)
        self.mlp = make_ffn(token_mlp, dim, dim * 4, dtype)

    def forward(self, x, chunk_len: int, H: int, W: int):
        tx = x + self.attn(self.norm1(x))
        return torch.cat([z + _ffn(self.mlp, z, H, W)
                          for z in tx.split(chunk_len, dim=1)], dim=1)


class OverlapPatchEmbedFuse(nn.Module):
    """Patch embed with a dilation knob (EffSegformer.py:117-131;
    legacy.py:156-177): conv, tokens, LN; returns (tokens, H, W). With
    target_size, the map is centre-padded with zeros up to that side
    before the tokens (OverlapPatchEmbedFusePadding, EffSegformer.py:
    91-114; legacy.py:354-383)."""

    def __init__(self, in_ch: int, dim: int, patch_size: int, stride: int,
                 padding: int, dilation: int = 1,
                 target_size: Optional[int] = None, dtype=torch.bfloat16):
        super().__init__()
        self.target = target_size
        self.proj = Conv2d(in_ch, dim, patch_size, stride, padding,
                           dtype=dtype, dilation=dilation)
        self.norm = LayerNorm(dim, dtype=dtype)

    def forward(self, x):
        y = self.proj(x)
        H1 = y.shape[1]
        if self.target is not None and H1 != self.target:
            lo = (self.target - H1) // 2
            hi = self.target - H1 - lo
            y = F.pad(y, (0, 0, lo, hi, lo, hi))
        B, H, W, C = y.shape
        return self.norm(y.reshape(B, H * W, C)), H, W


def OverlapPatchEmbedFusePadding(in_ch: int, dim: int, patch_size: int,
                                 stride: int, padding: int, dilation: int = 1,
                                 target_size: int = 28, dtype=torch.bfloat16):
    """OverlapPatchEmbedFuse with the JAX class's default target side."""
    return OverlapPatchEmbedFuse(in_ch, dim, patch_size, stride, padding,
                                 dilation, target_size, dtype)


def two_branch_schedule(dil_conv: int):
    """(branch 1, branch 2, dilation) of the two-branch encoder's patch
    embeds, kernels k and paddings p per stage (Transception.py:371-394;
    legacy.py:181-186)."""
    if dil_conv:
        return (dict(k=(7, 3, 3, 3), p=(3, 0, 0, 0)),
                dict(k=(1, 1, 1, 1), p=(0, 0, 0, 0)), 2)
    return (dict(k=(7, 3, 3, 3), p=(3, 1, 1, 1)),
            dict(k=(5, 1, 1, 1), p=(1, 0, 0, 0)), 1)


def three_branch_schedule(dil_conv: int):
    """The three-branch encoder's (Transception.py:563-579;
    legacy.py:189-196)."""
    if dil_conv:
        return (dict(k=(7, 5, 5, 5), p=(3, 0, 0, 0)),
                dict(k=(0, 3, 3, 3), p=(0, 0, 0, 0)),
                dict(k=(0, 1, 1, 1), p=(0, 0, 0, 0)), 2)
    return (dict(k=(7, 3, 3, 3), p=(3, 1, 1, 1)),
            dict(k=(5, 1, 1, 1), p=(1, 0, 0, 0)),
            dict(k=(0, 5, 5, 5), p=(0, 2, 2, 2)), 1)


def _add_blocks(module: nn.Module, stage: int, blocks) -> None:
    """A stage's blocks under the JAX names block{s}_{i}: the ModuleList
    block{s}.{i} (the converter's list renames, convert/from_jax.py)."""
    module.add_module(f"block{stage}", nn.ModuleList(blocks))


def _blocks(module: nn.Module, stage: int) -> nn.ModuleList:
    return getattr(module, f"block{stage}")


def _add_fused_stage(module: nn.Module, cfg: TransceptionConfig, s: int,
                     cin: int, embeds, merge: str = "conv") -> None:
    """Stage s + 1 of the inception encoders under the JAX names: a patch
    embed per (kernel, stride, padding, dilation) of `embeds` on a map of
    cin channels (patch_embed{st}_{j}), the fuse blocks (block{st}), LN
    (norm{st}), and the merge: a 1x1 conv over the branches' channels
    (conv1_1_s{st}) or, merge 'sk', SK fusion (sk_concat{st})."""
    dt, d, st = cfg.compute_dtype, cfg.dims[s], s + 1
    for j, (k, stride, p, dil) in enumerate(embeds, 1):
        module.add_module(f"patch_embed{st}_{j}", OverlapPatchEmbedFuse(
            cin, d, k, stride, p, dil, dtype=dt))
    _add_blocks(module, st, [EfficientTransformerBlockFuse(
        d, cfg.head_count, cfg.token_mlp, dt) for _ in range(LAYERS[s])])
    module.add_module(f"norm{st}", LayerNorm(d, dtype=dt))
    if merge == "sk":
        module.add_module(f"sk_concat{st}", SKBlock(d, d, 2, 16, dtype=dt))
    else:
        module.add_module(f"conv1_1_s{st}",
                          Conv2d(len(embeds) * d, d, 1, dtype=dt))


def _run_fused_stage(module: nn.Module, st: int, m, target: int,
                     resize) -> list:
    """Stage st of an inception encoder on map m, up to the merge: the
    branches' tokens concatenated through the fuse blocks and LN, split
    back into maps; branch j nearest-resized to target x target where
    resize[j]."""
    branches = [getattr(module, f"patch_embed{st}_{j}")(m)
                for j in range(1, len(resize) + 1)]
    lens = [t.shape[1] for t, _, _ in branches]
    sizes = [(H, W) for _, H, W in branches]
    cat = torch.cat([t for t, _, _ in branches], dim=1)
    for blk in _blocks(module, st):
        cat = blk(cat, lens, sizes)
    cat = getattr(module, f"norm{st}")(cat)
    B, C = cat.shape[0], cat.shape[-1]
    maps = [t.reshape(B, H, W, C)
            for t, (H, W) in zip(cat.split(lens, dim=1), sizes)]
    return [torch_nearest_resize(mp, target, target) if r else mp
            for mp, r in zip(maps, resize)]


class _EffStage1(nn.Module):
    """Stage 1 shared by the inception encoders: the 7x7/4 patch embed,
    two unfolded EfficientTransformerBlocks, LN (legacy.py:217-225)."""

    def _stage1(self, cfg: TransceptionConfig, folds: Optional[Folds]):
        dt, d = cfg.compute_dtype, cfg.dims
        folds = folds or legacy_folds(cfg)
        self.patch_embed1 = OverlapPatchEmbed(3, d[0], 7, 4, 3, dtype=dt)
        _add_blocks(self, 1, [EfficientTransformerBlock(
            d[0], dt, folds, cfg.token_mlp) for _ in range(LAYERS[0])])
        self.norm1 = LayerNorm(d[0], dtype=dt)

    def _run_stage1(self, x):
        t, H, W = self.patch_embed1(x)
        for blk in self.block1:
            t = blk(t, H, W)
        t = self.norm1(t)
        return t.reshape(t.shape[0], H, W, -1)


class MiT3Inception(_EffStage1):
    """Two-branch inception encoder (Transception.py:362-551; legacy.py:
    199-259): stages 2-4 embed the map with two kernel schedules, run
    joint fuse blocks over both branches' tokens, split them, resize
    branch 1 to the stage's side (nearest, torch's convention) and merge
    by a 1x1 conv ('original') or SK fusion ('sk')."""

    def __init__(self, cfg: TransceptionConfig, concat: str = "original",
                 folds: Optional[Folds] = None):
        super().__init__()
        self.cfg, self.concat = cfg, concat
        self._stage1(cfg, folds)
        *schedules, dil = two_branch_schedule(cfg.dil_conv)
        for s in range(1, 4):
            _add_fused_stage(self, cfg, s, cfg.dims[s - 1], [
                (sch["k"][s], 2, sch["p"][s], dil) for sch in schedules],
                "conv" if concat == "original" else "sk")

    def forward(self, x):
        m = self._run_stage1(x)
        outs, target = [m], self.cfg.img_size // 4
        for st in range(2, 5):
            target //= 2
            maps = _run_fused_stage(self, st, m, target, (True, False))
            if self.concat == "original":
                m = getattr(self, f"conv1_1_s{st}")(torch.cat(maps, -1))
            else:
                m = getattr(self, f"sk_concat{st}")(maps)
            outs.append(m)
        return outs


class MiT3Inception3Branches(_EffStage1):
    """Three-branch variant (Transception.py:553-723; legacy.py:262-315):
    every branch resized to the stage's side and merged by a 1x1 conv."""

    def __init__(self, cfg: TransceptionConfig,
                 folds: Optional[Folds] = None):
        super().__init__()
        self.cfg = cfg
        self._stage1(cfg, folds)
        *schedules, dil = three_branch_schedule(cfg.dil_conv)
        for s in range(1, 4):
            _add_fused_stage(self, cfg, s, cfg.dims[s - 1], [
                (sch["k"][s], 2, sch["p"][s], dil) for sch in schedules])

    def forward(self, x):
        m = self._run_stage1(x)
        outs, target = [m], self.cfg.img_size // 4
        for st in range(2, 5):
            target //= 2
            maps = _run_fused_stage(self, st, m, target, (True,) * 3)
            m = getattr(self, f"conv1_1_s{st}")(torch.cat(maps, -1))
            outs.append(m)
        return outs


class MiTInception4Stage(nn.Module):
    """4-stage two-branch inception encoder (Transception.py:728-889;
    legacy.py:386-434, the intended semantics of the reference's dead
    class: dilation 1, kernels 7/5 then 3/1, paddings 3/3 then 0/0): both
    branches resized to each stage's side and merged by a 1x1 conv."""

    K1, P1 = (7, 3, 3, 3), (3, 0, 0, 0)
    K2, P2 = (5, 1, 1, 1), (3, 0, 0, 0)
    STRIDES = (4, 2, 2, 2)

    def __init__(self, cfg: TransceptionConfig):
        super().__init__()
        self.cfg = cfg
        for s in range(4):
            _add_fused_stage(self, cfg, s, 3 if s == 0 else cfg.dims[s - 1],
                             [(k[s], self.STRIDES[s], p[s], 1) for k, p in
                              ((self.K1, self.P1), (self.K2, self.P2))])

    def forward(self, x):
        outs, m, target = [], x, self.cfg.img_size
        for s in range(4):
            target //= self.STRIDES[s]
            maps = _run_fused_stage(self, s + 1, m, target, (True, True))
            m = getattr(self, f"conv1_1_s{s + 1}")(torch.cat(maps, -1))
            outs.append(m)
        return outs


class SegformerSelfAtten(nn.Module):
    """SegFormer spatial-reduction softmax attention (legacy.py:442-478):
    the keys and values from the map reduced by an r x r stride-r conv
    ('SAME', flax's default) and LN, standard multi-head attention. The
    JAX rounding points: the scores formed in fp32 from the compute-dtype
    q and k and scaled, the softmax in fp32 rounded to v's dtype, P·V
    summed in fp32 and rounded (fp32 products here)."""

    def __init__(self, dim: int, head: int, reduction_ratio: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.head, self.r = head, reduction_ratio
        self.q = Linear(dim, dim, dtype=dtype)
        if reduction_ratio > 1:
            self.sr = Conv2d(dim, dim, reduction_ratio, reduction_ratio,
                             dtype=dtype)
            self.sr_norm = LayerNorm(dim, dtype=dtype)
        self.kv = Linear(dim, 2 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def _reduce(self, x, H, W):
        B, N, C = x.shape
        r = self.r
        m = x.reshape(B, H, W, C)
        ph, pw = (max((math.ceil(n / r) - 1) * r + r - n, 0) for n in (H, W))
        if ph or pw:  # flax 'SAME': the extra row and column at the end
            m = F.pad(m, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        return self.sr_norm(self.sr(m).reshape(B, -1, C))

    def forward(self, x, H: int, W: int):
        B, N, C = x.shape
        h = self.head
        d = C // h
        q = self.q(x).reshape(B, N, h, d).transpose(1, 2)
        xr = self._reduce(x, H, W) if self.r > 1 else x
        M = xr.shape[1]
        k, v = self.kv(xr).reshape(B, M, 2, h, d).permute(2, 0, 3, 1, 4)
        att = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            * (d ** -0.5)
        att = torch.softmax(att, dim=-1).to(v.dtype)
        out = torch.matmul(att.float(), v.float()).to(v.dtype)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class SegformerTransformerBlock(nn.Module):
    """LN -> SR attention -> residual -> LN -> FFN -> residual
    (legacy.py:481-498), the FFN of token_mlp, plain."""

    def __init__(self, dim: int, head: int, reduction_ratio: int = 1,
                 token_mlp: str = "mix_skip", dtype=torch.bfloat16):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = SegformerSelfAtten(dim, head, reduction_ratio, dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = make_ffn(token_mlp, dim, dim * 4, dtype)

    def forward(self, x, H: int, W: int):
        x = x + self.attn(self.norm1(x), H, W)
        return x + _ffn(self.mlp, self.norm2(x), H, W)


HEADS = (1, 2, 5, 8)       # MiT heads per stage (legacy.py:506, 600)
SR_RATIOS = (8, 4, 2, 1)   # spatial-reduction ratios (legacy.py:507, 601)
PATCH = ((7, 4, 3), (3, 2, 1), (3, 2, 1), (3, 2, 1))  # kernel, stride, pad


class _MiT(nn.Module):
    """The 4-stage MiT shape shared by SegformerMiT and EffMiT: patch
    embed, two blocks (block(s) builds one), LN, per stage."""

    def _build(self, cfg: TransceptionConfig, block):
        dt, d = cfg.compute_dtype, cfg.dims
        for s in range(4):
            k, st, p = PATCH[s]
            self.add_module(f"patch_embed{s + 1}", OverlapPatchEmbed(
                3 if s == 0 else d[s - 1], d[s], k, st, p, dtype=dt))
            _add_blocks(self, s + 1, [block(s) for _ in range(LAYERS[s])])
            self.add_module(f"norm{s + 1}", LayerNorm(d[s], dtype=dt))

    def forward(self, x):
        outs, m = [], x
        for s in range(1, 5):
            t, H, W = getattr(self, f"patch_embed{s}")(m)
            for blk in _blocks(self, s):
                t = blk(t, H, W)
            t = getattr(self, f"norm{s}")(t)
            m = t.reshape(t.shape[0], H, W, -1)
            outs.append(m)
        return outs


class SegformerMiT(_MiT):
    """The rebuilt MiT encoder (legacy.py:501-530): SegFormer blocks with
    heads (1, 2, 5, 8) and spatial-reduction ratios (8, 4, 2, 1)."""

    def __init__(self, cfg: TransceptionConfig, heads=HEADS,
                 sr_ratios=SR_RATIOS):
        super().__init__()
        self._build(cfg, lambda s: SegformerTransformerBlock(
            cfg.dims[s], heads[s], sr_ratios[s], cfg.token_mlp,
            cfg.compute_dtype))


class EffMiT(_MiT):
    """MiT with unfolded EfficientTransformerBlocks
    (EfficientMISSFormer.py:108-181; legacy.py:620-646)."""

    def __init__(self, cfg: TransceptionConfig,
                 folds: Optional[Folds] = None):
        super().__init__()
        folds = folds or legacy_folds(cfg)
        self._build(cfg, lambda s: EfficientTransformerBlock(
            cfg.dims[s], cfg.compute_dtype, folds, cfg.token_mlp))


class SegformerDecoderLayer(DecoderLayer):
    """MISSFormer decoder stage (MISSFormer.py:296-355; legacy.py:533-572):
    the decoder stage of models/decoder.py with two SegFormer blocks in
    place of its EfficientTransformerBlocks; the logits head only."""

    def __init__(self, in_dim: int, out_dim: int, head: int,
                 reduction_ratio: int, n_class: int = 9,
                 is_last: bool = False, bottom: bool = False,
                 dtype=torch.bfloat16, token_mlp: str = "mix_skip"):
        super().__init__(in_dim, out_dim, n_class, is_last, bottom, dtype,
                         token_mlp=token_mlp)
        if not bottom:
            for name in ("layer_former_1", "layer_former_2"):
                setattr(self, name, SegformerTransformerBlock(
                    out_dim, head, reduction_ratio, token_mlp, dtype))


# MiTResInception's MultiRes streams per inception key (legacy.py:684-691).
INCEPTION_BRANCHES = {
    "1": ("res",),
    "3": ("3",),
    "5": ("5",),
    "13": ("res", "3"),
    "15": ("res", "5"),
    "135": ("res", "3", "5"),
}


class MiTResInception(_EffStage1):
    """MiT_3_ResInception encoder (comment.py:5-203, rebuilt as
    legacy.py:694-764): stages 2-4 fuse a strided patch-embed branch and a
    MultiRes branch (its streams max-pooled onto the same grid) into one
    sequence, run EfficientTransformerBlockFuseRes over it, LN, split it
    into equal chunks, concatenate them along the channels and project to
    the stage's width by a 1x1 conv ((1 + streams)·dim inputs)."""

    def __init__(self, cfg: TransceptionConfig, inception: str = "15",
                 folds: Optional[Folds] = None):
        super().__init__()
        dt, d = cfg.compute_dtype, cfg.dims
        dil, pads = (2, (3, 2, 2, 2)) if cfg.dil_conv else (1, (3, 1, 1, 1))
        branches = INCEPTION_BRANCHES[inception]
        self._stage1(cfg, folds)
        for s in range(1, 4):
            st = s + 1
            self.add_module(f"patch_embed{st}_1", OverlapPatchEmbedFuse(
                d[s - 1], d[s], 3, 2, pads[s], dil, dtype=dt))
            self.add_module(f"resInception{st}_2", MultiResBlock(
                d[s - 1], d[s], branches, downsample=2, dtype=dt))
            _add_blocks(self, st, [EfficientTransformerBlockFuseRes(
                d[s], cfg.token_mlp, dt) for _ in range(LAYERS[s])])
            self.add_module(f"norm{st}", LayerNorm(d[s], dtype=dt))
            self.add_module(f"conv1_1_s{st}", Conv2d(
                (1 + len(branches)) * d[s], d[s], 1, dtype=dt))

    def forward(self, x):
        m = self._run_stage1(x)
        outs = [m]
        for s in range(2, 5):
            x1, H1, W1 = getattr(self, f"patch_embed{s}_1")(m)
            n1 = x1.shape[1]
            cat = torch.cat([x1, getattr(self, f"resInception{s}_2")(m)],
                            dim=1)
            for blk in _blocks(self, s):
                cat = blk(cat, n1, H1, W1)
            tx = getattr(self, f"norm{s}")(cat)
            B, C = tx.shape[0], tx.shape[-1]
            maps = [t.reshape(B, H1, W1, C) for t in tx.split(n1, dim=1)]
            m = getattr(self, f"conv1_1_s{s}")(torch.cat(maps, -1))
            outs.append(m)
        return outs


class _LegacyModel(nn.Module):
    """What the legacy models share: the config, the device and the
    kernel-dtype check, the seeded init, gray inputs repeated to 3
    channels, the kernel set per call, the four-stage decoder cascade."""

    def _setup(self, cfg: TransceptionConfig, device: DeviceLike):
        cfg = cfg.validate()
        self.cfg = cfg
        self.folds = legacy_folds(cfg)
        return model_device(cfg, device)

    def _decoders(self, make) -> None:
        """decoder_3 .. decoder_0 (legacy.py:337-351): make(i, in_dim,
        out_dim, is_last, bottom) builds stage 3 - i."""
        d, ins = self.cfg.dims, self.cfg.decoder_in_chans()
        for i in range(4):
            self.add_module(f"decoder_{3 - i}", make(
                i, ins[i], d[3 - i], i == 3, i == 0))

    def _finish(self, dev: torch.device, seed: int) -> None:
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(dev).eval()

    def _decode(self, enc):
        B, h4, w4, c4 = enc[3].shape
        t = self.decoder_3(enc[3].reshape(B, h4 * w4, c4))
        t = self.decoder_2(t, enc[2])
        t = self.decoder_1(t, enc[1])
        return self.decoder_0(t, enc[0])

    def encode(self, x):
        """The encoder's four maps (the bridge's too, MISSFormer)."""
        return self.backbone(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 1|3) -> (B, H, W, num_classes) fp32 logits (no
        fused argmax: eval.inference takes the argmax of the logits)."""
        if x.shape[-1] == 1:
            x = x.expand(*x.shape[:-1], 3)
        with kernels.enabled(kernel_set(self.cfg)
                             & kernels.active()):
            return self._decode(self.encode(x.to(self.cfg.compute_dtype)))


def _std_decoder(model: _LegacyModel):
    """The standard decoder stages (models/decoder.py), unfolded."""
    cfg = model.cfg

    def make(i, in_dim, out_dim, is_last, bottom):
        return DecoderLayer(in_dim, out_dim, cfg.num_classes, is_last=is_last,
                            bottom=bottom, dtype=cfg.compute_dtype,
                            folds=model.folds, token_mlp=cfg.token_mlp)
    return make


class Transception(_LegacyModel):
    """Legacy entry model (Transception.py:1010-1057; legacy.py:318-351):
    the two-branch inception encoder (encoder '3inception', concat
    'original' or 'sk') or the three-branch one ('3branches'), and the
    decoder cascade, no bridge."""

    def __init__(self, cfg: TransceptionConfig = TransceptionConfig(
            head_count=1), encoder: str = "3inception",
                 concat: str = "original", device: DeviceLike = "cuda",
                 seed: int = 0):
        super().__init__()
        dev = self._setup(cfg, device)
        self.backbone = (MiT3Inception3Branches(self.cfg, self.folds)
                         if encoder == "3branches" else
                         MiT3Inception(self.cfg, concat, self.folds))
        self._decoders(_std_decoder(self))
        self._finish(dev, seed)


class MISSFormer(_LegacyModel):
    """Baseline U-former (MISSFormer.py:357-405; legacy.py:575-617): the
    SegFormer MiT, with if_bridge four all-spatial bridge layers (head 1,
    the bridge's reduction ratios), SegFormer decoder stages."""

    def __init__(self, cfg: TransceptionConfig = TransceptionConfig(),
                 if_bridge: bool = True, device: DeviceLike = "cuda",
                 seed: int = 0):
        super().__init__()
        dev = self._setup(cfg, device)
        cfg, dt = self.cfg, self.cfg.compute_dtype
        self.backbone = SegformerMiT(cfg)
        self.if_bridge = if_bridge
        if if_bridge:
            self.geo = BridgeGeometry(cfg.img_size, cfg.dims, cfg.bridge_dim)
            for i in range(4):
                self.add_module(f"bridge_layer{i + 1}", BridgeLayer4(
                    self.geo, 1, False, cfg.reduction_ratios, dt, self.folds,
                    sp_bridge=True))

        def make(i, in_dim, out_dim, is_last, bottom):
            return SegformerDecoderLayer(
                in_dim, out_dim, HEADS[3 - i], SR_RATIOS[3 - i],
                cfg.num_classes, is_last, bottom, dt, cfg.token_mlp)
        self._decoders(make)
        self._finish(dev, seed)

    def encode(self, x):
        enc = self.backbone(x)
        if not self.if_bridge:
            return enc
        out = enc
        for i in range(4):
            out = getattr(self, f"bridge_layer{i + 1}")(out)
        return split_scales(out, self.geo)


class EffMISSFormer(_LegacyModel):
    """MISSFormer with EfficientAttention blocks and no bridge
    (EfficientMISSFormer.py:302-340; legacy.py:649-677)."""

    def __init__(self, cfg: TransceptionConfig = TransceptionConfig(),
                 device: DeviceLike = "cuda", seed: int = 0):
        super().__init__()
        dev = self._setup(cfg, device)
        self.backbone = EffMiT(self.cfg, self.folds)
        self._decoders(_std_decoder(self))
        self._finish(dev, seed)


class ResInceptionTransception(_LegacyModel):
    """The MiTResInception encoder and the decoder cascade, no bridge
    (legacy.py:767-797); `inception` picks the MultiRes streams
    (INCEPTION_BRANCHES)."""

    def __init__(self, cfg: TransceptionConfig = TransceptionConfig(),
                 inception: str = "15", device: DeviceLike = "cuda",
                 seed: int = 0):
        super().__init__()
        dev = self._setup(cfg, device)
        self.backbone = MiTResInception(self.cfg, inception, self.folds)
        self._decoders(_std_decoder(self))
        self._finish(dev, seed)


# Registry name -> (class, keyword arguments) (JAX models/registry.py:46-57).
MODELS = {
    "transception": (Transception, {}),
    "missformer": (MISSFormer, {}),
    "effmissformer": (EffMISSFormer, {}),
    "resinception": (ResInceptionTransception, {}),
    "resinception_135": (ResInceptionTransception, dict(inception="135")),
}


def build(name: str, cfg: TransceptionConfig, device: DeviceLike = "cuda",
          seed: int = 0) -> _LegacyModel:
    """The legacy model registered as `name` with the caller's config."""
    cls, kw = MODELS[name]
    return cls(cfg, device=device, seed=seed, **kw)


def _forward_calls(name: str, cfg: TransceptionConfig,
                   training: bool) -> Counter:
    """Kernel-wrapper calls of one forward of registry model `name`: K6 on
    every linear attention (two stage-1 blocks and two blocks a stage in
    the inception encoders and EffMiT, two blocks in each of decoders
    2-0), K7 on the three x2 expands and the x4 one, MISSFormer's four
    bridge layers (K8 and the FFN folds on the even-sided scales,
    kernels.mixffn.takes, with the bridge switch; else K3)."""
    calls = Counter(patch_expand=4)
    if name == "missformer":
        if fold_switches(cfg, training).sp_bridge:
            calls["bridge_attention_folded"] += 4
            calls["mixffn"] += 4 * sum(kernels.mixffn.takes(
                cfg.stage1_res >> i) for i in range(4))
        else:
            calls["bridge_attention"] += 4
        return calls
    calls["linear_attention"] += sum(LAYERS) + 3 * 2
    return calls


def _launches(name: str, cfg: TransceptionConfig, training: bool) -> dict:
    counts = {n: 0 for n, _, _ in kernels.COUNTERS}
    on = kernel_set(cfg)
    for n, c in _forward_calls(name, cfg, training).items():
        if n in on:
            counts[n] += c
    if training:  # one backward kernel per K3 and K2 forward
        counts[kernels.bridge_attention.BWD_NAME] = counts["bridge_attention"]
        counts[kernels.mixffn.BWD_NAME] = counts["mixffn"]
    return counts


def launches_per_forward(name: str, cfg: TransceptionConfig) -> dict:
    """Kernel launches of one eval forward of registry model `name` with
    config `cfg` on the card, per counter of ops.kernels.launch_counts (a
    pure function of name and config; every count 0 without
    use_kernels)."""
    return _launches(name, cfg, False)


def launches_per_step(name: str, cfg: TransceptionConfig) -> dict:
    """Kernel launches of one train step (forward and backward) of
    registry model `name`: the forward's (the same kernels as in eval),
    and K10 and K11 once per K3 and K2 forward."""
    return _launches(name, cfg, True)
