"""MSViT backbones, PyTorch port of transception_tpu/models/msvit.py: the
3-stage default (MSViT), the all-MHCA 4-stage variant (MSViT4Stages) and
the casa variant (MSViTCasa), with every IFF fusion mode of the MHCA
stages.

Behavioral reference: networks/MSTr.py:1350-1441 (MHCA_stage), :1443-1533
(casa), :1536-1744 (MSViT), :1746-1988 (MSViT_4Stages), :1990-2204
(MSViT_casa). Stages emit NHWC maps at /4, /8, /16, /32 with dims (64,
128, 320, 512). The per-path MHCA encoders are a ModuleList
(`mhca_blks.{i}`), run one after another. The MHCA blocks' drop-path
rates decay linearly over the stages' layers (dpr_schedule).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint

from transception_tpu_torch.core.config import (
    CRPE_WINDOW,
    DEFAULT_FOLDS,
    Folds,
    TransceptionConfig,
    fold_table,
)
from transception_tpu_torch.ops.attention import (
    EfficientTransformerBlock,
    MHCAEncoder,
)
from transception_tpu_torch.ops.common import LayerNorm, OverlapPatchEmbed
from transception_tpu_torch.ops.conv import (
    Conv2dBN,
    PatchEmbedStage,
    ResBlock,
)
from transception_tpu_torch.ops.fusion import (
    CBAMBlock,
    CBAMBlockCasa,
    Conv3dBNChannelAttentionConcat,
    Conv3dBNConcat,
    CoordAtt,
    SEBlock,
    SKBlock,
)


def dpr_schedule(drop_path_rate: float, num_layers: Sequence[int]
                 ) -> List[Tuple[float, ...]]:
    """Per-stage drop-path rates, a linear decay from 0 to drop_path_rate
    over all MHCA layers (JAX msvit.py:35-46, MSTr.py:1112-1124)."""
    total = sum(num_layers)
    if total == 0 or drop_path_rate == 0.0:
        return [(0.0,) * n for n in num_layers]
    flat = np.linspace(0.0, drop_path_rate, total).tolist()
    out, cur = [], 0
    for n in num_layers:
        out.append(tuple(flat[cur:cur + n]))
        cur += n
    return out


def _aggregate(concat: str, casa: bool, embed_dim: int, out_dim: int,
               paths: int, use_sa: bool, sa_ker: int, inter: str, dtype
               ) -> Tuple[nn.Module, bool]:
    """The IFF block of an MHCA stage fusing `paths` maps of embed_dim
    channels (JAX msvit.py:105-157), and whether it takes their
    concatenation (else the list). casa: only normal and se concatenate,
    cbam is the casa CBAM."""
    cat = embed_dim * paths
    if concat == "normal":
        return Conv2dBN(cat, out_dim, act=True, dtype=dtype), True
    if concat == "se":
        return SEBlock(cat, out_dim, 16, dtype), True
    if concat == "cbam":
        if casa:
            return CBAMBlockCasa(cat, out_dim, use_sa, 16, sa_ker, inter,
                                 dtype), False
        return CBAMBlock(cat, out_dim, use_sa, 16, sa_ker, dtype), True
    if concat == "coord" and not casa:
        return CoordAtt(cat, out_dim, 16, dtype), True
    if concat == "3d":
        return Conv3dBNConcat(embed_dim, out_dim, paths, dtype), False
    if concat == "skn":
        return SKBlock(embed_dim, out_dim, paths, 8, dtype=dtype), False
    return Conv3dBNChannelAttentionConcat(embed_dim, out_dim, paths, concat,
                                          dtype), False


class MHCAStage(nn.Module):
    """MB-Transformer stage + IFF fusion (MSTr.py:1350-1441, casa
    :1443-1533): ResBlock on path 0 plus one MHCAEncoder per path (each at
    the stage's per-layer drop-path rates), fused by the `concat` mode
    (CoordAtt, the published 'coord', by default)."""

    def __init__(self, embed_dim: int, out_embed_dim: int, num_layers: int,
                 num_heads: int, mlp_ratio: int, num_path: int,
                 dtype=torch.bfloat16, folds: Folds = DEFAULT_FOLDS,
                 drop_path_rates=(), concat: str = "coord",
                 use_sa: bool = True, sa_ker: int = 7, inter: str = "res",
                 casa: bool = False):
        super().__init__()
        self.InvRes = ResBlock(embed_dim, dtype)
        self.mhca_blks = nn.ModuleList(
            MHCAEncoder(embed_dim, num_layers, num_heads, mlp_ratio,
                        CRPE_WINDOW, dtype, folds, drop_path_rates)
            for _ in range(num_path))
        self.aggregate, self.takes_cat = _aggregate(
            concat, casa, embed_dim, out_embed_dim, num_path + 1, use_sa,
            sa_ker, inter, dtype)

    def forward(self, inputs: List[torch.Tensor],
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        outs = [self.InvRes(inputs[0])]
        outs += [enc(x, gen) for enc, x in zip(self.mhca_blks, inputs)]
        return self.aggregate(torch.cat(outs, dim=-1) if self.takes_cat
                              else outs)


def remat_stage(stage: nn.Module, paths: List[torch.Tensor],
                gen: Optional[torch.Generator]) -> torch.Tensor:
    """stage(paths, gen) with its activations recomputed in the backward
    instead of kept (torch.utils.checkpoint, non-reentrant, the whole
    forward recomputed: the JAX package's nn.remat). The recompute draws
    the forward's drop-path masks again: `gen`, which checkpoint's
    preserve_rng_state does not cover, is set back to its state before the
    forward for the recompute and put back after it, so the next draw is
    the one a run without remat makes; and the stage's buffers (its
    BatchNorms' running statistics) are copied back after the recompute,
    so they hold what the forward committed, once, as flax's nn.remat
    commits batch_stats once."""
    before = None if gen is None else gen.get_state()
    calls = []

    def run(*xs):
        calls.append(None)
        if len(calls) == 1:
            return stage(list(xs), gen)
        after = None if gen is None else gen.get_state()
        if gen is not None:
            gen.set_state(before)
        held = [(b, b.clone()) for b in stage.buffers()]
        try:
            return stage(list(xs), gen)
        finally:
            with torch.no_grad():
                for b, v in held:
                    b.copy_(v)
            if gen is not None:
                gen.set_state(after)

    with checkpoint.set_checkpoint_early_stop(False):
        return checkpoint.checkpoint(run, *paths, use_reentrant=False)


def _use_sa(cfg: TransceptionConfig, s: int) -> bool:
    lst = cfg.use_sa_list
    return lst[min(s, len(lst) - 1)]


class MSViT(nn.Module):
    """Stage 1: overlap patch embed (7/4/3) + `stage1_layers` efficient
    transformer blocks + LN. Stages 2-4: RIPM patch-embed stage + MHCA
    stage (the casa stages with casa=True, MSViTCasa). Returns the 4 NHWC
    scale maps. The blocks run the structure of cfg's fold switches (JAX
    msvit.py:160-296); `gen` draws the drop-path masks in training. With
    cfg.remat each MHCA stage is recomputed in the backward (remat_stage;
    JAX msvit.py:198-199), where autograd records. The casa backbone runs
    no drop path and no remat (JAX msvit.py:285-294)."""

    casa = False

    def __init__(self, cfg: TransceptionConfig):
        super().__init__()
        self.remat = cfg.remat and not self.casa
        dt = cfg.compute_dtype
        folds = fold_table(cfg)
        d = cfg.dims
        self.patch_embed1 = OverlapPatchEmbed(cfg.in_chans, d[0], 7, 4, 3,
                                              dtype=dt)
        self.block1 = nn.ModuleList(
            EfficientTransformerBlock(d[0], dt, folds, cfg.token_mlp)
            for _ in range(cfg.stage1_layers))
        self.norm1 = LayerNorm(d[0], dtype=dt)
        dpr = dpr_schedule(0.0 if self.casa else cfg.drop_path_rate,
                           cfg.num_layers)
        for s in range(3):
            self.add_module(f"patch_embed_stage{s + 2}", PatchEmbedStage(
                d[s], cfg.num_path[s], is_pool=True, dtype=dt))
            self.add_module(f"mhca_stage{s + 2}", MHCAStage(
                d[s], d[s + 1], cfg.num_layers[s], cfg.num_heads[s],
                cfg.mlp_ratio, cfg.num_path[s], dt, folds, dpr[s],
                cfg.concat, _use_sa(cfg, s), cfg.sa_ker, cfg.inter,
                self.casa))

    def forward(self, x, gen: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        t, H, W = self.patch_embed1(x)
        for blk in self.block1:
            t = blk(t, H, W)
        m = self.norm1(t).reshape(t.shape[0], H, W, -1)
        outs = [m]
        remat = self.remat and torch.is_grad_enabled()
        for s in range(2, 5):
            paths = getattr(self, f"patch_embed_stage{s}")(m)
            stage = getattr(self, f"mhca_stage{s}")
            m = remat_stage(stage, paths, gen) if remat else stage(paths,
                                                                   gen)
            outs.append(m)
        return outs


class MSViTCasa(MSViT):
    """The 3-stage backbone with MHCA_stage_casa fusion (MSTr.py:
    1990-2204; JAX msvit.py:256)."""

    casa = True


# The 4-stage backbone's own stage plan (MSTr.py:1746-1988; JAX
# msvit.py:225-227), whatever the config's num_path/num_layers/num_heads.
STAGES4 = dict(num_path=(2, 3, 3, 3), num_layers=(1, 3, 8, 3),
               num_heads=(8, 8, 8, 8))


class MSViT4Stages(nn.Module):
    """All-MHCA 4-stage variant (MSTr.py:1746-1988; JAX msvit.py:214): a
    conv stem (two 3x3 stride-2 Conv2d_BN + hardswish, to /4), then four
    RIPM patch-embed + MHCA stages at /4, /8, /16, /32 (the first without
    pooling) with STAGES4's paths, layers and heads."""

    def __init__(self, cfg: TransceptionConfig):
        super().__init__()
        dt = cfg.compute_dtype
        folds = fold_table(cfg)
        d = cfg.dims
        self.stem = nn.ModuleList([
            Conv2dBN(cfg.in_chans, d[0] // 2, 3, 2, 1, act=True, dtype=dt),
            Conv2dBN(d[0] // 2, d[0], 3, 2, 1, act=True, dtype=dt)])
        in_dims = (d[0], d[0], d[1], d[2])
        dpr = dpr_schedule(cfg.drop_path_rate, STAGES4["num_layers"])
        for s in range(4):
            self.add_module(f"patch_embed_stage{s + 1}", PatchEmbedStage(
                in_dims[s], STAGES4["num_path"][s], is_pool=s > 0, dtype=dt))
            self.add_module(f"mhca_stage{s + 1}", MHCAStage(
                in_dims[s], d[s], STAGES4["num_layers"][s],
                STAGES4["num_heads"][s], cfg.mlp_ratio,
                STAGES4["num_path"][s], dt, folds, dpr[s], cfg.concat,
                _use_sa(cfg, s), cfg.sa_ker))

    def forward(self, x, gen: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        m = x
        for conv in self.stem:
            m = conv(m)
        outs = []
        for s in range(1, 5):
            paths = getattr(self, f"patch_embed_stage{s}")(m)
            m = getattr(self, f"mhca_stage{s}")(paths, gen)
            outs.append(m)
        return outs


def make_backbone(cfg: TransceptionConfig) -> nn.Module:
    """The backbone of stage_3or4 (JAX transception.py:50-56): 4 the
    4-stage, 3 the default, any other value the casa variant."""
    if cfg.stage_3or4 == 4:
        return MSViT4Stages(cfg)
    return MSViT(cfg) if cfg.stage_3or4 == 3 else MSViTCasa(cfg)
