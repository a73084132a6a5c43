"""MSViT backbone (3-stage, published default), PyTorch port of
transception_tpu/models/msvit.py:49,160.

Behavioral reference: networks/MSTr.py:1350-1441 (MHCA_stage) and
:1536-1744 (MSViT). Stages emit NHWC maps at /4, /8, /16, /32 with dims
(64, 128, 320, 512). The per-path MHCA encoders are a ModuleList
(`mhca_blks.{i}`), run one after another. The MHCA blocks' drop-path
rates decay linearly over the stages' layers (dpr_schedule).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

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
from transception_tpu_torch.ops.conv import PatchEmbedStage, ResBlock
from transception_tpu_torch.ops.fusion import CoordAtt


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


class MHCAStage(nn.Module):
    """MB-Transformer stage + CoordAtt fusion (MSTr.py:1350-1441): ResBlock
    on path 0 plus one MHCAEncoder per path (each at the stage's per-layer
    drop-path rates), fused by concatenation."""

    def __init__(self, embed_dim: int, out_embed_dim: int, num_layers: int,
                 num_heads: int, mlp_ratio: int, num_path: int,
                 dtype=torch.bfloat16, folds: Folds = DEFAULT_FOLDS,
                 drop_path_rates=()):
        super().__init__()
        self.InvRes = ResBlock(embed_dim, dtype)
        self.mhca_blks = nn.ModuleList(
            MHCAEncoder(embed_dim, num_layers, num_heads, mlp_ratio,
                        CRPE_WINDOW, dtype, folds, drop_path_rates)
            for _ in range(num_path))
        self.aggregate = CoordAtt(embed_dim * (num_path + 1), out_embed_dim,
                                  16, dtype)

    def forward(self, inputs: List[torch.Tensor],
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        outs = [self.InvRes(inputs[0])]
        outs += [enc(x, gen) for enc, x in zip(self.mhca_blks, inputs)]
        return self.aggregate(torch.cat(outs, dim=-1))


class MSViT(nn.Module):
    """Stage 1: overlap patch embed (7/4/3) + `stage1_layers` efficient
    transformer blocks + LN. Stages 2-4: RIPM patch-embed stage + MHCA
    stage. Returns the 4 NHWC scale maps. The blocks run the structure of
    cfg's fold switches (JAX msvit.py:182-293); `gen` draws the drop-path
    masks in training."""

    def __init__(self, cfg: TransceptionConfig):
        super().__init__()
        dt = cfg.compute_dtype
        folds = fold_table(cfg)
        d = cfg.dims
        self.patch_embed1 = OverlapPatchEmbed(cfg.in_chans, d[0], 7, 4, 3,
                                              dtype=dt)
        self.block1 = nn.ModuleList(
            EfficientTransformerBlock(d[0], dt, folds)
            for _ in range(cfg.stage1_layers))
        self.norm1 = LayerNorm(d[0], dtype=dt)
        dpr = dpr_schedule(cfg.drop_path_rate, cfg.num_layers)
        for s in range(3):
            self.add_module(f"patch_embed_stage{s + 2}", PatchEmbedStage(
                d[s], cfg.num_path[s], is_pool=True, dtype=dt))
            self.add_module(f"mhca_stage{s + 2}", MHCAStage(
                d[s], d[s + 1], cfg.num_layers[s], cfg.num_heads[s],
                cfg.mlp_ratio, cfg.num_path[s], dt, folds, dpr[s]))

    def forward(self, x, gen: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        t, H, W = self.patch_embed1(x)
        for blk in self.block1:
            t = blk(t, H, W)
        m = self.norm1(t).reshape(t.shape[0], H, W, -1)
        outs = [m]
        for s in range(2, 5):
            paths = getattr(self, f"patch_embed_stage{s}")(m)
            m = getattr(self, f"mhca_stage{s}")(paths, gen)
            outs.append(m)
        return outs
