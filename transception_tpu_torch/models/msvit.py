"""MSViT backbone (3-stage, published default), PyTorch port of
transception_tpu/models/msvit.py:49,160.

Behavioral reference: networks/MSTr.py:1350-1441 (MHCA_stage) and
:1536-1744 (MSViT). Stages emit NHWC maps at /4, /8, /16, /32 with dims
(64, 128, 320, 512). The per-path MHCA encoders are a ModuleList
(`mhca_blks.{i}`), run one after another.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from transception_tpu_torch.core.config import CRPE_WINDOW, TransceptionConfig
from transception_tpu_torch.ops.attention import (
    EfficientTransformerBlock,
    MHCAEncoder,
)
from transception_tpu_torch.ops.common import LayerNorm, OverlapPatchEmbed
from transception_tpu_torch.ops.conv import PatchEmbedStage, ResBlock
from transception_tpu_torch.ops.fusion import CoordAtt


class MHCAStage(nn.Module):
    """MB-Transformer stage + CoordAtt fusion (MSTr.py:1350-1441): ResBlock
    on path 0 plus one MHCAEncoder per path, fused by concatenation."""

    def __init__(self, embed_dim: int, out_embed_dim: int, num_layers: int,
                 num_heads: int, mlp_ratio: int, num_path: int,
                 dtype=torch.bfloat16):
        super().__init__()
        self.InvRes = ResBlock(embed_dim, dtype)
        self.mhca_blks = nn.ModuleList(
            MHCAEncoder(embed_dim, num_layers, num_heads, mlp_ratio,
                        CRPE_WINDOW, dtype)
            for _ in range(num_path))
        self.aggregate = CoordAtt(embed_dim * (num_path + 1), out_embed_dim,
                                  16, dtype)

    def forward(self, inputs: List[torch.Tensor]) -> torch.Tensor:
        outs = [self.InvRes(inputs[0])]
        outs += [enc(x) for enc, x in zip(self.mhca_blks, inputs)]
        return self.aggregate(torch.cat(outs, dim=-1))


class MSViT(nn.Module):
    """Stage 1: overlap patch embed (7/4/3) + `stage1_layers` efficient
    transformer blocks + LN. Stages 2-4: RIPM patch-embed stage + MHCA
    stage. Returns the 4 NHWC scale maps."""

    def __init__(self, cfg: TransceptionConfig):
        super().__init__()
        dt = cfg.compute_dtype
        d = cfg.dims
        self.patch_embed1 = OverlapPatchEmbed(cfg.in_chans, d[0], 7, 4, 3,
                                              dtype=dt)
        self.block1 = nn.ModuleList(
            EfficientTransformerBlock(d[0], dt)
            for _ in range(cfg.stage1_layers))
        self.norm1 = LayerNorm(d[0], dtype=dt)
        for s in range(3):
            self.add_module(f"patch_embed_stage{s + 2}", PatchEmbedStage(
                d[s], cfg.num_path[s], is_pool=True, dtype=dt))
            self.add_module(f"mhca_stage{s + 2}", MHCAStage(
                d[s], d[s + 1], cfg.num_layers[s], cfg.num_heads[s],
                cfg.mlp_ratio, cfg.num_path[s], dt))

    def forward(self, x) -> List[torch.Tensor]:
        t, H, W = self.patch_embed1(x)
        for blk in self.block1:
            t = blk(t, H, W)
        m = self.norm1(t).reshape(t.shape[0], H, W, -1)
        outs = [m]
        for s in range(2, 5):
            paths = getattr(self, f"patch_embed_stage{s}")(m)
            m = getattr(self, f"mhca_stage{s}")(paths)
            outs.append(m)
        return outs
