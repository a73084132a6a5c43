"""MSTransception (networks/MSTr.py:2759-2852), PyTorch port of
transception_tpu/models/transception.py:24.

MSViT backbone -> 'original' dual bridge -> 4-stage decoder cascade. NHWC
in and out: input (B, H, W, 1|3), output (B, H, W, num_classes) fp32
logits, (B, H, W) uint8 class ids with argmax=True, or in training the
pre-shuffle logits with wide_head=True. Gray inputs are repeated to 3
channels (MSTr.py:2828-2829). Built in eval mode; .train() switches
BatchNorm to batch statistics and the kernels to the train step's set
(ops.kernels.kernel_set).
"""

from __future__ import annotations

import torch
from torch import nn

from transception_tpu_torch.core.config import TransceptionConfig
from transception_tpu_torch.core.device import DeviceLike, resolve_device
from transception_tpu_torch.models.bridge import BridgeBlock4, BridgeGeometry
from transception_tpu_torch.models.decoder import DecoderLayer
from transception_tpu_torch.models.msvit import MSViT
from transception_tpu_torch.ops import kernels
from transception_tpu_torch.ops.common import init_weights


class MSTransception(nn.Module):
    """U-shaped hierarchical transformer for 2-D medical image
    segmentation. Weights are drawn from `seed` (flax-equivalent init);
    load trained or JAX weights with convert.from_jax.load_jax_variables.
    Built on `device` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, cfg: TransceptionConfig = TransceptionConfig(),
                 device: DeviceLike = "cuda", seed: int = 0):
        super().__init__()
        cfg = cfg.validate()
        dev = resolve_device(device)
        if dev.type == "cuda" and cfg.use_kernels and \
                cfg.compute_dtype != torch.bfloat16:
            raise ValueError("the CUDA kernels take bf16; build an fp32 "
                             "model on the card with use_kernels=False")
        self.cfg = cfg
        dt = cfg.compute_dtype
        self.backbone = MSViT(cfg)
        geo = BridgeGeometry(cfg.img_size, cfg.dims, cfg.bridge_dim)
        self.bridge = BridgeBlock4(geo, cfg.bridge_heads, cfg.br_ch_att_list,
                                   cfg.reduction_ratios, dt)
        d = cfg.dims
        ins = cfg.decoder_in_chans()
        for i in range(4):
            self.add_module(f"decoder_{3 - i}", DecoderLayer(
                ins[i], d[3 - i], cfg.num_classes, is_last=(i == 3),
                bottom=(i == 0), dtype=dt))
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(dev).eval()

    def forward(self, x: torch.Tensor, argmax: bool = False,
                wide_head: bool = False) -> torch.Tensor:
        """x: (B, H, W, 1|3). argmax=True returns (B, H, W) uint8 class ids
        computed before the final pixel shuffle (decoder.py:154-201).
        wide_head=True (training) returns (B, (H/4)·(W/4), 16, num_classes)
        fp32 logits in pre-shuffle token order (transception.py:36-40).
        The kernels of kernels.kernel_set(cfg, self.training) run."""
        if x.shape[-1] == 1:
            x = x.expand(*x.shape[:-1], 3)
        with kernels.enabled(kernels.kernel_set(self.cfg, self.training)):
            enc = self.bridge(self.backbone(x.to(self.cfg.compute_dtype)))
            B, h4, w4, c4 = enc[3].shape
            t = self.decoder_3(enc[3].reshape(B, h4 * w4, c4))
            t = self.decoder_2(t, enc[2])
            t = self.decoder_1(t, enc[1])
            return self.decoder_0(t, enc[0], argmax_head=argmax,
                                  wide_head=wide_head)
