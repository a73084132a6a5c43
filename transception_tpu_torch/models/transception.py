"""MSTransception (networks/MSTr.py:2759-2852), PyTorch port of
transception_tpu/models/transception.py:24.

Backbone (3-stage, 4-stage or casa MSViT, cfg.stage_3or4) -> bridge
('original' dual bridge, 'sp', 'para' or none, cfg.have_bridge) -> 4-stage
decoder cascade (cfg.token_mlp's FFN in every transformer block). NHWC
in and out: input (B, H, W, 1|3), output (B, H, W, num_classes) fp32
logits, (B, H, W) uint8 class ids with argmax=True, or in training the
pre-shuffle logits with wide_head=True. Gray inputs are repeated to 3
channels (MSTr.py:2828-2829). Built in eval mode; .train() switches
BatchNorm to batch statistics, the blocks to the train step's fold
switches (core.config.fold_switches) and the kernels to the train step's
set (ops.kernels.kernel_set), and turns on drop path (drawn from the
caller's generator). Every fold configuration has the same parameters:
one state_dict (and one load_jax_variables) serves them all.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch
from torch import nn

from transception_tpu_torch.core.config import (
    TransceptionConfig,
    fold_switches,
    fold_table,
)
from transception_tpu_torch.core.device import DeviceLike, resolve_device
from transception_tpu_torch.models.bridge import (
    BridgeBlock4,
    BridgeBlockPara,
    BridgeBlockSp,
    BridgeGeometry,
)
from transception_tpu_torch.models.decoder import DecoderLayer
from transception_tpu_torch.models.msvit import (
    STAGES4,
    dpr_schedule,
    make_backbone,
)
from transception_tpu_torch.ops import kernels
from transception_tpu_torch.ops.common import init_weights


def model_device(cfg: TransceptionConfig, device: DeviceLike
                 ) -> torch.device:
    """The device a model of config `cfg` is built on; raises for CUDA
    when it is absent, and on the card for a compute dtype the CUDA
    kernels do not take (bf16 and fp32) while they are on."""
    dev = resolve_device(device)
    if dev.type == "cuda" and cfg.use_kernels and \
            cfg.compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA kernels take bf16 or fp32, not "
                         f"{cfg.dtype}; build such a model on the card "
                         f"with use_kernels=False")
    return dev


class MSTransception(nn.Module):
    """U-shaped hierarchical transformer for 2-D medical image
    segmentation. Weights are drawn from `seed` (flax-equivalent init);
    load trained or JAX weights with convert.from_jax.load_jax_variables.
    Built on `device` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, cfg: TransceptionConfig = TransceptionConfig(),
                 device: DeviceLike = "cuda", seed: int = 0):
        super().__init__()
        cfg = cfg.validate()
        dev = model_device(cfg, device)
        self.cfg = cfg
        dt = cfg.compute_dtype
        folds = fold_table(cfg)
        self.backbone = make_backbone(cfg)
        geo = BridgeGeometry(cfg.img_size, cfg.dims, cfg.bridge_dim)
        rr = cfg.reduction_ratios
        self.bridge = None
        if cfg.have_bridge == "sp":
            self.bridge = BridgeBlockSp(geo, cfg.dims, cfg.bridge_heads,
                                        cfg.num_sp, rr, dt, folds)
        elif cfg.have_bridge == "para":
            self.bridge = BridgeBlockPara(geo, cfg.bridge_heads, rr, dt, folds)
        elif cfg.have_bridge not in ("none", "None"):
            self.bridge = BridgeBlock4(geo, cfg.bridge_heads,
                                       cfg.br_ch_att_list, rr, dt, folds)
        d = cfg.dims
        ins = cfg.decoder_in_chans()
        for i in range(4):
            self.add_module(f"decoder_{3 - i}", DecoderLayer(
                ins[i], d[3 - i], cfg.num_classes, is_last=(i == 3),
                bottom=(i == 0), dtype=dt, folds=folds,
                token_mlp=cfg.token_mlp))
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(dev).eval()

    def forward(self, x: torch.Tensor, argmax: bool = False,
                wide_head: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, H, W, 1|3). argmax=True returns (B, H, W) uint8 class ids
        computed before the final pixel shuffle (decoder.py:154-201).
        wide_head=True (training) returns (B, (H/4)·(W/4), 16, num_classes)
        fp32 logits in pre-shuffle token order (transception.py:36-40).
        The kernels of kernels.kernel_set(cfg, self.training) run that the
        caller's kernels.enabled scope leaves on (all by default). In
        training with drop_path_rate > 0, `gen` (a torch.Generator on the
        model's device, the JAX step's dropout key) draws the masks (and
        those of the sp bridge's MLP dropout)."""
        if x.shape[-1] == 1:
            x = x.expand(*x.shape[:-1], 3)
        with kernels.enabled(kernels.kernel_set(self.cfg, self.training)
                             & kernels.active()):
            enc = self.backbone(x.to(self.cfg.compute_dtype), gen)
            if isinstance(self.bridge, BridgeBlockSp):
                enc = self.bridge(enc, gen)
            elif self.bridge is not None:
                enc = self.bridge(enc)
            B, h4, w4, c4 = enc[3].shape
            t = self.decoder_3(enc[3].reshape(B, h4 * w4, c4))
            t = self.decoder_2(t, enc[2])
            t = self.decoder_1(t, enc[1])
            return self.decoder_0(t, enc[0], argmax_head=argmax,
                                  wide_head=wide_head)


def _backbone_stages(cfg: TransceptionConfig, training: bool):
    """(ETB map sides, [(map side, width, paths, drop-path rates)] of the
    MHCA stages) of cfg's backbone (models.msvit.make_backbone); the rates
    are 0 in eval (drop path is the identity there)."""
    s1, d = cfg.stage1_res, cfg.dims
    rate = cfg.drop_path_rate if training else 0.0
    if cfg.stage_3or4 == 4:
        rates = dpr_schedule(rate, STAGES4["num_layers"])
        return [], [(s1 >> i, (d[0], d[0], d[1], d[2])[i],
                     STAGES4["num_path"][i], rates[i]) for i in range(4)]
    casa = cfg.stage_3or4 != 3  # the casa backbone runs no drop path
    rates = dpr_schedule(0.0 if casa else rate, cfg.num_layers)
    return [s1] * cfg.stage1_layers, [
        (s1 >> (i + 1), d[i], cfg.num_path[i], rates[i]) for i in range(3)]


def _mhca_calls(cfg: TransceptionConfig, stages, sw) -> Counter:
    """Kernel-wrapper calls of the MHCA stages of _backbone_stages: every
    path at the stage's rates; K5 where it takes the map
    (kernels.mhca_block.takes)."""
    takes = kernels.mixffn.takes
    es = 2 if cfg.compute_dtype == torch.bfloat16 else 4
    calls = Counter()
    for s, C, paths, stage in stages:
        for rate in stage:
            exact = rate == 0.0
            if sw.mhca_block and exact and \
                    kernels.mhca_block.takes(s, C, C * cfg.mlp_ratio, es):
                calls["mhca_block"] += paths
                continue
            calls["linear_attention"] += paths
            if sw.mhca_ffn and takes(s):
                calls["mixffn" if exact else "mixffn_skip"] += paths
    return calls


def _forward_calls(cfg: TransceptionConfig, training: bool,
                   head: str) -> Counter:
    """Kernel-wrapper calls of one forward by kernel switch: the structure
    the fold switches give each block at each map side, and in training
    the MHCA blocks' drop-path rates (a rate above 0 unfolds the block).
    head: "argmax", "logits" or "wide" (the wide head's expand is a plain
    Linear, DecoderLayer.wide_head)."""
    sw = fold_switches(cfg, training)
    s1 = cfg.stage1_res
    takes = kernels.mixffn.takes
    calls = Counter()
    etb_sides, stages = _backbone_stages(cfg, training)
    # Stage 1 (3-stage and casa) and decoders 2/1/0: two ETBs each at s1/4,
    # s1/2, s1; their FFN folds with token_mlp mix_skip only.
    for s in etb_sides + [s1 // 4, s1 // 2, s1] * 2:
        calls["etb_attention" if sw.etb_attn else "linear_attention"] += 1
        if sw.etb_ffn and cfg.token_mlp == "mix_skip" and takes(s):
            calls["mixffn"] += 1
    calls.update(_mhca_calls(cfg, stages, sw))
    # Bridge: spatial attention layers; the per-scale FFN folds.
    ffn = sum(takes(s1 >> i) for i in range(4))
    if cfg.have_bridge in ("sp", "para"):
        spatial = 4 if cfg.have_bridge == "sp" else 3
        calls["bridge_attention_folded" if sw.sp_bridge
              else "bridge_attention"] += spatial
        calls["mixffn"] += 4 * ffn if sw.sp_bridge else 0
    elif cfg.have_bridge not in ("none", "None"):
        for ch_att in cfg.br_ch_att_list:
            if not ch_att:
                calls["bridge_attention_folded" if sw.bridge_attn
                      else "bridge_attention"] += 1
            if sw.bridge_ffn:
                calls["mixffn"] += ffn
    # Decoders 3/2/1 expand x2; decoder 0 x4 (+ head + argmax in bf16).
    calls["patch_expand"] += 3
    if head == "argmax" and cfg.compute_dtype == torch.bfloat16:
        calls["expand_head"] += 1
    elif head != "wide":
        calls["patch_expand"] += 1
    return calls


def _launches(cfg: TransceptionConfig, training: bool, head: str) -> dict:
    counts = {name: 0 for name, _, _ in kernels.COUNTERS}
    on = kernels.kernel_set(cfg, training)
    for name, n in _forward_calls(cfg, training, head).items():
        if name in on:
            counts[name] += n
    if training:  # one backward kernel per K3 and K2 forward
        counts[kernels.bridge_attention.BWD_NAME] = counts["bridge_attention"]
        counts[kernels.mixffn.BWD_NAME] = counts["mixffn"]
    if training and cfg.remat and cfg.stage_3or4 == 3:
        # The backward recomputes each MHCA stage's forward (msvit.
        # remat_stage): its forward kernels launch twice.
        again = _mhca_calls(cfg, _backbone_stages(cfg, True)[1],
                            fold_switches(cfg, True))
        for name, n in again.items():
            if name in on:
                counts[name] += n
    return counts


def launches_per_forward(cfg: TransceptionConfig,
                         argmax: bool = True) -> dict:
    """Kernel launches of one eval forward of an MSTransception with config
    `cfg` on the card, per counter of ops.kernels.launch_counts: a pure
    function of the config (the structure its fold switches give each
    block at each map side). chip_smoke.py holds the card's counters to it.
    Without use_kernels every count is 0."""
    return _launches(cfg, False, "argmax" if argmax else "logits")


def launches_per_step(cfg: TransceptionConfig, wide_head: bool = True
                      ) -> dict:
    """Kernel launches of one train step (forward and backward) of an
    MSTransception with config `cfg` on the card, per counter of
    ops.kernels.launch_counts: a pure function of the config, as
    launches_per_forward, with the train step's fold switches, kernel set
    and drop-path rates; K10 and K11 once per K3 and K2 forward (the other
    kernels' backwards are autograd of their plain versions). The same at
    fp32: the fp32 forms (K3, K10, K2, K11, K9 and the "pallas" mode's
    K1, K5-K7) launch where the bf16 ones do, under the same counters;
    their shape tallies end with "fp32". With cfg.remat (the 3-stage
    backbone) the MHCA stages' forward kernels launch once more, in the
    recompute. chip_smoke.py holds the card's counters to it."""
    return _launches(cfg, True, "wide" if wide_head else "logits")
