"""Kernel launches of the MSTransception ablation family, port side (no
JAX): at the tiny config every forward kernel decision of an eval forward
(argmax and logits) and of a train step, as the kernel wrappers route
them on the CPU (ops.kernels.routed_counts: what a card would launch),
equals models.transception.launches_per_forward / launches_per_step; and
the counts at the published 224² shapes of each registry variant, which
chip_smoke.py holds the card to, are the ones the JAX programs' traced
pallas_calls give (tools/count_pallas_calls.py; ROADMAP.md §2), apart
from the port's stated choices (K6 on the MHCA blocks the JAX package
runs through XLA; K2 on the 14² folds; K9 at 14²). The same for the
legacy models (models/legacy.py launches_per_forward / launches_per_step
against the wrappers' routing at the tiny config, and the 224² counts
against the JAX trace of the registry models themselves)."""

import dataclasses

import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu_torch.core.config import TransceptionConfig
from transception_tpu_torch.models.registry import model_config
from transception_tpu_torch.models.transception import (
    MSTransception,
    launches_per_forward,
    launches_per_step,
)
from transception_tpu_torch.ops import kernels

TINY = TransceptionConfig(img_size=32, dtype="float32", stage1_layers=1,
                          num_path=(1, 1, 1), num_layers=(1, 1, 1))
CASES = {
    "4stage": ("mstransception_4stage", {}),
    "casa": ("mstransception_casa", {}),
    "casa-out": ("mstransception_casa", dict(inter="out")),
    "sp": ("mstransception_sp", {}),
    "para": ("mstransception_para", {}),
    "none": ("mstransception", dict(have_bridge="none")),
    "mix": ("mstransception", dict(token_mlp="mix")),
    "mlp": ("mstransception", dict(token_mlp="mlp")),
    "drop-path": ("mstransception", dict(drop_path_rate=0.1)),
    "4stage-drop-path": ("mstransception_4stage", dict(drop_path_rate=0.1)),
    **{f"concat-{c}": ("mstransception", dict(concat=c))
       for c in ("normal", "3d", "se", "skn", "cbam", "cam", "cam_fact")},
}
MODES = {"default": {}, "flash": dict(ffn_flash_train=True),
         "pallas": dict(use_pallas_train=True, mhca_ffn_fold=True)}


def _cfg(case, **kw):
    name, over = CASES[case]
    return model_config(name, dataclasses.replace(TINY, **over, **kw))


def _nonzero(counts):
    return {k: n for k, n in counts.items() if n}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_routes_equal_launches_per_forward(case):
    cfg = _cfg(case)
    m = MSTransception(cfg, device="cpu", seed=0)
    x = torch.randn(2, 32, 32, 1, generator=torch.Generator().manual_seed(0))
    for argmax in (True, False):
        kernels.reset_launches()
        with torch.no_grad():
            m(x, argmax=argmax)
        assert kernels.routed_counts() == _nonzero(
            launches_per_forward(cfg, argmax=argmax)), argmax


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", ["4stage", "sp", "para", "mlp",
                                  "4stage-drop-path"])
def test_train_step_routes_equal_launches_per_step(case, mode):
    """The forward kernel decisions of a train step (K10 and K11 follow
    K3 and K2, one each)."""
    cfg = _cfg(case, **MODES[mode])
    m = MSTransception(cfg, device="cpu", seed=0).train()
    x = torch.randn(2, 32, 32, 1, generator=torch.Generator().manual_seed(0))
    kernels.reset_launches()
    out = m(x, wide_head=True, gen=torch.Generator().manual_seed(1))
    out.float().square().mean().backward()
    want = launches_per_step(cfg)
    assert want["bridge_attention_bwd"] == want["bridge_attention"]
    assert want["mixffn_bwd"] == want["mixffn"]
    assert kernels.routed_counts() == {
        k: n for k, n in _nonzero(want).items()
        if k not in ("bridge_attention_bwd", "mixffn_bwd")}


# Launches at 224² per kernel (K1-K11) of the registry variants, in the
# eval forward (argmax; fp32: the x4 expand in place of K4) and the
# default, flash and pallas train steps: the JAX programs' traced
# pallas_calls (ROADMAP.md §2) with K5 once per path (JAX vmaps the paths
# into one call), K2 and K11 also at the 14² folds and per path in the
# MHCA stages, and K6 on every MHCA block that does not fold.
PUBLISHED = {
    "mstransception_4stage": (
        dict(K1=6, K2=6, K3=3, K5=33, K6=11), dict(K3=3, K10=3),
        dict(K2=53, K3=3, K10=3, K11=53),
        dict(K1=6, K2=6, K3=3, K5=33, K6=11, K7=3, K10=3, K11=6)),
    "mstransception_casa": (
        dict(K1=8, K2=8, K3=3, K5=33, K6=9), dict(K3=3, K10=3),
        dict(K2=53, K3=3, K10=3, K11=53),
        dict(K1=8, K2=8, K3=3, K5=33, K6=9, K7=3, K10=3, K11=8)),
    "mstransception_sp": (
        dict(K1=8, K2=20, K5=33, K6=9, K8=4), dict(K2=12, K8=4, K11=12),
        dict(K2=53, K8=4, K11=53),
        dict(K1=8, K2=20, K5=33, K6=9, K7=3, K8=4, K11=20)),
    "mstransception_para": (
        dict(K1=8, K2=20, K5=33, K6=9, K8=3), dict(K2=12, K8=3, K11=12),
        dict(K2=53, K8=3, K11=53),
        dict(K1=8, K2=20, K5=33, K6=9, K7=3, K8=3, K11=20)),
}
KID = {"etb_attention": "K1", "mixffn": "K2", "bridge_attention": "K3",
       "expand_head": "K4", "mhca_block": "K5", "linear_attention": "K6",
       "patch_expand": "K7", "bridge_attention_folded": "K8",
       "mixffn_skip": "K9", "bridge_attention_bwd": "K10",
       "mixffn_bwd": "K11"}


def _kids(counts):
    return {KID[k]: n for k, n in counts.items() if n}


@pytest.mark.parametrize("name", list(PUBLISHED))
def test_published_shape_launches(name):
    fwd, default, flash, pallas = PUBLISHED[name]
    for dtype, expand in (("bfloat16", dict(K4=1, K7=3)),
                          ("float32", dict(K7=4))):
        cfg = model_config(name, TransceptionConfig(dtype=dtype))
        assert _kids(launches_per_forward(cfg)) == {**fwd, **expand}
        for over, want in ((MODES["default"], default),
                           (MODES["flash"], flash),
                           (dict(use_pallas_train=True), pallas)):
            assert _kids(launches_per_step(
                dataclasses.replace(cfg, **over))) == want, over


# The legacy models (models/legacy.py) at 224² per kernel, in the eval
# forward and in a train step (every train mode alike: JAX
# train_step_model leaves these models as they are): the JAX programs'
# traced pallas_calls (tools/count_pallas_calls.py --model NAME: MISSFormer
# K8 4 + K2 8 a forward, K8 4 + K2 8 + K11 8 a step; the other four none)
# under the port's stated rules: K6 on every linear attention and K7 on
# the four expands, where JAX runs XLA; K2 and K11 also at the bridge's 14²
# scale.
LEGACY_224 = {
    "transception": (dict(K6=14, K7=4), dict(K6=14, K7=4)),
    "missformer": (dict(K2=12, K7=4, K8=4), dict(K2=12, K7=4, K8=4, K11=12)),
    "effmissformer": (dict(K6=14, K7=4), dict(K6=14, K7=4)),
    "resinception": (dict(K6=14, K7=4), dict(K6=14, K7=4)),
    "resinception_135": (dict(K6=14, K7=4), dict(K6=14, K7=4)),
}


@pytest.mark.parametrize("name", list(LEGACY_224))
def test_legacy_shape_launches(name):
    from transception_tpu_torch.models import legacy
    fwd, step = LEGACY_224[name]
    for dtype in ("bfloat16", "float32"):
        cfg = TransceptionConfig(dtype=dtype)
        assert _kids(legacy.launches_per_forward(name, cfg)) == fwd
        for over in MODES.values():
            assert _kids(legacy.launches_per_step(
                name, dataclasses.replace(cfg, **over))) == step, over
    off = TransceptionConfig(use_kernels=False)
    assert not _kids(legacy.launches_per_forward(name, off))
    assert not _kids(legacy.launches_per_step(name, off))


@pytest.mark.parametrize("name", list(LEGACY_224))
def test_legacy_forward_routes_equal_launches_per_forward(name):
    """The kernel wrappers' decisions in one eval forward of each legacy
    model at the tiny config (32², dil_conv 0) are
    legacy.launches_per_forward's, and none without use_kernels."""
    from transception_tpu_torch.models import legacy
    from transception_tpu_torch.models.registry import create_model
    x = torch.randn(2, 32, 32, 1, generator=torch.Generator().manual_seed(0))
    for use_kernels in (True, False):
        cfg = dataclasses.replace(TINY, dil_conv=0, use_kernels=use_kernels)
        m = create_model(name, cfg, device="cpu", seed=0)
        kernels.reset_launches()
        with torch.no_grad():
            m(x)
        assert kernels.routed_counts() == _nonzero(
            legacy.launches_per_forward(name, cfg))
