"""The legacy models' modules of the PyTorch port against the JAX
package's, one at a time, from the same weights (the JAX package's
converter) and numpy inputs:

  * FuseEfficientAttention (the linear-attention kernel's plain version,
    K6, with the softmax of Q) at head_count 8 and 1, on a fused sequence
    whose length is not a multiple of 64, through the reference's raw
    (B, N, D) -> (B, D, N) reshapes; fp32 and bf16;
  * MISSFormer's bridge: four all-spatial BridgeLayer4 (head 1) on four
    scale maps, the port's folded structure (the folded bridge attention,
    K8, and the per-scale FFN folds, K2, as plain versions) against the
    JAX layers built with use_pallas (their XLA path on the CPU); fp32
    and bf16;
  * MultiResBlock (every branch set of the registry's inception keys and
    the full chain) in eval and in train mode (BatchNorm: batch moments,
    flax's biased running variance and momentum 0.9), and ConvBlock's
    three orders;
  * SegformerSelfAtten at bf16, whose scores, softmax and P·V round as
    the JAX einsums with preferred_element_type=float32 do;
  * OverlapPatchEmbedFusePadding and torch_nearest_resize.

Tolerances: fp32 within 1e-5 of max|JAX| (the same math in another
summation order); bf16 within 2e-2 of max|JAX| (a bf16 rounding point of
difference at most; the attention at 1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)
from flax import linen as nn

from conftest import tiny_config
from torch_legacy import perturb, port_config, to_jax
from transception_tpu.models import bridge as jbridge
from transception_tpu.models import legacy as jl
from transception_tpu.ops import multires as jm
from transception_tpu_torch.convert.from_jax import load_jax_variables
from transception_tpu_torch.models import legacy as pl
from transception_tpu_torch.models.bridge import split_scales
from transception_tpu_torch.ops import kernels
from transception_tpu_torch.ops import multires as pm
from transception_tpu_torch.ops.common import init_weights

DT = {"fp32": (jnp.float32, torch.float32, 1e-5),
      "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _init(module, seed=0):
    init_weights(module, torch.Generator().manual_seed(seed))
    perturb(module, seed + 1)
    return module.eval()


def _rand(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _as(x, tdt):
    return torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("dt", list(DT))
@pytest.mark.parametrize("heads", [8, 1])
def test_fuse_efficient_attention(heads, dt):
    """K6's plain version through the raw reshapes on a fused sequence of
    10² + 2·22 tokens (144), 64 channels: head dims 8 (8 heads) and 64
    (1 head)."""
    jdt, tdt, tol = DT[dt]
    D, N = 64, 144
    jmod = jl.FuseEfficientAttention(D, D, head_count=heads, dtype=jdt)
    pmod = _init(pl.FuseEfficientAttention(D, D, D, heads, tdt))
    v, report = to_jax(jmod, pmod, jnp.zeros((1, N, D), jdt))
    assert report["unused_torch_keys"] == []
    x = _rand((2, N, D))
    want = jax.jit(jmod.apply)(v, jnp.asarray(x, jdt))
    kernels.reset_launches()
    with torch.no_grad():
        got = pmod(_as(x, tdt))
    assert kernels.routed_counts() == {"linear_attention": 1}
    assert got.dtype == tdt
    _close(got.float(), want.astype(jnp.float32), tol)


class _JBridge(nn.Module):
    """MISSFormer's bridge as the JAX model builds it (legacy.py:591-598)."""

    cfg: object

    @nn.compact
    def __call__(self, enc):
        cfg = self.cfg
        geo = jbridge.BridgeGeometry(cfg.img_size, cfg.dims, cfg.bridge_dim)
        out = enc
        for i in range(4):
            out = jbridge.BridgeLayer4(
                geo, 1, False, cfg.reduction_ratios, use_pallas=True,
                dtype=cfg.compute_dtype, name=f"bridge_layer{i + 1}")(out)
        return jbridge.split_scales(out, geo)


class _PBridge(torch.nn.Module):
    """The port MISSFormer's four bridge layers, as its encode runs them."""

    def __init__(self, model):
        super().__init__()
        self.geo = model.geo
        for i in range(4):
            self.add_module(f"bridge_layer{i + 1}",
                            getattr(model, f"bridge_layer{i + 1}"))

    def forward(self, enc):
        out = enc
        for i in range(4):
            out = getattr(self, f"bridge_layer{i + 1}")(out)
        return split_scales(out, self.geo)


@pytest.mark.parametrize("dt", list(DT))
def test_missformer_bridge(dt):
    """Four all-spatial layers on the four scale maps of a 32² config
    (sides 8, 4, 2, 1): the folded attention and the FFN folds (plain
    versions on the CPU) against JAX's layers."""
    jdt, tdt, tol = DT[dt]
    jc = tiny_config(dtype="float32" if dt == "fp32" else "bfloat16")
    model = pl.MISSFormer(port_config(jc), device="cpu")
    perturb(model, 4)
    pb = _PBridge(model)
    sides = [8, 4, 2, 1]
    maps = [_rand((2, s, s, c), seed=i)
            for i, (s, c) in enumerate(zip(sides, jc.dims))]
    jmod = _JBridge(jc)
    v, report = to_jax(jmod, pb, [jnp.asarray(m, jdt) for m in maps])
    assert report["unused_torch_keys"] == []
    want = jax.jit(jmod.apply)(v, [jnp.asarray(m, jdt) for m in maps])
    kernels.reset_launches()
    with torch.no_grad(), kernels.enabled(pl.kernel_set(model.cfg)):
        got = pb([_as(m, tdt) for m in maps])
    # K8 on each layer, K2 on the even-sided scales (8², 4², 2²).
    assert kernels.routed_counts() == {"bridge_attention_folded": 4,
                                       "mixffn": 12}
    for g, w in zip(got, want):
        _close(g.float(), w.astype(jnp.float32), tol)


BRANCHES = [("res",), ("3",), ("5",), ("res", "3"), ("res", "5"),
            ("res", "3", "5"), ("res", "3", "5", "7")]


@pytest.mark.parametrize("branches", BRANCHES, ids="-".join)
def test_multires_block_eval_and_train(branches):
    """fp32, (2, 8, 8, 12) -> U = 16: eval with the running statistics;
    a train-mode forward with batch moments and the running statistics
    it leaves behind."""
    jmod = jm.MultiResBlock(16, branches=branches, downsample=2,
                            dtype=jnp.float32)
    pmod = _init(pm.MultiResBlock(12, 16, branches, 2, dtype=torch.float32))
    x = _rand((2, 8, 8, 12))
    v, report = to_jax(jmod, pmod, jnp.zeros((1, 8, 8, 12)))
    assert report["unused_torch_keys"] == []
    want = jax.jit(jmod.apply)(v, x)
    with torch.no_grad():
        got = pmod(torch.from_numpy(x))
    assert got.shape == (2, 16 * len(branches), 16)
    _close(got, want, 1e-5)
    want, upd = jax.jit(lambda v, x: jmod.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, x)
    pmod.train()
    with torch.no_grad():
        got = pmod(torch.from_numpy(x))
    _close(got, want, 1e-5)
    back = _init(pm.MultiResBlock(12, 16, branches, 2, dtype=torch.float32),
                 seed=9)
    load_jax_variables(back, {"params": v["params"],
                              "batch_stats": upd["batch_stats"]},
                       device="cpu")
    for k, t in back.state_dict().items():
        torch.testing.assert_close(pmod.state_dict()[k], t, rtol=1e-5,
                                   atol=1e-6, msg=k)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "none"])
@pytest.mark.parametrize("train", [False, True])
def test_conv_block_orders(act, train):
    jmod = jm.ConvBlock(8, act=act, dtype=jnp.float32)
    pmod = _init(pm.ConvBlock(4, 8, act=act, dtype=torch.float32))
    x = _rand((2, 6, 6, 4))
    v, _ = to_jax(jmod, pmod, jnp.zeros((1, 6, 6, 4)))
    if train:
        want, _ = jmod.apply(v, x, train=True, mutable=["batch_stats"])
    else:
        want = jmod.apply(v, x)
    with torch.no_grad():
        got = pmod.train(train)(torch.from_numpy(x))
    _close(got, want, 1e-5)


def test_res_conv_block():
    jmod = jm.ResConvBlock(8, dtype=jnp.float32)
    pmod = _init(pm.ResConvBlock(4, 8, dtype=torch.float32))
    x = _rand((2, 6, 6, 4))
    v, report = to_jax(jmod, pmod, jnp.zeros((1, 6, 6, 4)))
    assert report["unused_torch_keys"] == []
    with torch.no_grad():
        _close(pmod(torch.from_numpy(x)), jmod.apply(v, x), 1e-5)


@pytest.mark.parametrize("r,side", [(1, 8), (2, 8), (4, 8), (4, 6)])
def test_segformer_attention_bf16(r, side):
    """bf16, 2 heads of 32: the scores, softmax and P·V in fp32 from bf16
    operands, each rounded where JAX rounds; a side not divisible by r
    takes flax's 'SAME' padding of the reduction conv."""
    C = 64
    jmod = jl.SegformerSelfAtten(C, 2, r, dtype=jnp.bfloat16)
    pmod = _init(pl.SegformerSelfAtten(C, 2, r, torch.bfloat16))
    x = _rand((2, side * side, C))
    v, report = to_jax(jmod, pmod, jnp.zeros((1, side * side, C),
                                              jnp.bfloat16), side, side)
    assert report["unused_torch_keys"] == []
    want = jax.jit(jmod.apply, static_argnums=(2, 3))(
        v, jnp.asarray(x, jnp.bfloat16), side, side)
    with torch.no_grad():
        got = pmod(_as(x, torch.bfloat16), side, side)
    _close(got.float(), want.astype(jnp.float32), 1e-2)


def test_overlap_patch_embed_fuse_padding():
    """Conv k3 s2 p0 on 12² (5²), centre-padded to 8² (1 before, 2 after),
    then the tokens' LN."""
    jmod = jl.OverlapPatchEmbedFusePadding(16, 3, 2, 0, target_size=8,
                                           dtype=jnp.float32)
    pmod = _init(pl.OverlapPatchEmbedFusePadding(4, 16, 3, 2, 0,
                                                 target_size=8,
                                                 dtype=torch.float32))
    x = _rand((1, 12, 12, 4))
    v, _ = to_jax(jmod, pmod, jnp.zeros((1, 12, 12, 4)))
    t, H, W = jmod.apply(v, x)
    with torch.no_grad():
        got, h, w = pmod(torch.from_numpy(x))
    assert (h, w) == (H, W) == (8, 8)
    _close(got, t, 1e-5)


@pytest.mark.parametrize("out", [(8, 8), (2, 2), (7, 5), (3, 4)])
def test_torch_nearest_resize(out):
    x = _rand((2, 4, 6, 3))
    want = jl.torch_nearest_resize(jnp.asarray(x), *out)
    got = pl.torch_nearest_resize(torch.from_numpy(x), *out)
    assert np.array_equal(got.numpy(), np.asarray(want))
