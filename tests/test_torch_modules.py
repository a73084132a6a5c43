"""Ported modules against their JAX counterparts, fp32, same weights
(carried by load_jax_variables) and the same numpy inputs.

Tolerance: 1e-4 (relative and absolute) — fp32 reassociation between
XLA's and PyTorch's reductions and products, through a few layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu.models import bridge as jb
from transception_tpu.models.decoder import DecoderLayer as JDecoder
from transception_tpu.ops import attention as ja
from transception_tpu.ops.fusion import CoordAtt as JCoordAtt
from transception_tpu_torch.convert.from_jax import load_jax_variables
from transception_tpu_torch.models import bridge as pb
from transception_tpu_torch.models.decoder import DecoderLayer
from transception_tpu_torch.ops import attention as pa
from transception_tpu_torch.ops.fusion import CoordAtt

F32 = torch.float32
TOL = dict(rtol=1e-4, atol=1e-4)


def _perturb(v, seed):
    """Random params and batch statistics (variances kept positive)."""
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(np.asarray, v)
    out = {"params": jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32),
        v["params"])}
    if "batch_stats" in v:
        out["batch_stats"] = jax.tree_util.tree_map(
            lambda a: (rng.random(a.shape) + 0.5).astype(np.float32),
            v["batch_stats"])
    return out


def _compare(jmod, pmod, inputs, seed=0, call=None):
    """init jmod on inputs, carry its variables into pmod, compare. Plain
    ints among the inputs (map sides) stay static under jit."""
    dyn = [i for i, a in enumerate(inputs) if not isinstance(a, int)]

    def full(arrs):
        out = list(inputs)
        for i, a in zip(dyn, arrs):
            out[i] = a
        return out

    arrs = [inputs[i] for i in dyn]
    v = _perturb(jax.jit(lambda k, a: jmod.init(k, *full(a)))(
        jax.random.PRNGKey(seed), arrs), seed)
    want = jax.jit(lambda v, a: jmod.apply(v, *full(a)))(v, arrs)
    load_jax_variables(pmod, v, device="cpu")
    pmod.eval()  # JAX applies eval mode: BatchNorm with running stats
    call = call or (lambda m, *a: m(*a))
    with torch.no_grad():
        got = call(pmod, *[torch.from_numpy(a) if isinstance(a, np.ndarray)
                           else a for a in inputs])
    return got, want


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("s,C", [(8, 64), (4, 128)])
def test_efficient_transformer_block(s, C):
    jm = ja.EfficientTransformerBlock(C, C, C, use_pallas=False,
                                      dtype=jnp.float32)
    pm = pa.EfficientTransformerBlock(C, F32)
    got, want = _compare(jm, pm, (_x(2, s * s, C), s, s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mhca_encoder():
    s, C = 8, 64
    jm = ja.MHCAEncoder(C, num_layers=2, num_heads=8, mlp_ratio=4,
                        use_pallas=False, dtype=jnp.float32)
    pm = pa.MHCAEncoder(C, 2, 8, 4, dtype=F32)
    got, want = _compare(jm, pm, (_x(2, s, s, C),), seed=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_coord_att():
    jm = JCoordAtt(96, dtype=jnp.float32)
    pm = CoordAtt(256, 96, dtype=F32)
    got, want = _compare(jm, pm, (_x(2, 8, 8, 256),), seed=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_coord_att_bf16_eval_batchnorm():
    """bf16 compute: the BN affine of _EvalBNAffine (ops/conv.py:57-80)
    with its fp32 coefficient rounded once; 2% of the output scale."""
    jm = JCoordAtt(96, dtype=jnp.bfloat16)
    pm = CoordAtt(256, 96, dtype=torch.bfloat16)
    x = np.array(jnp.asarray(_x(2, 8, 8, 256), jnp.bfloat16)
                 .astype(jnp.float32))
    got, want = _compare(jm, pm, (x,), seed=3,
                         call=lambda m, a: m(a.bfloat16()))
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 0.02 * np.abs(want).max()


@pytest.mark.parametrize("ch_att", [True, False])
def test_bridge_layer(ch_att):
    geo_j = jb.BridgeGeometry(32, (64, 128, 320, 512), 64)
    geo_p = pb.BridgeGeometry(32, (64, 128, 320, 512), 64)
    jm = jb.BridgeLayer4(geo_j, 1, ch_att, use_pallas=False,
                         dtype=jnp.float32)
    pm = pb.BridgeLayer4(geo_p, 1, ch_att, (1, 2, 4, 8), F32)
    got, want = _compare(jm, pm, (_x(2, geo_j.total, 64, seed=4),), seed=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bridge_block_split_scales():
    geo_j = jb.BridgeGeometry(32, (64, 128, 320, 512), 64)
    geo_p = pb.BridgeGeometry(32, (64, 128, 320, 512), 64)
    maps = tuple(_x(2, s, s, d, seed=5 + i) for i, (s, d) in
                 enumerate(zip(geo_j.sides, (64, 128, 320, 512))))
    jm = jb.BridgeBlock4(geo_j, 1, (True, False, False, False),
                         use_pallas=False, dtype=jnp.float32)
    pm = pb.BridgeBlock4(geo_p, 1, (True, False, False, False),
                         (1, 2, 4, 8), F32)
    got, want = _compare(jm, pm, (maps,), seed=5,
                         call=lambda m, ms: m([torch.from_numpy(a)
                                               for a in ms]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("bottom", [True, False])
def test_decoder_layer(bottom):
    if bottom:
        jm = JDecoder(512, 512, use_pallas=False, dtype=jnp.float32)
        pm = DecoderLayer(512, 512, bottom=True, dtype=F32)
        inputs = (_x(2, 4, 512, seed=6),)
    else:
        jm = JDecoder(144, 128, use_pallas=False, dtype=jnp.float32)
        pm = DecoderLayer(144, 128, dtype=F32)
        inputs = (_x(2, 16, 160, seed=7), _x(2, 4, 4, 128, seed=8))
    got, want = _compare(jm, pm, inputs, seed=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
