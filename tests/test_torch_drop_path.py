"""Stochastic depth in the PyTorch port: the drop-path schedule and
drop_path against the JAX package, and the MHCA blocks' train-mode routing
with drop path (route (b) to the unfolded MixFFN kernel K9) against JAX
at module level, with the same masks in both packages.

Tolerances (fp32, the same math in another summation order): the encoder's
output within 1e-4 of max|out|; each parameter gradient and the input
gradient within 1e-4 of its own max, plus 1e-6 of the largest gradient (the
key bias before the softmax over tokens has an exact gradient of 0 and
holds fp32 noise in both packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transception_tpu.ops.attention as ja
# Imported before any test patches the MixFFN facade's platform gate: it
# binds that gate by name, and must keep the real one (the CPU), so the
# JAX block fold stays off and other tests see no patched gate.
import transception_tpu.ops.pallas.mhca_block  # noqa: F401
import transception_tpu.ops.pallas.mixffn as jmf
import transception_tpu.ops.pallas.mixffn_kernel as jmk
from transception_tpu.models.msvit import dpr_schedule as j_dpr
from transception_tpu_torch.convert.from_jax import (
    _jax_entries,
    _to_torch_layout,
    load_jax_variables,
)
from transception_tpu_torch.core.config import TransceptionConfig, fold_table
from transception_tpu_torch.models.msvit import dpr_schedule
from transception_tpu_torch.ops import attention as pa
from transception_tpu_torch.ops import kernels


@pytest.mark.parametrize("rate,layers", [(0.0, (3, 8, 3)), (0.1, (3, 8, 3)),
                                         (0.3, (1, 1, 1)), (0.2, (2, 0, 5))])
def test_dpr_schedule_matches_jax(rate, layers):
    assert dpr_schedule(rate, layers) == j_dpr(rate, layers)


def test_drop_path_is_identity_in_eval_and_at_rate_zero():
    x = torch.randn(4, 5, 3)
    assert pa.drop_path(x, 0.3, training=False) is x
    assert pa.drop_path(x, 0.0, training=True) is x
    with pytest.raises(ValueError, match="Generator"):
        pa.drop_path(x, 0.3, training=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_drop_path_masks_whole_samples(dtype):
    rate, B = 0.25, 4096
    x = torch.ones(B, 3, 2, dtype=dtype)
    y = pa.drop_path(x, rate, True, torch.Generator().manual_seed(0))
    assert y.dtype == dtype
    # Each sample is dropped or kept whole, kept ones scaled by 1/keep
    # (in x's dtype, as jnp divides by the Python float).
    scale = 1.0 / torch.tensor(1.0 - rate, dtype=dtype)
    per = y.reshape(B, -1)
    assert torch.all((per == 0).all(1) | (per == scale.to(dtype)).all(1))
    assert abs(per[:, 0].float().mean().item() - 1.0) < 0.05
    again = pa.drop_path(x, rate, True, torch.Generator().manual_seed(0))
    other = pa.drop_path(x, rate, True, torch.Generator().manual_seed(1))
    assert torch.equal(y, again) and not torch.equal(y, other)


C, HEADS, LAYERS, S, B = 32, 8, 3, 8, 2
RATES = (0.0, 0.1, 0.2)


def _masks():
    """One mask per drop-path call of a train-mode pass, in call order:
    layers 1 and 2, attention branch then FFN branch (layer 0's rate is 0,
    so it draws none)."""
    rng = np.random.default_rng(5)
    return [(rng.random((B, 1, 1)) < 0.5).astype(np.float32)
            for _ in range(4)]


def _jax_encoder(monkeypatch, x, g):
    """The JAX MHCAEncoder in train mode with the TPU facade's kernel route:
    layer 0 (rate 0) through the folded K2 (backward K11), layers 1-2
    through K9, all in interpret mode. Returns the variables, the output
    and the gradients of sum(out · g) with respect to the params and x."""
    jm = ja.MHCAEncoder(C, num_layers=LAYERS, num_heads=HEADS, mlp_ratio=3,
                        drop_path_rates=RATES, use_pallas=True, ffn_fold=True,
                        block_fold=True, dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), True)
    rng = np.random.default_rng(6)
    v = {"params": jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32),
        v["params"])}
    monkeypatch.setattr(jmf, "_target_platform", lambda: "tpu")
    calls = []

    def interp(orig, name):
        def run(*a, **kw):
            calls.append(name)
            return orig(*a, **dict(kw, interpret=True))
        return run

    monkeypatch.setattr(jmk, "fused_mixffn_skip",
                        interp(jmk.fused_mixffn_skip, "K9"))
    monkeypatch.setattr(jmk, "fused_mixffn_ln_skip",
                        interp(jmk.fused_mixffn_ln_skip, "K2"))
    monkeypatch.setattr(jmk, "fused_mixffn_ln_skip_bwd",
                        interp(jmk.fused_mixffn_ln_skip_bwd, "K11"))
    masks = iter(_masks())

    def drop_path(b, rate, deterministic, rng=None):
        if deterministic or rate == 0.0:
            return b
        return b * jnp.asarray(next(masks), b.dtype) / (1.0 - rate)

    monkeypatch.setattr(ja, "drop_path", drop_path)

    @jax.jit
    def fwd_bwd(p, xx, gg):
        out, vjp = jax.vjp(lambda p, xx: jm.apply(
            {"params": p}, xx, False,
            rngs={"dropout": jax.random.PRNGKey(1)}), p, xx)
        return (out,) + vjp(gg)

    out, gp, gx = fwd_bwd(v["params"], jnp.asarray(x), jnp.asarray(g))
    assert sorted(set(calls)) == ["K11", "K2", "K9"]
    assert calls.count("K9") == 2
    return v, np.asarray(out), gp, np.asarray(gx)


def test_mhca_encoder_train_drop_path_matches_jax(monkeypatch):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S, S, C)).astype(np.float32)
    g = rng.normal(size=(B, S, S, C)).astype(np.float32)
    v, want, gp, gx = _jax_encoder(monkeypatch, x, g)

    folds = fold_table(TransceptionConfig(use_pallas_train=True,
                                          mhca_ffn_fold=True,
                                          mhca_block_fold=True))
    pm = pa.MHCAEncoder(C, LAYERS, HEADS, 3, dtype=torch.float32,
                        folds=folds, drop_path_rates=RATES)
    load_jax_variables(pm, v, device="cpu")
    pm.train()
    masks = iter(_masks())

    def drop_path(t, rate, training, gen=None):
        if not training or rate == 0.0:
            return t
        return t * torch.from_numpy(next(masks)) / (1.0 - rate)

    monkeypatch.setattr(pa, "drop_path", drop_path)
    xt = torch.from_numpy(x).requires_grad_()
    kernels.reset_launches()
    out = pm(xt, torch.Generator())
    # The port's routing: layer 0 as the whole-block fold (K5's plain
    # version on the CPU), layers 1-2 unfolded with their FFNs through K9.
    assert kernels.routed_counts() == {"mhca_block": 1,
                                       "linear_attention": 2,
                                       "mixffn_skip": 2}
    assert next(masks, None) is None
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    out.backward(torch.from_numpy(g))

    jg = {key: _to_torch_layout(arr, tuple(arr.shape[::-1]) if arr.ndim == 2
                                else tuple(arr.shape))
          for _, key, arr in _jax_entries({"params": gp})}
    grads = dict(pm.named_parameters())
    assert set(jg) == set(grads)
    top = max(np.abs(a).max() for a in jg.values())
    for name, want_g in jg.items():
        got = grads[name].grad.numpy()
        assert got.shape == want_g.shape, name
        err = np.abs(got - want_g).max()
        assert err <= 1e-4 * np.abs(want_g).max() + 1e-6 * top, name
    err = np.abs(xt.grad.numpy() - gx).max()
    assert err <= 1e-4 * np.abs(gx).max()
