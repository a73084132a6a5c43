"""The whole serving slice of the PyTorch port against the JAX package:
MSTransception logits and class maps, and make_predictor.predict_volume,
with the same weights (load_jax_variables) and numpy inputs.

Tolerances:
  * fp32: max |port − JAX| ≤ 1e-4 · max |JAX logit| (fp32 reassociation
    through ~40 layers); class maps identical apart from pixels whose top
    two JAX logits lie within that tolerance.
  * bf16: both packages round at their own points (the port follows the
    Pallas kernels' rounding, the JAX CPU path its XLA modules'), so one
    bf16 ulp differences grow through the net: max |port − JAX| ≤ 5% of
    max |JAX logit| and at least 97% of the class ids equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu.eval.inference import make_predictor as jax_predictor
from transception_tpu.models.transception import MSTransception as JModel
from transception_tpu_torch.convert.from_jax import load_jax_variables
from transception_tpu_torch.core.config import TransceptionConfig
from transception_tpu_torch.eval.inference import make_predictor
from transception_tpu_torch.models.transception import MSTransception

from conftest import tiny_config


def _port_config(jc, **kw):
    names = {f.name for f in dataclasses.fields(TransceptionConfig)}
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)
              if f.name in names}
    fields.update(kw)
    return TransceptionConfig(**fields)


def _pair(jc, seed=0):
    jm = JModel(jc)
    x0 = jnp.zeros((1, jc.img_size, jc.img_size, 1))
    v = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(seed), x0))
    rng = np.random.default_rng(seed)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (rng.random(a.shape) + 0.5).astype(np.float32),
        v["batch_stats"])
    pm = MSTransception(_port_config(jc), device="cpu")
    load_jax_variables(pm, v, device="cpu")
    return jm, v, pm


def _image(n, size, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def fp32_pair():
    return _pair(tiny_config())


def test_tiny_slice_fp32_logits_and_class_maps(fp32_pair):
    jm, v, pm = fp32_pair
    x = _image(2, 32)
    fwd = jax.jit(lambda v, x, a: jm.apply(v, x, argmax=a),
                  static_argnums=2)
    want, want_ids = np.asarray(fwd(v, x, False)), np.asarray(fwd(v, x, True))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
        ids = pm(torch.from_numpy(x), argmax=True).numpy()
    tol = 1e-4 * np.abs(want).max()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= tol
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > tol
    assert ids.dtype == np.uint8 and ids.shape == want_ids.shape
    np.testing.assert_array_equal(ids[clear], want_ids[clear])


def test_tiny_slice_bf16():
    jc = tiny_config(dtype="bfloat16")
    jm, v, pm = _pair(jc, seed=1)
    x = _image(2, 32, seed=1)
    fwd = jax.jit(lambda v, x, a: jm.apply(v, x, argmax=a),
                  static_argnums=2)
    want, want_ids = np.asarray(fwd(v, x, False)), np.asarray(fwd(v, x, True))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
        ids = pm(torch.from_numpy(x), argmax=True).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()
    assert (ids == want_ids).mean() >= 0.97


def test_predict_volume_matches_jax_predictor(fp32_pair):
    """Host spline resample + normalise + chunked argmax, both packages;
    a 40² volume of 6 slices through batch-4 buckets (last one padded)."""
    jm, v, pm = fp32_pair
    vol = np.random.default_rng(2).random((6, 40, 40), dtype=np.float32)
    want = jax_predictor(jm, v, 32, batch=4).predict_volume(vol)
    got = make_predictor(pm, 32, batch=4, device="cpu").predict_volume(vol)
    assert got.shape == want.shape == (6, 32, 32)
    assert got.dtype == np.uint8
    assert (got != want).mean() <= 1e-3


@pytest.mark.slow
def test_published_config_224_fp32_b1():
    """The default TransceptionConfig() at 224², batch 1, fp32."""
    jc = dataclasses.replace(tiny_config(), img_size=224, stage1_layers=2,
                             num_path=(3, 3, 3), num_layers=(3, 8, 3))
    jm, v, pm = _pair(jc, seed=3)
    x = _image(1, 224, seed=3)
    want = np.asarray(jax.jit(jm.apply)(v, x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    tol = 1e-4 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > tol
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])
