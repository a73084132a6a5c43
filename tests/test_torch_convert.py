"""Weight bridge between the JAX package and the PyTorch port: the port's
state_dict keys are the reference torch keys, so the JAX package's own
converter (convert/torch2flax.py) maps it back without missing keys, and
JAX -> port -> JAX returns every leaf bit for bit, for both the
path-stacked (vectorize_paths) and the per-path MHCA layouts."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu.convert.torch2flax import (
    convert_state_dict,
    flax_path_to_torch_key as jax_key,
)
from transception_tpu.models.transception import MSTransception as JModel
from transception_tpu_torch.convert.from_jax import (
    flax_path_to_torch_key,
    load_jax_variables,
)
from transception_tpu_torch.core.config import TransceptionConfig
from transception_tpu_torch.models.transception import MSTransception

from conftest import tiny_config


def _port_config(jc):
    names = {f.name for f in dataclasses.fields(TransceptionConfig)}
    return TransceptionConfig(**{f.name: getattr(jc, f.name)
                                 for f in dataclasses.fields(jc)
                                 if f.name in names})


def _jax_vars(jc, seed=0):
    x = jnp.zeros((1, jc.img_size, jc.img_size, 1))
    v = jax.jit(JModel(jc).init)(jax.random.PRNGKey(seed), x)
    # Random batch statistics, so buffers are exercised too.
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(np.asarray, v)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (rng.random(a.shape) + 0.5).astype(np.float32),
        v["batch_stats"])
    return v


@pytest.fixture(scope="module", params=[True, False],
                ids=["stacked_paths", "per_path"])
def pair(request):
    jc = tiny_config(vectorize_paths=request.param)
    v = _jax_vars(jc)
    m = MSTransception(_port_config(jc), device="cpu")
    load_jax_variables(m, v, device="cpu")
    return jc, v, m


def test_round_trip_is_bit_exact(pair):
    _, v, m = pair
    sd = {k: t.detach().numpy() for k, t in m.state_dict().items()}
    back, report = convert_state_dict(sd, v)
    assert report["unused_torch_keys"] == []
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path(v),
            jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_key_translation_matches_jax_converter(pair):
    _, v, _ = pair
    for kp, _ in jax.tree_util.tree_leaves_with_path(v["params"]):
        path = "/".join(str(k.key) for k in kp).replace(
            "mhca_blks_stacked", "mhca_blks_0")
        assert flax_path_to_torch_key(path) == jax_key(path)


def test_load_is_strict(pair):
    jc, v, _ = pair
    m = MSTransception(_port_config(jc), device="cpu")
    extra = dict(v)
    extra["params"] = dict(v["params"], stray={"kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError, match="1 unused JAX leaves"):
        load_jax_variables(m, extra, device="cpu")
    missing = dict(v)
    missing["params"] = {k: p for k, p in v["params"].items()
                         if k != "decoder_0"}
    with pytest.raises(KeyError, match="unfilled port tensors"):
        load_jax_variables(m, missing, device="cpu")


def test_port_init_fills_same_shapes_as_jax(pair):
    """The port's own seeded init has exactly the JAX tree's tensors."""
    jc, v, _ = pair
    sd = MSTransception(_port_config(jc), device="cpu").state_dict()
    _, report = convert_state_dict(
        {k: t.numpy() for k, t in sd.items()}, v)
    assert report["unused_torch_keys"] == []
    assert report["n_converted"] == len(sd)
    assert all(t.dtype == torch.float32 for t in sd.values())


def test_default_model_loads_strictly_and_round_trips():
    """Every parameter and buffer of the published model (default widths
    and depths; no parameter shape depends on img_size, so its tree is
    built at 32² from abstract shapes) is filled from the JAX tree and
    maps back bit for bit."""
    from transception_tpu.core.config import TransceptionConfig as JConfig
    jc = JConfig(img_size=32)
    shapes = jax.eval_shape(JModel(jc).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 1)))
    rng = np.random.default_rng(7)
    v = jax.tree_util.tree_map(
        lambda s: rng.random(s.shape, dtype=np.float32) + 0.5, shapes)
    m = MSTransception(TransceptionConfig(img_size=32), device="cpu")
    load_jax_variables(m, v, device="cpu")
    assert sum(p.numel() for p in m.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(v["params"]))
    back, report = convert_state_dict(
        {k: t.numpy() for k, t in m.state_dict().items()}, v)
    assert report["unused_torch_keys"] == []
    for a, b in zip(jax.tree_util.tree_leaves(v),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, np.asarray(b))
