"""The MSTransception ablation family of the PyTorch port against the JAX
package (transception_tpu/models/registry.py:31-57): each registry variant
(the 4-stage and casa backbones here, the sp and para bridges and no
bridge in tests/test_torch_variants_bridges.py, the mix and mlp token MLPs
in tests/test_torch_variants_ffn.py) as a tiny model (tests/conftest.py
tiny_config, fp32, 32²): logits from the same weights and numpy inputs,
and the weights carried both ways (the port's state_dict into the JAX
variables by the JAX package's own converter, convert/torch2flax.py
convert_state_dict, and back by load_jax_variables, bit for bit).

The weights are the port's seeded init with random biases, BatchNorm
statistics and CAM gammas (zero at init, which would hide their
branches), carried into JAX: no JAX init is compiled. The port runs its
kernel structure (every fold on, the kernels' plain versions on the CPU),
JAX its XLA path (its kernel gates are off on the CPU).

Tolerance: fp32, max|port − JAX| ≤ 1e-4 · max|JAX logit| (reassociation
through the ~40 layers), as tests/test_torch_model.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu.convert.torch2flax import convert_state_dict
from transception_tpu.models.registry import create_model as jcreate
from transception_tpu_torch.convert.from_jax import load_jax_variables
from transception_tpu_torch.core.config import TransceptionConfig
from transception_tpu_torch.models.transception import MSTransception

from conftest import tiny_config

IMG = 32


def port_config(jc, **kw):
    """The port's TransceptionConfig of a JAX one (the shared fields)."""
    names = {f.name for f in dataclasses.fields(TransceptionConfig)}
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)
              if f.name in names}
    fields.update(kw)
    return TransceptionConfig(**fields)


def perturb(model, seed):
    """Random biases, BatchNorm statistics and CAM gammas, in place."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_mean"):
                t.copy_(torch.rand(t.shape, generator=g) * 0.2 - 0.1)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif name.endswith(("bias", "conv3d_bias")):
                t.add_(torch.randn(t.shape, generator=g) * 0.02)
            elif name.endswith("gamma"):
                t.fill_(0.5)


def jax_pair(name, seed=0, **over):
    """(JAX model, its variables, the port model, the converter's report)
    of registry model `name` at tiny_config(**over): the port's weights
    carried into the JAX variables by convert_state_dict."""
    jm = jcreate(name, tiny_config(**over))
    pm = MSTransception(port_config(jm.cfg), device="cpu", seed=seed)
    perturb(pm, seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, IMG, IMG, 1)))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = {k: t.numpy() for k, t in pm.state_dict().items()}
    v, report = convert_state_dict(sd, zeros)
    return jm, jax.tree_util.tree_map(np.asarray, v), pm, report


def image(n=2, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, IMG, IMG, 1)).astype(np.float32)


def check_logits(pair, seed=0):
    jm, v, pm, _ = pair
    x = image(seed=seed)
    want = np.asarray(jax.jit(jm.apply)(v, x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, IMG, IMG, 9)
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def check_round_trip(pair):
    """Every port tensor reaches a JAX leaf, and the JAX variables load
    back strictly into a fresh port model, bit for bit."""
    jm, v, pm, report = pair
    assert report["unused_torch_keys"] == []
    back = MSTransception(pm.cfg, device="cpu", seed=123)
    load_jax_variables(back, v, device="cpu")
    want = pm.state_dict()
    for k, t in back.state_dict().items():
        assert torch.equal(t, want[k]), k


@pytest.fixture(scope="module", params=["mstransception_4stage",
                                        "mstransception_casa"])
def pair(request):
    return jax_pair(request.param, seed=1)


def test_variant_matches_jax_fp32(pair):
    check_logits(pair)


def test_variant_weights_round_trip(pair):
    check_round_trip(pair)


def test_4stage_structure():
    """The 4-stage backbone: the Conv2d_BN stem (stem.0/1), four MHCA
    stages of 2, 3, 3, 3 paths and 1, 3, 8, 3 layers whatever the config
    says, no stage-1 transformer blocks."""
    m = MSTransception(port_config(jcreate(
        "mstransception_4stage", tiny_config()).cfg), device="cpu")
    b = m.backbone
    assert [len(getattr(b, f"mhca_stage{s}").mhca_blks)
            for s in range(1, 5)] == [2, 3, 3, 3]
    assert [len(getattr(b, f"mhca_stage{s}").mhca_blks[0].MHCA_layers)
            for s in range(1, 5)] == [1, 3, 8, 3]
    keys = m.state_dict()
    assert "backbone.stem.1.bn.running_var" in keys
    assert not any(k.startswith("backbone.block1") for k in keys)
