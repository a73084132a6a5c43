"""The legacy models no registry name builds, against the JAX package's
(transception_tpu/models/legacy.py), at tests/conftest.py tiny_config
(fp32, dil_conv 0 at 32²): Transception with the three-branch encoder
and with SK fusion (concat 'sk', its BatchNorm in eval and in a train-mode
forward), MISSFormer without its bridge, and the 4-stage inception
encoder (MiTInception4Stage, at 64², tests/test_extra_ops.py:41-55);
logits (or the encoder's four maps) from the same weights and numpy
inputs within 1e-4 of max|JAX|, and the weights carried both ways
(tests/test_torch_legacy_models.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from conftest import tiny_config
from torch_legacy import (
    check_logits,
    check_round_trip,
    image,
    model_pair,
    perturb,
    port_config,
    to_jax,
)
from transception_tpu.models import legacy as jl
from transception_tpu_torch.convert.from_jax import load_jax_variables
from transception_tpu_torch.models import legacy as pl

JC = tiny_config(dil_conv=0)
# case -> (JAX model, port model class, keyword arguments)
CASES = {
    "3branches": (jl.Transception(JC, encoder="3branches"), pl.Transception,
                  dict(encoder="3branches")),
    "sk": (jl.Transception(JC, concat="sk"), pl.Transception,
           dict(concat="sk")),
    "missformer-no-bridge": (jl.MISSFormer(JC, if_bridge=False),
                             pl.MISSFormer, dict(if_bridge=False)),
}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    jm, cls, kw = CASES[request.param]
    pm = cls(port_config(JC), device="cpu", seed=0, **kw)
    return cls, kw, model_pair(jm, pm, 32)


def test_variant_matches_jax_fp32(pair):
    check_logits(pair[2], 32)


def test_variant_weights_round_trip(pair):
    cls, kw, p = pair
    check_round_trip(p, lambda: cls(p[2].cfg, device="cpu", seed=7, **kw))


def test_structure():
    """Three branches a stage with a 1x1 merge of 3·dim; SK fusion in
    place of the merge; no bridge layers without the bridge."""
    cfg = port_config(JC)
    m = pl.Transception(cfg, encoder="3branches", device="cpu")
    keys = m.state_dict()
    assert "backbone.patch_embed4_3.proj.weight" in keys
    assert tuple(keys["backbone.conv1_1_s2.weight"].shape[:2]) == (
        cfg.dims[1], 3 * cfg.dims[1])
    keys = pl.Transception(cfg, concat="sk", device="cpu").state_dict()
    assert "backbone.sk_concat3.conv_bn_ac.2.running_var" in keys
    assert not any("conv1_1" in k for k in keys)
    keys = pl.MISSFormer(cfg, if_bridge=False, device="cpu").state_dict()
    assert not any(k.startswith("bridge_layer") for k in keys)


def test_sk_train_mode_forward_matches_jax():
    """The SK fusion's BatchNorm with batch statistics: a train-mode
    forward's logits and the updated running statistics against JAX's
    (mutable batch_stats)."""
    jm, cls, kw = CASES["sk"]
    _, v, pm, _ = model_pair(jm, cls(port_config(JC), device="cpu", seed=2,
                                     **kw), 32, seed=2)
    x = image(n=4)
    want, upd = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, x)
    pm.train()
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    want = np.asarray(want)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    back = cls(pm.cfg, device="cpu", seed=9, **kw)
    load_jax_variables(back, {"params": v["params"],
                              "batch_stats": upd["batch_stats"]},
                       device="cpu")
    stats = {k: t for k, t in back.state_dict().items() if "running_" in k}
    assert stats
    for k, t in stats.items():
        torch.testing.assert_close(pm.state_dict()[k], t, rtol=1e-5,
                                   atol=1e-6, msg=k)


def test_mit_inception_4stage_matches_jax_fp32():
    """The 4-stage inception encoder's four maps (widths 64/128/320/512
    at sides 16/8/4/2 of a 64² input) and its weights both ways."""
    jc = tiny_config(img_size=64)
    jm = jl.MiTInception4Stage(jc)
    pm = pl.MiTInception4Stage(port_config(jc))
    pl.init_weights(pm, torch.Generator().manual_seed(0))
    perturb(pm, 3)
    x = np.random.default_rng(1).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    v, report = to_jax(jm, pm, jnp.zeros((1, 64, 64, 3)))
    assert report["unused_torch_keys"] == []
    want = jax.jit(jm.apply)(v, x)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [
        (1, 16, 16, 64), (1, 8, 8, 128), (1, 4, 4, 320), (1, 2, 2, 512)]
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()
    back = pl.MiTInception4Stage(port_config(jc))
    load_jax_variables(back, v, device="cpu")
    for k, t in back.state_dict().items():
        assert torch.equal(t, pm.state_dict()[k]), k
