"""The legacy model family of the PyTorch port (models/legacy.py) against
the JAX package's (transception_tpu/models/legacy.py), as the registry
builds them (transception, missformer, effmissformer, resinception,
resinception_135), at tests/conftest.py tiny_config (fp32, 32²; the
two-branch encoder's dilated schedules shrink its stage-4 maps to nothing
below ~96 px, so `transception` runs with dil_conv 0 here and dilated at
96², tests/test_legacy_models.py:37-42): logits from the same weights and
numpy inputs, and the weights carried both ways (the port's state_dict
into the JAX variables by the JAX package's converter, and back by
load_jax_variables, strictly and bit for bit). The Transception and
MISSFormer variants no registry name builds are in
tests/test_torch_legacy_variants.py.

The port runs its kernel structure (MISSFormer's bridge folds on, the
kernels' plain versions on the CPU), JAX its XLA path. Tolerance: fp32,
max|port − JAX| ≤ 1e-4 · max|JAX logit| (tests/test_torch_variants.py).
"""

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from conftest import tiny_config
from torch_legacy import (
    check_logits,
    check_round_trip,
    model_pair,
    port_config,
)
from transception_tpu.models.registry import create_model as jcreate
from transception_tpu_torch.models import legacy
from transception_tpu_torch.models.registry import LEGACY, create_model

# case -> (registry name, tiny_config overrides, image side)
CASES = {
    "transception": ("transception", dict(dil_conv=0), 32),
    "transception-dilated-96": ("transception", {}, 96),
    "missformer": ("missformer", {}, 32),
    "effmissformer": ("effmissformer", {}, 32),
    "resinception": ("resinception", {}, 32),
    "resinception_135": ("resinception_135", {}, 32),
}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    name, over, img = CASES[request.param]
    jc = tiny_config(img_size=img, **over)
    pm = create_model(name, port_config(jc), device="cpu", seed=0)
    return name, img, model_pair(jcreate(name, jc), pm, img)


def test_legacy_matches_jax_fp32(pair):
    _, img, p = pair
    check_logits(p, img)


def test_legacy_weights_round_trip(pair):
    name, _, p = pair
    check_round_trip(p, lambda: create_model(name, p[2].cfg, device="cpu",
                                             seed=123))


@pytest.mark.parametrize("name", LEGACY)
def test_registry_takes_the_callers_config(name):
    """The registry passes the caller's config as it is (head_count 8 and
    the dilated schedules by default), into the model's class."""
    cfg = port_config(tiny_config())
    m = create_model(name, cfg, device="cpu")
    assert m.cfg == cfg and (m.cfg.head_count, m.cfg.dil_conv) == (8, 1)
    assert type(m) is legacy.MODELS[name][0]
    assert not any(p.dtype != torch.float32 for p in m.parameters())


@pytest.mark.parametrize("name", LEGACY)
def test_parameter_counts_at_224(name):
    """The published widths (224², TransceptionConfig()): the port's
    parameter count is the JAX model's, by jax.eval_shape of its init (no
    forward run)."""
    import jax.numpy as jnp
    from transception_tpu.core.config import TransceptionConfig as JConfig
    from transception_tpu_torch.core.config import TransceptionConfig
    jm = jcreate(name, JConfig())
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 1)))
    want = sum(int(np.prod(s.shape)) for s in
               jax.tree_util.tree_leaves(shapes["params"]))
    m = create_model(name, TransceptionConfig(), device="cpu")
    assert sum(p.numel() for p in m.parameters()) == want
