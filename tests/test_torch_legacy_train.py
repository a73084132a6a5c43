"""One train step of MISSFormer in the PyTorch port against the JAX
package's make_train_step, without the wide head (the legacy models have
none, JAX trainer.py:202-209), at tests/conftest.py tiny_config (fp32,
32², batch 2), from the same weights on the same batch: losses, every
gradient leaf, and the parameters after the SGD update
(tests/torch_legacy.py check_train_step, the tolerances of
tests/test_torch_train_step.py:185-204). The port's step runs MISSFormer's bridge
folded (the folded bridge attention, K8, and the FFN folds, K2 and their
backward K11, as plain versions on the CPU), as JAX train_step_model
leaves the model; JAX runs its XLA path. ResInception's step (BatchNorm)
is tests/test_torch_legacy_train_res.py's."""

import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from conftest import tiny_config
from torch_legacy import check_train_step, train_step_pair
from transception_tpu_torch.core.config import (
    TrainConfig,
    TransceptionConfig,
)
from transception_tpu_torch.models import legacy
from transception_tpu_torch.models.registry import LEGACY, create_model
from transception_tpu_torch.ops import kernels
from transception_tpu_torch.train.state import TrainState
from transception_tpu_torch.train.trainer import make_train_step


@pytest.fixture(scope="module")
def missformer_step():
    return train_step_pair("missformer", tiny_config())


def test_missformer_train_step_matches_jax(missformer_step):
    check_train_step(*missformer_step)


@pytest.mark.parametrize("name", LEGACY)
def test_train_step_routes_equal_launches_per_step(name):
    """The kernel wrappers' decisions in one port train step of each
    legacy model (tiny config; on the CPU what a card would launch) are
    legacy.launches_per_step's forward kernels; the wide head is never
    asked for."""
    cfg = TransceptionConfig(img_size=32, dtype="float32", dil_conv=0)
    m = create_model(name, cfg, device="cpu", seed=0)
    st = TrainState(m, TrainConfig(batch_size=2), 4)
    x = torch.randn(2, 32, 32, 1, generator=torch.Generator().manual_seed(0))
    y = torch.randint(0, 9, (2, 32, 32),
                      generator=torch.Generator().manual_seed(1))
    kernels.reset_launches()
    make_train_step(st, 9, 0.4, 0.6)(x, y)
    want = legacy.launches_per_step(name, cfg)
    assert want["mixffn_bwd"] == want["mixffn"]
    assert kernels.routed_counts() == {
        k: n for k, n in want.items()
        if n and k not in ("bridge_attention_bwd", "mixffn_bwd")}
