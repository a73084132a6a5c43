"""One train step of ResInception ('15') in the PyTorch port against the
JAX package's make_train_step, without the wide head, at
tests/conftest.py tiny_config at 64² (so that the MultiRes branches'
train-mode BatchNorm has more than a handful of values per channel in the
deepest stage; batch 2), from the same weights and BatchNorm statistics
on the same batch: losses, every gradient leaf, the parameters and the
running statistics after the step (tests/torch_legacy.py
check_train_step, the tolerances of tests/test_torch_train_step.py:185-204)."""

import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from conftest import tiny_config
from torch_legacy import check_train_step, train_step_pair


def test_resinception_train_step_matches_jax():
    jax_out, port_out = train_step_pair("resinception",
                                        tiny_config(img_size=64))
    assert any("running_" in k for k in port_out[2])
    check_train_step(jax_out, port_out)
