"""The train steps of tests/test_torch_train_step.py with the standard
head (logits in map order, the loss on the unpermuted labels) against JAX
make_train_step, in the three train modes: the second of the module's two
JAX compiles, in a file of its own so that pytest-xdist's loadfile runs
the two on two workers. Tolerances are that module's."""

import pytest
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from test_torch_train_step import (  # noqa: F401 (fixtures)
    MODES,
    check_step_matches_jax,
    jax_steps,
    port_run,
    setup,
)


@pytest.fixture(scope="module", params=[False], ids=["std"])
def jax_run(request, setup):  # noqa: F811
    return jax_steps(setup, request.param)


@pytest.mark.parametrize("mode", list(MODES))
def test_train_step_matches_jax(setup, jax_run, port_run, mode):  # noqa: F811
    check_step_matches_jax(setup, jax_run, port_run, mode)
