"""The token_mlp ablations, 'mix' (MixFFN) and 'mlp' (MLP FFN), the port
against the JAX package at the tiny config (fp32): logits from the same
weights, the weights carried both ways (helpers and tolerances of
tests/test_torch_variants.py).

The JAX EfficientTransformerBlock calls its FFN with (h, H, W), which the
JAX MLPFFN does not take: token_mlp='mlp' raises there (as in the
reference, MSTr.py:63-77, 157-170). The port runs the MLP on the tokens
alone, without dropout (the JAX block passes no train flag); the JAX side
of this comparison swaps in, for the test only, an MLPFFN with the same
parameters and body that takes and ignores H and W."""

from typing import Any

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401 (torch's threads per xdist worker)
from flax import linen as nn

import transception_tpu.ops.common as jcommon
from test_torch_variants import check_round_trip, jax_pair


class MLPFFNTakingMap(nn.Module):
    """transception_tpu/ops/common.py MLPFFN (fc1, GELU, dropout, fc2,
    dropout), called as the JAX EfficientTransformerBlock calls its FFN."""

    c1: int
    c2: int
    drop_rate: float = 0.1
    dtype: Any = None

    @nn.compact
    def __call__(self, x, H=None, W=None, deterministic: bool = True):
        h = nn.Dense(self.c2, dtype=self.dtype, param_dtype=np.float32,
                     kernel_init=jcommon.xavier, name="fc1")(x)
        h = jcommon.gelu(h)
        h = nn.Dropout(self.drop_rate, deterministic=deterministic)(h)
        h = nn.Dense(self.c1, dtype=self.dtype, param_dtype=np.float32,
                     kernel_init=jcommon.xavier, name="fc2")(h)
        return nn.Dropout(self.drop_rate, deterministic=deterministic)(h)


@pytest.fixture(scope="module", params=["mix", "mlp"])
def pair(request):
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "mlp":
            mp.setattr(jcommon, "MLPFFN", MLPFFNTakingMap)
        jm, v, pm, report = jax_pair("mstransception", seed=3,
                                     token_mlp=request.param)
        x = np.random.default_rng(3).normal(
            size=(2, 32, 32, 1)).astype(np.float32)
        want = np.asarray(jax.jit(jm.apply)(v, x))
    return jm, v, pm, report, want


def test_token_mlp_matches_jax_fp32(pair):
    jm, v, pm, report, want = pair
    import torch
    with torch.no_grad():
        got = pm(torch.from_numpy(np.random.default_rng(3).normal(
            size=(2, 32, 32, 1)).astype(np.float32))).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_token_mlp_weights_round_trip(pair):
    check_round_trip(pair[:4])


def test_jax_mlp_token_mlp_raises_as_the_reference():
    """What the swap above stands in for: the JAX model with
    token_mlp='mlp' fails in its first transformer block."""
    from transception_tpu_torch.core.config import TransceptionConfig
    TransceptionConfig(token_mlp="mlp").validate()
    with pytest.raises(TypeError):
        jm, v, _, _ = jax_pair("mstransception", token_mlp="mlp")
        jm.apply(v, np.zeros((1, 32, 32, 1), np.float32))
