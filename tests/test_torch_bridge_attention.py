"""Port kernel K3 (bridge softmax attention): the plain PyTorch version
against the Pallas kernel in interpret mode (bf16) and against the XLA
branch of MEfficientSelfAtten (models/bridge.py:227-232, fp32).

Tolerances: fp32 to reassociation (2e-5, as the Pallas kernel's own test).
bf16: both round e = exp(l − m) to bf16 before P·V and divide the
(rows, d) output by the fp32 sum; they differ where a different fp32
summation order flips a bf16 rounding — at most 2 bf16 ulps of the output
scale and under 2% of elements beyond one ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu.ops.pallas.bridge_attention_kernel import (
    bridge_softmax_attention,
)
from transception_tpu_torch.ops.kernels import bridge_attention as ba

SHAPES = [(2, 1, 124, 28, 64), (1, 1, 600, 96, 64), (1, 2, 512, 128, 32)]


def _qkv(B, h, N, M, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, h, N, d)).astype(np.float32),
            rng.normal(size=(B, h, M, d)).astype(np.float32),
            rng.normal(size=(B, h, M, d)).astype(np.float32))


def _xla_branch(q, k, v, scale):
    attn = jnp.einsum("bhnd,bhmd->bhnm", q, k,
                      preferred_element_type=jnp.float32) * scale
    attn = jax.nn.softmax(attn, axis=-1).astype(v.dtype)
    return jnp.einsum("bhnm,bhmd->bhnd", attn, v,
                      preferred_element_type=jnp.float32).astype(v.dtype)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret_bf16(shape):
    B, h, N, M, d = shape
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _qkv(*shape))
    want = np.asarray(bridge_softmax_attention(q, k, v, scale=d ** -0.5,
                                               interpret=True), np.float32)
    qt, kt, vt = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .bfloat16() for a in (q, k, v))
    got = ba.bridge_attention(qt, kt, vt, d ** -0.5).float().numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 2 * 2.0 ** -8 * np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (diff > ulp).mean() < 0.02


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_xla_branch_fp32(shape):
    B, h, N, M, d = shape
    q, k, v = _qkv(*shape, seed=1)
    want = np.asarray(_xla_branch(*map(jnp.asarray, (q, k, v)), d ** -0.5))
    got = ba.bridge_attention(*map(torch.from_numpy, (q, k, v)), d ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_cpu_dispatch_runs_plain_and_counts_nothing():
    q, k, v = map(torch.from_numpy, _qkv(1, 1, 40, 16, 64))
    before = ba.launches
    ba.bridge_attention(q, k, v, 0.125)
    assert ba.launches == before


@pytest.mark.parametrize("q_shape,kv_shape,dtype", [
    ((1, 1, 64, 64), (1, 1, 32, 64), torch.float16),   # bf16/fp32 only
    ((1, 1, 64, 32), (1, 1, 32, 32), torch.bfloat16),  # head dim 64 only
    ((1, 1, 64, 64), (1, 1, 40, 64), torch.bfloat16),  # M % 16
    ((1, 1, 64, 64), (2, 1, 32, 64), torch.bfloat16),  # batch mismatch
])
def test_kernel_checks_raise(q_shape, kv_shape, dtype):
    q = torch.zeros(q_shape, dtype=dtype)
    kv = torch.zeros(kv_shape, dtype=dtype)
    with pytest.raises(ValueError):
        ba._check(q, kv, kv)
