"""Port kernel K10 (bridge attention backward): the plain PyTorch backward
against the Pallas backward in interpret mode and against jax.vjp of the
XLA attention, the autograd Function on the CPU against autograd through
the plain forward, and gradcheck of the plain backward.

Tolerances: fp32 rtol 2e-4 / atol 2e-5, the Pallas backward test's own
(tests/test_bridge_attention_kernel.py:96-101): the same fp32 algebra in
another summation order. The Function on the CPU: 1e-5 relative (the
factored 1/rowsum against autograd's softmax backward, fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu.ops.pallas.bridge_attention_kernel import (
    bridge_softmax_attention_bwd,
)
from transception_tpu_torch.ops.kernels import bridge_attention as ba

SHAPES = [(2, 1, 124, 28, 64), (1, 1, 600, 96, 64), (1, 2, 512, 128, 32)]


def _qkvg(B, h, N, M, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, h, n, d)).astype(np.float32)
                 for n in (N, M, M, N))


def _xla_attention(q, k, v, scale):
    logits = jnp.einsum("bhnd,bhmd->bhnm", q, k) * scale
    return jnp.einsum("bhnm,bhmd->bhnd", jax.nn.softmax(logits, -1), v)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_bwd_matches_pallas_and_autodiff(shape):
    q, k, v, g = _qkvg(*shape)
    scale = shape[-1] ** -0.5
    got = ba.bridge_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v, g)), scale)
    pallas = bridge_softmax_attention_bwd(*map(jnp.asarray, (q, k, v, g)),
                                          scale=scale, interpret=True)
    _, vjp = jax.vjp(lambda *a: _xla_attention(*a, scale),
                     *map(jnp.asarray, (q, k, v)))
    for want in (pallas, vjp(jnp.asarray(g))):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                       atol=2e-5)


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    q, k, v, g = map(torch.from_numpy, _qkvg(1, 1, 40, 16, 64))
    n0 = ba.bwd_launches
    got = ba.bridge_attention_bwd(q, k, v, g, 0.125)
    want = ba.bridge_attention_bwd_plain(q, k, v, g, 0.125)
    assert ba.bwd_launches == n0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_function_matches_autograd_of_plain_forward():
    q, k, v, g = map(torch.from_numpy, _qkvg(2, 1, 70, 24, 64, seed=3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ba.BridgeAttention.apply(*leaves, 0.125)
    assert torch.equal(out.detach(), ba.bridge_attention_plain(q, k, v,
                                                               0.125))
    out.backward(g)
    want = torch.autograd.grad(
        ba.bridge_attention_plain(*leaves, 0.125), leaves, g)
    for t, w in zip(leaves, want):
        torch.testing.assert_close(t.grad, w, rtol=1e-5, atol=1e-6)


def test_gradcheck_float64():
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.normal(size=(1, 1, n, 8)),
                            dtype=torch.float64, requires_grad=True)
               for n in (5, 4, 4))
    assert torch.autograd.gradcheck(
        lambda *a: ba.BridgeAttention.apply(*a, 0.5), (q, k, v))
