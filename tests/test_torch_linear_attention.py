"""Port kernel K6 (linear attention per batch and head): the plain PyTorch
version against the Pallas kernel in interpret mode (bf16) and the XLA
einsum path (fp32), and the port's factorized attention against JAX's.

The Pallas kernel's gate refuses head dims under 64
(tests/test_pallas_kernel.py test_tiny_head_dim_gate_raises), so it is
compared at its own shapes; the stage-4 shape (B, 8, 49, 40), where the
port runs its kernel, is held against the XLA path.

Tolerances: fp32 to float reassociation (2e-5 relative and absolute). In
bf16 both sides round softmax(K), the context and the output at the same
points: at most 2 bf16 ulps of the output scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu.ops.attention import (
    efficient_linear_attention as j_efficient,
    factorized_attention as j_factorized,
)
from transception_tpu.ops.pallas.linear_attention_kernel import (
    linear_attention as pallas_linear_attention,
)
from transception_tpu_torch.ops.attention import factorized_attention
from transception_tpu_torch.ops.kernels import linear_attention as la


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) * f
            for f in (1.0, 2.0, 1.0)]


@pytest.mark.parametrize("shape", [(2, 1, 64, 64), (1, 2, 49, 128)])
@pytest.mark.parametrize("q_softmax", [False, True])
def test_plain_matches_pallas_interpret_bf16(shape, q_softmax):
    qj = [jnp.asarray(a, jnp.bfloat16) for a in _qkv(shape)]
    want = np.asarray(pallas_linear_attention(*qj, q_softmax=q_softmax,
                                              interpret=True), np.float32)
    qt = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
          for a in qj]
    got = la.linear_attention(*qt, q_softmax).float().numpy()
    assert np.abs(got - want).max() <= 2 * 2.0 ** -8 * np.abs(want).max()


@pytest.mark.parametrize("shape", [(2, 8, 49, 40), (1, 2, 49, 128)])
@pytest.mark.parametrize("q_softmax", [False, True])
def test_plain_matches_xla_fp32(shape, q_softmax):
    q, k, v = _qkv(shape, seed=1)
    jq = [jnp.asarray(a) for a in (q, k, v)]
    want = np.asarray(j_efficient(*jq) if q_softmax
                      else j_factorized(*jq, 1.0))
    got = la.linear_attention(*map(torch.from_numpy, (q, k, v)), q_softmax)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_factorized_attention_matches_jax_stage4_fp32():
    q, k, v = _qkv((2, 8, 49, 40), seed=2)
    want = np.asarray(j_factorized(*map(jnp.asarray, (q, k, v)),
                                   40 ** -0.5))
    got = factorized_attention(*map(torch.from_numpy, (q, k, v)), 40 ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_cpu_dispatch_runs_plain_and_counts_nothing():
    q, k, v = map(torch.from_numpy, _qkv((1, 8, 49, 40)))
    before = la.launches
    out = la.linear_attention(q, k, v)
    assert la.launches == before
    assert torch.equal(out, la.linear_attention_plain(q, k, v))


@pytest.mark.parametrize("qs,ks,vs,dtype", [
    ((1, 8, 49, 40),) * 3 + (torch.float16,),              # bf16/fp32 only
    ((1, 8, 49, 40), (1, 8, 48, 40), (1, 8, 49, 40), torch.bfloat16),
    ((1, 49, 40),) * 3 + (torch.bfloat16,),                    # not 4-D
    ((1, 1, 64, 1024),) * 3 + (torch.bfloat16,),               # smem
])
def test_kernel_checks_raise(qs, ks, vs, dtype):
    q, k, v = (torch.zeros(s, dtype=dtype) for s in (qs, ks, vs))
    with pytest.raises(ValueError):
        la._check(q, k, v)


@pytest.mark.parametrize("shape", [(2, 8, 49, 40), (2, 8, 196, 16),
                                   (2, 8, 784, 8)])
def test_factorized_attention_rounds_once_bf16(shape):
    """The MHCA factorized attention in bf16 against JAX
    factorized_attention(use_pallas=False), the path the JAX package takes
    at every MHCA head dim: the scale multiplies the fp32 product and the
    result is rounded once. Rounding the product, scaling and rounding
    again puts ~27% of the outputs one bf16 ulp off at d = 40. Both sides
    round softmax(K) and the context at the same points; only the fp32
    summation order differs, so at most 1% of the outputs may differ, by at
    most one bf16 ulp of the output scale."""
    q, k, v = _qkv(shape, seed=3)
    jq = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    scale = shape[-1] ** -0.5
    want = np.asarray(j_factorized(*jq, scale).astype(jnp.float32))
    qt = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
          for a in jq]
    got = factorized_attention(*qt, scale).float().numpy()
    assert (got != want).mean() <= 0.01
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()


def test_plain_matches_pallas_interpret_long_n_bf16():
    """The ETB shape of stage 1 at batch 1, (1, 1, 3136, 64), with the
    softmax of Q: where etb_attn_fold=False sends the kernel. Tolerance as
    the short shapes' (2 bf16 ulps of the output scale)."""
    qj = [jnp.asarray(a, jnp.bfloat16) for a in _qkv((1, 1, 3136, 64), 4)]
    want = np.asarray(pallas_linear_attention(*qj, q_softmax=True,
                                              interpret=True), np.float32)
    qt = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
          for a in qj]
    got = la.linear_attention(*qt, True).float().numpy()
    assert np.abs(got - want).max() <= 2 * 2.0 ** -8 * np.abs(want).max()


@pytest.mark.parametrize("N,dk,dv,bh,want", [
    (49, 40, 40, 256, 1), (3136, 64, 64, 32, 9), (784, 128, 128, 32, 3),
    (196, 320, 320, 32, 1), (784, 8, 8, 256, 1), (5, 64, 64, 1, 1)])
def test_segments_fill_the_card(N, dk, dv, bh, want):
    """K6's plan on 132 SMs: the heads that fit a block (the MHCA shapes,
    and a 5-row head) take the head body, the whole head one segment;
    the others cut N into enough non-empty segments of whole 64-row
    chunks for 2 context-stage blocks per SM (context tiles x segments x
    batch·heads)."""
    p = la.plan(bh, N, dk, dv, 132)
    S, rps = p["segments"], p["segment_rows"]
    assert S == want
    assert p["body"] == ("segmented" if dk > 64 or N > 1000 else "head")
    assert S * rps >= N and (S - 1) * rps < N
    if p["body"] == "segmented":
        assert rps % 64 == 0 and p["blocks"]["ctx"] >= 2 * 132
