"""Port kernel K1 (folded ETB attention): the plain PyTorch version against
the Pallas kernel in interpret mode (bf16) and the jnp mirror (fp32).

Tolerances: fp32 agrees to float reassociation (1e-5). In bf16 both sides
round at the same points, so they differ only where a different fp32
summation order flips an intermediate bf16 rounding: at most 2 bf16 ulps
of the output's scale (2 * 2^-8 * max|out|) and on under 2% of elements
by more than one ulp of each element.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transception_tpu.ops.pallas.linear_attention import _reference_etb_folded
from transception_tpu.ops.pallas.linear_attention_kernel import (
    efficient_attention_block_folded,
)
from transception_tpu_torch.ops.kernels import etb_attention as ea

SHAPES = [(2, 256, 64), (1, 784, 128), (1, 196, 320)]


def _inputs(B, N, C, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    ls = (1 + 0.1 * rng.normal(size=C)).astype(np.float32)
    lb = (0.1 * rng.normal(size=C)).astype(np.float32)
    ps = []
    for _ in range(4):
        ps.append((rng.normal(size=(C, C)) * C ** -0.5).astype(np.float32))
        ps.append((0.1 * rng.normal(size=C)).astype(np.float32))
    return x, ls, lb, ps  # ps: wq, bq, wk, bk, wv, bv, wp, bp (flax layout)


def _torch_args(ls, lb, ps):
    t = torch.from_numpy
    out = [t(ls), t(lb)]
    for i in range(0, 8, 2):
        out += [t(ps[i].T.copy()), t(ps[i + 1])]
    return out


def _bf16_np(t):
    return t.float().numpy()


@pytest.mark.parametrize("B,N,C", SHAPES)
def test_plain_matches_pallas_interpret_bf16(B, N, C):
    x, ls, lb, ps = _inputs(B, N, C)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(efficient_attention_block_folded(
        xj, jnp.asarray(ls), jnp.asarray(lb), *map(jnp.asarray, ps),
        interpret=True), np.float32)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    got = _bf16_np(ea.etb_attention(xt, *_torch_args(ls, lb, ps)))
    diff = np.abs(got - want)
    assert diff.max() <= 2 * 2.0 ** -8 * np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (diff > ulp).mean() < 0.02


@pytest.mark.parametrize("B,N,C", SHAPES)
def test_plain_matches_jnp_mirror_fp32(B, N, C):
    x, ls, lb, ps = _inputs(B, N, C, seed=1)
    want = np.asarray(_reference_etb_folded(
        jnp.asarray(x), jnp.asarray(ls), jnp.asarray(lb),
        *map(jnp.asarray, ps), 1e-5))
    got = ea.etb_attention(torch.from_numpy(x), *_torch_args(ls, lb, ps))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cpu_dispatch_runs_plain_and_counts_nothing():
    x, ls, lb, ps = _inputs(1, 64, 64)
    before = ea.launches
    args = _torch_args(ls, lb, ps)
    out = ea.etb_attention(torch.from_numpy(x), *args)
    assert ea.launches == before
    assert torch.equal(out, ea.etb_attention_plain(torch.from_numpy(x),
                                                   *args))


@pytest.mark.parametrize("shape,dtype", [
    ((1, 64, 64), torch.float32),     # the kernel takes bf16 only
    ((1, 64, 72), torch.bfloat16),    # C not a multiple of 64
    ((1, 64, 576), torch.bfloat16),   # C above the kernel's limit (512)
    ((64, 64), torch.bfloat16),       # not (B, N, C)
])
def test_kernel_checks_raise(shape, dtype):
    C = shape[-1]
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError):
        ea._check(x, [torch.zeros(C, C)] * 4)
