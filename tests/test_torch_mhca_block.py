"""Port kernel K5 (whole MHCA block): the plain PyTorch version against the
Pallas kernel in interpret mode (bf16) and the jnp mirror (fp32).

Tolerances: fp32 agrees to float reassociation (1e-4 relative and
absolute; the block chains seven products and three LayerNorms). In bf16
both sides round at the same points but the Pallas GELU is a polynomial
where the port's is exact erf, and a different fp32 summation order can
flip any of the ~12 intermediate roundings. The Pallas kernel itself
differs from its own jnp mirror by more than one ulp on ~22% of the
elements at these shapes, so the bf16 test asks: at most 4 bf16 ulps of
the output scale (4 * 2^-8 * max|out|), and no larger share of elements
off by more than one ulp than the Pallas kernel's own share against the
mirror, plus 2 points.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu.ops.pallas.mhca_block import _reference_impl
from transception_tpu.ops.pallas.mhca_block_kernel import fused_mhca_block
from transception_tpu_torch.ops.kernels import mhca_block as mb

WIN = ((3, 2), (5, 3), (7, 3))


def _inputs(B, s, C, heads, hid, seed=0):
    """x and the block's parameters in the flax layouts of the Pallas
    kernel (mhca_block_kernel.py:200)."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=0.3, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)

    d = C // heads
    x = n(B, s * s, C, scale=1.0)
    p = [n(3, 3, 1, C), n(C, scale=0.1), n(C, scale=0.1, shift=1.0),
         n(C, scale=0.1), n(C, 3 * C, scale=C ** -0.5), n(3 * C, scale=0.1),
         tuple(n(w, w, 1, h * d, scale=1.0 / w) for w, h in WIN),
         tuple(n(h * d, scale=0.1) for _, h in WIN),
         n(C, C, scale=C ** -0.5), n(C, scale=0.1),
         n(C, scale=0.1, shift=1.0), n(C, scale=0.1),
         n(C, hid, scale=C ** -0.5), n(hid, scale=0.1), n(3, 3, 1, hid),
         n(hid, scale=0.1), n(hid, scale=0.1, shift=1.0), n(hid, scale=0.1),
         n(hid, C, scale=hid ** -0.5), n(C, scale=0.1)]
    return x, p


def _torch_args(p):
    """The same parameters in the port's torch layouts."""
    t = torch.from_numpy

    def dw(k):  # (kh, kw, 1, C) -> (C, 1, kh, kw)
        return t(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))

    def lin(k):  # Dense (in, out) -> Linear (out, in)
        return t(np.ascontiguousarray(k.T))

    (cpe_k, cpe_b, l1s, l1b, qkv_k, qkv_b, crpe_ks, crpe_bs, proj_k, proj_b,
     l2s, l2b, w1, b1, dwk, dwb, ls, lb, w2, b2) = p
    return (dw(cpe_k), t(cpe_b), t(l1s), t(l1b), lin(qkv_k), t(qkv_b),
            [dw(k) for k in crpe_ks], [t(b) for b in crpe_bs], lin(proj_k),
            t(proj_b), t(l2s), t(l2b), lin(w1), t(b1), dw(dwk), t(dwb),
            t(ls), t(lb), lin(w2), t(b2))


def _jax_args(p):
    return tuple(tuple(map(jnp.asarray, a)) if isinstance(a, tuple)
                 else jnp.asarray(a) for a in p)


@pytest.mark.parametrize("B,s,C,hid", [(2, 8, 64, 256), (1, 6, 128, 512)])
def test_plain_matches_pallas_interpret_bf16(B, s, C, hid):
    x, p = _inputs(B, s, C, 8, hid)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(fused_mhca_block(
        xj, *_jax_args(p), s=s, heads=8, hidden=hid, window=WIN,
        interpret=True), np.float32)
    mirror = np.asarray(_reference_impl(xj, *_jax_args(p), s, 8, hid, WIN),
                        np.float32)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    got = mb.mhca_block(xt, *_torch_args(p), s=s, heads=8).float().numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 4 * 2.0 ** -8 * np.abs(want).max()

    def off(a, b):  # share of elements more than one ulp of b apart
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
        return (np.abs(a - b) > ulp).mean()

    assert off(got, want) <= off(want, mirror) + 0.02


@pytest.mark.parametrize("B,s,C,hid", [(2, 8, 64, 256), (1, 6, 128, 512),
                                       (2, 7, 64, 192)])
def test_plain_matches_jnp_mirror_fp32(B, s, C, hid):
    x, p = _inputs(B, s, C, 8, hid, seed=1)
    want = np.asarray(_reference_impl(jnp.asarray(x), *_jax_args(p), s, 8,
                                      hid, WIN))
    got = mb.mhca_block(torch.from_numpy(x), *_torch_args(p), s=s, heads=8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_cpu_dispatch_runs_plain_and_counts_nothing():
    x, p = _inputs(1, 4, 64, 8, 256)
    args = _torch_args(p)
    before = mb.launches
    out = mb.mhca_block(torch.from_numpy(x), *args, s=4, heads=8)
    assert mb.launches == before
    assert torch.equal(out, mb.mhca_block_plain(torch.from_numpy(x), *args,
                                                s=4, heads=8))


def _crpe(C, heads=8):
    d = C // heads
    return [torch.zeros(h * d, 1, w, w) for w, h in WIN]


@pytest.mark.parametrize("shape,s,heads,hid,crpe,dtype", [
    ((1, 64, 64), 8, 8, 256, _crpe(64), torch.float16),   # bf16/fp32
    ((1, 60, 64), 8, 8, 256, _crpe(64), torch.bfloat16),  # not an s*s map
    ((1, 64, 64), 8, 6, 256, _crpe(64), torch.bfloat16),  # C % heads
    ((1, 64, 64), 8, 8, 256, _crpe(64)[:2], torch.bfloat16),  # 3 windows
    ((1, 64, 64), 8, 8, 200, _crpe(64), torch.bfloat16),  # hidden % 64
])
def test_kernel_checks_raise(shape, s, heads, hid, crpe, dtype):
    with pytest.raises(ValueError):
        mb._check(torch.zeros(shape, dtype=dtype), s, heads, hid, crpe)
