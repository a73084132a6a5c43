"""Port kernel K2 (MixFFN with folded LayerNorm and residual): the plain
PyTorch version against the Pallas kernel in interpret mode (bf16) and the
jnp mirror (fp32).

Tolerances: fp32 to float reassociation (1e-4 absolute on outputs of
order 1-10, 5e-5 relative); the mirror leaves the depthwise weight fp32
where the kernel rounds it, so the fp32 test holds the weight exact in
bf16. bf16: at most 2 bf16 ulps of the output scale, and under 2% of
elements off by more than one ulp of each element (rounding flips from
summation order; the plain GELU is exact erf where Pallas uses a
polynomial).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu.ops.pallas.mixffn import _reference_impl_ln
from transception_tpu.ops.pallas.mixffn_kernel import fused_mixffn_ln_skip
from transception_tpu_torch.ops.kernels import mixffn as mf


def _inputs(B, s, C, hid, seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=0.3):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    x = n(B, s * s, C, scale=1.0)
    lts, ltb = 1 + n(C, scale=0.1), n(C, scale=0.1)
    w1, b1 = n(C, hid, scale=C ** -0.5), n(hid, scale=0.1)
    dw = np.array(jnp.asarray(n(3, 3, hid), jnp.bfloat16)
                  .astype(jnp.float32))
    dwb = n(hid, scale=0.1)
    ls, lb = 1 + n(hid, scale=0.1), n(hid, scale=0.1)
    w2, b2 = n(hid, C, scale=hid ** -0.5), n(C, scale=0.1)
    return x, (lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2)


def _torch_params(p):
    lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2 = map(torch.from_numpy, p)
    return (lts, ltb, w1.T.contiguous(), b1,
            dw.permute(2, 0, 1).unsqueeze(1).contiguous(), dwb, ls, lb,
            w2.T.contiguous(), b2)


@pytest.mark.parametrize("s,C,hid", [(8, 64, 256), (14, 128, 512),
                                     (8, 320, 1280)])
def test_plain_matches_pallas_interpret_bf16(s, C, hid):
    x, p = _inputs(2, s, C, hid)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(fused_mixffn_ln_skip(
        xj, *map(jnp.asarray, p), s=s, hidden=hid, groups=1,
        interpret=True), np.float32)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    got = mf.mixffn_ln_skip(xt, *_torch_params(p), s=s).float().numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 2 * 2.0 ** -8 * np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (diff > ulp).mean() < 0.02


@pytest.mark.parametrize("s,C,hid,groups", [(8, 64, 256, 1),
                                            (14, 128, 512, 1),
                                            (8, 128, 512, 2)])
def test_plain_matches_jnp_mirror_fp32(s, C, hid, groups):
    x, p = _inputs(2, s, C, hid, seed=1)
    lts, ltb = p[0][:C // groups], p[1][:C // groups]
    tiled = (np.tile(lts, groups), np.tile(ltb, groups)) + p[2:]
    want = np.asarray(_reference_impl_ln(
        jnp.asarray(x), *map(jnp.asarray, tiled), s, hid, groups, 1e-5,
        1e-5))
    tp = _torch_params(p)
    got = mf.mixffn_ln_skip(torch.from_numpy(x), torch.from_numpy(lts),
                            torch.from_numpy(ltb), *tp[2:], s=s,
                            groups=groups)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5, atol=1e-4)


def test_cpu_dispatch_runs_plain_and_counts_nothing():
    x, p = _inputs(1, 8, 64, 256)
    before = mf.launches
    mf.mixffn_ln_skip(torch.from_numpy(x), *_torch_params(p), s=8)
    assert mf.launches == before


@pytest.mark.parametrize("shape,s,hid,groups,dtype", [
    ((1, 64, 64), 8, 256, 1, torch.float16),    # bf16 only
    ((1, 60, 64), 8, 256, 1, torch.bfloat16),   # not an s*s map
    ((1, 64, 64), 8, 256, 3, torch.bfloat16),   # groups must divide C
    ((1, 64, 64), 8, 200, 1, torch.bfloat16),   # hidden % 64
    ((1, 4096, 64), 64, 2048, 1, torch.bfloat16),  # row over smem
])
def test_kernel_checks_raise(shape, s, hid, groups, dtype):
    with pytest.raises(ValueError):
        mf._check(torch.zeros(shape, dtype=dtype), s, hid, groups)
