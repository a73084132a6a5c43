"""Port kernel K7 (patch expand + grouped LayerNorm, pre-shuffle): the
plain PyTorch version against the Pallas kernel in interpret mode (bf16)
and its XLA mirror (fp32).

Tolerances: fp32 to float reassociation (2e-5 relative and absolute). In
bf16 both sides round the expansion and the output at the same points: at
most 2 bf16 ulps of the output scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu.ops.pallas.expand_kernel import fused_patch_expand
from transception_tpu.ops.pallas.patch_expand import _reference_pre_shuffle
from transception_tpu_torch.ops.kernels import patch_expand as pe

# (H, C, p, c): decoders 3/2/1 (p = 2, narrowed maps) and the x4 expander.
SHAPES = [(4, 512, 2, 256), (14, 320, 2, 160), (8, 128, 2, 64),
          (8, 64, 4, 64)]


def _inputs(H, C, p, c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, H * H, C)).astype(np.float32)
    w = (rng.normal(size=(C, p * p * c)) * C ** -0.5).astype(np.float32)
    ls = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    lb = (0.1 * rng.normal(size=c)).astype(np.float32)
    return x, w, ls, lb


def _torch_args(w, ls, lb):
    return (torch.from_numpy(np.ascontiguousarray(w.T)),
            torch.from_numpy(ls), torch.from_numpy(lb))


@pytest.mark.parametrize("H,C,p,c", SHAPES)
def test_plain_matches_pallas_interpret_bf16(H, C, p, c):
    x, w, ls, lb = _inputs(H, C, p, c)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(fused_patch_expand(
        xj, jnp.asarray(w), jnp.asarray(ls), jnp.asarray(lb), H=H, W=H, p=p,
        c=c, interpret=True), np.float32)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    got = pe.patch_expand(xt, *_torch_args(w, ls, lb), p=p, c=c)
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() <= 2 * 2.0 ** -8 * np.abs(want).max()


@pytest.mark.parametrize("H,C,p,c", SHAPES)
def test_plain_matches_xla_mirror_fp32(H, C, p, c):
    x, w, ls, lb = _inputs(H, C, p, c, seed=1)
    want = np.asarray(_reference_pre_shuffle(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(ls), jnp.asarray(lb), p,
        c, 1e-5))
    got = pe.patch_expand(torch.from_numpy(x), *_torch_args(w, ls, lb), p=p,
                          c=c)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_cpu_dispatch_runs_plain_and_counts_nothing():
    x, w, ls, lb = _inputs(4, 128, 2, 64)
    args = _torch_args(w, ls, lb)
    before = pe.launches
    out = pe.patch_expand(torch.from_numpy(x), *args, p=2, c=64)
    assert pe.launches == before
    assert torch.equal(out, pe.patch_expand_plain(torch.from_numpy(x), *args,
                                                  p=2, c=64))


@pytest.mark.parametrize("shape,wshape,c,dtype", [
    ((1, 16, 128), (256, 128), 64, torch.float16),   # bf16/fp32
    ((1, 16, 120), (240, 120), 60, torch.bfloat16),  # C, c % 16
    ((1, 16, 128), (128, 128), 64, torch.bfloat16),  # w not (p²c, C)
    ((16, 128), (256, 128), 64, torch.bfloat16),     # not (B, N, C)
])
def test_kernel_checks_raise(shape, wshape, c, dtype):
    with pytest.raises(ValueError):
        pe._check(torch.zeros(shape, dtype=dtype), torch.zeros(wshape), 2, c)
