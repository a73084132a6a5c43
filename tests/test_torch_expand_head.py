"""Port kernel K4 (x4 expand + grouped LN + head + argmax): the plain
PyTorch version against the Pallas kernel in interpret mode (bf16) and
against the decoder's conv + argmax branch (models/decoder.py:192-201,
fp32).

Tolerances: fp32 class ids must match apart from pixels whose top two
reference logits lie within 1e-4. bf16: the logits are rounded to bf16
before the argmax, so a near-tie can flip with summation order; at most
0.2% of the ids may differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu.models.decoder import DecoderLayer as JDecoderLayer
from transception_tpu.ops.pallas.expand_kernel import (
    fused_patch_expand_argmax,
)
from transception_tpu_torch.models.decoder import DecoderLayer
from transception_tpu_torch.ops.kernels import expand_head as eh
from transception_tpu_torch.convert.from_jax import load_jax_variables


def _inputs(H, c, ncls, seed=0):
    rng = np.random.default_rng(seed)
    p = 4
    x = rng.normal(size=(2, H * H, c)).astype(np.float32)
    w = (rng.normal(size=(c, p * p * c)) * c ** -0.5).astype(np.float32)
    ls = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    lb = (0.1 * rng.normal(size=c)).astype(np.float32)
    hw = (rng.normal(size=(c, ncls)) * c ** -0.5).astype(np.float32)
    hb = (0.1 * rng.normal(size=ncls)).astype(np.float32)
    return x, w, ls, lb, hw, hb


def _near_tie(logits, tol):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) <= tol


@pytest.mark.parametrize("H,ncls", [(8, 9), (8, 2), (14, 9)])
def test_plain_matches_pallas_interpret_bf16(H, ncls):
    c = 64
    x, w, ls, lb, hw, hb = _inputs(H, c, ncls)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(fused_patch_expand_argmax(
        xj, *map(jnp.asarray, (w, ls, lb, hw, hb)), H=H, W=H, p=4, c=c,
        n_class=ncls, interpret=True))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    got = eh.expand_head(xt, torch.from_numpy(w.T.copy()),
                         torch.from_numpy(ls), torch.from_numpy(lb),
                         torch.from_numpy(hw.T.copy()),
                         torch.from_numpy(hb), p=4, c=c).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert (got != want).mean() <= 0.002


def test_plain_matches_conv_argmax_branch_fp32():
    """The plain version on fp32 inputs against the JAX decoder's fp32
    conv + argmax head branch (argmax_head with use_pallas off)."""
    H, C, out_dim, ncls = 8, 64, 32, 9
    rng = np.random.default_rng(3)
    x1 = rng.normal(size=(2, H * H, C - out_dim)).astype(np.float32)
    x2 = rng.normal(size=(2, H, H, out_dim)).astype(np.float32)
    jm = JDecoderLayer(C // 4, out_dim, n_class=ncls, is_last=True,
                       dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(0), x1, x2)
    v = jax.tree_util.tree_map(np.asarray, v)
    want = np.asarray(jm.apply(v, x1, x2, argmax_head=True))
    logits = np.asarray(jm.apply(v, x1, x2))
    pm = DecoderLayer(C // 4, out_dim, ncls, is_last=True,
                      dtype=torch.float32)
    load_jax_variables(pm, v, device="cpu")
    with torch.no_grad():
        got = pm(torch.from_numpy(x1), torch.from_numpy(x2),
                 argmax_head=True).numpy()
        # The bf16 fused-head route on the same weights and fp32 inputs.
        up, hl = pm.layer_up, pm.last_layer
        t = pm.layer_former_2(pm.layer_former_1(pm.concat_linear(
            torch.cat([torch.from_numpy(x1),
                       torch.from_numpy(x2).reshape(2, H * H, -1)], -1)),
            H, H), H, H)
        ids = eh.expand_head(t, up.expand.weight, up.norm.weight,
                             up.norm.bias, hl.weight.reshape(ncls, -1),
                             hl.bias, p=4, c=out_dim)
    ok = ~_near_tie(logits, 1e-4)
    np.testing.assert_array_equal(got[ok], want[ok])
    cls = ids.reshape(2, H, H, 4, 4).permute(0, 1, 3, 2, 4).reshape(
        2, 4 * H, 4 * H).numpy()
    np.testing.assert_array_equal(cls[ok], want[ok])


def test_cpu_dispatch_runs_plain_and_counts_nothing():
    x, w, ls, lb, hw, hb = _inputs(4, 64, 9)
    before = eh.launches
    eh.expand_head(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                   torch.from_numpy(ls), torch.from_numpy(lb),
                   torch.from_numpy(hw.T.copy()), torch.from_numpy(hb),
                   p=4, c=64)
    assert eh.launches == before


@pytest.mark.parametrize("C,c,w_shape,ncls,dtype", [
    (64, 64, (1024, 64), 9, torch.float32),    # bf16 only
    (72, 64, (1024, 72), 9, torch.bfloat16),   # C % 16
    (64, 64, (512, 64), 9, torch.bfloat16),    # w not (p²c, C)
    (64, 64, (1024, 64), 20, torch.bfloat16),  # more than 16 classes
])
def test_kernel_checks_raise(C, c, w_shape, ncls, dtype):
    x = torch.zeros((1, 16, C), dtype=dtype)
    with pytest.raises(ValueError):
        eh._check(x, torch.zeros(w_shape), torch.zeros(ncls, c), 4, c)
