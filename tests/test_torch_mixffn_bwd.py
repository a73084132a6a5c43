"""Port kernel K11 (MixFFN backward) and K2's grouped LN: the plain PyTorch
backward against the Pallas backward in interpret mode
(fused_mixffn_ln_skip_bwd), the autograd Function on the CPU against
autograd through the plain forward, and the grouped plain forward against
the Pallas forward (fused_mixffn_ln_skip) in interpret mode.

Tolerances: fp32 rtol/atol 2e-4 on every gradient, the Pallas backward
test's own (tests/test_mixffn_kernel.py:318-320): the same fp32 chain in
another summation order (and exact erf where Pallas has a 1.5e-7
polynomial). bf16: each gradient within 2% of its own max, as on the card:
both round h, d, the LN output and the GELU output to bf16, and a rounding
flipped by summation order moves the chain by one bf16 ulp. The bf16 case
holds the depthwise weight exact in bf16 so that neither side's rounding
of the fp32 parameter (mixffn_kernel.py:333, :735) enters the comparison.
The grouped forward: fp32 to 5e-5 relative / 1e-4 absolute, as K2's
test (tests/test_torch_mixffn.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu.ops.pallas.mixffn_kernel import (
    fused_mixffn_ln_skip,
    fused_mixffn_ln_skip_bwd,
)
from transception_tpu_torch.ops.kernels import mixffn as mf


def _inputs(B, s, C, hid, groups, seed=0, edge_g=False):
    """JAX-layout numpy inputs: x, g, then (lts, ltb) tiled to C, w1
    (C, hid), b1, dw (3, 3, hid), dwb, ls, lb, w2 (hid, C), b2."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=0.3):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    x, g = n(B, s * s, C, scale=1.0), n(B, s * s, C, scale=1.0)
    if edge_g:  # cotangent only on the map border
        g = np.zeros_like(g)
        gm = g.reshape(B, s, s, C)
        gm[:, 0], gm[:, -1], gm[:, :, 0], gm[:, :, -1] = 1.0, -1.0, 0.5, -0.5
    lts, ltb = 1 + n(C // groups, scale=0.1), n(C // groups, scale=0.1)
    dw = np.array(jnp.asarray(n(3, 3, hid), jnp.bfloat16).astype(
        jnp.float32))
    p = (np.tile(lts, groups), np.tile(ltb, groups), n(C, hid, scale=C ** -.5),
         n(hid, scale=0.1), dw, n(hid, scale=0.1), 1 + n(hid, scale=0.1),
         n(hid, scale=0.1), n(hid, C, scale=hid ** -0.5), n(C, scale=0.1))
    return x, g, p


def _port(p):
    """JAX layouts -> the port's: w1 (hid, C), dw (hid, 1, 3, 3), w2 (C,
    hid)."""
    lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2 = map(torch.from_numpy, p)
    return (lts, ltb, w1.T.contiguous(), b1,
            dw.permute(2, 0, 1).unsqueeze(1).contiguous(), dwb, ls, lb,
            w2.T.contiguous(), b2)


def _jax_layout(grads):
    """The port's gradients in the Pallas kernel's layouts."""
    dx, dlts, dltb, dw1, db1, ddw, ddwb, dls, dlb, dw2, db2 = (
        t.float().numpy() for t in grads)
    return (dx, dlts, dltb, dw1.T, db1, ddw[:, 0].transpose(1, 2, 0), ddwb,
            dls, dlb, dw2.T, db2)


NAMES = ("dx", "dlts", "dltb", "dw1", "db1", "ddw", "ddwb", "dls", "dlb",
         "dw2", "db2")


def _pallas_bwd(x, g, p, s, groups, dtype=jnp.float32):
    return fused_mixffn_ln_skip_bwd(
        jnp.asarray(x, dtype), *map(jnp.asarray, p), jnp.asarray(g, dtype),
        s=s, hidden=p[3].shape[0], groups=groups, interpret=True)


@pytest.mark.parametrize("s,C,hid,groups", [
    (8, 64, 256, 1), (16, 64, 256, 2), (14, 128, 384, 1), (8, 320, 1280, 5)])
def test_plain_bwd_matches_pallas_interpret_fp32(s, C, hid, groups):
    x, g, p = _inputs(2, s, C, hid, groups)
    got = _jax_layout(mf.mixffn_ln_skip_bwd_plain(
        torch.from_numpy(x), *_port(p), torch.from_numpy(g), s=s,
        groups=groups))
    want = _pallas_bwd(x, g, p, s, groups)
    for n, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4, atol=2e-4,
                                   err_msg=n)


def test_plain_bwd_edge_energy():
    """Cotangent only on the border: the halo rows and the conv
    transpose's zero padding (tests/test_mixffn_kernel.py:324-349)."""
    s, C, hid = 16, 64, 256
    x, g, p = _inputs(1, s, C, hid, 1, seed=2, edge_g=True)
    got = _jax_layout(mf.mixffn_ln_skip_bwd_plain(
        torch.from_numpy(x), *_port(p), torch.from_numpy(g), s=s))
    for n, a, b in zip(NAMES, got, _pallas_bwd(x, g, p, s, 1)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4, atol=2e-4,
                                   err_msg=n)


def test_plain_bwd_matches_pallas_interpret_bf16():
    s, C, hid, groups = 8, 128, 512, 2
    x, g, p = _inputs(2, s, C, hid, groups, seed=3)
    xb, gb = (jnp.asarray(a, jnp.bfloat16) for a in (x, g))
    xt, gt = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
              for a in (xb, gb))
    got = _jax_layout(mf.mixffn_ln_skip_bwd_plain(xt, *_port(p), gt, s=s,
                                                  groups=groups))
    want = _pallas_bwd(x, g, p, s, groups, jnp.bfloat16)
    for n, a, b in zip(NAMES, got, want):
        b = np.asarray(b, np.float32)
        assert np.abs(a - b).max() <= 0.02 * np.abs(b).max(), n


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    x, g, p = _inputs(1, 8, 64, 256, 1, seed=4)
    n0 = mf.bwd_launches
    args = (torch.from_numpy(x),) + _port(p) + (torch.from_numpy(g),)
    got = mf.mixffn_ln_skip_bwd(*args, s=8)
    assert mf.bwd_launches == n0
    for a, b in zip(got, mf.mixffn_ln_skip_bwd_plain(*args, s=8)):
        assert torch.equal(a, b)


def test_function_matches_autograd_of_plain_forward():
    """The Function on the CPU (plain forward, plain backward) against
    autograd through the plain forward, groups 2: the tiled LN vectors'
    gradients sum back into the caller's C/groups entries."""
    s, C, hid, groups = 8, 128, 512, 2
    x, g, p = _inputs(2, s, C, hid, groups, seed=5)
    pt = _port(p)
    leaves = [torch.from_numpy(x).requires_grad_()] + [
        (t[:C // groups] if i < 2 else t).clone().requires_grad_()
        for i, t in enumerate(pt)]
    lts, ltb = (t.repeat(groups) for t in leaves[1:3])
    out = mf.MixFFN.apply(leaves[0], lts, ltb, *leaves[3:], s, groups, 1e-5,
                          1e-5)
    gt = torch.from_numpy(g)
    out.backward(gt)
    want = torch.autograd.grad(
        mf.mixffn_ln_skip_plain(*leaves, s=s, groups=groups), leaves, gt)
    for t, w in zip(leaves, want):
        torch.testing.assert_close(t.grad, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("s,C,hid,groups", [(16, 128, 512, 2),
                                            (8, 320, 1280, 5)])
def test_grouped_forward_matches_pallas_interpret(s, C, hid, groups):
    x, _, p = _inputs(2, s, C, hid, groups, seed=6)
    want = fused_mixffn_ln_skip(jnp.asarray(x), *map(jnp.asarray, p), s=s,
                                hidden=hid, groups=groups, interpret=True)
    pt = _port(p)
    got = mf.mixffn_ln_skip(torch.from_numpy(x), pt[0][:C // groups],
                            pt[1][:C // groups], *pt[2:], s=s, groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=1e-4)


def _folded_route(monkeypatch, s, C, hid, training):
    """Which function MixFFNSkip.folded calls on a (1, s², C) map: the
    kernel wrapper or the plain version."""
    from transception_tpu_torch.ops.common import LayerNorm, MixFFNSkip
    calls = []
    for name in ("mixffn_ln_skip", "mixffn_ln_skip_plain"):
        monkeypatch.setattr(mf, name, lambda x, *a, _n=name, **k:
                            calls.append(_n) or x)
    ffn = MixFFNSkip(C, hid, dtype=torch.float32).train(training)
    ffn.folded(torch.zeros(1, s * s, C), s, LayerNorm(C, dtype=torch.float32))
    return calls


@pytest.mark.parametrize("s,C,hid,ok", [
    (56, 64, 256, True), (28, 128, 512, True), (14, 320, 1280, True),
    (28, 64, 256, True), (14, 128, 512, True),
    (7, 320, 1280, False),   # odd side: plain, as on the TPU
    (7, 512, 2048, False)])  # bridge scale 4
def test_takes_the_train_shapes(monkeypatch, s, C, hid, ok):
    """In training the folds of the train step go through the kernel
    wrapper, the odd-sided (7x7) ones through the plain version."""
    want = "mixffn_ln_skip" if ok else "mixffn_ln_skip_plain"
    assert _folded_route(monkeypatch, s, C, hid, True) == [want]


@pytest.mark.parametrize("s,C,hid", [(56, 64, 256), (7, 512, 2048)])
def test_eval_folds_always_take_the_wrapper(monkeypatch, s, C, hid):
    """Out of training the folds route as in training, by shape before
    the call: the kernel wrapper (which raises on a card tensor its kernel
    cannot take: no fallback after a failure) on an even-sided map, the
    plain version on the 7x7 bridge scale 4, where the JAX package runs
    XLA in eval too."""
    want = "mixffn_ln_skip" if s % 2 == 0 else "mixffn_ln_skip_plain"
    assert _folded_route(monkeypatch, s, C, hid, False) == [want]


def test_k11_wrapper_refuses_rows_over_shared_memory():
    """K11's shared-memory limit is checked by its own launch, never by a
    forward's routing. K11's stages hold no map rows, so a (56², 128) map
    is taken; what it refuses is a hidden width whose rows-kernel token
    tile (y and dz of 8 tokens over the whole width) exceeds shared memory,
    here hidden 4096, where every block of K2's forward stages fits."""
    assert mf.bwd_smem_bytes(128, 256) <= mf.SMEM_LIMIT
    s, C, hid = 2, 64, 4096
    assert mf.fwd_smem_bytes(s, C, hid) <= mf.SMEM_LIMIT
    assert max(mf.fwd_plan(1, s, C, hid, 132)["smem"].values()) <= \
        mf.SMEM_LIMIT
    assert mf.bwd_smem_bytes(C, hid) > mf.SMEM_LIMIT
    x = torch.zeros(1, s * s, C, dtype=torch.bfloat16)
    p = [torch.zeros(n) for n in (C, C)] + [torch.zeros(hid, C)] + [
        torch.zeros(hid), torch.zeros(hid, 1, 3, 3)] + [
        torch.zeros(hid)] * 3 + [torch.zeros(C, hid), torch.zeros(C)]
    with pytest.raises(ValueError, match="mixffn_bwd kernel: a token tile"):
        mf._launch_bwd(x, *p, x, s, 1, 1e-5, 1e-5)
