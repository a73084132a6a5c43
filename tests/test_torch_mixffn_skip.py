"""Port kernel K9 (the unfolded MixFFN_skip, no caller's LN, no residual):
the plain PyTorch version against the Pallas kernel in interpret mode and
the jnp mirror, its gradients against jax.vjp of the mirror, the wrappers'
plain backwards (K1, K5-K9) and the no-fallback rule.

Tolerances: fp32 against the Pallas kernel 5e-5 relative and absolute (as
tests/test_mixffn_kernel.py:38); the mirror leaves the depthwise weight
fp32 where the kernel rounds it, so every test holds that weight exact in
bf16. bf16 against the mirror: one bf16 ulp of max|out| (the same
rounding points; the GELU's fp32 erf may differ in its last bit, which
can flip one rounding). Gradients: each leaf within 1e-4 of its own max
(fp32, another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transception_tpu.ops.pallas.mixffn import _reference_impl
from transception_tpu.ops.pallas.mixffn_kernel import fused_mixffn_skip
from transception_tpu_torch.ops import kernels
from transception_tpu_torch.ops.kernels import _build
from transception_tpu_torch.ops.kernels import bridge_attention as ba
from transception_tpu_torch.ops.kernels import etb_attention as ea
from transception_tpu_torch.ops.kernels import linear_attention as la
from transception_tpu_torch.ops.kernels import mhca_block as mb
from transception_tpu_torch.ops.kernels import mixffn as mf
from transception_tpu_torch.ops.kernels import patch_expand as pe


def _inputs(B, s, C, hid, seed=0):
    """x and the FFN's parameters in the flax layouts of the Pallas kernel
    (mixffn_kernel.py:285), the depthwise weight exact in bf16."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=0.3, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)

    dw = np.array(jnp.asarray(n(3, 3, hid), jnp.bfloat16)
                  .astype(jnp.float32))
    return n(B, s * s, C, scale=1.0), (
        n(C, hid, scale=C ** -0.5), n(hid, scale=0.1), dw,
        n(hid, scale=0.1), n(hid, scale=0.1, shift=1.0), n(hid, scale=0.1),
        n(hid, C, scale=hid ** -0.5), n(C, scale=0.1))


def _torch_params(p):
    """The same parameters in the port's torch layouts."""
    w1, b1, dw, dwb, ls, lb, w2, b2 = map(torch.from_numpy, p)
    return (w1.T.contiguous(), b1,
            dw.permute(2, 0, 1).unsqueeze(1).contiguous(), dwb, ls, lb,
            w2.T.contiguous(), b2)


def _torch_grads_as_flax(g):
    """Port-layout gradients of _torch_params back in the flax layouts."""
    gw1, gb1, gdw, gdwb, gls, glb, gw2, gb2 = (t.numpy() for t in g)
    return (gw1.T, gb1, gdw[:, 0].transpose(1, 2, 0), gdwb, gls, glb,
            gw2.T, gb2)


# (2, 8², 32): row tiles with a halo; (2, 14², 32): whole-map mode.
SHAPES = [(2, 8, 32, 128), (2, 14, 32, 128)]


@pytest.mark.parametrize("B,s,C,hid", SHAPES)
def test_plain_matches_pallas_interpret_fp32(B, s, C, hid):
    x, p = _inputs(B, s, C, hid)
    want = np.asarray(fused_mixffn_skip(
        jnp.asarray(x), *map(jnp.asarray, p), s=s, hidden=hid,
        interpret=True))
    got = mf.mixffn_skip(torch.from_numpy(x), *_torch_params(p), s=s)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("B,s,C,hid", SHAPES)
def test_plain_matches_jnp_mirror_bf16(B, s, C, hid):
    x, p = _inputs(B, s, C, hid, seed=1)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax.jit(_reference_impl, static_argnums=(9, 10, 11))(
        xj, *map(jnp.asarray, p), s, hid, 1e-5), np.float32)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    got = mf.mixffn_skip(xt, *_torch_params(p), s=s)
    assert got.dtype == torch.bfloat16
    top = np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert np.abs(got.float().numpy() - want).max() <= ulp


def _route_to_plain_launchers(monkeypatch):
    """Every wrapper takes its kernel branch on the CPU, with the kernel
    launch replaced by the plain version of the same arguments: the
    autograd Function and the wrapper's argument binding run as on the
    card."""
    monkeypatch.setattr(_build, "plain", lambda name, t: False)
    monkeypatch.setattr(mf, "_launch_skip", lambda *a: mf.mixffn_skip_plain(
        *a[:9], s=a[9], eps=a[10]))
    monkeypatch.setattr(ea, "_launch", ea.etb_attention_plain)
    monkeypatch.setattr(la, "_launch", la.linear_attention_plain)
    monkeypatch.setattr(pe, "_launch",
                        lambda x, w, ls, lb, p, c, eps, shuffle=None:
                        pe.patch_expand_plain(x, w, ls, lb, p=p, c=c,
                                              eps=eps, shuffle=shuffle))
    monkeypatch.setattr(ba, "_launch_folded", ba.bridge_attention_folded_plain)
    monkeypatch.setattr(mb, "_launch", mb.mhca_block_plain)


@pytest.mark.parametrize("B,s,C,hid", SHAPES)
def test_function_grads_match_jax_vjp(monkeypatch, B, s, C, hid):
    _route_to_plain_launchers(monkeypatch)
    x, p = _inputs(B, s, C, hid, seed=2)
    g = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    want = [np.asarray(t) for t in jax.jit(lambda g, *a: jax.vjp(
        lambda *a: _reference_impl(*a, s, hid, 1e-5), *a)[1](g))(
            jnp.asarray(g), jnp.asarray(x), *map(jnp.asarray, p))]
    leaves = [torch.from_numpy(x).requires_grad_()] + [
        t.requires_grad_() for t in _torch_params(p)]
    out = mf.mixffn_skip(*leaves, s=s)
    assert type(out.grad_fn).__name__ == "_PlainBackwardBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    got = [got[0].numpy()] + list(_torch_grads_as_flax(got[1:]))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


def _r(gen, *shape, scale=1.0, shift=0.0):
    return torch.randn(shape, generator=gen) * scale + shift


def _wrapper_cases(gen):
    """(wrapper, plain version) bound to small inputs, per kernel with a
    plain backward."""
    C, hid, s = 16, 64, 4
    N = s * s
    chs = [2 * h for _, h in ((3, 2), (5, 3), (7, 3))]
    mhca = ([_r(gen, 2, N, C), _r(gen, C, 1, 3, 3, scale=0.3),
             _r(gen, C, scale=0.1), _r(gen, C, scale=0.1, shift=1.0),
             _r(gen, C, scale=0.1), _r(gen, 3 * C, C, scale=C ** -0.5),
             _r(gen, 3 * C, scale=0.1)],
            [_r(gen, n, 1, k, k, scale=1 / k) for n, k in
             zip(chs, (3, 5, 7))], [_r(gen, n, scale=0.1) for n in chs],
            [_r(gen, C, C, scale=C ** -0.5), _r(gen, C, scale=0.1),
             _r(gen, C, scale=0.1, shift=1.0), _r(gen, C, scale=0.1),
             _r(gen, hid, C, scale=C ** -0.5), _r(gen, hid, scale=0.1),
             _r(gen, hid, 1, 3, 3, scale=0.3), _r(gen, hid, scale=0.1),
             _r(gen, hid, scale=0.1, shift=1.0), _r(gen, hid, scale=0.1),
             _r(gen, C, hid, scale=hid ** -0.5), _r(gen, C, scale=0.1)])
    nw = len(chs)

    def mhca_call(fn):
        def call(*a):
            return fn(*a[:7], list(a[7:7 + nw]), list(a[7 + nw:7 + 2 * nw]),
                      *a[7 + 2 * nw:], s=s, heads=8)
        return call

    ffn = [_r(gen, 2, N, C), _r(gen, hid, C, scale=C ** -0.5),
           _r(gen, hid, scale=0.1), _r(gen, hid, 1, 3, 3, scale=0.3),
           _r(gen, hid, scale=0.1), _r(gen, hid, scale=0.1, shift=1.0),
           _r(gen, hid, scale=0.1), _r(gen, C, hid, scale=hid ** -0.5),
           _r(gen, C, scale=0.1)]
    return {
        "etb_attention": (
            ea.etb_attention, ea.etb_attention_plain,
            [_r(gen, 2, 24, C), _r(gen, C, scale=0.1, shift=1.0),
             _r(gen, C, scale=0.1)] + [
                 _r(gen, *sh, scale=0.3) for _ in range(4)
                 for sh in ((C, C), (C,))]),
        "mhca_block": (mhca_call(mb.mhca_block),
                       mhca_call(mb.mhca_block_plain),
                       mhca[0] + mhca[1] + mhca[2] + mhca[3]),
        "linear_attention": (
            lambda q, k, v: la.linear_attention(q, k, v, False, 0.5),
            lambda q, k, v: la.linear_attention_plain(q, k, v, False, 0.5),
            [_r(gen, 2, 8, 9, 5) for _ in range(3)]),
        "patch_expand": (
            lambda *a: pe.patch_expand(*a, p=2, c=8),
            lambda *a: pe.patch_expand_plain(*a, p=2, c=8),
            [_r(gen, 2, 9, C), _r(gen, 32, C, scale=C ** -0.5),
             _r(gen, 8, scale=0.1, shift=1.0), _r(gen, 8, scale=0.1)]),
        "bridge_attention_folded": (
            lambda *a: ba.bridge_attention_folded(*a, 0.125),
            lambda *a: ba.bridge_attention_folded_plain(*a, 0.125),
            [_r(gen, 2, 20, C), _r(gen, 2, 20, C),
             _r(gen, C, C, scale=0.5), _r(gen, C, scale=0.1),
             _r(gen, 2, 1, 6, C), _r(gen, 2, 1, 6, C),
             _r(gen, C, C, scale=0.3), _r(gen, C, scale=0.1)]),
        "mixffn_skip": (lambda *a: mf.mixffn_skip(*a, s=s),
                        lambda *a: mf.mixffn_skip_plain(*a, s=s), ffn),
    }


@pytest.mark.parametrize("name", ["etb_attention", "mhca_block",
                                  "linear_attention", "patch_expand",
                                  "bridge_attention_folded", "mixffn_skip"])
def test_plain_backward_reaches_every_input(monkeypatch, name):
    """K1, K5, K6, K7, K8 and K9 are differentiated through their plain
    versions: on the kernel branch the result carries the Function's graph,
    and every input gets autograd's gradient of the plain version (a wrong
    save or argument order in a wrapper would show here; the card runs the
    same check against the kernels in chip_smoke.py phase 8)."""
    _route_to_plain_launchers(monkeypatch)
    wrapper, plain, args = _wrapper_cases(torch.Generator().manual_seed(0))[
        name]
    leaves = [a.requires_grad_() for a in args]
    out = wrapper(*leaves)
    assert type(out.grad_fn).__name__ == "_PlainBackwardBackward"
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad(out, leaves, g)
    want = torch.autograd.grad(plain(*leaves), leaves, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with torch.no_grad():  # no graph wanted: the launch alone
        assert wrapper(*leaves).grad_fn is None


def test_wrapper_raises_without_its_library(monkeypatch):
    """A tensor off the CPU with the K9 switch on goes to the kernel, and a
    library that cannot be loaded raises: no quiet plain version. (A meta
    tensor stands in for the card's; tests/test_torch_cuda.py holds the
    same on the card.)"""
    def missing(name):
        raise RuntimeError(f"kernel build failed: no library {name}")

    monkeypatch.setattr(_build, "load", missing)
    x, p = _inputs(1, 8, 32, 128)
    args = [torch.from_numpy(x).bfloat16()] + list(_torch_params(p))
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="no library mixffn"):
        mf.mixffn_skip(*(t.to("meta") for t in args), s=8)
    assert mf.skip_launches == 0
    assert kernels.routed_counts() == {"mixffn_skip": 1}
    with kernels.enabled(False):  # the switch off: the plain version
        assert mf.mixffn_skip(*args, s=8).shape == x.shape
