"""The port's CUDA kernels on the card (marker `cuda`; each test skips
without a CUDA device). Run on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py sets up JAX, which the GPU machine does
not need.)
Each kernel is held against its plain PyTorch version at small shapes
that exercise ragged tiles, in bf16: at most 2% of max|plain| and at
most 0.1% of ids (K4), as chip_smoke.py does at full size. Kernels that
add their input back are held on the branch alone (output minus input).
The backward kernels (K10, K11) are held per gradient, each within 2% of
its own max: they round their tensor-core operands to bf16 (as the
forwards do) and sum their per-block partials in another order than the
plain versions.
"""

import pytest
import torch

from transception_tpu_torch.ops.kernels import (
    bridge_attention as ba,
    etb_attention as ea,
    expand_head as eh,
    linear_attention as la,
    mhca_block as mb,
    mixffn as mf,
    patch_expand as pe,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator().manual_seed(0)


def _r(gen, *shape, scale=1.0, shift=0.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen) * scale + shift).to(
        "cuda", dtype)


def _close(got, want, rel=0.02, base=None):
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if base is not None:
        got, want = got - base.float(), want - base.float()
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item()


@pytest.mark.parametrize("B,N,C", [(2, 200, 64), (1, 196, 320)])
def test_etb_attention_kernel(gen, B, N, C):
    x = _r(gen, B, N, C, scale=0.25, dtype=torch.bfloat16)
    args = [_r(gen, C, scale=0.1, shift=1.0), _r(gen, C, scale=0.1)]
    for f in (2, 4, 2, 2):  # peaked softmaxes: the branch is of order x
        args += [_r(gen, C, C, scale=f * C ** -0.5), _r(gen, C, scale=0.02)]
    n0 = ea.launches
    _close(ea.etb_attention(x, *args), ea.etb_attention_plain(x, *args),
           base=x)
    assert ea.launches == n0 + 1


@pytest.mark.parametrize("s,C", [(8, 64), (7, 128), (14, 320)])
def test_mixffn_kernel(gen, s, C):
    hid = 4 * C
    x = _r(gen, 2, s * s, C, dtype=torch.bfloat16)
    args = (x, _r(gen, C, scale=0.1, shift=1.0), _r(gen, C, scale=0.1),
            _r(gen, hid, C, scale=C ** -0.5), _r(gen, hid, scale=0.02),
            _r(gen, hid, 1, 3, 3, scale=0.3), _r(gen, hid, scale=0.02),
            _r(gen, hid, scale=0.1, shift=1.0), _r(gen, hid, scale=0.1),
            _r(gen, C, hid, scale=hid ** -0.5), _r(gen, C, scale=0.02))
    _close(mf.mixffn_ln_skip(*args, s=s), mf.mixffn_ln_skip_plain(*args, s=s),
           base=x)


@pytest.mark.parametrize("N,M", [(124, 16), (6076, 784)])
def test_bridge_attention_kernel(gen, N, M):
    q = _r(gen, 2, 1, N, 64, dtype=torch.bfloat16)
    k = _r(gen, 2, 1, M, 64, dtype=torch.bfloat16)
    v = _r(gen, 2, 1, M, 64, dtype=torch.bfloat16)
    _close(ba.bridge_attention(q, k, v, 0.125),
           ba.bridge_attention_plain(q, k, v, 0.125))


def test_expand_head_kernel(gen):
    x = _r(gen, 2, 200, 64, dtype=torch.bfloat16)
    args = (x, _r(gen, 1024, 64, scale=0.125), _r(gen, 64, scale=0.1,
                                                   shift=1.0),
            _r(gen, 64, scale=0.1), _r(gen, 9, 64, scale=0.125),
            _r(gen, 9, scale=0.02))
    got = eh.expand_head(*args, p=4, c=64)
    want = eh.expand_head_plain(*args, p=4, c=64)
    assert got.dtype == torch.uint8 and got.shape == (2, 200, 16)
    assert (got != want).float().mean().item() <= 1e-3


@pytest.mark.parametrize("B,s,C,hid", [(2, 8, 64, 256), (3, 7, 128, 512),
                                        (1, 14, 128, 512)])
def test_mhca_block_kernel(gen, B, s, C, hid):
    chs = [h * C // 8 for h in (2, 3, 3)]
    x = _r(gen, B, s * s, C, scale=0.5, dtype=torch.bfloat16)
    args = (x, _r(gen, C, 1, 3, 3, scale=0.3), _r(gen, C, scale=0.02),
            _r(gen, C, scale=0.1, shift=1.0), _r(gen, C, scale=0.1),
            _r(gen, 3 * C, C, scale=3 * C ** -0.5), _r(gen, 3 * C, scale=0.02),
            [_r(gen, n, 1, k, k, scale=1.0 / k)
             for n, k in zip(chs, (3, 5, 7))],
            [_r(gen, n, scale=0.02) for n in chs],
            _r(gen, C, C, scale=C ** -0.5), _r(gen, C, scale=0.02),
            _r(gen, C, scale=0.1, shift=1.0), _r(gen, C, scale=0.1),
            _r(gen, hid, C, scale=C ** -0.5), _r(gen, hid, scale=0.02),
            _r(gen, hid, 1, 3, 3, scale=0.3), _r(gen, hid, scale=0.02),
            _r(gen, hid, scale=0.1, shift=1.0), _r(gen, hid, scale=0.1),
            _r(gen, C, hid, scale=hid ** -0.5), _r(gen, C, scale=0.02))
    n0 = mb.launches
    _close(mb.mhca_block(*args, s=s, heads=8),
           mb.mhca_block_plain(*args, s=s, heads=8), base=x)
    assert mb.launches == n0 + 1


@pytest.mark.parametrize("shape,q_softmax", [((2, 8, 49, 40), False),
                                             ((1, 2, 100, 64), True)])
def test_linear_attention_kernel(gen, shape, q_softmax):
    q, k, v = (_r(gen, *shape, scale=f, dtype=torch.bfloat16)
               for f in (1.0, 3.0, 1.0))
    _close(la.linear_attention(q, k, v, q_softmax),
           la.linear_attention_plain(q, k, v, q_softmax))


@pytest.mark.parametrize("N,C,p", [(49, 512, 2), (50, 128, 2), (20, 64, 4)])
def test_patch_expand_kernel(gen, N, C, p):
    c = C // 2 if p == 2 else C
    args = (_r(gen, 2, N, C, dtype=torch.bfloat16),
            _r(gen, p * p * c, C, scale=C ** -0.5),
            _r(gen, c, scale=0.1, shift=1.0), _r(gen, c, scale=0.1))
    _close(pe.patch_expand(*args, p=p, c=c),
           pe.patch_expand_plain(*args, p=p, c=c))


def test_kernels_off_run_plain_on_the_card(gen):
    from transception_tpu_torch.ops import kernels
    q = _r(gen, 1, 2, 16, 64, dtype=torch.bfloat16)
    n0 = la.launches
    with kernels.enabled(False):
        out = la.linear_attention(q, q, q)
    assert la.launches == n0
    assert torch.equal(out, la.linear_attention_plain(q, q, q))


def test_kernels_raise_instead_of_falling_back(gen):
    x = _r(gen, 1, 64, 64)  # fp32 on the card: no kernel takes it
    w = torch.zeros(64, 64, device="cuda")
    v = torch.zeros(64, device="cuda")
    with pytest.raises(ValueError):
        ea.etb_attention(x, v, v, w, v, w, v, w, v, w, v)
    with pytest.raises(ValueError):
        ba.bridge_attention(x[None], x[None], x[None], 0.125)


def test_tiny_model_uses_every_kernel(gen):
    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.models.transception import MSTransception
    from transception_tpu_torch.ops import kernels
    cfg = TransceptionConfig(img_size=32, stage1_layers=1,
                             num_path=(1, 1, 1), num_layers=(1, 1, 1))
    m = MSTransception(cfg, device="cuda")
    kernels.reset_launches()
    with torch.inference_mode():
        ids = m(_r(gen, 2, 32, 32, 1), argmax=True)
    torch.cuda.synchronize()
    assert ids.shape == (2, 32, 32) and ids.dtype == torch.uint8
    # img 32: MHCA maps 4², 2², 1²; even sides take the whole-block
    # kernel, the 1² stage its modules with the linear-attention kernel.
    assert kernels.launch_counts() == {"etb_attention": 7, "mixffn": 7,
                                       "bridge_attention": 3,
                                       "expand_head": 1, "mhca_block": 2,
                                       "linear_attention": 1,
                                       "patch_expand": 3,
                                       "bridge_attention_bwd": 0,
                                       "mixffn_bwd": 0}


@pytest.mark.parametrize("N,M", [(124, 16), (300, 128), (6076, 784)])
def test_bridge_attention_bwd_kernel(gen, N, M):
    q, k, v, g = (_r(gen, 2, 1, n, 64, dtype=torch.bfloat16)
                  for n in (N, M, M, N))
    n0 = ba.bwd_launches
    got = ba.bridge_attention_bwd(q, k, v, g, 0.125)
    want = ba.bridge_attention_bwd_plain(q, k, v, g, 0.125)
    assert ba.bwd_launches == n0 + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.bfloat16
        _close(a, b)


def _ffn_args(gen, B, s, C, hid, groups):
    x = _r(gen, B, s * s, C, dtype=torch.bfloat16)
    gsz = C // groups
    return x, (_r(gen, gsz, scale=0.1, shift=1.0).repeat(groups),
               _r(gen, gsz, scale=0.1).repeat(groups),
               _r(gen, hid, C, scale=C ** -0.5), _r(gen, hid, scale=0.02),
               _r(gen, hid, 1, 3, 3, scale=0.3), _r(gen, hid, scale=0.02),
               _r(gen, hid, scale=0.1, shift=1.0), _r(gen, hid, scale=0.1),
               _r(gen, C, hid, scale=hid ** -0.5), _r(gen, C, scale=0.02))


@pytest.mark.parametrize("s,C,hid,groups,eps_ln", [
    (8, 64, 256, 1, 1e-5), (6, 128, 512, 1, 1e-6), (14, 128, 512, 2, 1e-5),
    (14, 320, 1280, 5, 1e-5), (28, 64, 256, 1, 1e-6)])
def test_mixffn_bwd_kernel(gen, s, C, hid, groups, eps_ln):
    x, p = _ffn_args(gen, 3, s, C, hid, groups)
    g = _r(gen, *x.shape, dtype=torch.bfloat16)
    n0 = mf.bwd_launches
    got = mf.mixffn_ln_skip_bwd(x, *p, g, s=s, groups=groups, eps_ln=eps_ln)
    want = mf.mixffn_ln_skip_bwd_plain(x, *p, g, s=s, groups=groups,
                                       eps_ln=eps_ln)
    assert mf.bwd_launches == n0 + 1
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        _close(a, b)


@pytest.mark.parametrize("s,C,hid,groups", [(28, 128, 512, 2),
                                            (14, 320, 1280, 5)])
def test_mixffn_kernel_grouped(gen, s, C, hid, groups):
    x, p = _ffn_args(gen, 2, s, C, hid, groups)
    args = (x, p[0][:C // groups], p[1][:C // groups]) + p[2:]
    _close(mf.mixffn_ln_skip(*args, s=s, groups=groups),
           mf.mixffn_ln_skip_plain(*args, s=s, groups=groups), base=x)


def test_autograd_functions_reach_every_input(gen):
    """The kernels with a backward keep the graph: every input gets the
    plain version's gradient (the guard against a cut graph)."""
    q, k, v = (_r(gen, 1, 1, n, 64, dtype=torch.bfloat16).requires_grad_()
               for n in (200, 32, 32))
    (ba.bridge_attention(q, k, v, 0.125).float() ** 2).sum().backward()
    want = torch.autograd.grad(
        (ba.bridge_attention_plain(q, k, v, 0.125).float() ** 2).sum(),
        (q, k, v))
    for t, w in zip((q, k, v), want):
        _close(t.grad, w)
    x, p = _ffn_args(gen, 2, 8, 128, 512, 2)
    leaves = [x.requires_grad_()] + [t[:64].clone().requires_grad_()
                                     if i < 2 else t.requires_grad_()
                                     for i, t in enumerate(p)]
    out = mf.mixffn_ln_skip(*leaves, s=8, groups=2)
    (out.float() ** 2).sum().backward()
    want = torch.autograd.grad(
        (mf.mixffn_ln_skip_plain(*leaves, s=8, groups=2).float() ** 2).sum(),
        leaves)
    for t, w in zip(leaves, want):
        assert t.grad is not None
        _close(t.grad, w)


def test_forward_only_kernels_refuse_a_graph(gen):
    x = _r(gen, 1, 64, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 64, device="cuda", requires_grad=True)
    v = torch.zeros(64, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        ea.etb_attention(x, v, v, w, v, w, v, w, v, w, v)
    with torch.no_grad():
        ea.etb_attention(x, v, v, w, v, w, v, w, v, w, v)


def test_tiny_model_train_step_kernels(gen):
    """Train mode runs only the kernels with a backward: the bridge
    attention, and the MixFFN folds with ffn_flash_train."""
    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.models.transception import MSTransception
    from transception_tpu_torch.ops import kernels
    for flash in (False, True):
        cfg = TransceptionConfig(img_size=64, stage1_layers=1,
                                 num_path=(1, 1, 1), num_layers=(1, 1, 1),
                                 ffn_flash_train=flash)
        m = MSTransception(cfg, device="cuda").train()
        kernels.reset_launches()
        out = m(_r(gen, 2, 64, 64, 1), wide_head=True)
        out.float().square().mean().backward()
        torch.cuda.synchronize()
        assert out.shape == (2, 256, 16, 9)
        counts = kernels.launch_counts()
        assert counts["bridge_attention"] == 3
        assert counts["bridge_attention_bwd"] == 3
        # img 64: ETB maps 16, 8, 4 (7); MHCA maps 8, 4 (2); bridge 16,
        # 8, 4 (12); the 2x2 MHCA map (stage 4) is even too (1).
        n_ffn = 22 if flash else 0
        assert counts["mixffn"] == counts["mixffn_bwd"] == n_ffn
        for name in ("etb_attention", "expand_head", "mhca_block",
                     "linear_attention", "patch_expand"):
            assert counts[name] == 0
        assert all(p.grad is not None for p in m.parameters())
