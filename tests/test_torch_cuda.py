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
plain versions; K10's fp32 form (3xTF32) within 1e-4. So are the plain backwards of K1 and K5-K9 (autograd of
the plain version through the kernels' autograd Function) against
autograd of the plain version itself.
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


def _etb_args(gen, B, N, C):
    x = _r(gen, B, N, C, scale=0.25, dtype=torch.bfloat16)
    args = [_r(gen, C, scale=0.1, shift=1.0), _r(gen, C, scale=0.1)]
    for f in (2, 4, 2, 2):  # peaked softmaxes: the branch is of order x
        args += [_r(gen, C, C, scale=f * C ** -0.5), _r(gen, C, scale=0.02)]
    return x, args


# Ragged row tiles (200, 196 rows) and the model's three shapes: several
# segments of N (3136, 784; and the small batches), one at (24, 196, 320).
@pytest.mark.parametrize("B,N,C", [(2, 200, 64), (1, 196, 320),
                                   (2, 3136, 64), (2, 784, 128),
                                   (24, 196, 320)])
def test_etb_attention_kernel(gen, B, N, C):
    x, args = _etb_args(gen, B, N, C)
    n0 = ea.launches
    _close(ea.etb_attention(x, *args), ea.etb_attention_plain(x, *args),
           base=x)
    assert ea.launches == n0 + 1


@pytest.mark.parametrize("B,N,C", [(2, 3136, 64), (24, 196, 320)])
def test_etb_attention_repeat_bit_identical(gen, B, N, C):
    """No atomics in K1's stages (49 segments at the first shape, one at
    the second): two launches on the same inputs give the same bits."""
    x, args = _etb_args(gen, B, N, C)
    assert torch.equal(ea.etb_attention(x, *args),
                       ea.etb_attention(x, *args))


@pytest.mark.parametrize("s,C", [(8, 64), (7, 128), (14, 320), (14, 128),
                                 (28, 64)])
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


@pytest.mark.parametrize("B,s,C", [(2, 8, 64), (3, 14, 128), (2, 28, 64)])
def test_mixffn_skip_kernel(gen, B, s, C):
    """K9: the FFN alone, no caller's LN and no residual."""
    hid = 4 * C
    x = _r(gen, B, s * s, C, dtype=torch.bfloat16)
    args = (x, _r(gen, hid, C, scale=C ** -0.5), _r(gen, hid, scale=0.02),
            _r(gen, hid, 1, 3, 3, scale=0.3), _r(gen, hid, scale=0.02),
            _r(gen, hid, scale=0.1, shift=1.0), _r(gen, hid, scale=0.1),
            _r(gen, C, hid, scale=hid ** -0.5), _r(gen, C, scale=0.02))
    n0 = mf.skip_launches
    _close(mf.mixffn_skip(*args, s=s), mf.mixffn_skip_plain(*args, s=s))
    assert mf.skip_launches == n0 + 1


# (B, h, N, M): N ragged against the 64- and 128-row query tiles (124,
# 300, 6076); M of one 16-key step (16), under one 112-key chunk (48, 96),
# over one (128), the published 7 chunks (784) and with a partial last
# chunk (240 = 2 x 112 + 16, 800 = 7 x 112 + 16); B·h > 1 throughout.
BRIDGE_SHAPES = [(2, 1, 124, 16), (2, 1, 6076, 784), (2, 1, 300, 128),
                 (2, 1, 124, 48), (1, 1, 6076, 128), (3, 2, 124, 240),
                 (2, 1, 300, 800), (1, 2, 6076, 48), (2, 2, 600, 96)]


def _bridge_inputs(gen, B, h, N, M, dtype=torch.bfloat16):
    """q, k, v, g drawn at `dtype` (fp32 draws carry all 24 bits: a bf16
    value has no lo part for a 3xTF32 split)."""
    return tuple(_r(gen, B, h, n, 64, dtype=dtype) for n in (N, M, M, N))


@pytest.mark.parametrize("B,h,N,M", BRIDGE_SHAPES)
def test_bridge_attention_kernel(gen, B, h, N, M):
    q, k, v, _ = _bridge_inputs(gen, B, h, N, M)
    n0 = ba.launches
    _close(ba.bridge_attention(q, k, v, 0.125),
           ba.bridge_attention_plain(q, k, v, 0.125))
    assert ba.launches == n0 + 1


@pytest.mark.parametrize("B,h,N,M", BRIDGE_SHAPES)
def test_bridge_attention_f32_kernel(gen, B, h, N, M):
    """K3's fp32 form (3xTF32 on the tensor cores, one pass over the keys)
    within 1e-4 of max|plain| (fp32 plain version, TF32 off by default),
    at ragged query tiles and short last key chunks and steps; twice on
    the same inputs, the same bits."""
    q, k, v = (_r(gen, B, h, n, 64) for n in (N, M, M))
    n0 = ba.launches
    got = ba.bridge_attention(q, k, v, 0.125)
    _close(got, ba.bridge_attention_plain(q, k, v, 0.125), rel=1e-4)
    assert ba.launches == n0 + 1
    assert torch.equal(got, ba.bridge_attention(q, k, v, 0.125))


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_bridge_attention_f32_nan_as_plain(gen, which):
    """A NaN in q, k or v reaches K3's fp32 output where it reaches the
    plain version's (the 3xTF32 split keeps NaNs): a row, every row, a
    channel; the rest within 1e-4 of max|plain|."""
    q, k, v = (_r(gen, 2, 1, n, 64) for n in (300, 784, 784))
    # The NaN a CUDA operation produces, 0x7fffffff.
    at = {"q": q[0, 0, 5], "k": k[0, 0, 17], "v": v[0, 0, 17]}[which]
    at.view(torch.int32)[3] = 0x7FFFFFFF
    got = ba.bridge_attention(q, k, v, 0.125)
    want = ba.bridge_attention_plain(q, k, v, 0.125)
    nan = want.isnan()
    assert nan.any() and torch.equal(got.isnan(), nan)
    _close(got[~nan], want[~nan], rel=1e-4)


# (B, H, W): partial token tiles (2 x 200, 2 x 1000 tokens against tiles of
# 128), one slice (batch 1: the groups split in quads), the serving map.
@pytest.mark.parametrize("B,H,W", [(2, 10, 20), (2, 25, 40), (1, 56, 56),
                                   (32, 56, 56)])
@pytest.mark.parametrize("shuffled", [True, False])
@pytest.mark.parametrize("ptype", [torch.float32, torch.bfloat16])
def test_expand_head_kernel(gen, B, H, W, shuffled, ptype):
    """K4 in both layouts, with the LN and head vectors in either dtype
    (read as they come, no cast)."""
    x = _r(gen, B, H * W, 64, dtype=torch.bfloat16)
    args = (x, _r(gen, 1024, 64, scale=0.125),
            _r(gen, 64, scale=0.1, shift=1.0, dtype=ptype),
            _r(gen, 64, scale=0.1, dtype=ptype),
            _r(gen, 9, 64, scale=0.125, dtype=ptype),
            _r(gen, 9, scale=0.02, dtype=ptype))
    shuffle = (H, W) if shuffled else None
    n0 = eh.launches
    got = eh.expand_head(*args, p=4, c=64, shuffle=shuffle)
    want = eh.expand_head_plain(*args, p=4, c=64, shuffle=shuffle)
    torch.cuda.synchronize()
    assert eh.launches == n0 + 1
    shape = (B, 4 * H, 4 * W) if shuffled else (B, H * W, 16)
    assert got.dtype == torch.uint8 and got.shape == shape
    assert (got != want).float().mean().item() <= 1e-3


def _mhca_args(gen, B, s, C, hid):
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
    return x, args


@pytest.mark.parametrize("B,s,C,hid", [(2, 8, 64, 256), (3, 7, 128, 512),
                                        (1, 14, 128, 512), (2, 28, 64, 256)])
def test_mhca_block_kernel(gen, B, s, C, hid):
    x, args = _mhca_args(gen, B, s, C, hid)
    n0 = mb.launches
    _close(mb.mhca_block(*args, s=s, heads=8),
           mb.mhca_block_plain(*args, s=s, heads=8), base=x)
    assert mb.launches == n0 + 1


def _la_args(gen, shape, q_softmax):
    q, k, v = (_r(gen, *shape, scale=f, dtype=torch.bfloat16)
               for f in (1.0, 3.0, 1.0))
    return q, k, v, q_softmax, 1.0 if q_softmax else shape[-1] ** -0.5


@pytest.mark.parametrize("shape,q_softmax", [
    ((2, 8, 49, 40), False), ((1, 2, 100, 64), True),
    # the ETB shapes (etb_attn_fold off) and the unfolded MHCA stages 2-3
    ((2, 1, 3136, 64), True), ((2, 1, 784, 128), True),
    ((2, 1, 196, 320), True), ((2, 8, 784, 8), False),
    ((2, 8, 196, 16), False),
    # the MHCA shapes at the train batch (the head body)
    ((24, 8, 49, 40), False), ((24, 8, 784, 8), False),
    ((24, 8, 196, 16), False)])
def test_linear_attention_kernel(gen, shape, q_softmax):
    args = _la_args(gen, shape, q_softmax)
    n0 = la.launches
    _close(la.linear_attention(*args), la.linear_attention_plain(*args))
    assert la.launches == n0 + 1


@pytest.mark.parametrize("shape,q_softmax", [
    ((2, 8, 784, 8), False),   # the head body
    ((24, 8, 49, 40), False),  # the head body at the train batch
    ((2, 1, 3136, 64), True),  # the segmented body, several segments
    ((32, 1, 196, 320), True)])  # the segmented body, one segment
def test_linear_attention_repeat_bit_identical(gen, shape, q_softmax):
    """No atomics in either K6 body: two launches on the same inputs give
    the same bits."""
    args = _la_args(gen, shape, q_softmax)
    assert la.plan(shape[0] * shape[1], *shape[2:], shape[3], 132)[
        "body"] == ("head" if shape[3] <= 64 and shape[2] < 1000
                    else "segmented")
    assert torch.equal(la.linear_attention(*args),
                       la.linear_attention(*args))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [
    # the legacy models' (models/legacy.py): the two-branch encoder's
    # head_count-8 fused sequences, EffMiT's and ResInception's wide heads
    # (fp32 at 512: the out stage's context in two pieces)
    (2, 8, 1460, 16), (2, 8, 74, 64), (2, 1, 49, 512), (2, 1, 147, 512),
    (2, 1, 2352, 128)])
def test_linear_attention_legacy_shapes(gen, shape, dtype):
    q, k, v = (_r(gen, *shape, scale=f, dtype=dtype) for f in (1.0, 3.0, 1.0))
    _close(la.linear_attention(q, k, v, True),
           la.linear_attention_plain(q, k, v, True),
           rel=1e-4 if dtype == torch.float32 else 0.02)


def _folded_inputs(gen, N, M, dtype=torch.bfloat16):
    x, res = (_r(gen, 2, N, 64, dtype=dtype) for _ in range(2))
    k, v = (_r(gen, 2, 1, M, 64, dtype=dtype) for _ in range(2))
    w = [_r(gen, 64, 64, scale=0.2), _r(gen, 64, scale=0.1)]
    return (x, res, w[0], w[1], k, v, _r(gen, 64, 64, scale=0.2),
            _r(gen, 64, scale=0.1), 0.125)


# (N, M): N ragged against the 128-row tiles (124, 300, 6076); M of one
# 16-key step, under one 112-key chunk (48), the published 7 chunks and a
# short last chunk (800 = 7 x 112 + 16).
@pytest.mark.parametrize("N,M", [(124, 16), (6076, 784), (300, 800),
                                 (300, 48)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_bridge_attention_folded_kernel(gen, N, M, dtype):
    """K8 on its branch alone (output minus res), with a ragged tile; its
    fp32 form within 1e-4 of the branch's scale."""
    args = _folded_inputs(gen, N, M, dtype)
    res = args[1]
    n0 = ba.folded_launches
    _close(ba.bridge_attention_folded(*args),
           ba.bridge_attention_folded_plain(*args),
           rel=1e-4 if dtype == torch.float32 else 0.02, base=res)
    assert ba.folded_launches == n0 + 1


@pytest.mark.parametrize("which", ["x", "wq", "wp"])
def test_bridge_attention_folded_f32_nan_as_plain(gen, which):
    """A NaN in a row of x, in Wq or in Wp reaches K8's fp32 output where
    it reaches the plain version's (the projections' 3xTF32 splits keep
    NaNs); the rest of the branch within 1e-4 of its scale."""
    args = list(_folded_inputs(gen, 300, 784, torch.float32))
    i, at = {"x": (0, (0, 5, 3)), "wq": (2, (5, 3)), "wp": (6, (5, 3))}[which]
    args[i].view(torch.int32)[at] = 0x7FFFFFFF  # a CUDA operation's NaN
    got = ba.bridge_attention_folded(*args)
    want = ba.bridge_attention_folded_plain(*args)
    nan = want.isnan()
    assert nan.any() and torch.equal(got.isnan(), nan)
    if not nan.all():  # (a NaN in Wq reaches every row)
        _close(got[~nan], want[~nan], rel=1e-4, base=args[1][~nan])


# (B, H, W, C, p): the three p = 2 widths (c = 256, 160, 64; ragged token
# tiles), the x4 expander on the logits path (a partial tile of 128 and the
# serving map) and one p = 2 map at batch 24 (a partial tile of 32).
@pytest.mark.parametrize("B,H,W,C,p", [
    (2, 7, 7, 512, 2), (2, 14, 14, 320, 2), (2, 5, 10, 128, 2),
    (2, 4, 5, 64, 4), (2, 25, 40, 64, 4), (32, 56, 56, 64, 4),
    (24, 7, 7, 512, 2)])
@pytest.mark.parametrize("shuffled", [True, False])
@pytest.mark.parametrize("ptype", [torch.float32, torch.bfloat16])
def test_patch_expand_kernel(gen, B, H, W, C, p, shuffled, ptype):
    """K7 in both layouts, with the LN vectors in either dtype."""
    c = C // 2 if p == 2 else C
    args = (_r(gen, B, H * W, C, dtype=torch.bfloat16),
            _r(gen, p * p * c, C, scale=C ** -0.5),
            _r(gen, c, scale=0.1, shift=1.0, dtype=ptype),
            _r(gen, c, scale=0.1, dtype=ptype))
    shuffle = (H, W) if shuffled else None
    n0 = pe.launches
    got = pe.patch_expand(*args, p=p, c=c, shuffle=shuffle)
    want = pe.patch_expand_plain(*args, p=p, c=c, shuffle=shuffle)
    assert pe.launches == n0 + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _close(got, want)


def test_kernels_off_run_plain_on_the_card(gen):
    from transception_tpu_torch.ops import kernels
    q = _r(gen, 1, 2, 16, 64, dtype=torch.bfloat16)
    n0 = la.launches
    with kernels.enabled(False):
        out = la.linear_attention(q, q, q)
    assert la.launches == n0
    assert torch.equal(out, la.linear_attention_plain(q, q, q))


def test_kernels_raise_instead_of_falling_back(gen):
    x = _r(gen, 1, 64, 64, dtype=torch.float16)  # no kernel takes fp16
    w = torch.zeros(64, 64, device="cuda")
    v = torch.zeros(64, device="cuda")
    with pytest.raises(ValueError):
        ea.etb_attention(x, v, v, w, v, w, v, w, v, w, v)
    with pytest.raises(ValueError):
        ba.bridge_attention(x[None], x[None], x[None], 0.125)
    with pytest.raises(ValueError):
        ba.bridge_attention_folded(x, x, w, v, x[None], x[None], w, v, 0.125)


@pytest.mark.parametrize("folds", ["default", "all-on", "folds-off",
                                   "mhca-ffn-fold"])
def test_tiny_model_uses_every_kernel(gen, folds):
    from chip_smoke import FOLD_GRID
    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.models.transception import (
        MSTransception,
        launches_per_forward,
    )
    from transception_tpu_torch.ops import kernels
    cfg = TransceptionConfig(img_size=32, stage1_layers=1,
                             num_path=(1, 1, 1), num_layers=(1, 1, 1),
                             **dict(FOLD_GRID).get(folds, {}))
    m = MSTransception(cfg, device="cuda")
    kernels.reset_launches()
    with torch.inference_mode():
        ids = m(_r(gen, 2, 32, 32, 1), argmax=True)
    torch.cuda.synchronize()
    assert ids.shape == (2, 32, 32) and ids.dtype == torch.uint8
    # img 32: MHCA maps 4², 2², 1²; even sides take the whole-block
    # kernel, the 1² stage its modules with the linear-attention kernel.
    counts = kernels.launch_counts()
    assert counts == launches_per_forward(cfg)
    if folds == "default":
        assert counts == {"etb_attention": 7, "mixffn": 7,
                          "bridge_attention": 3, "expand_head": 1,
                          "mhca_block": 2, "linear_attention": 1,
                          "patch_expand": 3, "bridge_attention_bwd": 0,
                          "mixffn_bwd": 0, "bridge_attention_folded": 0,
                          "mixffn_skip": 0}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("B,h,N,M", BRIDGE_SHAPES)
def test_bridge_attention_bwd_kernel(gen, B, h, N, M, dtype):
    """K10 per gradient against its plain version: bf16 within 2% of each
    gradient's max; its fp32 form (3xTF32 on the tensor cores; the fp32
    plain version with TF32 off by default) within 1e-4, at ragged query
    chunks, short last key chunks and key tiles past M."""
    q, k, v, g = _bridge_inputs(gen, B, h, N, M, dtype)
    n0 = ba.bwd_launches
    got = ba.bridge_attention_bwd(q, k, v, g, 0.125)
    want = ba.bridge_attention_bwd_plain(q, k, v, g, 0.125)
    assert ba.bwd_launches == n0 + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == dtype
        _close(a, b, rel=1e-4 if dtype == torch.float32 else 0.02)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("B,h,N,M", [(2, 1, 60, 784), (3, 2, 124, 240),
                                     (24, 1, 6076, 784)])
def test_bridge_attention_kernels_repeat_bit_identical(gen, B, h, N, M,
                                                       dtype):
    """No atomics in K3 or K10, at either dtype (K10 with one row segment
    at the first shape, with several at the others, bwd_plan): two
    launches on the same inputs give the same bits."""
    q, k, v, g = _bridge_inputs(gen, B, h, N, M, dtype)
    assert torch.equal(ba.bridge_attention(q, k, v, 0.125),
                       ba.bridge_attention(q, k, v, 0.125))
    one = ba.bridge_attention_bwd(q, k, v, g, 0.125)
    two = ba.bridge_attention_bwd(q, k, v, g, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.parametrize("which", ["q", "k", "v", "g"])
def test_bridge_attention_bwd_f32_nan_as_plain(gen, which):
    """A NaN in q, k, v or g reaches K10's fp32 gradients where it reaches
    the plain version's (every split keeps NaNs, E/S and T·s/S too); the
    rest within 1e-4 of each gradient's max|plain|."""
    q, k, v, g = (_r(gen, 2, 1, n, 64) for n in (300, 784, 784, 300))
    # The NaN a CUDA operation produces, 0x7fffffff.
    at = {"q": q[0, 0, 5], "k": k[0, 0, 17], "v": v[0, 0, 17],
          "g": g[0, 0, 5]}[which]
    at.view(torch.int32)[3] = 0x7FFFFFFF
    got = ba.bridge_attention_bwd(q, k, v, g, 0.125)
    want = ba.bridge_attention_bwd_plain(q, k, v, g, 0.125)
    assert any(b.isnan().any() for b in want)
    for a, b in zip(got, want):
        nan = b.isnan()
        assert torch.equal(a.isnan(), nan)
        if not nan.all():
            _close(a[~nan], b[~nan], rel=1e-4)


@pytest.mark.parametrize("N,M", [(300, 800), (6076, 784)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_bridge_attention_folded_repeat_bit_identical(gen, N, M, dtype):
    """No atomics in K8: two launches on the same inputs give the same
    bits."""
    args = _folded_inputs(gen, N, M, dtype)
    assert torch.equal(ba.bridge_attention_folded(*args),
                       ba.bridge_attention_folded(*args))


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
    (14, 320, 1280, 5, 1e-5), (28, 64, 256, 1, 1e-6),
    (2, 512, 2048, 8, 1e-5)])  # the bridge's scale 4 at 64²
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


@pytest.mark.parametrize("B,s,C,hid,groups", [(3, 6, 128, 512, 1),
                                              (24, 14, 320, 1280, 5)])
def test_mixffn_bwd_repeat_bit_identical(gen, B, s, C, hid, groups):
    """No atomics in K11 (fixed token ranges and split partials summed in a
    fixed order, bwd_plan): two launches give the same bits."""
    x, p = _ffn_args(gen, B, s, C, hid, groups)
    g = _r(gen, *x.shape, dtype=torch.bfloat16)
    one = mf.mixffn_ln_skip_bwd(x, *p, g, s=s, groups=groups)
    two = mf.mixffn_ln_skip_bwd(x, *p, g, s=s, groups=groups)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.parametrize("s,C,hid,groups", [(28, 128, 512, 2),
                                            (14, 320, 1280, 5),
                                            (2, 512, 2048, 8)])
def test_mixffn_kernel_grouped(gen, s, C, hid, groups):
    x, p = _ffn_args(gen, 2, s, C, hid, groups)
    args = (x, p[0][:C // groups], p[1][:C // groups]) + p[2:]
    _close(mf.mixffn_ln_skip(*args, s=s, groups=groups),
           mf.mixffn_ln_skip_plain(*args, s=s, groups=groups), base=x)


@pytest.mark.parametrize("B,s,C,hid,groups", [(2, 56, 64, 256, 1),
                                              (3, 14, 320, 1280, 5)])
def test_mixffn_repeat_bit_identical(gen, B, s, C, hid, groups):
    """No atomics in K2's stages (or K9's, the same chain): two launches on
    the same inputs give the same bits."""
    x, p = _ffn_args(gen, B, s, C, hid, groups)
    args = (x, p[0][:C // groups], p[1][:C // groups]) + p[2:]
    assert torch.equal(mf.mixffn_ln_skip(*args, s=s, groups=groups),
                       mf.mixffn_ln_skip(*args, s=s, groups=groups))
    bare = (x,) + p[2:]
    assert torch.equal(mf.mixffn_skip(*bare, s=s), mf.mixffn_skip(*bare, s=s))


@pytest.mark.parametrize("B,s,C,hid", [(2, 28, 64, 256), (3, 14, 128, 512)])
def test_mhca_block_repeat_bit_identical(gen, B, s, C, hid):
    """No atomics in K5's stages: two launches give the same bits."""
    _, args = _mhca_args(gen, B, s, C, hid)
    assert torch.equal(mb.mhca_block(*args, s=s, heads=8),
                       mb.mhca_block(*args, s=s, heads=8))


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
    """K4, the eval argmax head, has no backward and refuses a graph; the
    kernels with a plain backward (here K1 and K8) keep it."""
    x = _r(gen, 1, 64, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 64, device="cuda", requires_grad=True)
    v = torch.zeros(64, device="cuda")
    hw = torch.zeros(9, 64, device="cuda", requires_grad=True)
    w16 = torch.zeros(1024, 64, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        eh.expand_head(x, w16, v, v, hw, v[:9], p=4, c=64)
    with torch.no_grad():
        eh.expand_head(x, w16, v, v, hw, v[:9], p=4, c=64)
    assert ea.etb_attention(x, v, v, w, v, w, v, w, v, w, v).requires_grad
    kv = x[None]
    assert ba.bridge_attention_folded(x, x, w, v, kv, kv, w, v,
                                      0.125).requires_grad


def _leaf(t):
    return t.detach().clone().requires_grad_()


def test_plain_backwards_match_autograd_of_plain(gen):
    """K1, K5-K9 through their autograd Function on the card: the forward
    is the kernel's, every input's gradient autograd of the plain version
    (each within 2% of its own max)."""
    C, hid, s = 64, 256, 8
    chs = [h * C // 8 for h in (2, 3, 3)]
    ffn = [_r(gen, hid, C, scale=C ** -0.5), _r(gen, hid, scale=0.02),
           _r(gen, hid, 1, 3, 3, scale=0.3), _r(gen, hid, scale=0.02),
           _r(gen, hid, scale=0.1, shift=1.0), _r(gen, hid, scale=0.1),
           _r(gen, C, hid, scale=hid ** -0.5), _r(gen, C, scale=0.02)]
    mhca = [_r(gen, 2, s * s, C, scale=0.5, dtype=torch.bfloat16),
            _r(gen, C, 1, 3, 3, scale=0.3), _r(gen, C, scale=0.02),
            _r(gen, C, scale=0.1, shift=1.0), _r(gen, C, scale=0.1),
            _r(gen, 3 * C, C, scale=3 * C ** -0.5), _r(gen, 3 * C, scale=0.02)]
    crpe = ([_r(gen, n, 1, k, k, scale=1.0 / k)
             for n, k in zip(chs, (3, 5, 7))],
            [_r(gen, n, scale=0.02) for n in chs])
    tail = [_r(gen, C, C, scale=C ** -0.5), _r(gen, C, scale=0.02),
            _r(gen, C, scale=0.1, shift=1.0), _r(gen, C, scale=0.1)] + ffn

    def mhca_call(fn):
        return lambda *a: fn(*a[:7], list(a[7:10]), list(a[10:13]),
                             *a[13:], s=s, heads=8)

    etb = [_r(gen, 2, 100, C, scale=0.25, dtype=torch.bfloat16),
           _r(gen, C, scale=0.1, shift=1.0), _r(gen, C, scale=0.1)]
    for f in (2, 4, 2, 2):
        etb += [_r(gen, C, C, scale=f * C ** -0.5), _r(gen, C, scale=0.02)]
    qkv = [_r(gen, 2, 8, 49, 40, scale=f, dtype=torch.bfloat16)
           for f in (1.0, 3.0, 1.0)]
    fold = [_r(gen, 2, 124, 64, dtype=torch.bfloat16),
            _r(gen, 2, 124, 64, dtype=torch.bfloat16),
            _r(gen, 64, 64, scale=0.2), _r(gen, 64, scale=0.1),
            _r(gen, 2, 1, 16, 64, dtype=torch.bfloat16),
            _r(gen, 2, 1, 16, 64, dtype=torch.bfloat16),
            _r(gen, 64, 64, scale=0.2), _r(gen, 64, scale=0.1)]
    pex = [_r(gen, 2, 50, 128, dtype=torch.bfloat16),
           _r(gen, 256, 128, scale=128 ** -0.5),
           _r(gen, 64, scale=0.1, shift=1.0), _r(gen, 64, scale=0.1)]
    cases = [
        (ea.etb_attention, ea.etb_attention_plain, etb),
        (mhca_call(mb.mhca_block), mhca_call(mb.mhca_block_plain),
         mhca + crpe[0] + crpe[1] + tail),
        (lambda *a: la.linear_attention(*a, False, 40 ** -0.5),
         lambda *a: la.linear_attention_plain(*a, False, 40 ** -0.5), qkv),
        (lambda *a: pe.patch_expand(*a, p=2, c=64, shuffle=(5, 10)),
         lambda *a: pe.patch_expand_plain(*a, p=2, c=64, shuffle=(5, 10)),
         pex),
        (lambda *a: ba.bridge_attention_folded(*a, 0.125),
         lambda *a: ba.bridge_attention_folded_plain(*a, 0.125), fold),
        (lambda *a: mf.mixffn_skip(*a, s=s),
         lambda *a: mf.mixffn_skip_plain(*a, s=s),
         [_r(gen, 2, s * s, C, dtype=torch.bfloat16)] + ffn)]
    for kfn, pfn, args in cases:
        leaves = [_leaf(t) for t in args]
        out = kfn(*leaves)
        g = _r(gen, *out.shape, dtype=out.dtype)
        got = torch.autograd.grad(out, leaves, g)
        want = torch.autograd.grad(pfn(*leaves), leaves, g)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            _close(a, b)


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
        # 8, 4, 2 (16); the 2x2 MHCA map (stage 4) is even too (1). The
        # 2x2 maps of 320 and 512 channels take K2 and K11 as the others.
        n_ffn = 26 if flash else 0
        assert counts["mixffn"] == counts["mixffn_bwd"] == n_ffn
        for name in ("etb_attention", "expand_head", "mhca_block",
                     "linear_attention", "patch_expand",
                     "bridge_attention_folded"):
            assert counts[name] == 0
        assert all(p.grad is not None for p in m.parameters())


def test_tiny_model_pallas_train_step_kernels(gen):
    """use_pallas_train with drop path: every kernel the config routes to,
    K9 on the MHCA blocks whose rate is above 0, as launches_per_step."""
    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.models.transception import (
        MSTransception,
        launches_per_step,
    )
    from transception_tpu_torch.ops import kernels
    cfg = TransceptionConfig(img_size=64, stage1_layers=1,
                             num_path=(1, 1, 1), num_layers=(2, 2, 1),
                             use_pallas_train=True, mhca_ffn_fold=True,
                             drop_path_rate=0.1)
    m = MSTransception(cfg, device="cuda").train()
    kernels.reset_launches()
    out = m(_r(gen, 2, 64, 64, 1), wide_head=True,
            gen=torch.Generator(device="cuda").manual_seed(0))
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts == launches_per_step(cfg)
    # img 64: MHCA maps 8², 4², 2²; stage-2 layer 0 (rate 0) takes K5.
    assert counts["mixffn_skip"] == 4 and counts["mhca_block"] == 1
    assert all(p.grad is not None for p in m.parameters())


def test_mixffn_skip_raises_without_its_library(gen, monkeypatch):
    """K9 on a CUDA tensor with its switch on launches or raises: a
    library that cannot be loaded is an error, not the plain version."""
    from transception_tpu_torch.ops.kernels import _build

    def missing(name):
        raise RuntimeError(f"kernel build failed: no library {name}")

    monkeypatch.setattr(_build, "load", missing)
    args = [_r(gen, 1, 64, 32, dtype=torch.bfloat16),
            _r(gen, 128, 32, scale=32 ** -0.5), _r(gen, 128),
            _r(gen, 128, 1, 3, 3), _r(gen, 128), _r(gen, 128), _r(gen, 128),
            _r(gen, 32, 128, scale=128 ** -0.5), _r(gen, 32)]
    n0 = mf.skip_launches
    with pytest.raises(RuntimeError, match="no library mixffn"):
        mf.mixffn_skip(*args, s=8)
    assert mf.skip_launches == n0
