"""The port's kernels as torch.library operators (ops/kernels, namespace
transception_torch): every operator has a CUDA implementation (the
launch), a CPU implementation (the kernel's plain version, bit for bit)
and a fake implementation whose outputs have the CPU implementation's
shapes, dtypes and strides (K4's uint8 ids, K4's and K7's shuffled
layouts included); a trace under FakeTensor counts no launch; the
wrappers route to the operators where autograd does not record on the
CPU, to the plain versions where it does. No JAX, no card."""

import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)
from torch._subclasses.fake_tensor import FakeTensorMode

from transception_tpu_torch.ops import kernels
from transception_tpu_torch.ops.kernels import _build
from transception_tpu_torch.ops.kernels import bridge_attention as ba
from transception_tpu_torch.ops.kernels import etb_attention as ea
from transception_tpu_torch.ops.kernels import expand_head as eh
from transception_tpu_torch.ops.kernels import linear_attention as la
from transception_tpu_torch.ops.kernels import mhca_block as mb
from transception_tpu_torch.ops.kernels import mixffn as mf
from transception_tpu_torch.ops.kernels import patch_expand as pe

C, HID, S = 16, 64, 4
N = S * S


def _r(gen, *shape, scale=1.0, shift=0.0):
    return torch.randn(shape, generator=gen) * scale + shift


def _cases():
    """(operator, its arguments, the plain version's result) per case."""
    g = torch.Generator().manual_seed(0)
    ffn = [_r(g, HID, C, scale=C ** -0.5), _r(g, HID, scale=0.1),
           _r(g, HID, 1, 3, 3, scale=0.3), _r(g, HID, scale=0.1),
           _r(g, HID, scale=0.1, shift=1.0), _r(g, HID, scale=0.1),
           _r(g, C, HID, scale=HID ** -0.5), _r(g, C, scale=0.1)]
    x = _r(g, 2, N, C)
    lts, ltb = _r(g, C, scale=0.1, shift=1.0), _r(g, C, scale=0.1)
    gx = _r(g, 2, N, C)
    q, k, v = (_r(g, 2, 1, 20, C) for _ in range(3))
    kk, vv = _r(g, 2, 1, 6, C), _r(g, 2, 1, 6, C)
    w, b = _r(g, C, C, scale=0.5), _r(g, C, scale=0.1)
    chs = [2 * h for _, h in ((3, 2), (5, 3), (7, 3))]
    mhca = [x, _r(g, C, 1, 3, 3, scale=0.3), _r(g, C, scale=0.1), lts, ltb,
            _r(g, 3 * C, C, scale=C ** -0.5), _r(g, 3 * C, scale=0.1),
            [_r(g, n, 1, kz, kz, scale=1 / kz) for n, kz in zip(chs, (3, 5,
                                                                   7))],
            [_r(g, n, scale=0.1) for n in chs], w, b, lts, ltb] + ffn
    k2 = slice(0, HID // 2)
    half = [t[k2] for t in ffn[:6]] + [ffn[6][:, k2]]
    hh, st = mf.tp_fc1_plain(x, lts, ltb, *half[:4], S, 1, 1e-5, HID)
    st = st * 2
    rows_args = [x, gx, lts, ltb, *half, st, S, 1, HID, 1e-5, 1e-5]
    rows = mf.tp_bwd_rows_plain(*rows_args)
    dh_args = [*rows[:5], gx, half[2], half[4], half[0], st, rows[5] * 2, S,
               HID, 1e-5]
    qkv3 = _r(g, 2, N, 3 * C)
    xe = _r(g, 2, 9, C)
    wex, ls8, lb8 = _r(g, 32, C, scale=C ** -0.5), _r(g, 8) + 1, _r(g, 8)
    wh, lsh, lbh = _r(g, 16 * 64, C, scale=C ** -0.5), _r(g, 64) + 1, \
        _r(g, 64)
    hw, hb = _r(g, 9, 64, scale=0.2), _r(g, 9, scale=0.1)
    cases = {
        "etb_attention": (ea.OP, [x, lts, ltb, w, b, w, b, w, b, w, b, 1e-5],
                          ea.etb_attention_plain(x, lts, ltb, w, b, w, b, w,
                                                 b, w, b)),
        "mixffn": (mf.OP, [x, lts, ltb, *ffn, S, 1, 1e-5, 1e-5],
                   mf.mixffn_ln_skip_plain(x, lts, ltb, *ffn, s=S)),
        "mixffn_bwd": (mf.BWD_OP, [x, lts, ltb, *ffn, gx, S, 1, 1e-5, 1e-5],
                       mf.mixffn_ln_skip_bwd_plain(x, lts, ltb, *ffn, gx,
                                                   s=S)),
        "mixffn_skip": (mf.SKIP_OP, [x, *ffn, S, 1e-5],
                        mf.mixffn_skip_plain(x, *ffn, s=S)),
        # K2's and K11's hidden-sharded stages, at a shard of half the
        # hidden channels (hid_all = 2·hid) with made-up summed sums.
        "mixffn_tp": (mf.TP_FC1_OP, [x, lts, ltb, *half[:4], S, 1, 1e-5,
                                     HID],
                      mf.tp_fc1_plain(x, lts, ltb, *half[:4], S, 1, 1e-5,
                                      HID)),
        "mixffn_tp_fc2": (mf.TP_FC2_OP, [hh, *half[2:7], st, S, HID, 1e-5],
                          mf.tp_fc2_plain(hh, *half[2:7], st, S, HID, 1e-5)),
        "mixffn_tp_out": (mf.TP_OUT_OP, [gx, ffn[7], x],
                          mf.tp_out_plain(gx, ffn[7], x)),
        "mixffn_tp_bwd": (mf.TP_BWD_ROWS_OP, rows_args,
                          mf.tp_bwd_rows_plain(*rows_args)),
        "mixffn_tp_bwd_dh": (mf.TP_BWD_DH_OP, dh_args,
                             mf.tp_bwd_dh_plain(*dh_args)),
        "mixffn_tp_bwd_ln": (mf.TP_BWD_LN_OP, [x, gx, gx, lts, 1, 1e-5],
                             mf.tp_bwd_ln_plain(x, gx, gx, lts, 1, 1e-5)),
        # K9's hidden-sharded stages (fc2 is K2's, above).
        "mixffn_skip_tp": (mf.SKIP_TP_FC1_OP, [x, *half[:4], S, HID],
                           mf.skip_tp_fc1_plain(x, *half[:4], S, HID)),
        "mixffn_skip_tp_out": (mf.SKIP_TP_OUT_OP, [gx, ffn[7],
                                                   torch.bfloat16],
                               mf.skip_tp_out_plain(gx, ffn[7],
                                                    torch.bfloat16)),
        # K5's sharded stages: half the qkv columns and of the hidden
        # channels, a made-up gathered q|k|v and summed sums.
        "mhca_block_tp": (mb.TP_QKV_OP, mhca[:5] + [mhca[5][:3 * C // 2],
                                                    mhca[6][:3 * C // 2],
                                                    S, HID // 2, HID, 1e-6],
                          mb.tp_qkv_plain(*mhca[:5], mhca[5][:3 * C // 2],
                                          mhca[6][:3 * C // 2], S, 1e-6)),
        "mhca_block_tp_attn": (mb.TP_ATTN_OP, [qkv3, x, *mhca[7:11], S, 8],
                               mb.tp_attn_plain(qkv3, x, *mhca[7:11], S,
                                                8)),
        "mhca_block_tp_fc1": (mb.TP_FC1_OP, [x, lts, ltb, *half[:4], S,
                                             1e-6, HID],
                              mb.tp_fc1_plain(x, lts, ltb, *half[:4], S,
                                              1e-6, HID)),
        "mhca_block_tp_fc2": (mb.TP_FC2_OP, [hh, *half[2:7], st, S, HID,
                                             1e-5],
                              mf.tp_fc2_plain(hh, *half[2:7], st, S, HID,
                                              1e-5)),
        "bridge_attention": (ba.OP, [q, k, v, 0.25],
                             ba.bridge_attention_plain(q, k, v, 0.25)),
        "bridge_attention_bwd": (ba.BWD_OP, [q, k, v, q, 0.25],
                                 ba.bridge_attention_bwd_plain(q, k, v, q,
                                                               0.25)),
        "bridge_attention_folded": (
            ba.FOLDED_OP, [_r(g, 2, 20, C), _r(g, 2, 20, C), w, b, kk, vv, w,
                           b, 0.25], None),
        "linear_attention": (la.OP, [q, k, v, True, 0.5],
                             la.linear_attention_plain(q, k, v, True, 0.5)),
        "mhca_block": (mb.OP, mhca + [S, 8, 1e-6, 1e-6, 1e-5],
                       mb.mhca_block_plain(*mhca, s=S, heads=8)),
        "patch_expand": (pe.OP, [xe, wex, ls8, lb8, 2, 8, 1e-5, None],
                         pe.patch_expand_plain(xe, wex, ls8, lb8, p=2,
                                               c=8)),
        "patch_expand_shuffled": (
            pe.OP, [xe, wex, ls8, lb8, 2, 8, 1e-5, [3, 3]],
            pe.patch_expand_plain(xe, wex, ls8, lb8, p=2, c=8,
                                  shuffle=(3, 3))),
        "expand_head": (eh.OP, [xe.bfloat16(), wh, lsh, lbh, hw, hb, 4, 64,
                                1e-5, None],
                        eh.expand_head_plain(xe.bfloat16(), wh, lsh, lbh, hw,
                                             hb, p=4, c=64)),
        "expand_head_shuffled": (
            eh.OP, [xe.bfloat16(), wh, lsh, lbh, hw, hb, 4, 64, 1e-5, [3, 3]],
            eh.expand_head_plain(xe.bfloat16(), wh, lsh, lbh, hw, hb, p=4,
                                 c=64, shuffle=(3, 3))),
    }
    f = cases["bridge_attention_folded"]
    cases["bridge_attention_folded"] = (f[0], f[1],
                                        ba.bridge_attention_folded_plain(
                                            *f[1]))
    return cases


CASES = sorted(_cases())


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def test_every_kernel_is_an_operator():
    ops = {c.split("_shuffled")[0] for c in CASES}
    assert ops == set(_build.PLAIN_OPS)
    assert {name for name, _, _ in kernels.COUNTERS} <= ops
    for name in ops:
        qual = f"{kernels.NAMESPACE}::{name}"
        for key in ("CUDA", "CPU", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, key), \
                (name, key)


@pytest.mark.parametrize("case", CASES)
def test_cpu_implementation_is_the_plain_version(case):
    op, args, want = _cases()[case]
    got = _flat(op(*args))
    want = _flat(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("case", CASES)
def test_fake_implementation_gives_the_cpu_outputs_layout(case):
    """Under FakeTensor (what torch.export traces with) each operator's
    outputs have the shapes, dtypes and strides of its CPU
    implementation's, and no launch is counted."""
    op, args, _ = _cases()[case]
    real = _flat(op(*args))
    kernels.reset_launches()
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                     else [mode.from_tensor(t) for t in a]
                     if isinstance(a, list) and a and
                     isinstance(a[0], torch.Tensor) else a for a in args]
        fake = _flat(op(*fake_args))
    assert len(fake) == len(real)
    for f, r in zip(fake, real):
        assert f.shape == r.shape and f.dtype == r.dtype, case
        assert f.stride() == r.stride(), case
    assert set(kernels.launch_counts().values()) == {0}
    assert kernels.shape_counts() == {}


def test_meta_tensors_take_the_fake_implementation():
    op, args, want = _cases()["expand_head_shuffled"]
    out = op(*[a.to("meta") if isinstance(a, torch.Tensor) else a
               for a in args])
    assert out.device.type == "meta" and out.dtype == torch.uint8
    assert out.shape == want.shape == (2, 12, 12)


def test_wrappers_route_by_grad_mode_on_the_cpu():
    """On the CPU a wrapper calls its operator where autograd does not
    record (an eval forward, a trace) and the plain version where it does
    (autograd then differentiates it), with the same result; a kernel
    switched off always runs the plain version."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (_r(g, 2, 1, 20, C) for _ in range(3))
    seen = []

    class Spy(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func.namespace)
            return func(*args, **(kwargs or {}))

    with Spy():
        with torch.no_grad():
            a = la.linear_attention(q, k, v, True, 0.5)
        assert kernels.NAMESPACE in seen
        seen.clear()
        b = la.linear_attention(q, k, v, True, 0.5)
        assert kernels.NAMESPACE not in seen
        with torch.no_grad(), kernels.enabled(False):
            c = la.linear_attention(q, k, v, True, 0.5)
        assert kernels.NAMESPACE not in seen
    assert torch.equal(a, b) and torch.equal(a, c)
