"""K5's sharded form (ops/kernels/mhca_block.py tp_*: the per-path MHCA
layout's block under the model axis) and K9's hidden-sharded form
(ops/kernels/mixffn.py skip_tp_*) on the CPU: each shard's plain stages
run in turn in one process, the qkv columns gathered and the partials
summed in rank order as the model axis does, against the unsharded plain
versions and against the Pallas kernels in interpret mode
(fused_mhca_block, fused_mixffn_skip), at fp32 and bf16; and the sharded
wrappers on a model axis of one rank (their operators' CPU
implementations, and the sharded plain version under autograd) against
the unsharded plain version and its autograd.

Tolerances: against the unsharded plain version, fp32 within 1e-6 of the
output's largest value (the same chain with the hidden width's sums in
another order), bf16 within one bf16 ulp of it (the gathered qkv columns
are the same bits; only the fc2 partials' fp32 sums move); against
Pallas interpret, the unsharded plain versions' own limits
(tests/test_torch_mhca_block.py: fp32 1e-4, bf16 4 ulps of the output's
scale; tests/test_torch_mixffn_skip.py: fp32 5e-5, bf16 2 ulps as
tests/test_torch_tp_kernels.py's K2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_threads  # noqa: F401 (torch's threads per xdist worker)
import test_torch_mhca_block as K5
import test_torch_mixffn_skip as K9

from transception_tpu.ops.pallas.mhca_block_kernel import fused_mhca_block
from transception_tpu.ops.pallas.mixffn_kernel import fused_mixffn_skip
from transception_tpu_torch.ops.kernels import mhca_block as mb
from transception_tpu_torch.ops.kernels import mixffn as mf
from transception_tpu_torch.parallel.mesh import free_port
from transception_tpu_torch.parallel.tensor import ModelAxis

EPS1 = EPS2 = 1e-6
EPS = 1e-5
ULP = 2.0 ** -8


def _ffn_shard(p, tp, r):
    """Rank r's shards of MixFFNSkip.params() (w1, b1, dw, dwb, ls, lb,
    w2, b2)."""
    w1, b1, dw, dwb, ls, lb, w2, b2 = p
    n = w1.shape[0] // tp
    k = slice(r * n, (r + 1) * n)
    return w1[k], b1[k], dw[k], dwb[k], ls[k], lb[k], w2[:, k], b2


def k5_sharded(x, a, s, heads, tp):
    """K5's sharded plain stages over tp shards: each rank's qkv columns
    (gathered in rank order), the attention on the whole q|k|v, the FFN's
    partial sums summed in rank order."""
    (cpe_w, cpe_b, l1s, l1b, wqkv, bqkv, cws, cbs, wp, bp, l2s, l2b,
     *ffn) = a
    hid = ffn[0].shape[0]
    nq = wqkv.shape[0] // tp
    fronts = [mb.tp_qkv_plain(x, cpe_w, cpe_b, l1s, l1b,
                              wqkv[r * nq:(r + 1) * nq],
                              bqkv[r * nq:(r + 1) * nq], s, EPS1)
              for r in range(tp)]
    x1 = fronts[0][0]
    qkv = torch.cat([q for _, q in fronts], -1)
    x2 = mb.tp_attn_plain(qkv, x1, cws, cbs, wp, bp, s, heads)
    sh = [_ffn_shard(ffn, tp, r) for r in range(tp)]
    part = [mb.tp_fc1_plain(x2, l2s, l2b, *q[:4], s, EPS2, hid) for q in sh]
    st = sum(pt[1] for pt in part)
    p = sum(mf.tp_fc2_plain(h, *q[2:7], st, s, hid, EPS)
            for (h, _), q in zip(part, sh))
    return mf.tp_out_plain(p, ffn[7], x2)


def k9_sharded(x, p, s, tp):
    """K9's sharded plain stages over tp shards, the partials summed in
    rank order."""
    hid = p[0].shape[0]
    sh = [_ffn_shard(p, tp, r) for r in range(tp)]
    part = [mf.skip_tp_fc1_plain(x, *q[:4], s, hid) for q in sh]
    st = sum(pt[1] for pt in part)
    out = sum(mf.tp_fc2_plain(h, *q[2:7], st, s, hid, EPS)
              for (h, _), q in zip(part, sh))
    return mf.skip_tp_out_plain(out, p[7], x.dtype)


def _k5(B, s, C, hid, seed, dtype=torch.float32):
    x, p = K5._inputs(B, s, C, 8, hid, seed)
    return torch.from_numpy(x).to(dtype), K5._torch_args(p), x, p


def _k9(B, s, C, hid, seed, dtype=torch.float32):
    x, p = K9._inputs(B, s, C, hid, seed)
    return torch.from_numpy(x).to(dtype), K9._torch_params(p), x, p


def _bf16(x):
    xb = jnp.asarray(x, jnp.bfloat16)
    return xb, torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()


# (B, s, C, hid): K5's two map shapes at half and quarter widths.
K5_SHAPES = [(2, 8, 64, 256), (1, 6, 128, 512)]
K9_SHAPES = [(2, 8, 64, 256), (2, 4, 128, 512)]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("B,s,C,hid", K5_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_sharded_equals_unsharded_plain(dtype, B, s, C, hid, tp):
    dt = getattr(torch, dtype)
    xt, a, _, _ = _k5(B, s, C, hid, seed=tp, dtype=dt)
    want = mb.mhca_block_plain(xt, *a, s=s, heads=8).float()
    got = k5_sharded(xt, a, s, 8, tp).float()
    tol = 1e-6 if dt == torch.float32 else ULP
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("B,s,C,hid", K9_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k9_sharded_equals_unsharded_plain(dtype, B, s, C, hid, tp):
    dt = getattr(torch, dtype)
    xt, pt, _, _ = _k9(B, s, C, hid, seed=tp, dtype=dt)
    want = mf.mixffn_skip_plain(xt, *pt, s=s).float()
    got = k9_sharded(xt, pt, s, tp)
    assert got.dtype == dt
    tol = 1e-6 if dt == torch.float32 else ULP
    assert float((got.float() - want).abs().max()) <= \
        tol * float(want.abs().max())


@pytest.mark.parametrize("tp", [2, 4])
def test_k5_sharded_matches_pallas_interpret_fp32(tp):
    B, s, C, hid = 2, 8, 64, 256
    xt, a, x, p = _k5(B, s, C, hid, seed=20)
    want = np.asarray(fused_mhca_block(
        jnp.asarray(x), *K5._jax_args(p), s=s, heads=8, hidden=hid,
        window=K5.WIN, interpret=True))
    got = k5_sharded(xt, a, s, 8, tp)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_k5_sharded_matches_pallas_interpret_bf16():
    B, s, C, hid, tp = 1, 6, 128, 512, 2
    _, a, x, p = _k5(B, s, C, hid, seed=21)
    xb, xt = _bf16(x)
    want = np.asarray(fused_mhca_block(
        xb, *K5._jax_args(p), s=s, heads=8, hidden=hid, window=K5.WIN,
        interpret=True), np.float32)
    got = k5_sharded(xt, a, s, 8, tp).float().numpy()
    assert np.abs(got - want).max() <= 4 * ULP * np.abs(want).max()


@pytest.mark.parametrize("tp", [2, 4])
def test_k9_sharded_matches_pallas_interpret_fp32(tp):
    B, s, C, hid = 2, 8, 32, 128
    xt, pt, x, p = _k9(B, s, C, hid, seed=22)
    want = np.asarray(fused_mixffn_skip(
        jnp.asarray(x), *map(jnp.asarray, p), s=s, hidden=hid,
        interpret=True))
    got = k9_sharded(xt, pt, s, tp)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5, atol=5e-5)


def test_k9_sharded_matches_pallas_interpret_bf16():
    B, s, C, hid, tp = 2, 8, 64, 256, 2
    _, pt, x, p = _k9(B, s, C, hid, seed=23)
    xb, xt = _bf16(x)
    want = np.asarray(fused_mixffn_skip(
        xb, *map(jnp.asarray, p), s=s, hidden=hid, interpret=True),
        np.float32)
    got = k9_sharded(xt, pt, s, tp).float().numpy()
    assert np.abs(got - want).max() <= 2 * ULP * np.abs(want).max()


@pytest.fixture(scope="module")
def axis1():
    """A model axis of one rank (a gloo group of one process): the
    collectives are identities, the operators and the autograd run."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo",
                            init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        yield ModelAxis(1, 0, dist.group.WORLD)
    finally:
        dist.destroy_process_group()


def _run(fn, leaves, g, **kw):
    """fn's output on fresh leaves, and the leaves' gradients for
    cotangent g (where autograd records)."""
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    out = fn(*leaves, **kw)
    out.backward(g)
    return [out.detach()] + [t.grad for t in leaves]


@pytest.mark.parametrize("mode", ["kernel", "plain"])
def test_k5_sharded_wrapper_matches_plain(axis1, mode):
    """mhca_block_tp with K5 switched on (no_grad: tp_stages through the
    operators' CPU implementations; with grad: the sharded plain version)
    and off, against mhca_block_plain and its autograd."""
    from transception_tpu_torch.ops import kernels
    B, s, C, hid = 1, 4, 64, 256
    xt, a, _, _ = _k5(B, s, C, hid, seed=30)
    cws, cbs = a[6], a[7]
    flat = [xt, *a[:6], *cws, *cbs, *a[8:]]
    nw = len(cws)

    def unflat(fn, **kw):
        def call(*t):
            return fn(*t[:7], list(t[7:7 + nw]), list(t[7 + nw:7 + 2 * nw]),
                      *t[7 + 2 * nw:], s=s, heads=8, **kw)
        return call

    g = torch.randn(B, s * s, C, generator=torch.Generator().manual_seed(0))
    want = _run(unflat(mb.mhca_block_plain), flat, g)
    kernels.reset_launches()
    with kernels.enabled(mode == "kernel"):
        got = _run(unflat(mb.mhca_block_tp, hid_all=hid, axis=axis1), flat,
                   g)
        with torch.no_grad():
            fwd = unflat(mb.mhca_block_tp, hid_all=hid, axis=axis1)(*flat)
    assert kernels.routed_counts().get(mb.TP_NAME, 0) == \
        (2 if mode == "kernel" else 0)
    assert kernels.launch_counts()[mb.TP_NAME] == 0  # the CPU launches none
    assert float((fwd - want[0]).abs().max()) <= \
        1e-6 * float(want[0].abs().max())
    for i, (x, w) in enumerate(zip(got, want)):
        assert float((x - w).abs().max()) <= 2e-6 * float(w.abs().max()), i


@pytest.mark.parametrize("mode", ["kernel", "plain"])
def test_k9_sharded_wrapper_matches_plain(axis1, mode):
    from transception_tpu_torch.ops import kernels
    B, s, C, hid = 2, 8, 32, 128
    xt, pt, _, _ = _k9(B, s, C, hid, seed=31)
    g = torch.randn(B, s * s, C, generator=torch.Generator().manual_seed(1))
    want = _run(mf.mixffn_skip_plain, (xt, *pt), g, s=s)
    kernels.reset_launches()
    with kernels.enabled(mode == "kernel"):
        got = _run(mf.mixffn_skip_tp, (xt, *pt), g, s=s, hid_all=hid,
                   axis=axis1)
        with torch.no_grad():
            fwd = mf.mixffn_skip_tp(xt, *pt, s=s, hid_all=hid, axis=axis1)
    assert kernels.routed_counts().get(mf.SKIP_TP_NAME, 0) == \
        (2 if mode == "kernel" else 0)
    assert kernels.launch_counts()[mf.SKIP_TP_NAME] == 0
    assert float((fwd - want[0]).abs().max()) <= \
        1e-6 * float(want[0].abs().max())
    for i, (x, w) in enumerate(zip(got, want)):
        assert float((x - w).abs().max()) <= 2e-6 * float(w.abs().max()), i


@pytest.mark.parametrize("nq", [96, 48, 192])
def test_k5_sharded_checks_take_the_published_shards(nq):
    """The rank's qkv columns at the published stage-2 and stage-3 shapes
    and tp 2 and 4 (96, 48; 192, 96) pass K5's sharded checks; columns
    that are no multiple of 8 or do not divide 3C are refused."""
    x = torch.zeros(1, 28 * 28, 64, dtype=torch.bfloat16)
    crpe = K5._crpe(64)
    if 3 * 64 % nq == 0:
        mb._check_tp(x, 28, 8, 128, nq, crpe)
    for bad in (44, 100):
        with pytest.raises(ValueError, match="qkv columns"):
            mb._check_tp(x, 28, 8, 128, bad, crpe)
