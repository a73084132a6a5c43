"""The hidden-sharded forms of K2 and K11 (ops/kernels/mixffn.py tp_*) on
the CPU: each shard's plain stages run in turn in one process and their
partials are summed in rank order, as the model axis sums them, against
the unsharded plain version and against the Pallas kernels in interpret
mode (fused_mixffn_ln_skip, fused_mixffn_ln_skip_bwd); and the sharded
autograd Function (MixFFNTP, its operators' CPU implementations) on a
model axis of one rank against autograd of the unsharded plain forward.

Tolerances: against the unsharded plain version, fp32 within 1e-6 of each
output's largest value (the same chain with the hidden width's sums in
another order); against Pallas interpret, the unsharded plain version's
own limits (tests/test_torch_mixffn.py: 5e-5 relative / 1e-4 absolute
forward; tests/test_torch_mixffn_bwd.py: 2e-4 every gradient), bf16 within
2 bf16 ulps of the output's scale forward and 2% of each gradient's max.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_threads  # noqa: F401 (torch's threads per xdist worker)
from test_torch_mixffn_bwd import NAMES, _inputs, _jax_layout, _port

from transception_tpu.ops.pallas.mixffn_kernel import (
    fused_mixffn_ln_skip,
    fused_mixffn_ln_skip_bwd,
)
from transception_tpu_torch.ops.kernels import mixffn as mf
from transception_tpu_torch.parallel.mesh import free_port
from transception_tpu_torch.parallel.tensor import ModelAxis

EPS = 1e-5


def _shard(p, tp, r):
    """Rank r's shards of the port-layout params (lts, ltb, w1, b1, dw,
    dwb, ls, lb, w2, b2)."""
    lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2 = p
    n = w1.shape[0] // tp
    k = slice(r * n, (r + 1) * n)
    return lts, ltb, w1[k], b1[k], dw[k], dwb[k], ls[k], lb[k], w2[:, k], b2


def sharded_forward(x, p, s, groups, tp):
    """K2's sharded plain stages over tp shards, the partials summed in
    rank order."""
    hid = p[2].shape[0]
    sh = [_shard(p, tp, r) for r in range(tp)]
    part = [mf.tp_fc1_plain(x, *q[:6], s, groups, EPS, hid) for q in sh]
    st = sum(pt[1] for pt in part)
    pp = sum(mf.tp_fc2_plain(h, *q[4:9], st, s, hid, EPS)
             for (h, _), q in zip(part, sh))
    return mf.tp_out_plain(pp, p[9], x), st


def sharded_backward(x, g, p, s, groups, tp):
    """K11's sharded plain stages over tp shards: the port's eleven
    gradients, the shards' pieces concatenated."""
    hid = p[2].shape[0]
    _, st = sharded_forward(x, p, s, groups, tp)
    sh = [_shard(p, tp, r) for r in range(tp)]
    rows = [mf.tp_bwd_rows_plain(x, g, *q[:9], st, s, groups, hid, EPS, EPS)
            for q in sh]
    m = sum(rw[5] for rw in rows)
    dh = [mf.tp_bwd_dh_plain(*rw[:5], g, q[4], q[6], q[2], st, m, s, hid,
                             EPS) for rw, q in zip(rows, sh)]
    dx, dlts, dltb, db2 = mf.tp_bwd_ln_plain(x, g, sum(d[0] for d in dh),
                                             p[0], groups, EPS)

    def cat(i, dim=0, src=dh):
        return torch.cat([d[i] for d in src], dim)

    return (dx, dlts, dltb, cat(1), cat(2), cat(3), cat(4), cat(6, src=rows),
            cat(7, src=rows), cat(5, 1), db2)


def _fwd_inputs(B, s, C, hid, groups, seed, dtype=torch.float32):
    x, g, p = _inputs(B, s, C, hid, groups, seed)
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(g).to(dtype),
            _port(p), p, x, g)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("s,C,hid,groups", [(8, 64, 256, 1),
                                            (4, 128, 512, 2)])
def test_sharded_forward_equals_unsharded_plain(s, C, hid, groups, tp):
    xt, _, pt, _, _, _ = _fwd_inputs(2, s, C, hid, groups, seed=tp)
    want = mf.mixffn_plain(xt, *pt[2:], s=s, pre_ln=(pt[0], pt[1], groups,
                                                     EPS), residual=True)
    got, _ = sharded_forward(xt, pt, s, groups, tp)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("s,C,hid,groups", [(8, 64, 256, 1),
                                            (4, 128, 512, 2)])
def test_sharded_backward_equals_unsharded_plain(s, C, hid, groups, tp):
    xt, gt, pt, _, _, _ = _fwd_inputs(2, s, C, hid, groups, seed=10 + tp)
    want = mf.mixffn_ln_skip_bwd_plain(xt, *pt, gt, s=s, groups=groups)
    got = sharded_backward(xt, gt, pt, s, groups, tp)
    for n, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, n
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max()), n


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_forms_match_pallas_interpret_fp32(tp):
    s, C, hid, groups = 8, 64, 256, 1
    xt, gt, pt, p, x, g = _fwd_inputs(2, s, C, hid, groups, seed=20)
    want = np.asarray(fused_mixffn_ln_skip(
        jnp.asarray(x), *map(jnp.asarray, p), s=s, hidden=hid, groups=1,
        interpret=True))
    got, _ = sharded_forward(xt, pt, s, groups, tp)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5, atol=1e-4)
    wantg = fused_mixffn_ln_skip_bwd(
        jnp.asarray(x), *map(jnp.asarray, p), jnp.asarray(g), s=s,
        hidden=hid, groups=groups, interpret=True)
    gotg = _jax_layout(sharded_backward(xt, gt, pt, s, groups, tp))
    for n, a, b in zip(NAMES, gotg, wantg):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4, atol=2e-4,
                                   err_msg=n)


def test_sharded_forms_match_pallas_interpret_bf16():
    s, C, hid, groups, tp = 8, 128, 512, 2, 2
    x, g, p = _inputs(2, s, C, hid, groups, seed=3)
    xb, gb = (jnp.asarray(a, jnp.bfloat16) for a in (x, g))
    xt, gt = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
              for a in (xb, gb))
    want = np.asarray(fused_mixffn_ln_skip(
        xb, *map(jnp.asarray, p), s=s, hidden=hid, groups=groups,
        interpret=True), np.float32)
    got, _ = sharded_forward(xt, _port(p), s, groups, tp)
    assert np.abs(got.float().numpy() - want).max() <= \
        2 * 2.0 ** -8 * np.abs(want).max()
    wantg = fused_mixffn_ln_skip_bwd(
        xb, *map(jnp.asarray, p), gb, s=s, hidden=hid, groups=groups,
        interpret=True)
    gotg = _jax_layout(sharded_backward(xt, gt, _port(p), s, groups, tp))
    for n, a, b in zip(NAMES, gotg, wantg):
        b = np.asarray(b, np.float32)
        assert np.abs(a - b).max() <= 0.02 * np.abs(b).max(), n


@pytest.fixture(scope="module")
def axis1():
    """A model axis of one rank (a gloo group of one process): the
    collectives are identities, the operators and the Function run."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo",
                            init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        yield ModelAxis(1, 0, dist.group.WORLD)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["kernel", "plain"])
def test_sharded_function_matches_autograd_of_plain(axis1, mode):
    """mixffn_ln_skip_tp with the MixFFN switch on (MixFFNTP over the
    operators' CPU implementations) and off (mixffn_tp_plain), forward and
    every gradient, against autograd of the unsharded plain forward."""
    from transception_tpu_torch.ops import kernels
    s, C, hid, groups = 8, 64, 256, 1
    xt, gt, pt, _, _, _ = _fwd_inputs(2, s, C, hid, groups, seed=30)
    lts, ltb = pt[0][:C // groups], pt[1][:C // groups]

    def run(fn, **kw):
        leaves = [t.clone().requires_grad_(True)
                  for t in (xt, lts, ltb) + pt[2:]]
        out = fn(*leaves, s=s, groups=groups, **kw)
        out.backward(gt)
        return [out.detach()] + [t.grad for t in leaves]

    want = run(mf.mixffn_ln_skip_plain)
    kernels.reset_launches()
    with kernels.enabled(mode == "kernel"):
        got = run(mf.mixffn_ln_skip_tp, hid_all=hid, axis=axis1)
    assert kernels.routed_counts().get(mf.TP_NAME, 0) == (mode == "kernel")
    assert kernels.launch_counts()[mf.TP_NAME] == 0  # the CPU launches none
    for i, (a, b) in enumerate(zip(got, want)):
        assert float((a - b).abs().max()) <= 2e-6 * float(b.abs().max()), i
