"""The row-block forms of K2 and K11 (ops/kernels/mixffn.py) that the
bridge's sequence sharding runs, through their plain versions on the CPU:
a block of map rows with its halo rows (mixffn.halo_rows), run as a map of
its own, keeps its interior rows. Every partition of an s-row map into
blocks (first, middle and last blocks; heights 1 to s/2 + 2; one LN group
and several) gives the full map's output rows, and the blocks' backwards
(the cotangent zero on the halo rows), each scattered to the rows it read
and summed as the model axis sums them, give the full map's gradients;
both also against the Pallas kernels in interpret mode on the full map
(fused_mixffn_ln_skip, fused_mixffn_ln_skip_bwd), sliced. The module
path (MixFFNSkip.folded and its unfolded call with rows=) gives the
same rows, and a block whose halo rows are dropped does not.

Tolerances: against the full-map plain version, fp32 within 1e-6 of each
output's largest value (the same chain; the backward's sums in another
order); against Pallas interpret, the full-map plain version's own limits
(tests/test_torch_mixffn.py, tests/test_torch_mixffn_bwd.py: 5e-5
relative / 1e-4 absolute forward, 2e-4 every gradient; bf16 within 2
bf16 ulps of the output's scale forward and 2% of each gradient's max).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)
from test_torch_mixffn_bwd import NAMES, _inputs, _jax_layout, _port

from transception_tpu.ops.pallas.mixffn_kernel import (
    fused_mixffn_ln_skip,
    fused_mixffn_ln_skip_bwd,
)
from transception_tpu_torch.ops.kernels import mixffn as mf

TOL = 1e-6
# Cut points of an 8-row map: blocks of 1, 2 and 4 rows (tp 8, 4, 2), and
# uneven blocks up to s/2 + 2 = 6 rows.
CUTS = ((0, 1, 2, 3, 4, 5, 6, 7, 8), (0, 2, 4, 6, 8), (0, 4, 8), (0, 3, 8),
        (0, 6, 8), (0, 1, 7, 8))
SHAPES = ((8, 32, 64, 1), (8, 64, 128, 2))


def _blocks(cuts):
    return list(zip(cuts[:-1], cuts[1:]))


def _block_forward(x, pt, s, groups, r0, r1):
    """K2's plain version on rows [r0, r1) with their halo rows: the
    block's rows."""
    a, b = mf.halo_rows(s, r0, r1)
    lts, ltb = pt[0][:x.shape[-1] // groups], pt[1][:x.shape[-1] // groups]
    out = mf.mixffn_ln_skip_plain(x[:, a * s:b * s], lts, ltb, *pt[2:], s=s,
                                  groups=groups)
    return out[:, (r0 - a) * s:(r1 - a) * s]


def _blocks_backward(x, g, pt, s, groups, cuts):
    """K11's plain version on each block with its halo rows, the cotangent
    the block's rows of g (zero on the halo rows): dx scattered to the
    rows each block read and summed, the parameters' gradients summed."""
    acc = None
    for r0, r1 in _blocks(cuts):
        a, b = mf.halo_rows(s, r0, r1)
        ge = torch.zeros_like(x[:, a * s:b * s])
        ge[:, (r0 - a) * s:(r1 - a) * s] = g[:, r0 * s:r1 * s]
        gb = mf.mixffn_ln_skip_bwd_plain(x[:, a * s:b * s], *pt, ge, s=s,
                                         groups=groups)
        if acc is None:
            acc = [torch.zeros_like(x)] + [torch.zeros_like(t)
                                           for t in gb[1:]]
        acc[0][:, a * s:b * s] += gb[0]
        for i in range(1, len(gb)):
            acc[i] += gb[i]
    return acc


@pytest.mark.parametrize("cuts", CUTS)
@pytest.mark.parametrize("s,C,hid,groups", SHAPES)
def test_blocks_give_the_full_map(s, C, hid, groups, cuts):
    x, g, p = _inputs(2, s, C, hid, groups, seed=len(cuts))
    xt, gt, pt = torch.from_numpy(x), torch.from_numpy(g), _port(p)
    lts, ltb = pt[0][:C // groups], pt[1][:C // groups]
    full = mf.mixffn_ln_skip_plain(xt, lts, ltb, *pt[2:], s=s, groups=groups)
    for r0, r1 in _blocks(cuts):
        got = _block_forward(xt, pt, s, groups, r0, r1)
        assert float((got - full[:, r0 * s:r1 * s]).abs().max()) <= \
            TOL * float(full.abs().max()), (r0, r1)
    want = mf.mixffn_ln_skip_bwd_plain(xt, *pt, gt, s=s, groups=groups)
    got = _blocks_backward(xt, gt, pt, s, groups, cuts)
    for n, a, b in zip(NAMES, got, want):
        assert float((a - b).abs().max()) <= TOL * float(b.abs().max()), n


def test_blocks_match_pallas_interpret_fp32():
    s, C, hid, groups, cuts = 8, 64, 256, 1, (0, 3, 8)
    x, g, p = _inputs(2, s, C, hid, groups, seed=40)
    xt, gt, pt = torch.from_numpy(x), torch.from_numpy(g), _port(p)
    want = np.asarray(fused_mixffn_ln_skip(
        jnp.asarray(x), *map(jnp.asarray, p), s=s, hidden=hid, groups=groups,
        interpret=True))
    for r0, r1 in _blocks(cuts):
        np.testing.assert_allclose(
            _block_forward(xt, pt, s, groups, r0, r1).numpy(),
            want[:, r0 * s:r1 * s], rtol=5e-5, atol=1e-4)
    wantg = fused_mixffn_ln_skip_bwd(
        jnp.asarray(x), *map(jnp.asarray, p), jnp.asarray(g), s=s,
        hidden=hid, groups=groups, interpret=True)
    gotg = _jax_layout(_blocks_backward(xt, gt, pt, s, groups, cuts))
    for n, a, b in zip(NAMES, gotg, wantg):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4, atol=2e-4,
                                   err_msg=n)


def test_blocks_match_pallas_interpret_bf16():
    s, C, hid, groups, cuts = 8, 128, 512, 2, (0, 1, 7, 8)
    x, g, p = _inputs(2, s, C, hid, groups, seed=41)
    xb, gb = (jnp.asarray(a, jnp.bfloat16) for a in (x, g))
    xt, gt = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
              for a in (xb, gb))
    pt = _port(p)
    want = np.asarray(fused_mixffn_ln_skip(
        xb, *map(jnp.asarray, p), s=s, hidden=hid, groups=groups,
        interpret=True), np.float32)
    for r0, r1 in _blocks(cuts):
        got = _block_forward(xt, pt, s, groups, r0, r1).float().numpy()
        assert np.abs(got - want[:, r0 * s:r1 * s]).max() <= \
            2 * 2.0 ** -8 * np.abs(want).max(), (r0, r1)
    wantg = fused_mixffn_ln_skip_bwd(
        xb, *map(jnp.asarray, p), gb, s=s, hidden=hid, groups=groups,
        interpret=True)
    gotg = _jax_layout(_blocks_backward(xt, gt, pt, s, groups, cuts))
    for n, a, b in zip(NAMES, gotg, wantg):
        b = np.asarray(b, np.float32)
        assert np.abs(a - b).max() <= 0.02 * np.abs(b).max(), n


@pytest.mark.parametrize("fold", [True, False])
def test_module_rows_give_the_full_map(fold):
    """MixFFNSkip.folded(..., rows=) and its unfolded call with rows= (the
    bridge layer's two FFN paths) on each block of a 4-way split, forward
    and the blocks' summed backward, against the whole map."""
    from transception_tpu_torch.ops.common import (
        LayerNorm,
        MixFFNSkip,
        init_weights,
    )
    s, C, groups = 8, 32, 2
    torch.manual_seed(0)
    ffn = MixFFNSkip(C, 4 * C, dtype=torch.float32)
    ln = LayerNorm(C // groups, dtype=torch.float32)
    init_weights(ffn, torch.Generator().manual_seed(1))
    with torch.no_grad():
        ln.weight.uniform_(0.5, 1.5)
        ln.bias.normal_(0.0, 0.1)
    x = torch.randn(2, s * s, C)
    g = torch.randn(2, s * s, C)

    def run(rows=None):
        xl = x.clone().requires_grad_(True)
        out = (ffn.folded(xl, s, ln, groups=groups, rows=rows) if fold
               else ffn(xl, s, s, rows=rows))
        r0, r1 = rows or (0, s)
        out.backward(g[:, r0 * s:r1 * s])
        grads = [xl.grad] + [p.grad.clone() for p in ffn.parameters()] + (
            [ln.weight.grad.clone(), ln.bias.grad.clone()] if fold else [])
        ffn.zero_grad()
        ln.zero_grad()
        return out.detach(), grads

    full, want = run()
    acc = None
    for r0, r1 in _blocks((0, 2, 4, 6, 8)):
        out, grads = run((r0, r1))
        assert float((out - full[:, r0 * s:r1 * s]).abs().max()) <= \
            TOL * float(full.abs().max())
        acc = grads if acc is None else [a + b for a, b in zip(acc, grads)]
    for i, (a, b) in enumerate(zip(acc, want)):
        assert float((a - b).abs().max()) <= TOL * float(b.abs().max()), i


def test_dropped_halo_rows_change_the_block():
    """The planted fault: a block run without its halo rows (zero-padded
    at the cut) does not give the full map's rows."""
    s, C, hid, groups = 8, 64, 256, 1
    x, _, p = _inputs(2, s, C, hid, groups, seed=42)
    xt, pt = torch.from_numpy(x), _port(p)
    full = mf.mixffn_ln_skip_plain(xt, pt[0], pt[1], *pt[2:], s=s)
    got = mf.mixffn_ln_skip_plain(xt[:, 2 * s:4 * s], pt[0], pt[1], *pt[2:],
                                  s=s)
    assert float((got - full[:, 2 * s:4 * s]).abs().max()) > \
        1e-3 * float(full.abs().max())


def test_halo_rows_and_block_plans():
    """halo_rows stops at the map's edges; the plans count the block's
    tokens (rows x s) and check_block takes the bridge's blocks at the
    published widths and refuses groups K2 does not take."""
    assert mf.halo_rows(56, 0, 28) == (0, 29)
    assert mf.halo_rows(56, 28, 56) == (27, 56)
    assert mf.halo_rows(28, 7, 14) == (6, 15)
    assert mf.halo_rows(4, 1, 2) == (0, 3)
    fp = mf.fwd_plan(24, 56, 64, 256, 132, rows=29)
    assert fp["gemms"]["fc1"][0] == 24 * 29 * 56
    assert fp["blocks"]["rows"] == 24 * 29
    assert fp["workspace"]["h"] == 24 * 29 * 56 * 256 * 2
    bp = mf.bwd_plan(24, 28, 128, 512, 132, es=4, rows=9)
    assert bp["gemms"]["h"][0] == 24 * 9 * 28
    assert bp["walk_partials"] == 24 * -(-28 // 8)
    assert mf.fwd_plan(24, 56, 64, 256, 132) == \
        mf.fwd_plan(24, 56, 64, 256, 132, rows=56)
    for s, m, rows in ((56, 1, 29), (28, 2, 15), (14, 5, 8), (56, 1, 16),
                       (28, 2, 9)):
        for dt in (torch.bfloat16, torch.float32):
            mf.check_block(24, rows, s, 64 * m, 256 * m, m, dt)
    with pytest.raises(ValueError, match="multiples of 64 channels"):
        mf.check_block(24, 5, 8, 16, 64, 1, torch.float32)
