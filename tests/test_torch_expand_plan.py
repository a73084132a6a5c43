"""The expand kernels (K4: ops/kernels/expand_head.py, K7:
ops/kernels/patch_expand.py) on the CPU: their launch plans (pure Python,
constants held equal to csrc/expand_stages.cuh), the plain versions in the
pixel-shuffled layout against the JAX package, and the decoder's class
maps and logits against the pre-shuffle route they replace.

Tolerances: fp32 to float reassociation (2e-5 relative and absolute). In
bf16 both sides round the expansion and the output at the same points: at
most 2 bf16 ulps of the output scale. Class ids: the logits are rounded to
bf16 before the argmax, so a near-tie can flip with the fp32 summation
order; at most 0.1% of the ids may differ. The decoder against its
pre-shuffle route: the same plain functions in another order, so equal.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transception_tpu.ops.pallas.expand_kernel import (
    fused_patch_expand,
    fused_patch_expand_argmax,
)
from transception_tpu.ops.pallas.patch_expand import _reference_impl
from transception_tpu_torch.models.decoder import DecoderLayer
from transception_tpu_torch.ops.common import PatchExpand
from transception_tpu_torch.ops.kernels import expand_head as eh
from transception_tpu_torch.ops.kernels import patch_expand as pe

CSRC = pathlib.Path(pe.__file__).resolve().parents[2] / "csrc"
SMS = 132  # an H100 SXM
# (B, N, C, c, p) of every K7 call: the p = 2 expanders of decoders 3/2/1
# at the serving batch (32) and in the "pallas" train step (24), the x4
# expander of decoder 0 when logits are asked for, the card tests' shapes
# and two tails (B·N leaves a partial token tile).
K7_SERVING = [(32, 49, 512, 256, 2), (32, 196, 320, 160, 2),
              (32, 784, 128, 64, 2), (32, 3136, 64, 64, 4)]
K7_OTHER = [(24, 49, 512, 256, 2), (24, 196, 320, 160, 2),
            (24, 784, 128, 64, 2), (2, 49, 512, 256, 2), (2, 50, 128, 64, 2),
            (2, 20, 64, 64, 4), (3, 50, 128, 64, 2), (2, 1000, 64, 64, 4)]
# (B, N, C) of K4: serving, one slice (make_predictor(batch=1)), a tail and
# the card test's shape.
K4_SERVING = [(32, 3136, 64)]
K4_OTHER = [(1, 3136, 64), (2, 1000, 64), (2, 200, 64)]


def _constexpr(path, name):
    return re.findall(rf"constexpr int {name} = (\d+);", path.read_text())


@pytest.mark.parametrize("path,name,value", [
    ("expand_stages.cuh", "THREADS", pe.THREADS),
    ("expand_stages.cuh", "BK", pe.DEPTH),
    ("expand_stages.cuh", "STAGES", pe.STAGES),
    ("expand_stages.cuh", "MAX_CIN", pe.MAX_CIN),
    ("expand_head.cu", "C", eh.WIDTH), ("expand_head.cu", "P", eh.P),
    ("expand_head.cu", "NPAD", eh.MAX_CLASSES)])
def test_constants_match_cuda_source(path, name, value):
    assert _constexpr(CSRC / path, name) == [str(value)]


def test_split_and_widths_match_cuda_source():
    """The warp split by group width and the widths K7 is built for."""
    stages = (CSRC / "expand_stages.cuh").read_text()
    assert "return c <= 64 ? 1 : (c <= 160 ? 2 : 4);" in stages
    assert [pe.warps_n(c) for c in (64, 160, 256)] == [1, 2, 4]
    cases = re.findall(r"case (\d+):\s+return launch<LT, POST, (\d+)>",
                       (CSRC / "patch_expand.cu").read_text())
    assert [int(a) for a, b in cases if a == b] == list(pe.WIDTHS)


def _check_plan(pl, B, N, C, c, p, head):
    G = p * p
    assert pl["smem"] <= pe.SMEM_LIMIT
    assert pl["smem"] == pe.smem_bytes(c, C, not head)
    # Every token in exactly one row tile, the last one partial at most.
    bm, tiles = pl["block_rows"], pl["row_tiles"]
    assert (tiles - 1) * bm < B * N <= tiles * bm
    covered = np.zeros(B * N, np.int64)
    for i in range(tiles):
        covered[i * bm:(i + 1) * bm] += 1
    assert (covered == 1).all()
    # Every group in exactly one split of a tile.
    gpb = pl["groups_per_block"]
    assert pl["splits"] * gpb == G and pl["grid"] == (tiles, pl["splits"])
    assert pl["blocks"] == tiles * pl["splits"]
    # Every LN group whole inside one tile: the tile's N-extent is one
    # group at a time, its c columns split over whole warps of whole pairs
    # of n8 tiles; the strips make the tile's rows.
    strips, wn = pl["warps"]
    assert strips * wn * 32 == pe.THREADS and strips * 16 == bm
    assert wn * pl["warp_cols"] == c and pl["warp_cols"] % 16 == 0
    if head:  # lane t of a quad keeps the ids of groups 4t..4t+3
        assert gpb % 4 == 0


@pytest.mark.parametrize("B,N,C,c,p", K7_SERVING + K7_OTHER)
def test_patch_expand_plan(B, N, C, c, p):
    pl = pe.plan(B, N, C, c, p, SMS)
    _check_plan(pl, B, N, C, c, p, head=False)
    if B >= 24:
        # Serving (b = 32) and train (b = 24) shapes fill the card.
        assert pl["blocks"] >= SMS
    else:
        # The card tests' and tail shapes have so few token tiles that the
        # plan splits the groups as far as they go (at (2, 1000, 64), 16
        # tiles: 8 splits would leave 128 blocks, under one an SM).
        assert pl["splits"] == p * p


@pytest.mark.parametrize("B,N,C", K4_SERVING + K4_OTHER)
def test_expand_head_plan(B, N, C):
    pl = eh.plan(B, N, C, SMS)
    _check_plan(pl, B, N, C, eh.WIDTH, eh.P, head=True)
    if B == 32:
        assert pl["blocks"] >= SMS and pl["splits"] == 1
    else:
        # Fewer than 132 blocks: one slice is 3136 tokens, 25 tiles of 128,
        # and K4 splits its 16 groups at most into 4 quads (100 blocks).
        assert pl["splits"] == 4 and pl["blocks"] < SMS


@pytest.mark.parametrize("B,N,C,c,p", [(32, 49, 512, 256, 2),
                                       (32, 196, 320, 160, 2)])
def test_small_maps_split_groups(B, N, C, c, p):
    """At the small maps the token tiles alone would leave SMs idle (49
    tiles of 32 tokens, 98 of 64): the plan splits the groups."""
    pl = pe.plan(B, N, C, c, p, SMS)
    assert pl["row_tiles"] < SMS and pl["splits"] > 1


def _inputs(B, H, W, C, p, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H * W, C)).astype(np.float32)
    w = (rng.normal(size=(C, p * p * c)) * C ** -0.5).astype(np.float32)
    ls = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    lb = (0.1 * rng.normal(size=c)).astype(np.float32)
    return x, w, ls, lb


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# (H, W, C, p, c): non-square maps, so that a swapped H and W shows.
SHUFFLE_SHAPES = [(4, 6, 128, 2, 64), (2, 3, 64, 4, 64), (7, 7, 320, 2, 160)]


@pytest.mark.parametrize("H,W,C,p,c", SHUFFLE_SHAPES)
def test_shuffled_plain_matches_xla_reference_fp32(H, W, C, p, c):
    x, w, ls, lb = _inputs(2, H, W, C, p, c, seed=4)
    want = np.asarray(_reference_impl(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(ls), jnp.asarray(lb), H, W,
                                      p, c, 1e-5))
    xt, wt, lst, lbt = _t(x, w.T, ls, lb)
    got = pe.patch_expand(xt, wt, lst, lbt, p=p, c=c, shuffle=(H, W))
    assert got.shape == want.shape == (2, p * p * H * W, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("H,W,C,p,c", SHUFFLE_SHAPES[:2])
def test_shuffled_plain_matches_pallas_interpret_bf16(H, W, C, p, c):
    x, w, ls, lb = _inputs(2, H, W, C, p, c, seed=5)
    xj = jnp.asarray(x, jnp.bfloat16)
    pre = np.asarray(fused_patch_expand(
        xj, jnp.asarray(w), jnp.asarray(ls), jnp.asarray(lb), H=H, W=W, p=p,
        c=c, interpret=True), np.float32)
    want = pre.reshape(2, H, W, p, p, c).transpose(0, 1, 3, 2, 4, 5).reshape(
        2, p * p * H * W, c)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    got = pe.patch_expand(xt, *_t(w.T, ls, lb), p=p, c=c, shuffle=(H, W))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() <= 2 * 2.0 ** -8 * np.abs(want).max()


@pytest.mark.parametrize("H,W,ncls", [(8, 6, 9), (6, 8, 2)])
def test_shuffled_head_matches_pallas_interpret(H, W, ncls):
    p, c = 4, 64
    x, w, ls, lb = _inputs(2, H, W, c, p, c, seed=6)
    rng = np.random.default_rng(7)
    hw = (rng.normal(size=(c, ncls)) * c ** -0.5).astype(np.float32)
    hb = (0.1 * rng.normal(size=ncls)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    pre = np.asarray(fused_patch_expand_argmax(
        xj, *map(jnp.asarray, (w, ls, lb, hw, hb)), H=H, W=W, p=p, c=c,
        n_class=ncls, interpret=True))
    want = pre.reshape(2, H, W, p, p).transpose(0, 1, 3, 2, 4).reshape(
        2, p * H, p * W)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    got = eh.expand_head(xt, *_t(w.T, ls, lb, hw.T, hb), p=p, c=c,
                         shuffle=(H, W)).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert (got != want).mean() <= 0.001


def _seeded(module, seed):
    """Every parameter of `module` drawn from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for prm in module.parameters():
            v = rng.normal(size=tuple(prm.shape)) * 0.3
            if prm.dim() == 1:
                v += 1.0  # LN scales and biases around 1
            prm.copy_(torch.from_numpy(v).to(prm.dtype))
    return module


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decoder_maps_and_logits_unchanged(dtype):
    """The last decoder stage's class map and logits against the route
    they replace: the kernels' pre-shuffle results pixel-shuffled after
    the call (tiny config, seeded weights, CPU)."""
    H, dim, ncls = 4, 16, 9
    m = _seeded(DecoderLayer(dim, dim, ncls, is_last=True, dtype=dtype), 1)
    rng = np.random.default_rng(2)
    x1 = torch.from_numpy(rng.normal(size=(2, H * H, 3 * dim))).to(dtype)
    x2 = torch.from_numpy(rng.normal(size=(2, H, H, dim))).to(dtype)
    with torch.no_grad():
        got_ids = m(x1, x2, argmax_head=True)
        got_logits = m(x1, x2)
        t = m.layer_former_2(m.layer_former_1(m.concat_linear(torch.cat(
            [x1, x2.reshape(2, H * H, dim)], -1)), H, H), H, H)
        up, hl = m.layer_up, m.last_layer
        y = pe.patch_expand_plain(t, up.expand.weight, up.norm.weight,
                                  up.norm.bias, p=4, c=dim,
                                  eps=up.norm.eps).reshape(2, H * H, 16, dim)
        if dtype == torch.bfloat16:
            ids = eh.expand_head_plain(
                t, up.expand.weight, up.norm.weight, up.norm.bias,
                hl.weight.reshape(ncls, -1), hl.bias, p=4, c=dim,
                eps=up.norm.eps)
        else:
            ids = hl(y).argmax(-1).to(torch.uint8)
        want_ids = ids.reshape(2, H, H, 4, 4).permute(0, 1, 3, 2, 4).reshape(
            2, 4 * H, 4 * H)
        ys = y.reshape(2, H, H, 4, 4, dim).permute(0, 1, 3, 2, 4, 5)
        want_logits = hl(ys.reshape(2, 4 * H, 4 * H, dim))
    assert got_ids.dtype == torch.uint8 and torch.equal(got_ids, want_ids)
    assert torch.equal(got_logits, want_logits)


def test_patch_expand_module_shuffles_non_square_maps():
    """PatchExpand on a 3 x 5 map: the kernel route's shuffled layout is
    the pre-shuffle result permuted (the JAX rearrange), and pre_shuffle
    keeps (B, N, p², c)."""
    H, W, dim = 3, 5, 32
    m = _seeded(PatchExpand(dim, torch.float32), 3)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, H * W, dim))).float()
    with torch.no_grad():
        got = m(x, H, W)
        pre = m(x, H, W, pre_shuffle=True)
    assert pre.shape == (2, H * W, 4, dim // 2)
    want = pre.reshape(2, H, W, 2, 2, dim // 2).permute(0, 1, 3, 2, 4, 5)
    assert torch.equal(got, want.reshape(2, 4 * H * W, dim // 2))


@pytest.mark.parametrize("kw", [
    dict(ls=torch.zeros(64, dtype=torch.float16)),        # LN dtype
    dict(ls=torch.zeros(32)),                              # LN shape
    dict(lb=torch.zeros(64, dtype=torch.bfloat16)),        # mixed dtypes
    dict(shuffle=(3, 5)),                                  # not a map of N
    dict(C=96),                                            # C % 64
    dict(C=576),                                           # C > 512
])
def test_patch_expand_checks_raise(kw):
    C = kw.pop("C", 128)
    ls = kw.pop("ls", torch.zeros(64))
    lb = kw.pop("lb", torch.zeros(64))
    x = torch.zeros((1, 16, C), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        pe._check(x, torch.zeros(256, C), 2, 64, ls, lb, kw.get("shuffle"))


@pytest.mark.parametrize("p,c,C,hb_dtype", [
    (2, 64, 64, torch.float32),     # not the x4 expand
    (4, 160, 64, torch.float32),    # not 64-wide groups
    (4, 64, 64, torch.bfloat16),    # head weight and bias of two dtypes
    (4, 64, 576, torch.float32),    # C > 512
])
def test_expand_head_checks_raise(p, c, C, hb_dtype):
    x = torch.zeros((1, 16, C), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        eh._check(x, torch.zeros(p * p * c, C), torch.zeros(9, c), p, c,
                  torch.zeros(c), torch.zeros(c),
                  torch.zeros(9, dtype=hb_dtype))


def test_valid_arguments_pass_the_checks():
    x = torch.zeros((2, 12, 64), dtype=torch.bfloat16)
    bf = torch.bfloat16
    pe._check(x, torch.zeros(1024, 64), 4, 64, torch.zeros(64, dtype=bf),
              torch.zeros(64, dtype=bf), (3, 4))
    eh._check(x, torch.zeros(1024, 64), torch.zeros(9, 64), 4, 64,
              torch.zeros(64, dtype=bf), torch.zeros(64, dtype=bf),
              torch.zeros(9), (4, 3))
