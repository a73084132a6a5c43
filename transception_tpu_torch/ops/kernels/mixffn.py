"""Fused MixFFN_skip with the caller's LayerNorm and the residual folded in,
and its backward; the unfolded MixFFN_skip alone.

K2 replaces transception_tpu/ops/pallas/mixffn_kernel.py:342
`fused_mixffn_ln_skip` (pallas_call at :361): x + fc2(GELU(LN(dw3x3(h) +
h))), h = fc1(groupLN(x)), on the ETB maps (B, 56², 64) hidden 256,
(B, 28², 128) hidden 512 and (B, 14², 320) hidden 1280 (groups = 1), and in
the flash train mode also on the MHCA maps and the bridge scales, where the
bridge's norm2 folds in as a grouped LN (groups 2 and 5, 64 channels each).
(On the TPU the 14² pair runs in XLA, mixffn_kernel.py:35-70; Hopper has
no such limit.) K11 replaces its backward, mixffn_kernel.py:659
`fused_mixffn_ln_skip_bwd` (pallas_call at :682). The two form one
torch.autograd.Function.

K2 bound on the H100: near the ridge. At (32, 3136, 64) hidden 256 bytes
(x read and the output written once, 25.7 MB: 7.7 us at 3.35 TB/s,
against 4·T·C·hidden + 18·T·hidden = 7.0 GFLOP: 7.1 us at the bf16 peak),
at the 28² and 14² shapes operations. What it takes in practice is the
hidden state: the 3x3 conv and the LN over the hidden width need the
hidden state of a map row and its neighbours, which a Hopper block cannot
hold for a whole map as the TPU's VMEM does.

K2 design (csrc/mixffn.cu on csrc/mixffn_stages.cuh): a block per (map
row, batch) would hold the row's hidden state in ~160 KB of shared memory
(one block an SM), run fc1 over 3 normalised rows and fc2 over 16 padded
rows and read both weight matrices from L2 in every block; at the
stage-3 shapes such a kernel lost to its own plain version. So K2 runs
as three stages over the whole batch, each of which fills the card, with h and a (T x hidden bf16 each, 98 MiB at (32,
3136, 64, 256)) in device memory for the length of one call: (1) fc1 as
the tiled tensor-core product that K11 runs (128- or 64-wide output
tiles, cp.async ring of swizzled panels, ldmatrix, mma.sync), with the
caller's (grouped) LN computed per block into the product's A panel, so
xn never reaches device memory, and the bias in the epilogue: h =
bf16(LN(x)·w1ᵀ + b1) (x's rows staged for the whole depth by cp.async,
normalised in place, eight lanes a row); (2) per (map row, batch), a thread
per pair of hidden channels and 8 columns loads its 3 x 10 window of h at
once, with the taps in registers: d = bf16(conv3x3(h) + dwb) and y = d + h
go to shared memory, then a warp per token takes the hidden LN, z =
bf16(LN(y)) and a = bf16(GELU(z)) in the erfc form of jax.nn.gelu; (3) fc2
as the same product with the epilogue bf16(bf16(a·w2ᵀ + b2) + x), read and
written through a shared-memory tile in 16-byte pieces. Three launches a
call; `fwd_plan` picks the
tiles (at least a block per SM in every stage at the model's shapes) and
sizes the workspace. Rounding points are the Pallas kernel's, the
depthwise weight rounded to bf16 as it does.

K2 at fp32 (the published eval protocol's dtype; the Pallas kernel is
dtype-generic): the same three stages with fp32 activations, weights and
workspace (csrc/mixffn.cu mixffn_ln_skip_f32), every rounding point the
identity. Hopper has no fp32 tensor-core product, so the products run on
the CUDA cores (mixffn_stages.cuh on bsa::ffma_step: FFMA from the same
swizzled panels, 32 deep a step, the bf16 path's accumulator layout and
epilogues); bound: operations at 67 TFLOP/s of FFMA. `fwd_plan(...,
es=4)` sizes the fp32 panels and workspace.

K11 bound on the H100: operations at the train shapes (five products of
2·T·C·hidden flops over T = B·N tokens: at (24, 56², 64, 256) 1.2e10
flops, 0.012 ms, against ≈ 29 MB of bf16 inputs and outputs, 0.009 ms).

K11 design (csrc/mixffn_bwd.cu): few tokens per map row and a wide
hidden layer leave a block per map row short of the card's SMs, and
blocks cannot carry the weight gradients across the batch as the TPU's
grid does. So the backward is a chain of stages over the whole batch,
each of which fills the card, with the hidden intermediates in device
memory for the length of one launch (`bwd_plan` sizes them): xn =
groupLN(x); h = bf16(xn·w1ᵀ + b1) and da = g·w2 as tiled products; the
depthwise conv d = bf16(conv3x3(h) + dwb) as a column walk (a warp per
map column moving a 3 x 3 window of h down the map, a lane per channel,
so each step loads one new row of three); a rows kernel per tile of 8
tokens over the whole hidden width (y = d + h, the hidden LN's
statistics, z, GELU′, the LN backward's two means, dy over da, a =
bf16(GELU(z)), per-block partials of dls, dlb and ddwb); the depthwise
transpose as the same column walk over dy and h (dh = dy + the
correlation of dy with the taps, rounded to bf16 as a tensor-core
operand, per-block partials of the nine tap gradients and db1); dxn =
dh·w1, and dw1 = dhᵀ·xn and dw2 = gᵀ·a with the token dimension split
into a fixed number of fp32 partials; the group-LN backward per token
(dx + g, per-block partials of dlts, dltb, db2); and a fixed-order sum
of each set of partials (no atomics, the same bits in every launch). The
products are K2's tiled product (csrc/mixffn_stages.cuh): 128- or 64-wide
output tiles of 8 warps, 64-deep operand tiles staged with cp.async in a
3-deep ring of swizzled panels, ldmatrix fragments and mma.sync with fp32
accumulation. Rounding
points: h, the conv output, z and a in bf16, dh rounded as an operand of
dxn and dw1, everything else fp32; a = bf16(z·Φ(z)) in the plain
backward's form.

K9 replaces transception_tpu/ops/pallas/mixffn_kernel.py:285
`fused_mixffn_skip` (pallas_call at :297): fc2(GELU(LN(dw3x3(h) + h))),
h = fc1(x), with neither the caller's LN nor the residual. The train step
with use_pallas_train runs it in the MHCA blocks whose drop-path rate is
above 0 (their FFN fold would hide the drop path): (24, 28², 64) hidden
256 and (24, 14², 128) hidden 512. (The TPU gate takes only 28² there,
mixffn_kernel.py:35-71 with whole_map=False; the port follows `takes`, as
K2 does.) Its backward is autograd of the plain version recomputed from
the saved inputs (_build.with_plain_backward), as JAX mixffn.py:80-84.

K9 bound on the H100: near the ridge at both shapes. At (24, 28², 64)
bytes (x in and out once, 4.8 MB: 1.4 us, against 4·N·C·hidden = 1.2
GFLOP: 1.2 us); at (24, 14², 128) operations (the same 1.2 GFLOP against
2.7 MB).

K9 design: K2's stages, the BARE instantiation of the same forward chain
(csrc/mixffn_stages.cuh ffn::forward): fc1 stages x as it is instead of
normalising it, and fc2's epilogue adds no residual. Three launches a
call, with K2's plan (`fwd_plan`).

K11 and K9 at fp32 (the fp32 train step's: K11 at every flash fold, K9
in the "pallas" mode's drop-path blocks): the same stages at E = float
(csrc/mixffn_bwd.cu mixffn_ln_skip_bwd_f32, csrc/mixffn.cu
mixffn_skip_f32), every rounding point the identity, the products on the
CUDA cores through the tiled product's fp32 step (bsa::ffma_step), the
plans sized with es=4 (`bwd_plan`, `bwd_smem_bytes`, `fwd_plan`). Bound:
operations at 67 TFLOP/s of FFMA.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from transception_tpu_torch.ops.common import gelu, group_ln
from transception_tpu_torch.ops.kernels import _build

NAME = "mixffn"
REPLACES = "transception_tpu/ops/pallas/mixffn_kernel.py:342"
BWD_NAME = "mixffn_bwd"
BWD_REPLACES = "transception_tpu/ops/pallas/mixffn_kernel.py:659"
SKIP_NAME = "mixffn_skip"
SKIP_REPLACES = "transception_tpu/ops/pallas/mixffn_kernel.py:285"
SMEM_LIMIT = 232448  # bytes a block may opt into on sm_90
# The tiling of the shared product and of K11, BIG/SMALL (output tile
# sides), BK (product depth), THREADS of csrc/mixffn_stages.cuh and TT
# (tokens per rows-kernel tile), CH of csrc/mixffn_bwd.cu
# (tests/test_torch_mixffn_bwd_plan.py holds the copies equal).
BWD_TILES = (128, 64)
BWD_DEPTH = 64
BWD_TOKEN_TILE = 8
BWD_CHANNELS = 32  # CH: channels of a column-walk block, a lane each
BWD_THREADS = 256
BWD_BLOCKS_PER_SM = 4  # rows and LN-backward blocks per SM
BWD_SPLIT_BLOCKS_PER_SM = 2  # blocks per SM of the smaller split product
BWD_SPLIT_BYTES = 64 << 20  # cap on the split products' fp32 partials
GEMM_STAGES = 3  # GSTAGES: the products' cp.async ring depth
FWD_SEGMENT = 8  # SEG: map columns of a forward rows-stage work item
launches = 0
bwd_launches = 0
skip_launches = 0


def mixffn_plain(x, w1, b1, dw, dwb, ls, lb, w2, b2, *, s: int,
                 pre_ln=None, residual: bool = False, eps: float = 1e-5):
    """Plain MixFFN_skip with the Pallas kernel's rounding points
    (mixffn.py:33 _reference_impl, :122 _reference_impl_ln; the depthwise
    weight rounded to the compute dtype as in mixffn_kernel.py:333).
    Weights are torch layouts: w1 (hidden, C), dw (hidden, 1, 3, 3),
    w2 (C, hidden). pre_ln = (scale, bias, groups, eps) with the (C,)-tiled
    scale and bias, or None."""
    dt = x.dtype
    B, N, C = x.shape
    hid = w1.shape[0]
    xin = x
    if pre_ln is not None:
        lts, ltb, groups, peps = pre_ln
        xin = group_ln(x, lts, ltb, groups, peps)
    h = F.linear(xin.float(), w1.to(dt).float(), b1.float()).to(dt)
    hm = h.float().reshape(B, s, s, hid).permute(0, 3, 1, 2)
    d = F.conv2d(hm, dw.to(dt).float(), dwb.float(), padding=1, groups=hid)
    d = d.permute(0, 2, 3, 1).reshape(B, N, hid).to(dt)
    y = d.float() + h.float()
    mean = y.mean(-1, keepdim=True)
    var = (y * y).mean(-1, keepdim=True) - mean * mean
    a = ((y - mean) * torch.rsqrt(var + eps) * ls.float()
         + lb.float()).to(dt)
    a = gelu(a)
    out = F.linear(a.float(), w2.to(dt).float(), b2.float()).to(dt)
    if residual:
        out = (out.float() + x.float()).to(dt)
    return out


def mixffn_skip_plain(x, w1, b1, dw, dwb, ls, lb, w2, b2, *, s: int,
                      eps: float = 1e-5):
    """Plain K9: fc2(GELU(LN(dw3x3(h) + h))), h = fc1(x), with the Pallas
    kernel's rounding points (the depthwise weight rounded to the compute
    dtype, mixffn_kernel.py:334)."""
    return mixffn_plain(x, w1, b1, dw, dwb, ls, lb, w2, b2, s=s, eps=eps)


def mixffn_ln_skip_plain(x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2, *,
                         s: int, groups: int = 1, eps_ln: float = 1e-5,
                         eps: float = 1e-5):
    """Plain version of the folded kernel: x + mixffn(groupLN(x)), with the
    caller's (C/groups,) LN scale and bias."""
    return mixffn_plain(x, w1, b1, dw, dwb, ls, lb, w2, b2, s=s,
                        pre_ln=(lts.repeat(groups), ltb.repeat(groups),
                                groups, eps_ln),
                        residual=True, eps=eps)


def mixffn_ln_skip_bwd_plain(x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2,
                             g, *, s: int, groups: int = 1,
                             eps_ln: float = 1e-5, eps: float = 1e-5):
    """Plain backward of x + mixffn(groupLN(x)) for cotangent g, with the
    Pallas backward's math (mixffn_kernel.py:479-653): fp32 throughout, the
    dtype casts passed straight through, the forward recomputed with h, d
    and the LN output rounded where the kernel rounds them and the
    depthwise weight in the compute dtype (:735). lts/ltb are the (C,)-
    tiled scale and bias. Returns the grads of (x, lts, ltb, w1, b1, dw,
    dwb, ls, lb, w2, b2) in their torch layouts: dx in x's dtype, the rest
    in the parameters' dtypes."""
    f32, dt = torch.float32, x.dtype
    B, N, C = x.shape
    hid = w1.shape[0]
    gsz = C // groups
    xf, gf = x.to(f32), g.to(f32)
    w1f, w2f = w1.to(dt).to(f32), w2.to(dt).to(f32)
    dwk = dw.to(dt).to(f32)
    lsf, lbf, ltsf = ls.to(f32), lb.to(f32), lts.to(f32)

    # Forward recompute.
    xr = xf.reshape(B, N, groups, gsz)
    mu = xr.mean(-1, keepdim=True)
    inv = torch.rsqrt((xr * xr).mean(-1, keepdim=True) - mu * mu + eps_ln)
    yhx = (xr - mu) * inv
    xn = (yhx.reshape(B, N, C) * ltsf + ltb.to(f32)).to(dt).to(f32)
    h = (xn @ w1f.t() + b1.to(f32)).to(dt).to(f32)
    hm = h.reshape(B, s, s, hid).permute(0, 3, 1, 2)
    d = F.conv2d(hm, dwk, dwb.to(f32), padding=1, groups=hid)
    d = d.permute(0, 2, 3, 1).reshape(B, N, hid).to(dt).to(f32)
    y = d + h
    muy = y.mean(-1, keepdim=True)
    invy = torch.rsqrt((y * y).mean(-1, keepdim=True) - muy * muy + eps)
    yh = (y - muy) * invy
    z = (yh * lsf + lbf).to(dt).to(f32)
    half1e = 0.5 * (1.0 + torch.erf(z * 2.0 ** -0.5))
    a = (z * half1e).to(dt).to(f32)
    gp = half1e + z * torch.exp(-0.5 * z * z) * (2.0 * torch.pi) ** -0.5

    # Backward through fc2, GELU and the hidden LN.
    da = gf @ w2f
    dz = da * gp
    dyh = dz * lsf
    dy = invy * (dyh - dyh.mean(-1, keepdim=True)
                 - yh * (dyh * yh).mean(-1, keepdim=True))
    # The conv transpose: a correlation of the padded dd with the taps.
    ddp = F.pad(dy.reshape(B, s, s, hid).permute(0, 3, 1, 2), (1, 1, 1, 1))
    hp = F.pad(hm, (1, 1, 1, 1))
    dhc = torch.zeros_like(hm)
    ddw = torch.zeros(hid, 3, 3, dtype=f32, device=x.device)
    ddm = ddp[:, :, 1:1 + s, 1:1 + s]
    for di in range(3):
        for dj in range(3):
            tap = dwk[:, 0, di, dj].reshape(1, hid, 1, 1)
            dhc += ddp[:, :, 2 - di:2 - di + s, 2 - dj:2 - dj + s] * tap
            ddw[:, di, dj] = (ddm * hp[:, :, di:di + s, dj:dj + s]).sum(
                (0, 2, 3))
    dh = dy + dhc.permute(0, 2, 3, 1).reshape(B, N, hid)

    # Backward through fc1 and the group LN, plus the residual path.
    dxn = dh @ w1f
    dyhx = (dxn * ltsf).reshape(B, N, groups, gsz)
    dx = inv * (dyhx - dyhx.mean(-1, keepdim=True)
                - yhx * (dyhx * yhx).mean(-1, keepdim=True))
    dx = dx.reshape(B, N, C) + gf

    def flat(t):
        return t.reshape(-1, t.shape[-1])

    grads = (dx.to(dt),
             (dxn * yhx.reshape(B, N, C)).sum((0, 1)), dxn.sum((0, 1)),
             flat(dh).t() @ flat(xn), dh.sum((0, 1)),
             ddw.reshape(hid, 1, 3, 3), dy.sum((0, 1)),
             (dz * yh).sum((0, 1)), dz.sum((0, 1)),
             flat(gf).t() @ flat(a), gf.sum((0, 1)))
    params = (x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2)
    return tuple(gr.to(p.dtype) for gr, p in zip(grads, params))


def gemm_smem(aln: bool, bm: int, bn: int, K: int, es: int = 2) -> int:
    """Shared memory of one block of the tiled product over elements of es
    bytes (mirrors ffn::gemm_smem in csrc/mixffn_stages.cuh): a 3-deep ring
    of A and B tiles of 128-byte rows (64 bf16 or 32 fp32 deep), or with
    the caller's LN folded in (aln) A's whole normalised panel (K rounded
    up to the step depth) and a ring of B tiles; the epilogue's output tile
    (padded rows) reuses it."""
    kd = 128 // es
    ring_b = GEMM_STAGES * bn * 128
    if aln:
        ops = bm * -(-K // kd) * kd * es + ring_b
    else:
        ops = GEMM_STAGES * bm * 128 + ring_b
    return max(ops, bm * (bn + 8) * es)


def rows_smem(s: int, hid: int) -> int:
    """Shared memory of one block of the forward's conv/rows stage (mirrors
    ffn::rows_smem): y of a map row, fp32."""
    return s * hid * 4


def fwd_smem_bytes(s: int, C: int, hid: int, es: int = 2) -> int:
    """The most shared memory any block of K2's, K9's or K5's FFN stages
    takes over elements of es bytes, at the largest tiles: fc1 with the
    folded LN, the product ring, the conv/rows stage."""
    big = BWD_TILES[0]
    return max(gemm_smem(True, big, big, C, es),
               gemm_smem(False, big, big, 0, es), rows_smem(s, hid))


def takes(s: int) -> bool:
    """Whether a fold on an s x s map runs K2: even sides only, where the
    JAX package runs its kernel (mixffn_kernel.py _pick_rows rejects odd
    sides). A routing by shape, made before the call; a map the kernel
    cannot take raises in the wrapper."""
    return s % 2 == 0


def bwd_smem_bytes(C: int, hid: int, es: int = 2) -> int:
    """Largest shared memory of a K11 block over elements of es bytes
    (mirrors csrc/mixffn_bwd.cu): the rows kernel's y and dz of a token
    tile over the hidden width, its three column partials and reductions
    (rows_smem, fp32 at either es); the LN backward's per-warp column
    partials; a 128 x 128 product's 3-deep operand ring or its epilogue
    tile (gemm_smem)."""
    nw, tt = BWD_THREADS // 32, BWD_TOKEN_TILE
    rows = (2 * tt * hid + 3 * hid + 2 * tt * BWD_THREADS + tt * 4) * 4
    lnb = 3 * nw * C * 4
    big = BWD_TILES[0]
    return max(rows, lnb, gemm_smem(False, big, big, 0, es))


def _blocks(M, N, bm, bn):
    return -(-M // bm) * -(-N // bn)


def _side(n):
    """An output tile side: BIG where it divides n, else SMALL."""
    big, small = BWD_TILES
    return big if n % big == 0 else small


def token_tile(T, N, sms):
    """The (BM, BN) tile of a product over T token rows and N columns:
    BIG rows first, then SMALL rows, then SMALL columns, until the product
    has a block per SM."""
    big, small = BWD_TILES
    bn = _side(N)
    for bm, bnn in ((big, bn), (small, bn), (small, small)):
        if _blocks(T, N, bm, bnn) >= sms:
            break
    return bm, bnn


def fwd_plan(B: int, s: int, C: int, hid: int, sms: int, es: int = 2
             ) -> dict:
    """The forward plan of K2, K9 and K5's FFN for x (B, s², C), hidden
    `hid`, on a card of `sms` SMs. Products (M, N, K, BM, BN): fc1 (T, hid,
    C) and fc2 (T, C, hid) over the T = B·s² tokens, tiles by `token_tile`;
    the conv/rows stage takes a block per (map row, batch). `plan` is the
    int list the CUDA entries take (ffn::FwdPlan); `blocks` the blocks of
    each stage; `workspace` the bytes of h and a (T x hid elements of es
    bytes each: 2 bf16, 4 for the fp32 form); `smem` the shared memory of a
    block of each stage (fc1 with the LN folded in, K2 and K5, or without,
    K9)."""
    T = B * s * s
    gemms = {"fc1": (T, hid, C) + token_tile(T, hid, sms),
             "fc2": (T, C, hid) + token_tile(T, C, sms)}
    plan = [v for k in ("fc1", "fc2") for v in gemms[k][3:]]
    blocks = {k: _blocks(*g[:2], *g[3:]) for k, g in gemms.items()}
    blocks["rows"] = B * s
    f1, f2 = gemms["fc1"], gemms["fc2"]
    smem = {"fc1_ln": gemm_smem(True, f1[3], f1[4], C, es),
            "fc1": gemm_smem(False, f1[3], f1[4], C, es),
            "rows": rows_smem(s, hid),
            "fc2": gemm_smem(False, f2[3], f2[4], hid, es)}
    return dict(gemms=gemms, plan=plan, blocks=blocks,
                workspace={"h": T * hid * es, "a": T * hid * es}, smem=smem)


def bwd_plan(B: int, s: int, C: int, hid: int, sms: int, es: int = 2
             ) -> dict:
    """K11's launch plan for x (B, s², C), hidden `hid`, on a card of `sms`
    SMs, over elements of es bytes (2 bf16, 4 for the fp32 form). Products (M, N, K): h (T, hid, C), da (T, hid, C), dxn (T, C,
    hid), then dw1 (hid, C, T) and dw2 (C, hid, T) with K split into
    `splits` token ranges of `kper` (whole BWD_DEPTH tiles). An output tile
    side is BIG where it divides the side, else SMALL; the token products
    drop to SMALL rows, then SMALL columns, until they have a block per SM.
    The splits give BWD_SPLIT_BLOCKS_PER_SM blocks per SM to the smaller of
    dw1 and dw2, within BWD_SPLIT_BYTES of partials. The token kernels
    (rows, LN backward) aim at BWD_BLOCKS_PER_SM blocks per SM: each of
    `blocks` blocks takes `tiles_per_block` tiles of BWD_TOKEN_TILE
    tokens, a contiguous range.
    The column walks (conv, depthwise transpose) take a block per (8 map
    columns, batch row, BWD_CHANNELS channels); the transpose writes one
    partial per (batch row, column group): `walk_partials`.
    `plan` is the int list the CUDA entry takes; `workspace` the bytes of
    each intermediate and partial it is handed (xn, h, a and dh in the
    element type, the rest fp32 at either). The split depth is whole
    BWD_DEPTH tiles at both element types (a multiple of the fp32 step's
    32), and the partials are fp32 at both, so BWD_SPLIT_BYTES caps the
    same bytes at fp32."""
    T = B * s * s
    gemms = {"h": (T, hid, C) + token_tile(T, hid, sms),
             "da": (T, hid, C) + token_tile(T, hid, sms),
             "dxn": (T, C, hid) + token_tile(T, C, sms),
             "dw1": (hid, C, T, _side(hid), _side(C)),
             "dw2": (C, hid, T, _side(C), _side(hid))}
    ktiles = -(-T // BWD_DEPTH)
    fewest = min(_blocks(*gemms[k][:2], *gemms[k][3:]) for k in ("dw1",
                                                                 "dw2"))
    most = max(1, BWD_SPLIT_BYTES // (2 * hid * C * 4))
    want = min(ktiles, most, -(-BWD_SPLIT_BLOCKS_PER_SM * sms // fewest))
    kper = -(-ktiles // want) * BWD_DEPTH
    splits = -(-T // kper)
    walk = B * -(-s // (BWD_THREADS // 32))
    tiles = -(-T // BWD_TOKEN_TILE)
    tpb = -(-tiles // (BWD_BLOCKS_PER_SM * sms))
    blocks = -(-tiles // tpb)
    plan = [v for k in ("h", "da", "dxn", "dw1", "dw2")
            for v in gemms[k][3:]] + [splits, kper, blocks, tpb]
    workspace = {"xn": T * C * es, "h": T * hid * es, "da": T * hid * 4,
                 "a": T * hid * es, "dh": T * hid * es, "dxn": T * C * 4,
                 "pw": splits * 2 * hid * C * 4, "pr": blocks * 3 * hid * 4,
                 "pd": walk * 10 * hid * 4, "pl": blocks * 3 * C * 4}
    return dict(gemms=gemms, splits=splits, kper=kper, blocks=blocks,
                tiles_per_block=tpb, walk_partials=walk, plan=plan,
                workspace=workspace)


def _check(x, s, hid, groups, ln=True, dtypes=_build.DTYPES):
    """Raise on what the kernels do not take; ln: the caller's LN is folded
    into fc1 (K2, K5), which takes groups of a multiple of 64 channels;
    dtypes: the element types of the kernel's forms (bf16 and fp32 for
    K2, K5, K9 and K11)."""
    _build.element_dtype(NAME, x, dtypes=dtypes)
    if x.dim() != 3:
        raise ValueError(f"{NAME} kernel takes a (B, N, C) tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    B, N, C = x.shape
    if N != s * s:
        raise ValueError(f"{NAME} kernel needs a square s*s map, N={N}")
    if groups < 1 or C % groups or ln and C // groups % 64:
        raise ValueError(f"{NAME} kernel: {groups} LN groups do not divide "
                         f"C={C} into multiples of 64 channels")
    if C % 16 or hid % 64:
        raise ValueError(f"{NAME} kernel needs C % 16 == 0 and "
                         f"hidden % 64 == 0, got C={C}, hidden={hid}")
    if fwd_smem_bytes(s, C, hid, x.element_size()) > SMEM_LIMIT:
        raise ValueError(f"{NAME} kernel: a map row's hidden state or the "
                         f"normalised panel (s={s}, C={C}, hidden={hid}) "
                         f"exceeds shared memory")


def _fwd_args(x, s, hid):
    """The output, the workspace allocation (held until the launch is
    enqueued) and the entry's trailing arguments (out, h, a, plan) of one
    forward call of K2 or K9 (fwd_plan)."""
    B, _, C = x.shape
    sizes, plan = _fwd_launch_plan(B, s, C, hid, _build.sms(x),
                                   x.element_size())
    out = torch.empty_like(x)
    ws, work = _build.workspace(sizes, x.device)
    return out, ws, [_build.ptr(out)] + work + [plan]


@functools.lru_cache(maxsize=None)
def _fwd_launch_plan(B, s, C, hid, sms, es=2):
    """fwd_plan's workspace sizes and its int list as the entries take it
    (a ctypes array, read only), kept per shape, card and element size."""
    pl = fwd_plan(B, s, C, hid, sms, es)
    return (tuple(pl["workspace"].values()),
            (ctypes.c_int * len(pl["plan"]))(*pl["plan"]))


def _launch(x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2, s, groups, eps_ln,
            eps):
    """K2 on the card (its bf16 or fp32 form, x's dtype); lts/ltb are
    (C,)-tiled. One counted launch runs the three stages of the plan
    (fwd_plan)."""
    hid = w1.shape[0]
    _check(x, s, hid, groups)
    global launches
    x = _build.aligned(x)
    fn = _build.entry(NAME, _build.symbol("mixffn_ln_skip", x.dtype),
                      [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                      + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    B, N, C = x.shape
    bf = functools.partial(_build.weight, dtype=x.dtype)
    f32 = _build.f32
    out, ws, tail = _fwd_args(x, s, hid)
    held = (
        x, f32(lts), f32(ltb), bf(w1), f32(b1), bf(dw.reshape(hid, 9)),
        f32(dwb), f32(ls), f32(lb), bf(w2), f32(b2))
    args = [_build.ptr(t) for t in held] + tail
    rc = fn(*args, B, s, C, hid, groups, eps_ln, eps, _build.stream_of(x))
    _build.check(rc, NAME)
    launches += 1
    _build.tally(NAME, tuple(x.shape), hid, groups, _build.tag(x))
    return out


def _launch_skip(x, w1, b1, dw, dwb, ls, lb, w2, b2, s, eps):
    """K9 on the card: K2's stages without the LN and the residual, its
    bf16 or fp32 form (x's dtype)."""
    hid = w1.shape[0]
    _check(x, s, hid, 1, ln=False)
    global skip_launches
    x = _build.aligned(x)
    fn = _build.entry(NAME, _build.symbol(SKIP_NAME, x.dtype),
                      [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                      + [ctypes.c_float, ctypes.c_void_p])
    B, N, C = x.shape
    bf = functools.partial(_build.weight, dtype=x.dtype)
    f32 = _build.f32
    out, ws, tail = _fwd_args(x, s, hid)
    held = (
        x, bf(w1), f32(b1), bf(dw.reshape(hid, 9)), f32(dwb), f32(ls),
        f32(lb), bf(w2), f32(b2))
    args = [_build.ptr(t) for t in held] + tail
    rc = fn(*args, B, s, C, hid, eps, _build.stream_of(x))
    _build.check(rc, SKIP_NAME)
    skip_launches += 1
    _build.tally(SKIP_NAME, tuple(x.shape), hid, _build.tag(x))
    return out


def mixffn_skip(x, w1, b1, dw, dwb, ls, lb, w2, b2, *, s: int,
                eps: float = 1e-5):
    """K9 wrapper: the plain version with the kernel off or where autograd
    records on the CPU, else K9's operator, whose backward is autograd of
    the plain version."""
    if _build.plain(SKIP_NAME, x):
        return mixffn_skip_plain(x, w1, b1, dw, dwb, ls, lb, w2, b2, s=s,
                                 eps=eps)
    return _build.with_plain_backward(
        lambda *a: SKIP_OP(*a, s, eps),
        lambda *a: mixffn_skip_plain(*a, s=s, eps=eps),
        x, w1, b1, dw, dwb, ls, lb, w2, b2)


def _launch_bwd(x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2, g, s, groups,
                eps_ln, eps):
    """K11 on the card, its bf16 or fp32 form (x's dtype); lts/ltb are
    (C,)-tiled. One counted launch runs every stage of the plan
    (bwd_plan)."""
    hid = w1.shape[0]
    _check(x, s, hid, groups, ln=False)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"{BWD_NAME} kernel needs g like x, got "
                         f"{tuple(g.shape)} {g.dtype}")
    B, N, C = x.shape
    es = x.element_size()
    if bwd_smem_bytes(C, hid, es) > SMEM_LIMIT:
        raise ValueError(f"{BWD_NAME} kernel: a token tile (C={C}, "
                         f"hidden={hid}) exceeds shared memory")
    global bwd_launches
    x, g = _build.aligned(x), _build.aligned(g)
    pl = bwd_plan(B, s, C, hid, _build.sms(x), es)
    dx = torch.empty_like(x)
    grads = torch.empty(2 * hid * C + 13 * hid + 3 * C, device=x.device,
                        dtype=torch.float32)
    # The intermediates and partials in the entry's argument order (xn, h,
    # da, a, dh, dxn, pw, pr, pd, pl).
    ws, work = _build.workspace(pl["workspace"].values(), x.device)
    bf = functools.partial(_build.weight, dtype=x.dtype)
    f = _build.f32
    held = (
        x, g, f(lts), f(ltb), bf(w1), f(b1), bf(dw.reshape(hid, 9)), f(dwb),
        f(ls), f(lb), bf(w2), dx, grads)
    args = [_build.ptr(t) for t in held] + work
    plan = (ctypes.c_int * len(pl["plan"]))(*pl["plan"])
    fn = _build.entry(BWD_NAME, _build.symbol("mixffn_ln_skip_bwd", x.dtype),
                      [ctypes.c_void_p] * 24 + [ctypes.c_int] * 5
                      + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    rc = fn(*args, plan, B, s, C, hid, groups, eps_ln, eps,
            _build.stream_of(x))
    _build.check(rc, BWD_NAME)
    bwd_launches += 1
    _build.tally(BWD_NAME, tuple(x.shape), hid, groups, _build.tag(x))
    sizes = (hid * C, C * hid, hid, 9 * hid, hid, hid, hid, C, C, C)
    dw1, dw2, db1, ddw, ddwb, dls, dlb, db2, dlts, dltb = torch.split(
        grads, sizes)
    grads = (dlts, dltb, dw1.view(hid, C), db1, ddw.view(hid, 1, 3, 3), ddwb,
             dls, dlb, dw2.view(C, hid), db2)
    params = (lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2)
    return (dx,) + tuple(gr.to(p.dtype) for gr, p in zip(grads, params))


def mixffn_ln_skip_bwd(x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2, g, *,
                       s: int, groups: int = 1, eps_ln: float = 1e-5,
                       eps: float = 1e-5):
    """K11 wrapper: the grads of (x, lts, ltb, w1, ..., b2) for cotangent g,
    lts/ltb (C,)-tiled; the plain version with the kernel off or where
    autograd records on the CPU, else K11's operator."""
    if _build.plain(NAME, x):
        return mixffn_ln_skip_bwd_plain(x, lts, ltb, w1, b1, dw, dwb, ls, lb,
                                        w2, b2, g, s=s, groups=groups,
                                        eps_ln=eps_ln, eps=eps)
    return BWD_OP(x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2, g, s,
                  groups, eps_ln, eps)


class MixFFN(torch.autograd.Function):
    """K2 forward and K11 backward (their operators: the plain versions on
    the CPU) of x + mixffn(groupLN(x)) with the (C,)-tiled LN scale and
    bias."""

    @staticmethod
    def forward(ctx, x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2, s, groups,
                eps_ln, eps):
        params = (lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2)
        out = OP(x, *params, s, groups, eps_ln, eps)
        ctx.save_for_backward(x, *params)
        ctx.cfg = (s, groups, eps_ln, eps)
        return out

    @staticmethod
    def backward(ctx, g):
        return tuple(BWD_OP(*ctx.saved_tensors, g, *ctx.cfg)) + (None,) * 4


def mixffn_ln_skip(x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2, *, s: int,
                   groups: int = 1, eps_ln: float = 1e-5, eps: float = 1e-5):
    """x + mixffn(LN(x)): plain version with the kernel off or where
    autograd records on the CPU, else K2's operator, with K11's backward
    (MixFFN) where autograd records. lts/ltb are the caller's (C/groups,)
    LN scale and bias."""
    if _build.plain(NAME, x):
        return mixffn_ln_skip_plain(x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2,
                                    b2, s=s, groups=groups, eps_ln=eps_ln,
                                    eps=eps)
    args = (x, lts.repeat(groups), ltb.repeat(groups), w1, b1, dw, dwb, ls,
            lb, w2, b2, s, groups, eps_ln, eps)
    if _build.needs_graph(*args[:11]):
        return MixFFN.apply(*args)
    return OP(*args)


def _tiled_plain(x, lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2, s, groups,
                 eps_ln, eps):
    """K2's plain version with the operator's signature (lts/ltb tiled)."""
    return mixffn_plain(x, w1, b1, dw, dwb, ls, lb, w2, b2, s=s,
                        pre_ln=(lts, ltb, groups, eps_ln), residual=True,
                        eps=eps)


_FFN = ("Tensor x, Tensor lts, Tensor ltb, Tensor w1, Tensor b1, Tensor dw, "
        "Tensor dwb, Tensor ls, Tensor lb, Tensor w2, Tensor b2")
OP = _build.define(
    NAME, f"({_FFN}, int s, int groups, float eps_ln, float eps) -> Tensor",
    _launch, _tiled_plain, lambda x, *a: x.new_empty(x.shape))
BWD_OP = _build.define(
    BWD_NAME, f"({_FFN}, Tensor g, int s, int groups, float eps_ln, "
    "float eps) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, "
    "Tensor, Tensor, Tensor, Tensor)", _launch_bwd,
    lambda *a: mixffn_ln_skip_bwd_plain(*a[:12], s=a[12], groups=a[13],
                                        eps_ln=a[14], eps=a[15]),
    lambda *a: tuple(t.new_empty(t.shape) for t in a[:11]))
SKIP_OP = _build.define(
    SKIP_NAME, "(Tensor x, Tensor w1, Tensor b1, Tensor dw, Tensor dwb, "
    "Tensor ls, Tensor lb, Tensor w2, Tensor b2, int s, float eps) -> Tensor",
    _launch_skip,
    lambda *a: mixffn_skip_plain(*a[:9], s=a[9], eps=a[10]),
    lambda x, *a: x.new_empty(x.shape))
