"""One whole MHCA block: CPE -> LN1 -> factorized attention + CRPE -> proj
-> residual -> LN2 -> MixFFN_skip -> residual.

Replaces transception_tpu/ops/pallas/mhca_block_kernel.py:200
`fused_mhca_block` (pallas_call at :285). On the serving path: every
block of MHCA stages 2 and 3, (B, 28², 64) 8 heads hidden 256 (9 blocks
per forward) and (B, 14², 128) 8 heads hidden 512 (24 blocks). Like the
TPU kernel it runs where the map side is even; stage 4 (7²) runs the
block's modules, with the linear-attention kernel for its attention.

Bound on the H100: operations, narrowly. At (32, 28², 64) 2.8 GFLOP (the
four products, the CRPE windows, Q · context; 2.8 us at the bf16 peak)
against 6.7 MB of x, out and the weights (2.0 us); at (32, 14², 128) 2.6
GFLOP against 3.6 MB.

Design (csrc/mhca_block.cu on csrc/mixffn_stages.cuh): the TPU kernel
holds one whole (s², C) map and its 4x hidden state in VMEM; on Hopper that
does not fit one block's shared memory (a stage-2 map's fp32 hidden state
alone is 800 KB), and softmax(K) and the per-head contexts reduce over all
tokens. Kernels per 32 tokens leave the taps and q to be re-read from
device memory per output element and the weights per block. So the
block runs as eight stages over the whole batch on one stream, each of
which fills the card, with its intermediates in device memory for the
length of one call (one counted launch): (1) the CPE x1, a block per (map
row, batch), a thread per channel pair and 8 columns with its 3 x 10
window of x loaded at once and the rounded taps in registers; (2) q|k|v on
the tiled tensor-core product that K2 and K11 run, with LN1 folded into
its A panel and the Dense epilogue bf16(bf16(acc) + bf16(b)); (3) per
(head, batch), the column softmax of K over the tokens and the d x d
context, from shared memory (the TPU's block-diagonal mask of the full C x
C Gram becomes a per-head product); (4) per (band of map rows, batch), Q
and V of the band (V with a 3-row, 3-column zero-padded halo) and the
contexts staged in shared memory once, by cp.async; a thread per channel
pair over the band's tokens with its CRPE window's taps rounded to bf16
once into registers, centred in a 7 x 7 grid of zeros so that no warp
splits over the three window sizes (the zero taps add exact zeros); Q ·
context from the staged rows; (5) the proj product with the residual
epilogue x2 = bf16(x1 + bf16(bf16(acc) + bf16(bp))); (6-8) K2's forward
chain on x2 with LN2 (eps 1e-6) folded into fc1 and the residual
(csrc/mixffn_stages.cuh). `plan` picks the product
tiles and the band rows (at least a block per SM in every stage at the
model's shapes). Rounding follows the Pallas kernel: weights rounded to
bf16, fp32 accumulation, bf16 wherever a flax Dense or Conv emits its
output.

The fp32 form (csrc/mhca_block.cu mhca_block_f32, the published eval
protocol's dtype, 11 blocks x 3 paths a forward): the same eight stages
with fp32 activations, weights and workspace and no rounding points; the
products on the CUDA cores (mixffn_stages.cuh's fp32 step), the CRPE taps
of the attention stage in shared memory (`attn_smem(..., es=4)`). `plan(...,
es=4)` sizes it; the band rows stay those of bf16 (130,304 and 129,536
bytes of attention-stage shared memory at the two shapes at b = 32: one
block an SM).

K5's sharded form (`mhca_block_tp`, below): the per-path MHCA layout's
block under the model axis, the same stages as entries with the axis's
gather of q|k|v and sums of the FFN's partials between them.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from transception_tpu_torch.ops.common import group_ln
from transception_tpu_torch.ops.kernels import _build, mixffn

NAME = "mhca_block"
REPLACES = "transception_tpu/ops/pallas/mhca_block_kernel.py:200"
SMEM_LIMIT = 232448  # bytes a block may opt into on sm_90
THREADS = 256        # threads per block of the context and attention stages
HALO = 3             # the widest CRPE window's reach (csrc/mhca_block.cu)
BAND_ROWS = (4, 2)   # map rows per attention block, the most that fills
launches = 0


# The TPU kernel's VMEM budget (transception_tpu/ops/pallas/mixffn_kernel.py
# _VMEM_BUDGET), which decides where the JAX package runs it.
TPU_VMEM_BUDGET = 10 * 1024 * 1024


def takes(s: int, C: int, hid: int, es: int, wmax: int = 7) -> bool:
    """Whether an MHCA block on an s x s map of C channels (FFN width hid,
    elements of es bytes) folds into K5: where the JAX package runs its
    whole-block kernel (mhca_block_kernel.py:56-87 eligible_block): even
    sides, and the TPU kernel's working set within its VMEM budget, which
    the 56² stage of the 4-stage backbone exceeds (11.0 MB at bf16). A
    routing by shape, made before the call."""
    need = ((s + 2) ** 2 * C * 4 + (s + wmax - 1) ** 2 * C * 4
            + (s + 2) ** 2 * hid * 4 + s * s * C * es * 6 + s * s * hid * 4
            + C * (5 * C + 2 * hid) * es)
    return s % 2 == 0 and need <= TPU_VMEM_BUDGET


def _dwconv(xm, w, b, dt):
    """Depthwise conv of an NCHW fp32 map with the weight rounded to dt,
    'same' padding, fp32 bias; fp32 out."""
    k = w.shape[-1]
    return F.conv2d(xm, w.to(dt).float(), b.float(), padding=k // 2,
                    groups=xm.shape[1])


def _dense(t, w, b):
    """flax Dense rounding: bf16(bf16(t · w) + bf16(b)) in t's dtype."""
    dt = t.dtype
    o = F.linear(t.float(), w.to(dt).float()).to(dt)
    return (o.float() + b.to(dt).float()).to(dt)


def _cpe_plain(x, cpe_w, cpe_b, s):
    """Stage 1 plain: x1 = E(E(dw3x3(x) + b) + x)."""
    dt = x.dtype
    B, N, C = x.shape
    xm = x.reshape(B, s, s, C).permute(0, 3, 1, 2).float()
    y = _dwconv(xm, cpe_w, cpe_b, dt).to(dt).float()
    return (y + xm).to(dt).permute(0, 2, 3, 1).reshape(B, N, C)


def tp_qkv_plain(x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, s, eps1):
    """Stages 1-2 plain: x1 = the CPE, and LN1(x1) through the qkv Dense
    over wqkv's output features (3C, or a model-axis rank's shard: K5's
    sharded form's first stage)."""
    x1 = _cpe_plain(x, cpe_w, cpe_b, s)
    return x1, _dense(group_ln(x1, ln1_s, ln1_b, 1, eps1), wqkv, bqkv)


def tp_attn_plain(qkv, x1, crpe_ws, crpe_bs, wp, bp, s, heads):
    """Stages 3-5 plain on the whole (in the sharded form, gathered)
    q|k|v: the contexts, the attention with the CRPE, proj with the
    residual x1: x2."""
    dt = x1.dtype
    B, N, C = x1.shape
    d = C // heads
    q, k, v = qkv.split(C, dim=-1)
    ks = torch.softmax(k.float(), dim=1).to(dt)
    heads_of = (lambda t: t.float().reshape(B, N, heads, d))  # noqa: E731
    ctx = torch.einsum("bnhi,bnhj->bhij", heads_of(ks), heads_of(v)).to(dt)
    att = torch.einsum("bnhi,bhij->bnhj", heads_of(q), ctx.float())
    att = (att * d ** -0.5).to(dt).reshape(B, N, C)
    vm = v.reshape(B, s, s, C).permute(0, 3, 1, 2).float()
    segs = torch.split(vm, [w.shape[0] for w in crpe_ws], dim=1)
    conv_v = torch.cat([_dwconv(t, w, b, dt) for t, w, b in
                        zip(segs, crpe_ws, crpe_bs)], dim=1).to(dt)
    conv_v = conv_v.permute(0, 2, 3, 1).reshape(B, N, C)
    crpe = (q.float() * conv_v.float()).to(dt)
    a = (att.float() + crpe.float()).to(dt)
    return (x1.float() + _dense(a, wp, bp).float()).to(dt)


def mhca_block_plain(x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, crpe_ws,
                     crpe_bs, wp, bp, ln2_s, ln2_b, w1, b1, dw, dwb, ls, lb,
                     w2, b2, *, s: int, heads: int, eps1: float = 1e-6,
                     eps2: float = 1e-6, eps: float = 1e-5):
    """Plain version with the Pallas kernel's rounding points
    (mhca_block.py:41 _reference_impl). x (B, s², C); torch layouts:
    cpe_w (C, 1, 3, 3), wqkv (3C, C), crpe_ws per window (chs, 1, k, k)
    in head-major channel order, wp (C, C); w1 .. b2 as MixFFNSkip.params().
    """
    x1, qkv = tp_qkv_plain(x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, s,
                           eps1)
    x2 = tp_attn_plain(qkv, x1, crpe_ws, crpe_bs, wp, bp, s, heads)
    return mixffn.mixffn_ln_skip_plain(x2, ln2_s, ln2_b, w1, b1, dw, dwb, ls,
                                       lb, w2, b2, s=s, eps_ln=eps2, eps=eps)


def attn_smem(s: int, C: int, d: int, rows: int, es: int = 2) -> int:
    """Shared memory of one block of the attention stage over elements of
    es bytes (mirrors attn_smem in csrc/mhca_block.cu): the transposed
    contexts, Q of the band's rows, the zero-padded band of V and, at fp32,
    the CRPE taps (a 7 x 7 grid of fp32 a channel)."""
    taps = (2 * HALO + 1) ** 2 * C * 4 if es == 4 else 0
    return (d * C * 4 + rows * s * C * es
            + (rows + 2 * HALO) * (s + 2 * HALO) * C * es + taps)


def plan(B: int, s: int, C: int, heads: int, hid: int, sms: int,
         es: int = 2, nq: int = 0) -> dict:
    """K5's launch plan for x (B, s², C) on a card of `sms` SMs: the qkv
    (T, nq, C) (nq: the qkv's output features, 3C by default, a model-axis
    rank's shard in the sharded form) and proj (T, C, C) product tiles
    (mixffn.token_tile), the
    map rows per attention block (the most of BAND_ROWS that gives a block
    per SM, else 1: a band's V halo is staged once for its rows) and the FFN's forward plan (mixffn.fwd_plan). `plan` is
    the int list the CUDA entry takes; `blocks` the blocks of each stage;
    `workspace` the bytes of each intermediate in the entry's order
    (elements of es bytes: 2 bf16, 4 for the fp32 form; the contexts are
    fp32 in both); `smem` the attention stage's shared memory."""
    T, d = B * s * s, C // heads
    nq = nq or 3 * C
    gemms = {"qkv": (T, nq, C) + mixffn.token_tile(T, nq, sms),
             "proj": (T, C, C) + mixffn.token_tile(T, C, sms)}
    rows = next((r for r in BAND_ROWS if B * -(-s // r) >= sms), 1)
    ffn = mixffn.fwd_plan(B, s, C, hid, sms, es)
    blocks = {k: mixffn._blocks(*g[:2], *g[3:]) for k, g in gemms.items()}
    blocks.update(cpe=B * s, ctx=B * heads, attn=B * -(-s // rows),
                  **{f"ffn_{k}": n for k, n in ffn["blocks"].items()})
    workspace = {"x1": T * C * es, "qkv": T * nq * es,
                 "ctx": B * C * d * 4, "att": T * C * es, "x2": T * C * es,
                 **ffn["workspace"]}
    return dict(gemms=gemms, band_rows=rows, ffn=ffn, blocks=blocks,
                smem={"attn": attn_smem(s, C, d, rows, es),
                      "ctx": (2 * s * s * d + THREADS) * 4,
                      "qkv": mixffn.gemm_smem(True, *gemms["qkv"][3:], C,
                                              es),
                      "proj": mixffn.gemm_smem(False, *gemms["proj"][3:], C,
                                               es)},
                plan=[*gemms["qkv"][3:], *gemms["proj"][3:], rows]
                + ffn["plan"], workspace=workspace)


@functools.lru_cache(maxsize=None)
def _launch_plan(B, s, C, heads, hid, sms, es=2, nq=0):
    """plan's workspace sizes and its int list as the entry takes it (a
    ctypes array, read only), kept per shape, card and element size."""
    pl = plan(B, s, C, heads, hid, sms, es, nq)
    return (tuple(pl["workspace"].values()),
            (ctypes.c_int * len(pl["plan"]))(*pl["plan"]))


def _check(x, s, heads, hid, crpe_ws):
    _build.element_dtype(NAME, x)
    if x.dim() != 3:
        raise ValueError(f"{NAME} kernel takes a (B, N, C) tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    B, N, C = x.shape
    if N != s * s or C % heads:
        raise ValueError(f"{NAME} kernel needs a square s*s map and C % "
                         f"heads == 0, got N={N}, s={s}, C={C}")
    d = C // heads
    if C % 32 or THREADS % C or 32 % d or d % 8 or len(crpe_ws) != 3 or \
            sum(w.shape[0] for w in crpe_ws) != C or \
            any(w.shape[-1] > 2 * HALO + 1 for w in crpe_ws):
        raise ValueError(f"{NAME} kernel needs C of 32 to {THREADS} "
                         f"dividing {THREADS}, a head dim of 8, 16 or 32 and "
                         f"three CRPE windows of "
                         f"at most {2 * HALO + 1}² over all C channels")
    if (2 * N * d + THREADS) * 4 > SMEM_LIMIT or \
            attn_smem(s, C, d, BAND_ROWS[0], x.element_size()) > SMEM_LIMIT:
        raise ValueError(f"{NAME} kernel: (N={N}, C={C}, heads={heads}) "
                         f"exceeds shared memory")
    mixffn._check(x, s, hid, 1)


def mhca_block(x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, crpe_ws, crpe_bs,
               wp, bp, ln2_s, ln2_b, w1, b1, dw, dwb, ls, lb, w2, b2, *,
               s: int, heads: int, eps1: float = 1e-6, eps2: float = 1e-6,
               eps: float = 1e-5):
    """Wrapper: plain version with the kernels off or where autograd
    records on the CPU, else the operator (the CUDA kernels, one counted
    launch per block, whose backward is autograd of the plain version)."""
    kw = dict(s=s, heads=heads, eps1=eps1, eps2=eps2, eps=eps)
    if _build.plain(NAME, x):
        return mhca_block_plain(
            x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, crpe_ws, crpe_bs, wp,
            bp, ln2_s, ln2_b, w1, b1, dw, dwb, ls, lb, w2, b2, **kw)
    nw = len(crpe_ws)

    def unflat(fn):
        # The flat tensors back into the operator's arguments (the CRPE
        # weights and biases are lists).
        def call(*a):
            return fn(*a[:7], list(a[7:7 + nw]), list(a[7 + nw:7 + 2 * nw]),
                      *a[7 + 2 * nw:], *kw.values())
        return call

    return _build.with_plain_backward(
        unflat(OP), unflat(_plain_op),
        x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, *crpe_ws, *crpe_bs, wp,
        bp, ln2_s, ln2_b, w1, b1, dw, dwb, ls, lb, w2, b2)


def _plain_op(x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, crpe_ws, crpe_bs,
              wp, bp, ln2_s, ln2_b, w1, b1, dw, dwb, ls, lb, w2, b2, s,
              heads, eps1, eps2, eps):
    """mhca_block_plain with the operator's positional signature."""
    return mhca_block_plain(
        x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, crpe_ws, crpe_bs, wp, bp,
        ln2_s, ln2_b, w1, b1, dw, dwb, ls, lb, w2, b2, s=s, heads=heads,
        eps1=eps1, eps2=eps2, eps=eps)


def _launch(x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, crpe_ws, crpe_bs, wp,
            bp, ln2_s, ln2_b, w1, b1, dw, dwb, ls, lb, w2, b2, s, heads,
            eps1, eps2, eps):
    hid = w1.shape[0]
    _check(x, s, heads, hid, crpe_ws)
    global launches
    x = _build.aligned(x)
    fn = _build.entry(NAME, _build.symbol("mhca_block", x.dtype),
                      [ctypes.c_void_p] * 34 + [ctypes.c_int] * 10
                      + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    B, N, C = x.shape
    d = C // heads
    bf = functools.partial(_build.weight, dtype=x.dtype)
    f32 = _build.f32
    sizes, ints = _launch_plan(B, s, C, heads, hid, _build.sms(x),
                               x.element_size())
    out = torch.empty_like(x)
    ws, work = _build.workspace(sizes, x.device)
    held = (
        x, f32(cpe_w), f32(cpe_b), f32(ln1_s), f32(ln1_b), bf(wqkv),
        f32(bqkv), *(f32(w) for w in crpe_ws), *(f32(b) for b in crpe_bs),
        bf(wp), f32(bp), f32(ln2_s), f32(ln2_b), bf(w1), f32(b1),
        bf(dw.reshape(hid, 9)), f32(dwb), f32(ls), f32(lb), bf(w2),
        f32(b2))
    ptrs = [_build.ptr(t) for t in held] + work + [_build.ptr(out)]
    rc = fn(*ptrs, ints, B, s, C, heads, hid,
            *(w.shape[-1] for w in crpe_ws), crpe_ws[0].shape[0],
            crpe_ws[1].shape[0], eps1, eps2, eps, d ** -0.5,
            _build.stream_of(x))
    _build.check(rc, NAME)
    launches += 1
    _build.tally(NAME, tuple(x.shape), _build.tag(x))
    return out


OP = _build.define(
    NAME, "(Tensor x, Tensor cpe_w, Tensor cpe_b, Tensor ln1_s, Tensor ln1_b, "
    "Tensor wqkv, Tensor bqkv, Tensor[] crpe_ws, Tensor[] crpe_bs, "
    "Tensor wp, Tensor bp, Tensor ln2_s, Tensor ln2_b, Tensor w1, Tensor b1, "
    "Tensor dw, Tensor dwb, Tensor ls, Tensor lb, Tensor w2, Tensor b2, "
    "int s, int heads, float eps1, float eps2, float eps) -> Tensor",
    _launch, _plain_op, lambda x, *a: x.new_empty(x.shape))


# ---- K5's sharded form: the per-path MHCA layout under the model axis ----
#
# In the per-path layout (TransceptionConfig.vectorize_paths False) the
# JAX TP rules shard each MHCA block's qkv on its output features (dim 0
# of the port's (3C, C) weight, with its bias) and its FFN's hidden layer
# (parallel.mesh.shard_layout), so a rank holds nq = 3C/tp qkv columns
# and hid = hid_all/tp hidden channels. The block then runs as K5's stage
# ranges with the model axis between them (csrc/mhca_block.cu
# mhca_block_tp_*): stages 1-2 on the rank's qkv columns (the Dense
# epilogue is per column, so the gathered columns are the unsharded
# launch's bits; the product takes an nq that is no multiple of its
# 64-wide tiles, the columns past nq never read or stored), the q|k|v
# gathered over the axis, stages 3-5 on the whole of it, then the FFN as
# K2's hidden-sharded chain (mixffn_stages.cuh fc1_stats with LN2 folded
# in, the sum of (Σ y, Σ y²), act_fc2, the sum of the fp32 fc2 partials,
# K2's sharded out stage with the residual). A qkv or FFN that the rules
# leave whole (a width tp does not divide) runs its stages whole, without
# the sums. One counted launch a block (the first stage's, named
# TP_NAME, tallied with (x's shape, nq, hid_all, hid)); the backward is
# autograd of the sharded plain version with the axis's autograd
# collectives (K5's backward since it was ported).

TP_NAME = "mhca_block_tp"
TP_REPLACES = REPLACES
tp_launches = 0

# The stage entries read their part of plan(): the qkv tile and band rows
# depend on neither the heads nor the hidden width, the FFN's tiles not on
# the heads, so the stages that do not take one plan at a stand-in.
_ANY_HEADS, _ANY_HID = 8, 64


def tp_fc1_plain(x2, ln2_s, ln2_b, w1, b1, dw, dwb, s, eps2, hid_all):
    """Plain sharded FFN stage 1 (LN2 folded in): h, the partial sums."""
    return mixffn.tp_fc1_plain(x2, ln2_s, ln2_b, w1, b1, dw, dwb, s, 1,
                               eps2, hid_all)


def mhca_block_tp_plain(x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, crpe_ws,
                        crpe_bs, wp, bp, ln2_s, ln2_b, w1, b1, dw, dwb, ls,
                        lb, w2, b2, *, s: int, heads: int, hid_all: int,
                        axis, eps1: float = 1e-6, eps2: float = 1e-6,
                        eps: float = 1e-5):
    """K5's sharded form as plain PyTorch, differentiable: the unsharded
    plain version's rounding points with the model axis's autograd
    collectives: LN1(x1) into the rank's qkv columns through the axis's
    copy, the columns gathered, the FFN hidden-sharded
    (mixffn.mixffn_tp_plain). A qkv (wqkv of 3C rows) or FFN (w1 of
    hid_all rows) that is whole runs whole."""
    x1 = _cpe_plain(x, cpe_w, cpe_b, s)
    cur = group_ln(x1, ln1_s, ln1_b, 1, eps1)
    if wqkv.shape[0] == 3 * x.shape[-1]:
        qkv = _dense(cur, wqkv, bqkv)
    else:  # column-parallel, as Linear's "gather" mode
        qkv = axis.gather(_dense(axis.copy(cur.float()).to(x.dtype), wqkv,
                                 bqkv))
    x2 = tp_attn_plain(qkv, x1, crpe_ws, crpe_bs, wp, bp, s, heads)
    if w1.shape[0] == hid_all:
        return mixffn.mixffn_ln_skip_plain(x2, ln2_s, ln2_b, w1, b1, dw, dwb,
                                           ls, lb, w2, b2, s=s, eps_ln=eps2,
                                           eps=eps)
    return mixffn.mixffn_tp_plain(x2, w1, b1, dw, dwb, ls, lb, w2, b2, s=s,
                                  hid_all=hid_all, axis=axis,
                                  pre_ln=(ln2_s, ln2_b, 1, eps2),
                                  residual=True, eps=eps)


def _check_tp(x, s, heads, hid, nq, crpe_ws):
    """Raise on what K5's sharded form does not take: K5's own checks at
    the rank's hidden width, and nq qkv columns a multiple of 8 (whole
    16-byte stores of the product's epilogue) dividing 3C."""
    _check(x, s, heads, hid, crpe_ws)
    C = x.shape[-1]
    if nq % 8 or 3 * C % nq:
        raise ValueError(f"{TP_NAME} kernel needs the rank's qkv columns, "
                         f"a multiple of 8 dividing 3C={3 * C}, got {nq}")


def _launch_tp_qkv(x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, s, hid,
                   hid_all, eps1):
    nq = wqkv.shape[0]
    _build.element_dtype(TP_NAME, x)
    B, N, C = x.shape
    if N != s * s or nq % 8 or 3 * C % nq:
        raise ValueError(f"{TP_NAME} kernel needs a square s*s map and the "
                         f"rank's qkv columns, a multiple of 8 dividing "
                         f"3C={3 * C}; got N={N}, s={s}, {nq} columns")
    global tp_launches
    x = _build.aligned(x)
    _, ints = _launch_plan(B, s, C, _ANY_HEADS, hid, _build.sms(x),
                           x.element_size(), nq)
    x1 = torch.empty_like(x)
    qkv = x.new_empty((B, N, nq))
    bf = functools.partial(_build.weight, dtype=x.dtype)
    f32 = _build.f32
    held = (x, f32(cpe_w), f32(cpe_b), f32(ln1_s), f32(ln1_b), bf(wqkv),
            f32(bqkv), x1, qkv)
    fn = _build.entry(NAME, _build.symbol("mhca_block_tp_qkv", x.dtype),
                      [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                      + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(*[_build.ptr(t) for t in held], ints, B, s, C, nq, eps1,
            _build.stream_of(x))
    _build.check(rc, "mhca_block_tp_qkv")
    tp_launches += 1
    _build.tally(TP_NAME, tuple(x.shape), nq, hid_all, hid, _build.tag(x))
    return x1, qkv


def _launch_tp_attn(qkv, x1, crpe_ws, crpe_bs, wp, bp, s, heads):
    _check(x1, s, heads, _ANY_HID, crpe_ws)
    x1, qkv = _build.aligned(x1), _build.aligned(qkv)
    B, N, C = x1.shape
    if qkv.shape != (B, N, 3 * C) or qkv.dtype != x1.dtype:
        raise ValueError(f"mhca_block_tp_attn needs the gathered q|k|v "
                         f"({B}, {N}, {3 * C}), got {tuple(qkv.shape)}")
    d = C // heads
    _, ints = _launch_plan(B, s, C, heads, _ANY_HID, _build.sms(x1),
                           x1.element_size())
    ctx = torch.empty((B, heads, d, d), device=x1.device,
                      dtype=torch.float32)
    att, x2 = torch.empty_like(x1), torch.empty_like(x1)
    bf = functools.partial(_build.weight, dtype=x1.dtype)
    f32 = _build.f32
    held = (qkv, x1, *(f32(w) for w in crpe_ws), *(f32(b) for b in crpe_bs),
            bf(wp), f32(bp), ctx, att, x2)
    fn = _build.entry(NAME, _build.symbol("mhca_block_tp_attn", x1.dtype),
                      [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9
                      + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(*[_build.ptr(t) for t in held], ints, B, s, C, heads,
            *(w.shape[-1] for w in crpe_ws), crpe_ws[0].shape[0],
            crpe_ws[1].shape[0], d ** -0.5, _build.stream_of(x1))
    _build.check(rc, "mhca_block_tp_attn")
    return x2


def _launch_tp_fc1(x2, ln2_s, ln2_b, w1, b1, dw, dwb, s, eps2, hid_all):
    hid = w1.shape[0]
    mixffn._check(x2, s, hid, 1)
    x2 = _build.aligned(x2)
    B, N, C = x2.shape
    _, ints = _launch_plan(B, s, C, _ANY_HEADS, hid, _build.sms(x2),
                           x2.element_size())
    h = x2.new_empty((B, N, hid))
    st = torch.empty((B, N, 2), device=x2.device, dtype=torch.float32)
    bf = functools.partial(_build.weight, dtype=x2.dtype)
    f32 = _build.f32
    held = (x2, f32(ln2_s), f32(ln2_b), bf(w1), f32(b1),
            bf(dw.reshape(hid, 9)), f32(dwb), h, st)
    fn = _build.entry(NAME, _build.symbol("mhca_block_tp_fc1", x2.dtype),
                      [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                      + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(*[_build.ptr(t) for t in held], ints, B, s, C, hid, eps2,
            _build.stream_of(x2))
    _build.check(rc, "mhca_block_tp_fc1")
    return h, st


def _launch_tp_fc2(h, dw, dwb, ls, lb, w2, st, s, hid_all, eps):
    B, N, hid = h.shape
    C = w2.shape[0]
    h = _build.aligned(h)
    _, ints = _launch_plan(B, s, C, _ANY_HEADS, hid, _build.sms(h),
                           h.element_size())
    p = torch.empty((B, N, C), device=h.device, dtype=torch.float32)
    a = torch.empty_like(h)
    bf = functools.partial(_build.weight, dtype=h.dtype)
    f32 = _build.f32
    held = (h, bf(dw.reshape(hid, 9)), f32(dwb), f32(ls), f32(lb), bf(w2),
            f32(st), p, a)
    fn = _build.entry(NAME, _build.symbol("mhca_block_tp_fc2", h.dtype),
                      [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                      + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(*[_build.ptr(t) for t in held], ints, B, s, C, hid, hid_all, eps,
            _build.stream_of(h))
    _build.check(rc, "mhca_block_tp_fc2")
    return p


_BLOCK = ("Tensor x, Tensor cpe_w, Tensor cpe_b, Tensor ln1_s, "
          "Tensor ln1_b, Tensor wqkv, Tensor bqkv")
TP_QKV_OP = _build.define(
    TP_NAME, f"({_BLOCK}, int s, int hid, int hid_all, float eps1) -> "
    "(Tensor, Tensor)", _launch_tp_qkv,
    lambda x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, s, hid, hid_all, eps1:
    tp_qkv_plain(x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, s, eps1),
    lambda x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, *a: (
        x.new_empty(x.shape), x.new_empty(x.shape[:2] + wqkv.shape[:1])))
TP_ATTN_OP = _build.define(
    "mhca_block_tp_attn", "(Tensor qkv, Tensor x1, Tensor[] crpe_ws, "
    "Tensor[] crpe_bs, Tensor wp, Tensor bp, int s, int heads) -> Tensor",
    _launch_tp_attn, tp_attn_plain,
    lambda qkv, x1, *a: x1.new_empty(x1.shape))
TP_FC1_OP = _build.define(
    "mhca_block_tp_fc1", "(Tensor x2, Tensor ln2_s, Tensor ln2_b, Tensor w1, "
    "Tensor b1, Tensor dw, Tensor dwb, int s, float eps2, int hid_all) -> "
    "(Tensor, Tensor)", _launch_tp_fc1, tp_fc1_plain,
    lambda x2, ln2_s, ln2_b, w1, *a: (
        x2.new_empty(x2.shape[:2] + (w1.shape[0],)),
        x2.new_empty(x2.shape[:2] + (2,), dtype=torch.float32)))
TP_FC2_OP = _build.define(
    "mhca_block_tp_fc2", "(Tensor h, Tensor dw, Tensor dwb, Tensor ls, "
    "Tensor lb, Tensor w2, Tensor st, int s, int hid_all, float eps) -> "
    "Tensor", _launch_tp_fc2, mixffn.tp_fc2_plain,
    lambda h, dw, dwb, ls, lb, w2, *a: h.new_empty(
        h.shape[:2] + (w2.shape[0],), dtype=torch.float32))


def tp_stages(x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, crpe_ws, crpe_bs,
              wp, bp, ln2_s, ln2_b, w1, b1, dw, dwb, ls, lb, w2, b2, *,
              s: int, heads: int, hid_all: int, gather, total,
              eps1: float = 1e-6, eps2: float = 1e-6, eps: float = 1e-5):
    """K5's sharded form as its operators (the CUDA stages on the card,
    the plain stages on the CPU), with the model axis's sums as the
    caller's `gather(qkv)` (the rank's columns gathered into q|k|v) and
    `total(t)` (t summed over the ranks, in place), identities where the
    qkv or the FFN is whole."""
    x1, qkv = TP_QKV_OP(x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, s,
                        w1.shape[0], hid_all, eps1)
    if wqkv.shape[0] != 3 * x.shape[-1]:
        qkv = gather(qkv)
    x2 = TP_ATTN_OP(qkv, x1, list(crpe_ws), list(crpe_bs), wp, bp, s, heads)
    h, st = TP_FC1_OP(x2, ln2_s, ln2_b, w1, b1, dw, dwb, s, eps2, hid_all)
    sharded = w1.shape[0] != hid_all
    if sharded:
        total(st)
    p = TP_FC2_OP(h, dw, dwb, ls, lb, w2, st, s, hid_all, eps)
    if sharded:
        total(p)
    return mixffn.TP_OUT_OP(p, b2, x2)


def mhca_block_tp(x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, crpe_ws,
                  crpe_bs, wp, bp, ln2_s, ln2_b, w1, b1, dw, dwb, ls, lb, w2,
                  b2, *, s: int, heads: int, hid_all: int, axis,
                  eps1: float = 1e-6, eps2: float = 1e-6, eps: float = 1e-5):
    """An MHCA block of the per-path layout under the model axis `axis`
    (wqkv, bqkv: the rank's qkv output features; w1 .. lb the rank's FFN
    shards, w2 its columns, b2 whole): with K5 switched on, its sharded
    form (tp_stages, the sums over `axis`), whose backward is autograd of
    mhca_block_tp_plain; on the CPU where autograd records, and with K5
    off, mhca_block_tp_plain."""
    kw = dict(s=s, heads=heads, hid_all=hid_all, eps1=eps1, eps2=eps2,
              eps=eps)
    nw = len(crpe_ws)

    def unflat(fn, **more):
        def call(*a):
            return fn(*a[:7], list(a[7:7 + nw]), list(a[7 + nw:7 + 2 * nw]),
                      *a[7 + 2 * nw:], **kw, **more)
        return call

    flat = (x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, *crpe_ws, *crpe_bs,
            wp, bp, ln2_s, ln2_b, w1, b1, dw, dwb, ls, lb, w2, b2)
    plain = unflat(mhca_block_tp_plain, axis=axis)
    if NAME not in _build.active():
        return plain(*flat)
    _build.routed[TP_NAME] += 1
    if x.device.type == "cpu" and torch.is_grad_enabled():
        return plain(*flat)
    if x.device.type == "cuda":
        _check_tp(x, s, heads, w1.shape[0], wqkv.shape[0], crpe_ws)
    kernel = unflat(tp_stages,
                    gather=lambda t: axis.gather(t, -1, grad=False),
                    total=axis.all_reduce_)
    return _build.with_plain_backward(kernel, plain, *flat)
