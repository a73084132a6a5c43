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


def mhca_block_plain(x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, crpe_ws,
                     crpe_bs, wp, bp, ln2_s, ln2_b, w1, b1, dw, dwb, ls, lb,
                     w2, b2, *, s: int, heads: int, eps1: float = 1e-6,
                     eps2: float = 1e-6, eps: float = 1e-5):
    """Plain version with the Pallas kernel's rounding points
    (mhca_block.py:41 _reference_impl). x (B, s², C); torch layouts:
    cpe_w (C, 1, 3, 3), wqkv (3C, C), crpe_ws per window (chs, 1, k, k)
    in head-major channel order, wp (C, C); w1 .. b2 as MixFFNSkip.params().
    """
    dt = x.dtype
    B, N, C = x.shape
    d = C // heads
    xm = x.reshape(B, s, s, C).permute(0, 3, 1, 2).float()
    y = _dwconv(xm, cpe_w, cpe_b, dt).to(dt).float()
    x1 = (y + xm).to(dt).permute(0, 2, 3, 1).reshape(B, N, C)
    cur = group_ln(x1, ln1_s, ln1_b, 1, eps1)
    q, k, v = _dense(cur, wqkv, bqkv).split(C, dim=-1)
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
    x2 = (x1.float() + _dense(a, wp, bp).float()).to(dt)
    return mixffn.mixffn_ln_skip_plain(x2, ln2_s, ln2_b, w1, b1, dw, dwb, ls,
                                       lb, w2, b2, s=s, eps_ln=eps2, eps=eps)


def attn_smem(s: int, C: int, d: int, rows: int) -> int:
    """Shared memory of one block of the attention stage (mirrors
    attn_smem in csrc/mhca_block.cu): the transposed contexts, Q of the
    band's rows and the zero-padded band of V."""
    return (d * C * 4 + rows * s * C * 2
            + (rows + 2 * HALO) * (s + 2 * HALO) * C * 2)


def plan(B: int, s: int, C: int, heads: int, hid: int, sms: int) -> dict:
    """K5's launch plan for x (B, s², C) on a card of `sms` SMs: the qkv
    (T, 3C, C) and proj (T, C, C) product tiles (mixffn.token_tile), the
    map rows per attention block (the most of BAND_ROWS that gives a block
    per SM, else 1: a band's V halo is staged once for its rows) and the FFN's forward plan (mixffn.fwd_plan). `plan` is
    the int list the CUDA entry takes; `blocks` the blocks of each stage;
    `workspace` the bytes of each intermediate in the entry's order."""
    T, d = B * s * s, C // heads
    gemms = {"qkv": (T, 3 * C, C) + mixffn.token_tile(T, 3 * C, sms),
             "proj": (T, C, C) + mixffn.token_tile(T, C, sms)}
    rows = next((r for r in BAND_ROWS if B * -(-s // r) >= sms), 1)
    ffn = mixffn.fwd_plan(B, s, C, hid, sms)
    blocks = {k: mixffn._blocks(*g[:2], *g[3:]) for k, g in gemms.items()}
    blocks.update(cpe=B * s, ctx=B * heads, attn=B * -(-s // rows),
                  **{f"ffn_{k}": n for k, n in ffn["blocks"].items()})
    workspace = {"x1": T * C * 2, "qkv": T * 3 * C * 2,
                 "ctx": B * C * d * 4, "att": T * C * 2, "x2": T * C * 2,
                 **ffn["workspace"]}
    return dict(gemms=gemms, band_rows=rows, ffn=ffn, blocks=blocks,
                plan=[*gemms["qkv"][3:], *gemms["proj"][3:], rows]
                + ffn["plan"], workspace=workspace)


@functools.lru_cache(maxsize=None)
def _launch_plan(B, s, C, heads, hid, sms):
    """plan's workspace sizes and its int list as the entry takes it (a
    ctypes array, read only), kept per shape and card."""
    pl = plan(B, s, C, heads, hid, sms)
    return (tuple(pl["workspace"].values()),
            (ctypes.c_int * len(pl["plan"]))(*pl["plan"]))


def _check(x, s, heads, hid, crpe_ws):
    if x.dtype != torch.bfloat16 or x.dim() != 3:
        raise ValueError(f"{NAME} kernel takes a (B, N, C) bf16 tensor, "
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
            attn_smem(s, C, d, BAND_ROWS[0]) > SMEM_LIMIT:
        raise ValueError(f"{NAME} kernel: (N={N}, C={C}, heads={heads}) "
                         f"exceeds shared memory")
    mixffn._check(x, s, hid, 1)


def mhca_block(x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, crpe_ws, crpe_bs,
               wp, bp, ln2_s, ln2_b, w1, b1, dw, dwb, ls, lb, w2, b2, *,
               s: int, heads: int, eps1: float = 1e-6, eps2: float = 1e-6,
               eps: float = 1e-5):
    """Wrapper: plain version for a CPU tensor or with the kernels off,
    the CUDA kernels otherwise (one counted launch per block), whose
    backward is autograd of the plain version."""
    kw = dict(s=s, heads=heads, eps1=eps1, eps2=eps2, eps=eps)
    if _build.plain(NAME, x):
        return mhca_block_plain(
            x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, crpe_ws, crpe_bs, wp,
            bp, ln2_s, ln2_b, w1, b1, dw, dwb, ls, lb, w2, b2, **kw)
    nw = len(crpe_ws)

    def unflat(fn):
        # The flat tensors back into the wrapper's arguments (the CRPE
        # weights and biases are lists).
        def call(*a):
            return fn(*a[:7], list(a[7:7 + nw]), list(a[7 + nw:7 + 2 * nw]),
                      *a[7 + 2 * nw:], **kw)
        return call

    return _build.with_plain_backward(
        unflat(_launch), unflat(mhca_block_plain),
        x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, *crpe_ws, *crpe_bs, wp,
        bp, ln2_s, ln2_b, w1, b1, dw, dwb, ls, lb, w2, b2)


def _launch(x, cpe_w, cpe_b, ln1_s, ln1_b, wqkv, bqkv, crpe_ws, crpe_bs, wp,
            bp, ln2_s, ln2_b, w1, b1, dw, dwb, ls, lb, w2, b2, *, s, heads,
            eps1, eps2, eps):
    hid = w1.shape[0]
    _check(x, s, heads, hid, crpe_ws)
    global launches
    x = _build.aligned(x)
    fn = _build.entry(NAME, "mhca_block", [ctypes.c_void_p] * 34 + [
        ctypes.c_int] * 10 + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    B, N, C = x.shape
    d = C // heads
    bf, f32 = mixffn._weight, _build.f32
    sizes, ints = _launch_plan(B, s, C, heads, hid, _build.sms(x))
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
    _build.tally(NAME, tuple(x.shape))
    return out
