"""Fused patch expand + grouped LayerNorm, with the pixel shuffle folded
into the store.

Replaces transception_tpu/ops/pallas/expand_kernel.py:233
`fused_patch_expand` (pallas_call at :255): y = x @ W (C -> p²·c), rounded
to bf16, then a LayerNorm per c-wide group (fp32 statistics, flax's E[y²]
− E[y]² variance), out in pre-shuffle order (B, N, p²·c), or with
`shuffle=(H, W)` in the pixel-shuffled order (B, p²·H·W, c) that the JAX
package's XLA transpose after the kernel gives (ops/pallas/
patch_expand.py:56-58; the TPU kernel left it to XLA only because Mosaic
cannot reshape the lane axis). On the serving path: the p = 2 expanders
of decoders 3/2/1, (B, 49, 512) -> 1024, (B, 196, 320) -> 640 and (B, 784,
128) -> 256, shuffled; the x4 expander of decoder 0, (B, 3136, 64) ->
1024, when logits are asked for.

Bound on the H100: bytes at these shapes (x in, p² times its width out; ~2
FLOP per weight per token is far below the tensor cores' rate).

Design (csrc/patch_expand.cu on csrc/expand_stages.cuh): a block takes BM
tokens (BM by the group width c: 128, 64 or 32, so that 8 warps of 16-token
strips cover one group's columns) and a run of whole groups; its x panel
is staged once, the groups' weight tiles stream through a cp.async ring,
products on mma.sync, the LN in registers, each warp's normalised share
stored in 16-byte chunks straight to its place in the chosen layout.
`plan` splits the groups over blocks where the token tiles alone would not
fill the card. The LN vectors are read in the dtype they come in (bf16 or
fp32; the model keeps them in fp32), so no cast is launched per call. The
backward is autograd of the plain version in the same layout
(_build.with_plain_backward), as the JAX custom VJP is the VJP of its XLA
reference (patch_expand.py:68-74).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from transception_tpu_torch.ops.kernels import _build

NAME = "patch_expand"
REPLACES = "transception_tpu/ops/pallas/expand_kernel.py:233"
SMEM_LIMIT = 232448  # bytes a block may opt into on sm_90
# Held equal to csrc/expand_stages.cuh (tests/test_torch_expand_plan.py).
THREADS = 256
DEPTH = 64       # BK: the depth of a staged weight tile
STAGES = 3       # the weight ring
MAX_CIN = 512
WIDTHS = (64, 160, 256)  # the group widths csrc/patch_expand.cu is built for
LN_DTYPES = (torch.bfloat16, torch.float32)
launches = 0


def shuffle_tokens(y, H: int, W: int, p: int):
    """(B, H·W, p²·c) in pre-shuffle order -> (B, p²·H·W, c): token (h, w),
    group (p1, p2) to row (h·p + p1)·(W·p) + w·p + p2."""
    B, _, feats = y.shape
    c = feats // (p * p)
    y = y.reshape(B, H, W, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(B, p * p * H * W, c)


def patch_expand_plain(x, w, ls, lb, *, p: int, c: int, eps: float = 1e-5,
                       shuffle=None):
    """Plain version with the Pallas kernel's rounding points. x (B, N, C);
    w (p²·c, C) torch Linear layout; -> (B, N, p²·c) in x's dtype, or with
    shuffle=(H, W) (H·W = N) the shuffled (B, p²·N, c)."""
    dt = x.dtype
    B, N, C = x.shape
    y = F.linear(x.float(), w.to(dt).float()).to(dt).float()
    y = y.reshape(B, N, p * p, c)
    mean = y.mean(-1, keepdim=True)
    var = (y * y).mean(-1, keepdim=True) - mean * mean
    yn = (y - mean) * torch.rsqrt(var + eps) * ls.float() + lb.float()
    out = yn.to(dt).reshape(B, N, p * p * c)
    return out if shuffle is None else shuffle_tokens(out, *shuffle, p)


def warps_n(c: int) -> int:
    """Warps that share one group's c columns (expand_stages.cuh warps_n)."""
    return 1 if c <= 64 else 2 if c <= 160 else 4


def block_rows(c: int) -> int:
    """BM: tokens of a block, 16 a warp strip (expand_stages.cuh)."""
    return 16 * (THREADS // 32 // warps_n(c))


def smem_bytes(c: int, C: int, tile: bool = True) -> int:
    """Shared bytes of a block (expand_stages.cuh smem_bytes): x panel,
    weight ring, the LN partials where warps share a group, and with
    `tile` the padded bf16 output tile."""
    bm, wn = block_rows(c), warps_n(c)
    return (bm * C * 2 + STAGES * c * DEPTH * 2
            + (bm * wn * 8 if wn > 1 else 0)
            + (bm * (c + 8) * 2 if tile else 0))


def plan(B: int, N: int, C: int, c: int, p: int, sm_count: int,
         head: bool = False) -> dict:
    """The launch of K7 (or with head=True, K4's: expand_head.plan) for x
    (B, N, C) expanded into p² groups of c on a card of `sm_count` SMs:
    token tiles of `block_rows` (the last one masked where B·N leaves a
    partial tile) times `splits` blocks per tile, each taking
    `groups_per_block` consecutive groups: the fewest splits (a divisor of
    p²; for K4 one that leaves whole quads of groups) that give a block per
    SM, else all p². `warps` is (strips, warps a group), `warp_cols` the
    columns of a warp; `smem` a block's shared bytes."""
    G, wn, bm = p * p, warps_n(c), block_rows(c)
    tiles = -(-B * N // bm)
    options = [d for d in range(1, G + 1)
               if G % d == 0 and (not head or (G // d) % 4 == 0)]
    splits = next((d for d in options if tiles * d >= sm_count), options[-1])
    return dict(block_rows=bm, warps=(THREADS // 32 // wn, wn),
                warp_cols=c // wn, row_tiles=tiles, splits=splits,
                groups_per_block=G // splits, grid=(tiles, splits),
                blocks=tiles * splits, smem=smem_bytes(c, C, not head))


def _check(x, w, p, c, ls=None, lb=None, shuffle=None):
    if x.dtype != torch.bfloat16 or x.dim() != 3:
        raise ValueError(f"{NAME} kernel takes a (B, N, C) bf16 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    C = x.shape[-1]
    if C % DEPTH or C > MAX_CIN or c not in WIDTHS or \
            tuple(w.shape) != (p * p * c, C):
        raise ValueError(f"{NAME} kernel needs C a multiple of {DEPTH} up "
                         f"to {MAX_CIN}, c in {WIDTHS} and w of shape "
                         f"(p²c, C), got C={C}, c={c}, w {tuple(w.shape)}")
    if ls is not None and any(v.dtype not in LN_DTYPES or v.dtype != ls.dtype
                              or tuple(v.shape) != (c,) for v in (ls, lb)):
        raise ValueError(f"{NAME} kernel takes LN vectors of shape ({c},), "
                         f"both bf16 or both fp32")
    if shuffle is not None and shuffle[0] * shuffle[1] != x.shape[1]:
        raise ValueError(f"{NAME}: shuffle {shuffle} is not a map of "
                         f"{x.shape[1]} tokens")


def patch_expand(x, w, ls, lb, *, p: int, c: int, eps: float = 1e-5,
                 shuffle=None):
    """Wrapper: plain version for a CPU tensor or with the kernels off,
    the CUDA kernel otherwise, whose backward is autograd of the plain
    version. shuffle=(H, W): the pixel-shuffled layout (B, p²·H·W, c)."""
    if _build.plain(NAME, x):
        return patch_expand_plain(x, w, ls, lb, p=p, c=c, eps=eps,
                                  shuffle=shuffle)
    return _build.with_plain_backward(
        lambda *a: _launch(*a, p, c, eps, shuffle),
        lambda *a: patch_expand_plain(*a, p=p, c=c, eps=eps,
                                      shuffle=shuffle), x, w, ls, lb)


def _launch(x, w, ls, lb, p, c, eps, shuffle=None):
    _check(x, w, p, c, ls, lb, shuffle)
    global launches
    x = _build.aligned(x)
    B, N, C = x.shape
    pl = plan(B, N, C, c, p, _build.sms(x))
    shape = (B, N, p * p * c) if shuffle is None else (B, p * p * N, c)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    fn = _build.entry(NAME, "patch_expand", [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
    args = (x, _build.aligned(_build.bf16(w)), ls.contiguous(),
            lb.contiguous(), out)
    rc = fn(*[_build.ptr(t) for t in args], B * N, C, c, p, pl["splits"], N,
            N if shuffle is None else shuffle[1], int(shuffle is not None),
            int(ls.dtype == torch.float32), eps, _build.stream_of(x))
    _build.check(rc, NAME)
    launches += 1
    _build.tally(NAME, tuple(x.shape), p, layout(shuffle))
    return out


def layout(shuffle) -> str:
    """The layout part of a K4 or K7 launch's tally key."""
    return "pre-shuffle" if shuffle is None else "shuffled"
