"""Fused linear attention: scale · Q' · (softmax_N(K)ᵀ · V) per (batch, head).

Replaces transception_tpu/ops/pallas/linear_attention_kernel.py:235
`linear_attention` (pallas_call at :252). On the serving path it takes:
  * the factorized attention of the MHCA blocks that do not run the
    whole-block kernel, q_softmax False, the scale applied to the fp32
    product before the one rounding (as the JAX package computes it in XLA
    at every MHCA head dim, ops/attention.py:68-73): stage 4's 7² maps,
    q/k/v (B, 8, 49, 40), and with mhca_block_fold off stages 2-3,
    (B, 8, 784, 8) and (B, 8, 196, 16);
  * the EfficientAttention of the ETBs with etb_attn_fold off, q_softmax
    True (ops/attention.py:33-55): (B, 1, 3136, 64), (B, 1, 784, 128) and
    (B, 1, 196, 320).
The TPU gate sends head dims under 64 to XLA (VMEM tiling); the H100 has
no such limit.

Bound on the H100: bytes (q, k, v in and the output once, 4·B·h·N·d·2
bytes, against ~4·B·h·N·d² flops: at d ≤ 320 far below the bf16 ridge).

Design (csrc/linear_attention.cu): a head of N = 3136 tokens does not fit
a block's shared memory, and blocks run in parallel, so the column softmax
of K and the context Ksᵀ·V, both reductions over N, are cut into S
segments of N (S chosen so that segments x context tiles x batch·heads
fill the card): per segment the online column max and sum of exp(K), then
per (64 x 64 context tile, segment) the fp32 partial of Ksᵀ·V from
Ks = bf16(exp(K − m) / S) and V staged in 64-row chunks, the partials added
in a fixed order (no atomics: the same result in every run) and rounded to
bf16, and last Q' (the channel softmax of Q, rounded, or Q) times the
context per 64 rows and 64 columns, scaled in fp32 and rounded once. Both
products run on the tensor cores (WMMA, bf16 operands that are bf16
values in the Pallas kernel too, fp32 accumulation); head dims that are
no multiple of 16 (8, 40) are zero-padded in shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from transception_tpu_torch.ops.kernels import _build

NAME = "linear_attention"
REPLACES = "transception_tpu/ops/pallas/linear_attention_kernel.py:235"
SMEM_LIMIT = 232448  # bytes a block may opt into on sm_90
TILE_K = TILE_V = 64  # context tile of csrc/linear_attention.cu
FILL_BLOCKS = 264     # 2 blocks per SM on 132 SMs
launches = 0


def linear_attention_plain(q, k, v, q_softmax: bool = False,
                           scale: float = 1.0):
    """Plain version with the Pallas kernel's rounding points, the scale
    applied to the fp32 product before its one rounding. q, k (B, h, N,
    dk); v (B, h, N, dv) -> (B, h, N, dv) in v's dtype."""
    dt = v.dtype
    ks = torch.softmax(k.float(), dim=2).to(dt)
    ctx = torch.matmul(ks.float().transpose(-1, -2), v.float()).to(dt)
    qu = torch.softmax(q.float(), dim=3).to(dt) if q_softmax else q
    return (torch.matmul(qu.float(), ctx.float()) * scale).to(dt)


def out_smem_bytes(dk: int) -> int:
    """Shared memory of one output block (mirrors out_smem in the .cu):
    Q' rows and the context tile in bf16 at the padded head dim, the fp32
    output tile."""
    dkp = -(-dk // 16) * 16
    return (64 * dkp + dkp * TILE_V) * 2 + 64 * TILE_V * 4


def segments(N: int, dk: int, dv: int, bh: int) -> int:
    """Segments of N per (batch, head): enough blocks to fill the card,
    at least 32 rows a segment."""
    tiles = -(-dk // TILE_K) * -(-dv // TILE_V)
    want = -(-FILL_BLOCKS // (tiles * bh))
    s = max(1, min(want, -(-N // 32)))
    return -(-N // -(-N // s))  # no empty segment


def _check(q, k, v):
    if any(t.dtype != torch.bfloat16 or t.dim() != 4 for t in (q, k, v)):
        raise ValueError(f"{NAME} kernel takes (B, h, N, d) bf16 tensors, "
                         f"got {q.dtype} {tuple(q.shape)}")
    B, h, N, dk = q.shape
    if tuple(k.shape) != (B, h, N, dk) or tuple(v.shape[:3]) != (B, h, N):
        raise ValueError(f"{NAME} kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if out_smem_bytes(dk) > SMEM_LIMIT:
        raise ValueError(f"{NAME} kernel: head dim {dk} exceeds shared "
                         f"memory")


def linear_attention(q, k, v, q_softmax: bool = False, scale: float = 1.0):
    """Wrapper: plain version for a CPU tensor or with the kernels off,
    the CUDA kernel otherwise, whose backward is autograd of the plain
    version."""
    if _build.plain(NAME, v):
        return linear_attention_plain(q, k, v, q_softmax, scale)
    return _build.with_plain_backward(
        lambda *a: _launch(*a, q_softmax, scale),
        lambda *a: linear_attention_plain(*a, q_softmax, scale), q, k, v)


def _launch(q, k, v, q_softmax, scale):
    _check(q, k, v)
    global launches
    q, k, v = (t.contiguous() for t in (q, k, v))
    B, h, N, dk = q.shape
    dv = v.shape[-1]
    bh = B * h
    S = segments(N, dk, dv, bh)
    f32 = dict(device=v.device, dtype=torch.float32)
    out = torch.empty((B, h, N, dv), dtype=v.dtype, device=v.device)
    part = torch.empty((S, bh, dk, 2), **f32)
    pctx = torch.empty((S, bh, dk, dv), **f32)
    ctx = torch.empty((bh, dk, dv), dtype=v.dtype, device=v.device)
    fn = _build.load(NAME).linear_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    rc = fn(*[_build.ptr(t) for t in (q, k, v, out, part, pctx, ctx)], bh, N,
            dk, dv, S, int(q_softmax), scale, _build.stream_of(v))
    _build.check(rc, NAME)
    launches += 1
    _build.tally(NAME, tuple(q.shape), bool(q_softmax))
    return out
