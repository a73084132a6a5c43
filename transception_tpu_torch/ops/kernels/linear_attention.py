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
    (B, 1, 196, 320);
  * the legacy models' linear attentions (models/legacy.py), q_softmax
    True: their unfolded ETBs at those maps and EffMiT's stage 4,
    (B, 1, 49, 512); the two-branch encoder's fused sequences at
    head_count 8, (B, 8, 1460, 16), (B, 8, 340, 40), (B, 8, 74, 64);
    ResInception's one-head fused sequences, (B, 1, 2352, 128),
    (B, 1, 588, 320), (B, 1, 147, 512) and ('135') (B, 1, 3136, 128),
    (B, 1, 784, 320), (B, 1, 196, 512).
The TPU gate sends head dims under 64 to XLA (VMEM tiling); the H100 has
no such limit.

Bound on the H100: bytes (q, k, v in and the output once, 4·B·h·N·d·2
bytes, against ~4·B·h·N·d² flops: at d ≤ 320 far below the bf16 ridge).
At the MHCA shapes the bytes are a few MB (1.2 us at (32, 8, 49, 40)), so
what a call costs there is its launches and allocations.

Design (csrc/linear_attention.cu), two bodies that `plan` picks by shape:
  * head: where one head's q, k and v fit a block's shared memory (head
    dims up to 64; every MHCA shape: 11.8 KB of q, k and v at (49, 40),
    37.6 KB at (784, 8), 18.8 KB at (196, 16)). One CUDA launch, a block
    per head (192 and 256 blocks at b = 24 and 32 for 132 SMs; two heads
    a block would leave 96 and 128); the head staged whole by cp.async as
    16-byte rows, the column statistics, Ks, the context and the output on
    chip with CUDA-core FMAs (head dims 8 and 40 would leave the tensor
    cores' 16-wide operands half padding), no device-memory partials and
    no workspace.
  * segmented: the ETB shapes and anything larger. The linear-attention
    core that K1 shares (csrc/linear_attention.cuh): N cut into S
    segments of whole 64-row chunks (S chosen so that the context stage
    has two blocks per SM), per segment the column max and sum of exp(K),
    per (64 x 64 context tile, segment) Ks = bf16(exp(K − m) / S) formed
    in shared memory and the fp32 partial of Ksᵀ·V on the tensor cores
    (cp.async ring, ldmatrix, mma.sync), the partials added in a fixed
    order and rounded to bf16, then per (64 columns, 64 rows) Q' (the
    channel softmax of Q, rounded, or Q) times the context, scaled in fp32
    and rounded once. No atomics: the same bits in every launch.

The fp32 form (csrc/linear_attention.cu linear_attention_f32; the fp32
eval forward runs its head body at stage 4, (B, 8, 49, 40)): both bodies at
fp32 with no rounding points; the core's products on the CUDA cores
(mixffn_stages.cuh's fp32 step, 32-row ctx chunks of the same bytes). The
plans take the element size (`plan(..., es=4)`): the head body's q, k, v
and context double, the out stage's Q rows and context tile double; where
the whole context tile no longer fits beside Q's rows (fp32 at head dim
512), the out stage stages it in pieces of whole 64-row tiles, one after
another (out_ctx_rows: 384 rows, then 128).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from transception_tpu_torch.ops.kernels import _build

NAME = "linear_attention"
REPLACES = "transception_tpu/ops/pallas/linear_attention_kernel.py:235"
SMEM_LIMIT = 232448  # bytes a block may opt into on sm_90
# The core's tiling (THREADS of csrc/mixffn_stages.cuh; CT, RC, RO, SCOLS,
# CSTAGES of csrc/linear_attention.cuh) and the head body's widest head
# (HEAD_MAX, csrc/linear_attention.cu); tests/test_torch_linear_plan.py
# holds the copies equal.
THREADS = 256
CTX_TILE = 64
CHUNK_ROWS = 64
OUT_ROWS = 64
STATS_COLS = 32
CTX_STAGES = 3
HEAD_MAX = 64
MAX_D = 512  # the segmented body's widest head
BODIES = ("head", "segmented")
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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def head_smem(N: int, dk: int, dv: int, es: int = 2) -> int:
    """Shared memory of one head-body block over elements of es bytes
    (mirrors head_smem in the .cu): q, k and v of the head, the column
    statistics, a reduction row, the context strips' fp32 partials, the
    context."""
    strips = dk * (dv // 8)
    return ((2 * N * dk + N * dv) * es + (2 * HEAD_MAX + THREADS) * 4
            + 8 * max(strips, THREADS) * 4 + dk * dv * es)


def stats_smem() -> int:
    """Static shared memory of one core stats-stage block: the (m, l)
    pairs of its row groups (four lanes a row of 32 columns)."""
    return THREADS // (STATS_COLS // 8) * STATS_COLS * 8


def ctx_smem() -> int:
    """Shared memory of one core ctx-stage block (lin::ctx_smem): the ring
    of K and V chunks (64 bf16 or 32 fp32 rows of 64 channels: the same
    bytes), the column statistics."""
    return CTX_STAGES * 2 * CHUNK_ROWS * CTX_TILE * 2 + 2 * CTX_TILE * 4


def out_ctx_rows(dk: int, es: int = 2) -> int:
    """Rows of the context's column tile one core out-stage block stages
    at once (lin::out_ctx_rows): all of dk rounded up to 64 where they fit
    beside Q's rows in SMEM_LIMIT, else as many whole 64-row tiles as fit
    (fp32 at dk = 512: 384 rows, then the other 128)."""
    dkp = _cdiv(dk, CTX_TILE) * CTX_TILE
    room = (SMEM_LIMIT // es - OUT_ROWS * dkp) // CTX_TILE // CTX_TILE \
        * CTX_TILE
    return min(room, dkp)


def out_smem(dk: int, es: int = 2) -> int:
    """Shared memory of one core out-stage block over elements of es bytes
    (lin::out_smem): Q's rows over dk rounded up to 64 channels and a
    piece of out_ctx_rows rows of the context's column tile."""
    dkp = _cdiv(dk, CTX_TILE) * CTX_TILE
    return (OUT_ROWS * dkp + out_ctx_rows(dk, es) * CTX_TILE) * es


def core_plan(bh: int, N: int, dk: int, dv: int, sms: int, es: int = 2
              ) -> dict:
    """The linear-attention core's plan (K6's segmented body, K1's stages
    2-4) for bh heads of N rows on a card of `sms` SMs: S segments of
    `segment_rows` rows (whole 64-row chunks, none empty; as many
    segments as give the context stage two blocks per SM, before the
    rounding to chunks), the blocks of each
    stage, the workspace bytes in the entry's order (the statistics, the
    fp32 partials when S > 1, the context in elements of es bytes) and each
    stage's shared memory."""
    tk, tv = _cdiv(dk, CTX_TILE), _cdiv(dv, CTX_TILE)
    S = max(1, min(_cdiv(2 * sms, tk * tv * bh), _cdiv(N, CHUNK_ROWS)))
    rows = _cdiv(_cdiv(N, S), CHUNK_ROWS) * CHUNK_ROWS
    S = _cdiv(N, rows)
    blocks = {"stats": _cdiv(dk, STATS_COLS) * S * bh, "ctx": tk * tv * S * bh}
    if S > 1:
        blocks["sum"] = _cdiv(bh * dk * dv, 256)
    blocks["out"] = tv * _cdiv(N, OUT_ROWS) * bh
    workspace = {"part": S * bh * dk * 8,
                 "pctx": S * bh * dk * dv * 4 if S > 1 else 0,
                 "ctx": bh * dk * dv * es}
    return dict(segments=S, segment_rows=rows, blocks=blocks,
                workspace=workspace,
                smem={"stats": stats_smem(), "ctx": ctx_smem(),
                      "out": out_smem(dk, es)})


def plan(bh: int, N: int, dk: int, dv: int, sms: int, es: int = 2) -> dict:
    """K6's plan for bh heads of N rows, head dims dk and dv, on a card of
    `sms` SMs, over elements of es bytes (2 bf16, 4 fp32): the body
    ("head", a block per head, where a head fits a
    block; else "segmented", the core), the segments (1 for the head body:
    the whole head is on chip), blocks, workspace and shared memory of
    each stage, and `plan`, the int list the CUDA entry takes (body,
    segments, segment rows)."""
    if dk <= HEAD_MAX and dv <= HEAD_MAX and \
            head_smem(N, dk, dv, es) <= SMEM_LIMIT:
        return dict(body="head", segments=1, segment_rows=N,
                    blocks={"head": bh}, workspace={},
                    smem={"head": head_smem(N, dk, dv, es)},
                    plan=[BODIES.index("head"), 1, N])
    core = core_plan(bh, N, dk, dv, sms, es)
    return dict(core, body="segmented",
                plan=[BODIES.index("segmented"), core["segments"],
                      core["segment_rows"]])


@functools.lru_cache(maxsize=None)
def _launch_plan(bh, N, dk, dv, sms, es=2):
    """plan's workspace sizes and its int list as the entry takes it (a
    ctypes array, read only), kept per shape, card and element size."""
    pl = plan(bh, N, dk, dv, sms, es)
    return (tuple(pl["workspace"].values()),
            (ctypes.c_int * len(pl["plan"]))(*pl["plan"]))


def _check(q, k, v):
    _build.element_dtype(NAME, q, k, v)
    if any(t.dim() != 4 for t in (q, k, v)):
        raise ValueError(f"{NAME} kernel takes (B, h, N, d) tensors, "
                         f"got {q.dtype} {tuple(q.shape)}")
    B, h, N, dk = q.shape
    if tuple(k.shape) != (B, h, N, dk) or tuple(v.shape[:3]) != (B, h, N):
        raise ValueError(f"{NAME} kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    dv = v.shape[-1]
    if dk % 8 or dv % 8 or max(dk, dv) > MAX_D or \
            out_ctx_rows(dk, q.element_size()) < CTX_TILE:
        raise ValueError(f"{NAME} kernel needs head dims that are "
                         f"multiples of 8 up to {MAX_D}, got {dk}, {dv}")


def linear_attention(q, k, v, q_softmax: bool = False, scale: float = 1.0):
    """Wrapper: plain version with the kernels off or where autograd
    records on the CPU, else the operator (the CUDA kernel, whose backward
    is autograd of the plain version)."""
    if _build.plain(NAME, v):
        return linear_attention_plain(q, k, v, q_softmax, scale)
    return _build.with_plain_backward(
        lambda *a: OP(*a, q_softmax, scale),
        lambda *a: linear_attention_plain(*a, q_softmax, scale), q, k, v)


def _launch(q, k, v, q_softmax, scale):
    _check(q, k, v)
    global launches
    q, k, v = (_build.aligned(t) for t in (q, k, v))
    B, h, N, dk = q.shape
    dv = v.shape[-1]
    sizes, ints = _launch_plan(B * h, N, dk, dv, _build.sms(v),
                               v.element_size())
    out = torch.empty((B, h, N, dv), dtype=v.dtype, device=v.device)
    # The head body takes no workspace: null pointers for the partials.
    ws, work = (_build.workspace(sizes, v.device) if sizes
                else (None, [None] * 3))
    fn = _build.entry(NAME, _build.symbol("linear_attention", v.dtype),
                      [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                      + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(*[_build.ptr(t) for t in (q, k, v, out)], *work, ints, B * h, N,
            dk, dv, int(q_softmax), scale, _build.stream_of(v))
    _build.check(rc, NAME)
    launches += 1
    _build.tally(NAME, tuple(q.shape), bool(q_softmax), _build.tag(v))
    return out


OP = _build.define(
    NAME, "(Tensor q, Tensor k, Tensor v, bool q_softmax, float scale) -> "
    "Tensor", _launch, linear_attention_plain,
    lambda q, k, v, *a: v.new_empty(tuple(q.shape[:3]) + (v.shape[-1],)))
