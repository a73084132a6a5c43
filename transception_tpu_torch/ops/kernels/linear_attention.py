"""Fused linear attention: Q' · (softmax_N(K)ᵀ · V) per (batch, head).

Replaces transception_tpu/ops/pallas/linear_attention_kernel.py:235
`linear_attention` (pallas_call at :252). On the serving path it is the
factorized attention of the stage-4 MHCA blocks (7² maps, where the
whole-block kernel does not run): q/k/v (B, 8, 49, 40), q_softmax False,
9 calls per forward; the caller applies the scale to the rounded output,
as ops/attention.py:58 does after the Pallas kernel. The TPU gate sends
head dims under 64 to XLA (VMEM tiling); the H100 has no such limit.

Bound on the H100: bytes (q, k, v in and the output once, ~4 MB at
B = 32, against ~0.3 MFLOP per (batch, head)).

Design (csrc/linear_attention.cu): one block per (batch, head) keeps
the head's K, V and (dk, dv) context in fp32 shared memory; the column
softmax, the context and the output product are plain fp32 loops,
rounded where the Pallas kernel rounds (softmax(K), context, output).
"""

from __future__ import annotations

import ctypes

import torch

from transception_tpu_torch.ops.kernels import _build

NAME = "linear_attention"
REPLACES = "transception_tpu/ops/pallas/linear_attention_kernel.py:235"
SMEM_LIMIT = 232448  # bytes a block may opt into on sm_90
launches = 0


def linear_attention_plain(q, k, v, q_softmax: bool = False):
    """Plain version with the Pallas kernel's rounding points. q, k
    (B, h, N, dk); v (B, h, N, dv) -> (B, h, N, dv) in v's dtype."""
    dt = v.dtype
    ks = torch.softmax(k.float(), dim=2).to(dt)
    ctx = torch.matmul(ks.float().transpose(-1, -2), v.float()).to(dt)
    qu = torch.softmax(q.float(), dim=3).to(dt) if q_softmax else q
    return torch.matmul(qu.float(), ctx.float()).to(dt)


def _check(q, k, v):
    if any(t.dtype != torch.bfloat16 or t.dim() != 4 for t in (q, k, v)):
        raise ValueError(f"{NAME} kernel takes (B, h, N, d) bf16 tensors, "
                         f"got {q.dtype} {tuple(q.shape)}")
    B, h, N, dk = q.shape
    dv = v.shape[-1]
    if tuple(k.shape) != (B, h, N, dk) or tuple(v.shape[:3]) != (B, h, N):
        raise ValueError(f"{NAME} kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if (N * dk + N * dv + dk * dv) * 4 > SMEM_LIMIT:
        raise ValueError(f"{NAME} kernel: a head of (N={N}, dk={dk}, "
                         f"dv={dv}) exceeds shared memory")


def linear_attention(q, k, v, q_softmax: bool = False):
    """Wrapper: plain version for a CPU tensor or with the kernels off,
    the CUDA kernel otherwise."""
    if _build.plain(NAME, v):
        return linear_attention_plain(q, k, v, q_softmax)
    _build.forward_only(NAME, q, k, v)
    _check(q, k, v)
    global launches
    q, k, v = (t.contiguous() for t in (q, k, v))
    B, h, N, dk = q.shape
    dv = v.shape[-1]
    out = torch.empty((B, h, N, dv), dtype=v.dtype, device=v.device)
    fn = _build.load(NAME).linear_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    rc = fn(*[_build.ptr(t) for t in (q, k, v, out)], B * h, N, dk, dv,
            int(q_softmax), _build.stream_of(v))
    _build.check(rc, NAME)
    launches += 1
    return out
