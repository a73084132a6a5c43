"""Bridge softmax cross-attention: softmax(Q·Kᵀ·scale)·V.

Replaces transception_tpu/ops/pallas/bridge_attention_kernel.py:256
`bridge_softmax_attention` (pallas_call at :279): q (B, 1, 6076, 64)
against the Scale_reduce'd k/v (B, 1, 784, 64), scale 1/8, in bridge
layers 2-4.

Bound on the H100: bytes at the published shapes (the q/out stream,
2·B·N·d·2 bytes, dominates K/V; ~39 GFLOP over ~57 MB is under the bf16
ridge), with ~154 M exponentials per call. Without a kernel the
(B, 6076, 784) fp32 probability matrix goes through device memory.

Design (csrc/bridge_attention.cu): flash-shaped, but two passes over K
per 64-row query tile instead of an online softmax, so the rounding is the
TPU's: the row max over all M keys first, then e = exp(l − m) with the
unrounded e summed in fp32 and the bf16-rounded e multiplied into V on the
tensor cores, and one divide of the (rows, d) output by the sum
(bridge_attention_kernel.py:59-75). M = 784 is short, so recomputing
Q·Kᵀ costs less than keeping the (64, 784) logits. The ragged last tile
of N = 6076 is zero-filled on load and masked on store; the TPU's padding
of the stream to 6144 is not carried over.
"""

from __future__ import annotations

import ctypes

import torch

from transception_tpu_torch.ops.kernels import _build

NAME = "bridge_attention"
REPLACES = "transception_tpu/ops/pallas/bridge_attention_kernel.py:256"
HEAD_DIM = 64
launches = 0


def bridge_attention_plain(q, k, v, scale: float):
    """Plain version with the Pallas kernel's rounding points: fp32
    logits, row max, e = exp(l − m), P·V on bf16(e), divide by the fp32
    sum of e. q: (B, h, N, d); k, v: (B, h, M, d)."""
    dt = v.dtype
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - m)
    out = torch.matmul(e.to(dt).float(), v.float())
    return (out / e.sum(-1, keepdim=True)).to(dt)


def _check(q, k, v):
    for t in (q, k, v):
        if t.dtype != torch.bfloat16 or t.dim() != 4:
            raise ValueError(f"{NAME} kernel takes (B, h, n, d) bf16 "
                             f"tensors, got {tuple(t.shape)} {t.dtype}")
    if q.shape[-1] != HEAD_DIM or k.shape != v.shape or \
            k.shape[:2] != q.shape[:2] or k.shape[-1] != HEAD_DIM:
        raise ValueError(f"{NAME} kernel needs head dim {HEAD_DIM} and "
                         f"matching q/k/v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[2] % 16:
        raise ValueError(f"{NAME} kernel needs M % 16 == 0, "
                         f"got M={k.shape[2]}")


def bridge_attention(q, k, v, scale: float):
    """Wrapper: plain version for a CPU tensor or with the kernels off,
    the CUDA kernel otherwise."""
    if _build.plain(q):
        return bridge_attention_plain(q, k, v, scale)
    _check(q, k, v)
    global launches
    q, k, v = (_build.aligned(t) for t in (q, k, v))
    B, h, N, d = q.shape
    M = k.shape[2]
    out = torch.empty_like(q)
    fn = _build.load(NAME).bridge_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    P = _build.ptr
    rc = fn(P(q), P(k), P(v), P(out), B * h, N, M, scale,
            _build.stream_of(q))
    _build.check(rc, NAME)
    launches += 1
    return out
