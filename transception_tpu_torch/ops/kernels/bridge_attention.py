"""Bridge softmax cross-attention: softmax(Q·Kᵀ·scale)·V, its backward, and
its folded form res + proj(MHA(x·Wq + bq)).

K3 replaces transception_tpu/ops/pallas/bridge_attention_kernel.py:256
`bridge_softmax_attention` (pallas_call at :279): q (B, 1, 6076, 64)
against the Scale_reduce'd k/v (B, 1, 784, 64), scale 1/8, in bridge
layers 2-4. K10 replaces its backward, bridge_attention_kernel.py:190
`bridge_softmax_attention_bwd` (pallas_call at :215). The two form one
torch.autograd.Function, the one path of the bridge attention in both
train modes and in eval.

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

K10 bound on the H100: operations. Per launch about 10·N·M·d·B flops
(recomputed logits, dP = G·Vᵀ, T·K, Tᵀ·Q, Eᵀ·G: 7.3e10 at B = 24, 0.074 ms
at the bf16 peak) against ~70 MB of bf16 traffic (0.021 ms). Without a
kernel two (B, 6076, 784) fp32 matrices go through device memory.

K10 design (csrc/bridge_attention_bwd.cu). Blocks run in parallel on
Hopper, so the TPU's sequential dK/dV accumulation over N tiles
(bridge_attention_kernel.py:178-186) becomes two kernels. A rows kernel
per 64 query rows recomputes the row statistics in two passes over K/V
(max; rowsum E and rowsum E∘dP, as the TPU does) and then dQ = (T·K)·s/S
in a third, writing dQ and the (m, S, c) statistics (12 bytes a row). A
columns kernel per (112 keys, N segment) keeps its keys' dK/dV in
registers and walks the segment's query rows, recomputing E and T from the
statistics; the segments' fp32 partials are added in a fixed order, so
there are no atomics and the result is the same in every run. The
(N, M) matrices stay on chip; E, T, Q·s/S and G/S are rounded to bf16 as
tensor-core operands, with fp32 accumulation.

K8 replaces bridge_attention_kernel.py:307 `bridge_attention_folded`
(pallas_call at :332): res + proj(MHA(x·Wq + bq)) with x the post-norm1
stream and res the raw layer input, (B, 6076, 64), against K3's k/v, in
bridge layers 2-4 when bridge_attn_fold is on: in eval, and in the
train step with use_pallas_train, where its backward is autograd of the
plain version (JAX's is the mirror's VJP, bridge_attention.py:115).
Rounding points of its _folded_kernel (:78-133): q = bf16(x·Wq + bq) with
fp32 accumulation; K3's softmax (row max over all M, bf16(e) into P·V,
one divide); the out projection accumulated in fp32, + bp, rounded; the
residual added in fp32, rounded. In fp32 these are the mirror's
(bridge_attention.py:79-100 _reference_folded).

K8 bound on the H100: operations (about 4·B·N·M·d for the attention plus
4·B·N·C² for the projections, 4.2e10 flops at B = 32, 0.043 ms at the bf16
peak, against ~81 MB of bf16 traffic, 0.024 ms).

K8 design (csrc/bridge_attention_folded.cu): K3's block of 64 stream rows
with a prologue and an epilogue. The prologue loads the x tile and forms
q = x·Wqᵀ on the tensor cores (one (64 x 64)·(64 x 64) product), adds bq
in fp32 and rounds; K3's two passes over K/V follow; the rounded attention
output goes back into the x tile's shared memory, and the epilogue forms
its out projection on the tensor cores, adds bp, rounds, adds the
residual in fp32 and rounds. Rows past N (the ragged last tile of 6076)
are zero-filled on load and never stored; the TPU's padding of the
stream is not carried over. One head of d = 64, as the published bridge
(bridge_heads 1).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from transception_tpu_torch.ops.kernels import _build

NAME = "bridge_attention"
REPLACES = "transception_tpu/ops/pallas/bridge_attention_kernel.py:256"
HEAD_DIM = 64
BWD_NAME = "bridge_attention_bwd"
BWD_REPLACES = "transception_tpu/ops/pallas/bridge_attention_kernel.py:190"
BWD_SEGMENTS = 4  # N segments of the K10 columns kernel (blocks x 4)
FOLDED_NAME = "bridge_attention_folded"
FOLDED_REPLACES = "transception_tpu/ops/pallas/bridge_attention_kernel.py:307"
launches = 0
bwd_launches = 0
folded_launches = 0


def bridge_attention_plain(q, k, v, scale: float):
    """Plain version with the Pallas kernel's rounding points: fp32
    logits, row max, e = exp(l − m), P·V on bf16(e), divide by the fp32
    sum of e. q: (B, h, N, d); k, v: (B, h, M, d)."""
    dt = v.dtype
    ct = torch.promote_types(dt, torch.float32)  # fp32 (fp64 for fp64)
    logits = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)) * scale
    m = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - m)
    out = torch.matmul(e.to(dt).to(ct), v.to(ct))
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


def bridge_attention_bwd_plain(q, k, v, g, scale: float):
    """Plain backward with the Pallas backward's math
    (bridge_attention_kernel.py:136-186): fp32 throughout, 1/rowsum
    factored onto the (rows, d) side; dq in q's dtype, dk and dv
    accumulated in fp32 and cast to k's and v's. g: cotangent of out."""
    f32 = torch.promote_types(q.dtype, torch.float32)  # fp64 stays fp64
    qf, kf, vf, gf = (t.to(f32) for t in (q, k, v, g))
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    s = e.sum(-1, keepdim=True)
    dv = torch.matmul(e.transpose(-1, -2), gf / s)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    t = e * (dp - (e * dp).sum(-1, keepdim=True) / s)
    dq = torch.matmul(t, kf) * (scale / s)
    dk = torch.matmul(t.transpose(-1, -2), qf / s) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _launch(q, k, v, scale):
    global launches
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
    _build.tally(NAME, tuple(q.shape))
    return out


def bridge_attention_bwd(q, k, v, g, scale: float):
    """K10 wrapper: (dq, dk, dv) of softmax(q·kᵀ·scale)·v for cotangent
    g; the plain version for a CPU tensor or with the kernel off."""
    if _build.plain(NAME, q):
        return bridge_attention_bwd_plain(q, k, v, g, scale)
    return _launch_bwd(q, k, v, g, scale)


def _launch_bwd(q, k, v, g, scale):
    _check(q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"{BWD_NAME} kernel needs g like q, got "
                         f"{tuple(g.shape)} {g.dtype}")
    global bwd_launches
    q, k, v, g = (_build.aligned(t) for t in (q, k, v, g))
    B, h, N, d = q.shape
    M = k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    f32 = dict(device=q.device, dtype=torch.float32)
    stats = torch.empty(B * h, N, 4, **f32)
    dkp = torch.empty(BWD_SEGMENTS, B * h, M, d, **f32)
    dvp = torch.empty_like(dkp)
    fn = _build.load(BWD_NAME).bridge_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    P = _build.ptr
    rc = fn(P(q), P(k), P(v), P(g), P(dq), P(dk), P(dv), P(stats), P(dkp),
            P(dvp), B * h, N, M, scale, BWD_SEGMENTS, _build.stream_of(q))
    _build.check(rc, BWD_NAME)
    bwd_launches += 1
    _build.tally(BWD_NAME, tuple(q.shape))
    return dq, dk, dv


class BridgeAttention(torch.autograd.Function):
    """K3 forward and K10 backward (the plain versions on the CPU). Saves
    q, k and v; the forward's result is K3's, bit for bit."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.device.type == "cpu":
            out = bridge_attention_plain(q, k, v, scale)
        else:
            _check(q, k, v)
            out = _launch(*(_build.aligned(t) for t in (q, k, v)), scale)
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        bwd = (bridge_attention_bwd_plain if q.device.type == "cpu"
               else _launch_bwd)
        return (*bwd(q, k, v, g, ctx.scale), None)


def bridge_attention(q, k, v, scale: float):
    """Wrapper: plain version for a CPU tensor or with the kernel off,
    else K3 forward and K10 backward (BridgeAttention)."""
    if _build.plain(NAME, q):
        return bridge_attention_plain(q, k, v, scale)
    return BridgeAttention.apply(q, k, v, scale)


def bridge_attention_folded_plain(x, res, wq, bq, k, v, wp, bp,
                                  scale: float):
    """Plain K8 with the Pallas kernel's rounding points: res +
    proj(MHA(x·Wqᵀ + bq)). x, res (B, N, C); k, v (B, h, M, C/h); wq, wp
    torch Linear weights (C, C), bq, bp (C,)."""
    dt = x.dtype
    ct = torch.promote_types(dt, torch.float32)  # fp32 (fp64 for fp64)
    B, N, C = x.shape
    h = k.shape[1]
    q = F.linear(x.to(ct), wq.to(dt).to(ct), bq.to(ct)).to(dt)
    att = bridge_attention_plain(q.reshape(B, N, h, C // h).transpose(1, 2),
                                 k.to(dt), v.to(dt), scale)
    att = att.transpose(1, 2).reshape(B, N, C)
    proj = F.linear(att.to(ct), wp.to(dt).to(ct), bp.to(ct)).to(dt)
    return (proj.to(ct) + res.to(ct)).to(dt)


def _check_folded(x, res, k, v):
    if x.dtype != torch.bfloat16 or x.dim() != 3 or res.shape != x.shape \
            or res.dtype != x.dtype:
        raise ValueError(f"{FOLDED_NAME} kernel takes x and res (B, N, "
                         f"{HEAD_DIM}) bf16, got {tuple(x.shape)} {x.dtype},"
                         f" {tuple(res.shape)} {res.dtype}")
    B, N, C = x.shape
    if C != HEAD_DIM or k.shape[:2] != (B, 1):
        raise ValueError(f"{FOLDED_NAME} kernel takes one head of "
                         f"{HEAD_DIM} channels, got x {tuple(x.shape)}, "
                         f"k {tuple(k.shape)}")
    _check(x[:, None], k, v)


def bridge_attention_folded(x, res, wq, bq, k, v, wp, bp, scale: float):
    """K8 wrapper: the plain version for a CPU tensor or with the kernel
    off, else the CUDA kernel, whose backward is autograd of the plain
    version."""
    if _build.plain(FOLDED_NAME, x):
        return bridge_attention_folded_plain(x, res, wq, bq, k, v, wp, bp,
                                             scale)
    return _build.with_plain_backward(
        lambda *a: _launch_folded(*a, scale),
        lambda *a: bridge_attention_folded_plain(*a, scale),
        x, res, wq, bq, k, v, wp, bp)


def _launch_folded(x, res, wq, bq, k, v, wp, bp, scale):
    _check_folded(x, res, k, v)
    global folded_launches
    x, res, k, v = (_build.aligned(t) for t in (x, res, k, v))
    B, N, C = x.shape
    M = k.shape[2]
    out = torch.empty_like(x)
    bf, f32 = _build.bf16, _build.f32
    args = (x, res, bf(wq), f32(bq), k, v, bf(wp), f32(bp), out)
    fn = _build.load(FOLDED_NAME).bridge_attention_folded
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    rc = fn(*[_build.ptr(t) for t in args], B, N, M, scale,
            _build.stream_of(x))
    _build.check(rc, FOLDED_NAME)
    folded_launches += 1
    _build.tally(FOLDED_NAME, tuple(x.shape))
    return out
