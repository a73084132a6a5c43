"""Bridge softmax cross-attention: softmax(Q·Kᵀ·scale)·V, its backward, and
its folded form res + proj(MHA(x·Wq + bq)).

K3 replaces transception_tpu/ops/pallas/bridge_attention_kernel.py:256
`bridge_softmax_attention` (pallas_call at :279): q (B, 1, 6076, 64)
against the Scale_reduce'd k/v (B, 1, 784, 64), scale 1/8, in bridge
layers 2-4. K10 replaces its backward, bridge_attention_kernel.py:190
`bridge_softmax_attention_bwd` (pallas_call at :215). The two form one
torch.autograd.Function, the one path of the bridge attention in both
train modes and in eval.

K3 bound on the H100: operations. At b=32, 4·B·N·M·d = 3.9e10 flop (Q·Kᵀ
and P·V) over 56 MB (q and out, 2·B·N·d·2 bytes, with k and v) is 690
flop a byte, above the card's bf16 ridge of ~295: 0.0394 ms at the bf16
peak against 0.0168 ms of bytes (chip_smoke.record reckons it so). Add
~152 M exponentials. Without a kernel the (B, 6076, 784) fp32
probability matrix goes through device memory.

K3 design (csrc/bridge_attention.cu on csrc/bridge_softmax.cuh): the
TPU's rounding points (bridge_attention_kernel.py:59-75) forbid an online
softmax, so K is walked twice: pass 1 forms only Q·Kᵀ and the row max
over all M keys; pass 2 forms e = exp(l − m), adds the unrounded e into
the fp32 row sum and bf16(e) into P·V, and the (rows, d) output is
divided by the sum once and rounded once. That is 1.5x the products of a
one-pass flash kernel. A block of 8 warps takes 128 query rows; each warp
keeps its 16 rows of q as mma.m16n8k16 A fragments in registers. K and V
reach shared memory once per block, in 112-key chunks (784 = 7 x 112)
through a 2-deep cp.async ring with XOR-swizzled rows, and every warp
reads them with ldmatrix (.trans for V). A warp's logits stay in
registers: the accumulators of two 8-key tiles, rounded and packed, are
the A fragment of P·V over those 16 keys. exp(l − m) is computed as
2^(l·log2e − m·log2e) on the MUFU (ex2.approx); the max is taken on the
raw logits, so the launchers refuse a scale that is not positive. The
ragged last query tile loads as zero and is never stored; a last key
chunk shorter than 112 (a multiple of 16) is computed over its whole
16-key steps. No atomics.

K3 at fp32 (csrc/bridge_attention.cu bridge_attention_f32, the published
eval protocol's dtype and the fp32 train step's, 3 launches a forward):
bridge_softmax.cuh attend32, fp32-accurate products on the tensor cores
as 3xTF32 (each operand x split into hi = tf32(x) and lo = tf32(x − hi),
rounded to nearest, ties away, a NaN kept as NaN; a·b = lo·hi + hi·lo +
hi·hi in fp32, about 2^-22 relative an operand), in one pass over K and V with an
online max: the TPU kernel's second pass exists for its bf16 rounding
of e, the identity at fp32, so the running sum and output are rescaled
by 2^(m_old − m_new) when a row's max rises (4·B·N·M·d flops, not 6). A
block of 12 warps over 192 query rows, one block an SM: each warp's q
split once into its own 8 KB of shared memory; K and V through a 2-deep
cp.async ring of raw 64-key fp32 chunks, each split once per block into
K hi and lo and Vᵀ hi and lo (channel-major), so every B fragment is an
ldmatrix; mma.m16n8k8 with the logits' tile holding keys t, t + 4 where
P·V's A fragment wants them, so e never leaves the registers. The tensor
cores' fp32 sums round toward zero: the logits keep hi·hi apart from the
small terms, and P·V sums each 32-key step apart, both added in fp32.
exp is ex2.approx; no atomics. The kernel reads nothing of
torch.backends.cuda.matmul.allow_tf32; its plain version runs fp32 with
TF32 off (core/device.py fp32_exact). Bound: operations, 4·B·N·M·d
flops as 3 TF32 products each at 495 TFLOP/s (0.2365 ms at b=32;
0.5825 ms at 67 TFLOP/s of FFMA, the other fp32 forms' yardstick). Where
the time goes is in PERF.md; warps, chunk, ring depth and step are
F32_WARPS, F32_KEY_CHUNK, F32_STAGES and F32_KEY_STEP below.

K10 bound on the H100: operations. Per launch about 10·B·N·M·d flop
(recomputed logits, dP = G·Vᵀ, T·K, Tᵀ·Q, Eᵀ·G: 7.3e10 at B = 24, 0.074 ms
at the bf16 peak) against ~70 MB of bf16 traffic (0.021 ms). Without a
kernel two (B, 6076, 784) fp32 matrices go through device memory.

K10 design (csrc/bridge_attention_bwd.cu). Blocks run in parallel on
Hopper, so the TPU's sequential dK/dV accumulation over N tiles
(bridge_attention_kernel.py:178-186) becomes two kernels on K3's
building blocks. The rows kernel (8 warps, 128 query rows, Q and G in A
fragments, K and V through the same cp.async ring) takes the row
statistics in one pass, with an online rescale of S and rowsum(E∘dP) when
the running max rises (fp32 sums, no bf16 rounding in them), then
dQ = (T·K)·s/S in a second pass with T = E∘(dP − c) packed into A
fragments in registers; it writes dQ and (m·log2e, c, 1/S, s/S) per row.
The columns kernel holds a tile of keys (K and V in A fragments, dK and
dV accumulators in registers, 16 keys a warp) and walks its segment's
query rows in 64-row chunks of Q, G and the statistics through a
cp.async ring. It forms the transposed tiles Lᵀ = K·Qᵀ and dPᵀ = V·Gᵀ,
so that Eᵀ and Tᵀ land in A-fragment layout with the per-row factors
folded in before rounding (bf16(E/S), bf16(T·s/S)), and adds Eᵀ·G and
Tᵀ·Q with Q and G unscaled from shared memory. `bwd_plan` cuts the query
rows into segments so the grid fills the card; the segments' fp32
partials are added in a fixed order, so there are no atomics and the
result is the same in every run. The (N, M) matrices
stay on chip; E/S and T·s/S are the bf16-rounded tensor-core operands of
dV and dK, with fp32 accumulation; the JAX backward is fp32 throughout.

K10 at fp32 (csrc/bridge_attention_bwd.cu bridge_attention_bwd_f32, the
fp32 train step's, 3 launches a step): the same rows and columns kernels,
statistics and fixed-order sum of the segments' partials, with nothing
rounded to a narrower type, every product 3xTF32 on the tensor cores as
in K3's fp32 form (bridge_softmax.cuh's split, mma.m16n8k8 at TF32; lo·hi
+ hi·lo + hi·hi in fp32). A warp's own 16 rows (rows kernel: q and g;
columns kernel: k and v) are split into hi and lo once, into its own 16
KB of shared memory, and read as A fragments (the rows kernel holds q's
and g's hi fragments in registers); each chunk of the other side comes
through a 2-deep cp.async ring and is split once a block, each value
once, as rows (the B operand of L = Q·Kᵀ and dP = G·Vᵀ, or of Lᵀ = K·Qᵀ
and dPᵀ = V·Gᵀ) and transposed (Kᵀ for T·K; Gᵀ and Qᵀ for (E/S)ᵀ·G and
(T·s/S)ᵀ·Q).
The logit tiles read their B rows so that an accumulator's columns 2t,
2t + 1 are the tile's rows t, t + 4, where the next product's A fragment
holds them: T, E/S and T·s/S are split in registers and never reach
shared memory. The tensor cores' fp32 sums round toward zero, so the
logits and dP keep hi·hi apart from the small terms, and the three
second products are summed a chunk apart and added into fp32 totals. The
split is cvt.rna everywhere, so NaNs reach the gradients as in the plain
version. Shared memory sets the chunks (BWD_F32_*, one block an SM): 32
keys a chunk and 8 warps in the rows kernel (208 KB); 32 query rows a
chunk and 112 keys (7 warps) a block in the columns kernel (209 KB), so
`bwd_plan(..., fp32=True)` cuts the rows in 32-row chunks. exp is
ex2.approx. Bound: operations, 10·B·N·M·d flops as 3 TF32 products each
at 495 TFLOP/s (0.4434 ms at b=24; 1.09 ms at 67 TFLOP/s of FFMA); the
kernels do 9 products of 2·B·N·M·d, 1.8x the function's.

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
peak, against ~81 MB of bf16 traffic, 0.024 ms; its fp32 form's 3xTF32
bound 0.2556 ms, FFMA 0.6300 ms).

K8 design (csrc/bridge_attention_folded.cu): K3's core with the
projections folded around it. The attention dominates the flops, so K8
runs on bridge_softmax.cuh's softmax_av, in K3's block of 8 warps over
128 stream rows. Wq and Wp go into swizzled shared memory once per
block; each warp loads its 16 x rows as mma A fragments and forms q =
x·Wqᵀ with mma.sync; + bq in fp32, rounded and packed, the accumulators
are the A fragments of q·Kᵀ, so q never leaves the registers. softmax_av
follows (the cp.async K/V ring of 112-key chunks, logits in registers).
The fp32 output divided by the row sum and rounded is again an A
fragment, for attn·Wpᵀ; + bp, rounded, it is staged through the warp's
rows of the ring and the residual is added in fp32 with 16-byte
coalesced reads, rounded, and stored for the rows below N. The rounding
points are the ones above; the row max is taken on the raw logits, so
`_launch_folded` refuses a scale that is not positive. Rows past N (the
ragged last tile of 6076) load as zero and are never stored; the TPU's
padding of the stream is not carried over. One head of d = 64, as the
published bridge (bridge_heads 1).

K8 at fp32 (bridge_attention_folded_f32; the fp32 sp and para bridges,
any fp32 model with bridge_attn_fold): K3's fp32 block with the
projections as 3xTF32 products too. q = x·Wqᵀ + bq from x's split A
fragments and Wq (in the room of the split chunk, before the first one)
goes into the warp's split q rows; attend32; (o / rowsum)·Wpᵀ takes the
output's accumulators as its A fragment (channels 2t, 2t + 1 at columns
t, t + 4) against Wp, loaded into the same room after the last chunk;
+ bp, staged in the warp's q rows, + res in fp32. The rounding points
are the mirror's (bridge_attention.py:79-100).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from transception_tpu_torch.ops.kernels import _build

NAME = "bridge_attention"
REPLACES = "transception_tpu/ops/pallas/bridge_attention_kernel.py:256"
HEAD_DIM = 64
BWD_NAME = "bridge_attention_bwd"
BWD_REPLACES = "transception_tpu/ops/pallas/bridge_attention_kernel.py:190"
# The K10 columns kernel's tiling, KT and RC of csrc/bridge_attention_bwd.cu
# (tests/test_torch_bridge_plan.py holds the two equal).
BWD_KEY_TILE = 64  # keys a columns block holds (4 warps of 16 keys)
BWD_ROW_CHUNK = 64  # query rows a columns block stages at a time
BWD_BLOCKS_PER_SM = 8  # K10 columns blocks the launch plan aims for per SM
# K3's and K8's fp32 forms: the 3xTF32 core's block shape, F32_WARPS,
# F32_KC, F32_STAGES and F32_KS of csrc/bridge_softmax.cuh
# (tests/test_torch_fp32_kernels.py holds the two equal).
F32_WARPS = 12  # warps a block, 16 query rows each: one block an SM
F32_KEY_CHUNK = 64  # keys per staged chunk
F32_STAGES = 2  # depth of the raw K/V ring
F32_KEY_STEP = 32  # keys per online-softmax step
# K10's fp32 form: KC3, RW, RC3 and KT3 of csrc/bridge_attention_bwd.cu,
# STAGES of csrc/bridge_softmax.cuh (tests/test_torch_fp32_kernels.py and
# tests/test_torch_bridge_plan.py hold them equal).
BWD_F32_KEY_CHUNK = 32  # keys a rows block stages at a time
BWD_F32_STAGES = 2  # depth of the raw rings
BWD_F32_WARPS = 8  # warps of the rows kernel, 16 query rows each
BWD_F32_ROW_CHUNK = 32  # query rows a columns block stages at a time
BWD_F32_KEY_TILE = 112  # keys a columns block holds (7 warps of 16 keys)
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


def _check(q, k, v, dtypes=_build.DTYPES):
    """Raise on what K3 and K10 (bf16 or fp32) or, with dtypes=(bf16,),
    K8 do not take."""
    _build.element_dtype(NAME, q, k, v, dtypes=dtypes)
    for t in (q, k, v):
        if t.dim() != 4:
            raise ValueError(f"{NAME} kernel takes (B, h, n, d) tensors, "
                             f"got {tuple(t.shape)} {t.dtype}")
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


def f32_smem(folded: bool = False) -> int:
    """Shared memory of a block of K3's fp32 form (F32_SMEM of
    csrc/bridge_softmax.cuh): the raw ring of fp32 K and V chunks, the
    chunk split into hi and lo (K, and V transposed) and each warp's split
    q rows (224 KB at 12 warps: one block an SM). folded: K8's, which adds
    its two bias vectors (its weights borrow the split chunk's room)."""
    tile = F32_KEY_CHUNK * HEAD_DIM * 4
    q = 2 * 16 * HEAD_DIM * 4
    return (F32_STAGES * 2 * tile + 4 * tile + F32_WARPS * q
            + (2 * HEAD_DIM * 4 if folded else 0))


def bwd_f32_smem() -> tuple:
    """Shared memory of a block of K10's fp32 form (mirrors RSMEM32 and
    CSMEM32 of csrc/bridge_attention_bwd.cu): the rows kernel's ring of
    raw K and V chunks, the chunk split (K and V rows, Kᵀ; hi and lo) and
    its warps' split q and g rows (208 KB); the columns kernel's ring of
    raw Q and G chunks with their statistics, the chunk split (Q and G
    rows, Qᵀ and Gᵀ) and its warps' split k and v rows (209 KB)."""
    kc = BWD_F32_KEY_CHUNK * HEAD_DIM * 4  # a chunk of K, or Kᵀ
    rc = BWD_F32_ROW_CHUNK * HEAD_DIM * 4  # a chunk of Q, or Qᵀ
    warp = 4 * 16 * HEAD_DIM * 4  # two blocks of 16 rows, hi and lo
    rows = BWD_F32_STAGES * 2 * kc + 6 * kc + BWD_F32_WARPS * warp
    cols = BWD_F32_STAGES * (2 * rc + BWD_F32_ROW_CHUNK * 16) + 8 * rc \
        + BWD_F32_KEY_TILE // 16 * warp
    return rows, cols


def _check_scale(scale):
    if not scale > 0:  # the kernels take the row max on the raw logits
        raise ValueError(f"{NAME} kernels need scale > 0, got {scale}")


def _launch(q, k, v, scale):
    _check_scale(scale)
    global launches
    B, h, N, d = q.shape
    M = k.shape[2]
    out = torch.empty_like(q)
    fn = _build.entry(NAME, _build.symbol(NAME, q.dtype),
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                      + [ctypes.c_float, ctypes.c_void_p])
    P = _build.ptr
    rc = fn(P(q), P(k), P(v), P(out), B * h, N, M, scale,
            _build.stream_of(q))
    _build.check(rc, NAME)
    launches += 1
    _build.tally(NAME, tuple(q.shape), _build.tag(q))
    return out


def bwd_plan(bh: int, n: int, m: int, sms: int, fp32: bool = False):
    """Launch plan of K10's columns kernel for bh batch·heads, n query rows
    and m keys on a card of `sms` SMs: (nseg, seg_rows). The kernel's
    grid has a block per BWD_KEY_TILE keys, per row segment and per
    batch·head; the query rows are cut into nseg segments of seg_rows
    rows, whole BWD_ROW_CHUNK-row chunks and none empty, so that the grid
    has BWD_BLOCKS_PER_SM blocks per SM or as many segments as there are
    chunks. fp32: the fp32 form's BWD_F32_KEY_TILE and BWD_F32_ROW_CHUNK
    (one block an SM: the grid then runs in about BWD_BLOCKS_PER_SM
    waves). The segments' fp32 partials are added in a fixed order."""
    key_tile, row_chunk = ((BWD_F32_KEY_TILE, BWD_F32_ROW_CHUNK) if fp32
                           else (BWD_KEY_TILE, BWD_ROW_CHUNK))
    tiles = -(-m // key_tile)
    chunks = -(-n // row_chunk)
    want = -(-BWD_BLOCKS_PER_SM * sms // (tiles * bh))
    per = -(-chunks // max(1, min(chunks, want)))
    return -(-chunks // per), per * row_chunk


def bridge_attention_bwd(q, k, v, g, scale: float):
    """K10 wrapper: (dq, dk, dv) of softmax(q·kᵀ·scale)·v for cotangent
    g; the plain version for a CPU tensor or with the kernel off."""
    if _build.plain(NAME, q):
        return bridge_attention_bwd_plain(q, k, v, g, scale)
    return _launch_bwd(q, k, v, g, scale)


def _launch_bwd(q, k, v, g, scale):
    """K10 on the card, its bf16 or fp32 form (q's dtype)."""
    _check(q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"{BWD_NAME} kernel needs g like q, got "
                         f"{tuple(g.shape)} {g.dtype}")
    _check_scale(scale)
    global bwd_launches
    q, k, v, g = (_build.aligned(t) for t in (q, k, v, g))
    B, h, N, d = q.shape
    M = k.shape[2]
    nseg, seg_rows = bwd_plan(
        B * h, N, M,
        torch.cuda.get_device_properties(q.device).multi_processor_count,
        fp32=q.dtype == torch.float32)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    f32 = dict(device=q.device, dtype=torch.float32)
    stats = torch.empty(B * h, N, 4, **f32)
    dkp = torch.empty(nseg, B * h, M, d, **f32)  # the segments' partials
    dvp = torch.empty_like(dkp)
    fn = _build.entry(BWD_NAME, _build.symbol(BWD_NAME, q.dtype),
                      [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
                      + [ctypes.c_float] + [ctypes.c_int] * 2
                      + [ctypes.c_void_p])
    P = _build.ptr
    rc = fn(P(q), P(k), P(v), P(g), P(dq), P(dk), P(dv), P(stats), P(dkp),
            P(dvp), B * h, N, M, scale, nseg, seg_rows, _build.stream_of(q))
    _build.check(rc, BWD_NAME)
    bwd_launches += 1
    _build.tally(BWD_NAME, tuple(q.shape), _build.tag(q))
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
    dt = _build.element_dtype(FOLDED_NAME, x, res)
    if x.dim() != 3 or res.shape != x.shape:
        raise ValueError(f"{FOLDED_NAME} kernel takes x and res (B, N, "
                         f"{HEAD_DIM}) of one shape, got {tuple(x.shape)} "
                         f"{dt}, {tuple(res.shape)} {res.dtype}")
    B, N, C = x.shape
    if C != HEAD_DIM or k.shape[:2] != (B, 1):
        raise ValueError(f"{FOLDED_NAME} kernel takes one head of "
                         f"{HEAD_DIM} channels, got x {tuple(x.shape)}, "
                         f"k {tuple(k.shape)}")
    _check(x[:, None], k, v, dtypes=(dt,))
    return dt


def bridge_attention_folded(x, res, wq, bq, k, v, wp, bp, scale: float):
    """K8 wrapper: the plain version for a CPU tensor or with the kernel
    off, else the CUDA kernel (its bf16 or fp32 form, x's dtype), whose
    backward is autograd of the plain version."""
    if _build.plain(FOLDED_NAME, x):
        return bridge_attention_folded_plain(x, res, wq, bq, k, v, wp, bp,
                                             scale)
    return _build.with_plain_backward(
        lambda *a: _launch_folded(*a, scale),
        lambda *a: bridge_attention_folded_plain(*a, scale),
        x, res, wq, bq, k, v, wp, bp)


def _launch_folded(x, res, wq, bq, k, v, wp, bp, scale):
    _check_scale(scale)
    dt = _check_folded(x, res, k, v)
    global folded_launches
    x, res, k, v = (_build.aligned(t) for t in (x, res, k, v))
    B, N, C = x.shape
    M = k.shape[2]
    out = torch.empty_like(x)
    w = functools.partial(_build.weight, dtype=dt)
    f32 = _build.f32
    args = (x, res, w(wq), f32(bq), k, v, w(wp), f32(bp), out)
    fn = _build.entry(FOLDED_NAME, _build.symbol(FOLDED_NAME, dt),
                      [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                      + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(*[_build.ptr(t) for t in args], B, N, M, scale,
            _build.stream_of(x))
    _build.check(rc, FOLDED_NAME)
    folded_launches += 1
    _build.tally(FOLDED_NAME, tuple(x.shape), _build.tag(x))
    return out
