"""The arithmetic of K10's fp32 form (csrc/bridge_attention_bwd.cu
rows32_kernel and cols32_kernel, bridge_attention_bwd_f32), emulated in
torch on the CPU.

The kernels multiply on the tensor cores at fp32 accuracy with 3xTF32,
as K3's fp32 core does (tests/test_torch_bridge_tf32x3.py):
- tf32(x): x rounded to 10 mantissa bits, to nearest, ties away from
  zero, infinities and NaNs kept (cvt.rna.tf32.f32); split(x) = (hi, lo)
  with hi = tf32(x), lo = tf32(x − hi), at every split point: q, g, k and
  v as staged, T, E/S and T·s/S in registers;
- a product a·b is lo(a)·hi(b) + hi(a)·lo(b) + hi(a)·hi(b); L, dP, Lᵀ
  and dPᵀ keep hi·hi apart from the two small terms and add them after;
- the rows kernel: pass 1 over the keys in chunks of BWD_F32_KEY_CHUNK,
  the running row max in log2 units (NaNs dropped, as fmaxf drops them),
  the factor 2^(m_old − m_new) on S and rowsum(E∘dP), e = 2^(l·sl2 −
  m·sl2); c = rowsum(E∘dP)/S; pass 2: T = E∘(dP − c), T·K summed a chunk
  at a time into dQ's total, dQ = total / (S/scale); the statistics (m,
  c, 1/S, scale/S) per row;
- the columns kernel: per row segment of `bwd_plan(..., fp32=True)`, in
  chunks of BWD_F32_ROW_CHUNK rows, E/S and T·s/S from each row's
  statistics, (E/S)ᵀ·G and (T·s/S)ᵀ·Q summed a chunk at a time into the
  segment's partials; the partials added in segment order (sum_partials);
- a NaN the card's arithmetic makes is 0x7fffffff.

The emulation is held against the JAX package's fp32 Pallas backward
(`bridge_softmax_attention_bwd`, interpret=True) and against the port's
plain version at float64, at ragged N (129, 300), M = 784 and 240 (a
short last chunk of 16 keys in both), d = 64, scale 1/8: each gradient
within REL = 5e-6 of its max|reference| (3xTF32 keeps each operand to
about 2^-22, and fp32 sums in another order differ by ~1e-7). Planted
faults: the same arithmetic with the lo terms dropped (1xTF32, ~5e-4 an
operand) fails FP32_TOL = 1e-4, chip_smoke.py's limit for the kernel; the
add-and-mask split of E/S (the split K3's core keeps for e in [0, 1])
turns the NaN that a NaN in q makes of E/S into a zero, and dV comes out
finite where the plain version's is NaN.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu.ops.pallas.bridge_attention_kernel import (
    bridge_softmax_attention_bwd,
)
from transception_tpu_torch.ops.kernels import bridge_attention as ba

REL = 5e-6
FP32_TOL = 1e-4
SCALE = 0.125
LOG2E = 1.4426950408889634
SMS = 132  # an H100 SXM: the launch plan's segments
SHAPES = [(2, 129, 784), (2, 300, 784), (2, 300, 240)]  # (B, N, M)
F32 = torch.float32
NAMES = ("dq", "dk", "dv")


def _add_and_mask(x: torch.Tensor) -> torch.Tensor:
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 on its int32 view: nearest, ties away;
    infinities and NaNs kept."""
    return torch.where(torch.isfinite(x), _add_and_mask(x), x)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def cuda_nan(x):
    """x with its NaNs as the card's arithmetic makes them, 0x7fffffff."""
    nan = torch.tensor(0x7FFFFFFF, dtype=torch.int32).view(torch.float32)
    return torch.where(torch.isnan(x), nan, x)


def split_add_and_mask(x):
    """The planted fault: the split by an add and a mask alone."""
    hi = _add_and_mask(x)
    return hi, _add_and_mask(cuda_nan(x - hi))


def logits(a, b, terms=3):
    """a·bᵀ over the channels: hi·hi and the small terms in two sums,
    added (terms=1: hi·hi alone, the planted fault)."""
    ah, al = split(a)
    bh, bl = split(b)
    big = ah @ bh.transpose(-1, -2)
    if terms == 1:
        return big
    return big + (al @ bh.transpose(-1, -2) + ah @ bl.transpose(-1, -2))


def mm3(a, b, terms=3, split_a=split):
    """a @ b as the kernels form it: the two small terms, then hi·hi."""
    ah, al = split_a(a)
    bh, bl = split(b)
    if terms == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def fma(x, y, z):
    """fmaf(x, y, z): one rounding."""
    return (x.double() * y.double() + z.double()).float()


def row_max(s):
    """The row max as the kernel's fmaxf takes it: NaNs dropped."""
    return torch.where(torch.isnan(s), -torch.inf, s).amax(-1, keepdim=True)


def rows(q, k, v, g, scale, terms=3):
    """The rows kernel: dq and the statistics (m·log2e, c, 1/S, s/S), each
    (BH, N, 1). q, g (BH, N, 64); k, v (BH, M, 64); fp32."""
    sl2 = torch.tensor(scale * LOG2E, dtype=F32)
    kc = ba.BWD_F32_KEY_CHUNK
    M = k.shape[1]
    m2 = torch.full((q.shape[0], q.shape[1], 1), -torch.inf, dtype=F32)
    s = torch.zeros_like(m2)
    edp = torch.zeros_like(m2)
    for key0 in range(0, M, kc):
        l = logits(q, k[:, key0:key0 + kc], terms)
        dp = logits(g, v[:, key0:key0 + kc], terms)
        mn = torch.fmax(m2, row_max(l) * sl2)
        a = torch.exp2(m2 - mn)
        m2 = mn
        e = torch.exp2(fma(l, sl2, -m2))
        s = s * a + e.sum(-1, keepdim=True)
        edp = edp * a + (e * dp).sum(-1, keepdim=True)
    c = edp / s
    o = torch.zeros_like(q)
    for key0 in range(0, M, kc):
        kk = k[:, key0:key0 + kc]
        l = logits(q, kk, terms)
        dp = logits(g, v[:, key0:key0 + kc], terms)
        t = torch.exp2(fma(l, sl2, -m2)) * (dp - c)
        o = o + mm3(cuda_nan(t), kk, terms)
    return o / (s / scale), (m2, c, 1.0 / s, scale / s)


def cols(q, k, v, g, stats, scale, terms=3, split_es=split):
    """The columns kernel and sum_partials: dk and dv."""
    sl2 = torch.tensor(scale * LOG2E, dtype=F32)
    rc = ba.BWD_F32_ROW_CHUNK
    BH, N, _ = q.shape
    nseg, seg_rows = ba.bwd_plan(BH, N, k.shape[1], SMS, fp32=True)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for seg in range(nseg):
        pk, pv = torch.zeros_like(k), torch.zeros_like(v)
        for n0 in range(seg * seg_rows, min(N, (seg + 1) * seg_rows), rc):
            n1 = min(n0 + rc, (seg + 1) * seg_rows, N)
            qc, gc = q[:, n0:n1], g[:, n0:n1]
            m2, c, rs, ss = (x[:, n0:n1].transpose(-1, -2) for x in stats)
            ex = torch.exp2(fma(logits(k, qc, terms), sl2, -m2))
            es = cuda_nan(ex * rs)
            ts = cuda_nan(ex * (logits(v, gc, terms) - c) * ss)
            pv = pv + mm3(es, gc, terms, split_es)
            pk = pk + mm3(ts, qc, terms)
        dk, dv = dk + pk, dv + pv
    return dk, dv


def emulated(q, k, v, g, terms=3, split_es=split):
    """(dq, dk, dv) of numpy (B, 1, n, 64) fp32 inputs, as numpy."""
    B, h, N, d = q.shape
    q, k, v, g = (torch.from_numpy(a).reshape(B * h, -1, d)
                  for a in (q, k, v, g))
    dq, stats = rows(q, k, v, g, SCALE, terms)
    dk, dv = cols(q, k, v, g, stats, SCALE, terms, split_es)
    return tuple(x.reshape(B, h, -1, d).numpy() for x in (dq, dk, dv))


def _inputs(B, N, M, seed=41):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, 1, n, 64)).astype(np.float32)
                 for n in (N, M, M, N))


def _plain(q, k, v, g):
    t = torch.from_numpy
    return tuple(x.numpy() for x in ba.bridge_attention_bwd_plain(
        *(t(a).double() for a in (q, k, v, g)), SCALE))


def _errs(got, want):
    """max|got - want| / max|want| per gradient: got the emulation's fp32,
    want fp32 (JAX) or float64 (the plain version)."""
    out = []
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == np.float32
        assert b.dtype in (np.float32, np.float64)
        out.append(np.abs(a.astype(b.dtype) - b).max() / np.abs(b).max())
    return out


@pytest.mark.parametrize("B,N,M", SHAPES)
def test_k10_emulation_matches_pallas_interpret_fp32(B, N, M):
    q, k, v, g = _inputs(B, N, M)
    want = bridge_softmax_attention_bwd(*map(jnp.asarray, (q, k, v, g)),
                                        scale=SCALE, interpret=True)
    errs = _errs(emulated(q, k, v, g), want)
    assert max(errs) <= REL, dict(zip(NAMES, errs))


@pytest.mark.parametrize("B,N,M", SHAPES)
def test_k10_emulation_matches_plain(B, N, M):
    q, k, v, g = _inputs(B, N, M)
    errs = _errs(emulated(q, k, v, g), _plain(q, k, v, g))
    assert max(errs) <= REL, dict(zip(NAMES, errs))


def test_k10_one_tf32_term_fails_the_check():
    """The planted fault: hi·hi alone (10 mantissa bits an operand) is not
    an fp32 kernel; chip_smoke.py's limit rejects it on a gradient."""
    q, k, v, g = _inputs(*SHAPES[0])
    want = _plain(q, k, v, g)
    assert max(_errs(emulated(q, k, v, g), want)) <= REL
    assert max(_errs(emulated(q, k, v, g, terms=1), want)) > FP32_TOL


@pytest.mark.parametrize("which", ["q", "k", "v", "g"])
def test_k10_nan_reaches_the_gradients_as_in_plain(which):
    """A NaN in a row of q or g, or a key of k or v, comes out in dq, dk and
    dv where it comes out of the plain version, the rest within REL."""
    q, k, v, g = (a[:1].copy() for a in _inputs(*SHAPES[1]))
    at = {"q": q[0, 0, 5], "k": k[0, 0, 17], "v": v[0, 0, 17],
          "g": g[0, 0, 5]}[which]
    at.view(np.int32)[3] = 0x7FFFFFFF
    want = _plain(q, k, v, g)
    got = emulated(q, k, v, g)
    assert any(np.isnan(w).any() for w in want)
    for name, a, b in zip(NAMES, got, want):
        nan = np.isnan(b)
        assert np.array_equal(np.isnan(a), nan), name
        if not nan.all():
            assert _errs([a[~nan]], [b[~nan]])[0] <= REL, name


def test_k10_add_and_mask_split_of_es_hides_a_nan():
    """The planted fault: E/S split by the add and mask (the split K3's
    core keeps for e in [0, 1]). A NaN in q makes its row's S, so E/S, NaN; the add and mask
    turns that NaN into −0, and dV comes out finite where the plain
    version's is NaN (cvt.rna keeps it: the test above)."""
    q, k, v, g = (a[:1].copy() for a in _inputs(*SHAPES[1]))
    q[0, 0, 5].view(np.int32)[3] = 0x7FFFFFFF
    dv_plain = _plain(q, k, v, g)[2]
    assert np.isnan(dv_plain).all()
    assert np.isnan(emulated(q, k, v, g)[2]).all()
    dv_bad = emulated(q, k, v, g, split_es=split_add_and_mask)[2]
    assert np.isfinite(dv_bad).all()
