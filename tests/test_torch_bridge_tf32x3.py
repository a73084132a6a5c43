"""The arithmetic of the fp32 bridge attention core of K3's and K8's fp32
forms (csrc/bridge_softmax.cuh attend32), emulated in torch on the CPU.

The kernel multiplies on the tensor cores at fp32 accuracy with 3xTF32:
- tf32(x): x rounded to 10 mantissa bits, to nearest, ties away from
  zero: (bits + 0x1000) & ~0x1fff on the int32 view, infinities and NaNs
  kept (cvt.rna.tf32.f32; the kernel splits the probabilities e, which
  lie in [0, 1], by the add and mask alone);
- split(x) = (hi, lo) with hi = tf32(x), lo = tf32(x − hi);
- a product a·b is lo(a)·hi(b) + hi(a)·lo(b) + hi(a)·hi(b): each term a
  product of 11-bit significands, exact in fp32, summed in fp32; the
  logits keep hi·hi apart from the two small terms and add them after;
- one pass over the keys in chunks of F32_KEY_CHUNK and steps of
  F32_KEY_STEP: the running row max in log2 units, the factor 2^(m_old −
  m_new) on the row sum and the output, e = 2^(l·sl2 − m·sl2), the step's
  P·V added to the rescaled output, one divide by the row sum at the end;
- K8: q = x·Wqᵀ + bq and proj = (o / rowsum)·Wpᵀ + bp at 3xTF32, + res.

The emulation is held against the JAX package's fp32 Pallas kernels
(`bridge_softmax_attention`, `bridge_attention_folded`, interpret=True)
and against the port's plain versions, at ragged N (129, 300) and M = 784
(a short last chunk and step), d = 64, scale 1/8: within 2e-6 of
max|reference| (K8 on its branch, output minus res). 3xTF32 keeps each
operand to about 2^-22, and fp32 sums in another order differ by ~1e-7 of
the output. The plain versions run at float64 here (they take it): at
K8's peaked logits (|q| ~ 4) the fp32 plain version is itself 1.6e-6 from
the float64 result, as far as the emulation is, so two fp32 results can
sit 2.7e-6 apart. The same emulation with the lo terms dropped (1xTF32,
~5e-4 an operand) must fail that check. A NaN in q, k or v reaches the
output where it reaches the plain version's; with the add and mask on
every operand (a NaN becomes a zero) it would not.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu.ops.pallas.bridge_attention_kernel import (
    bridge_attention_folded as pallas_folded,
    bridge_softmax_attention,
)
from transception_tpu_torch.ops.kernels import bridge_attention as ba

REL = 2e-6
SCALE = 0.125
LOG2E = 1.4426950408889634
SHAPES = [(2, 129, 784), (2, 300, 784)]  # (B, N, M)


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


def mm3(a, b, terms=3):
    """a @ b as the kernel forms it: the two small terms, then hi·hi
    (terms=1: hi·hi alone, the planted fault)."""
    ah, al = split(a)
    bh, bl = split(b)
    if terms == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def logits(q, k, terms=3):
    """The logits: hi·hi and the small terms in two sums, added."""
    qh, ql = split(q)
    kh, kl = split(k)
    big = qh @ kh.transpose(-1, -2)
    if terms == 1:
        return big
    return big + (ql @ kh.transpose(-1, -2) + qh @ kl.transpose(-1, -2))


def attend(q, k, v, scale, terms=3):
    """The kernel's one pass: q (BH, N, 64), k and v (BH, M, 64), fp32."""
    f32 = torch.float32
    sl2 = torch.tensor(scale * LOG2E, dtype=f32)
    BH, N, _ = q.shape
    M = k.shape[1]
    m2 = torch.full((BH, N, 1), -torch.inf, dtype=f32)
    rs = torch.zeros(BH, N, 1, dtype=f32)
    o = torch.zeros_like(q)
    for key0 in range(0, M, ba.F32_KEY_CHUNK):
        rows = min(ba.F32_KEY_CHUNK, M - key0)
        for k0 in range(key0, key0 + rows, ba.F32_KEY_STEP):
            k1 = min(k0 + ba.F32_KEY_STEP, key0 + rows)
            s = logits(q, k[:, k0:k1], terms)
            mn = torch.maximum(m2, s.amax(-1, keepdim=True) * sl2)
            a = torch.exp2(m2 - mn)
            m2 = mn
            # fmaf(s, sl2, -m2): one rounding.
            e = torch.exp2((s.double() * sl2.double() - m2.double()).to(f32))
            rs = rs * a + e.sum(-1, keepdim=True)
            o = o * a + mm3(e, v[:, k0:k1], terms)
    return o / rs


def folded(x, res, wq, bq, k, v, wp, bp, scale, terms=3):
    """K8's fp32 form: x, res (B, N, 64); k, v (B, 1, M, 64); wq, wp torch
    Linear weights (out, in)."""
    q = mm3(x, wq.T, terms) + bq
    att = attend(q, k[:, 0], v[:, 0], scale, terms)
    return (mm3(att, wp.T, terms) + bp) + res


def _normal(seed):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return n


def _k3_inputs(B, N, M):
    n = _normal(31)
    return n(B, 1, N, 64), n(B, 1, M, 64), n(B, 1, M, 64)


def _k8_inputs(B, N, M):
    n = _normal(32)
    x, res = n(B, N, 64), n(B, N, 64)
    k, v = n(B, 1, M, 64), n(B, 1, M, 64)
    # flax Dense layouts (in, out); torch Linear takes their transposes.
    wq, wp = n(64, 64, scale=0.5), n(64, 64, scale=0.2)
    bq, bp = n(64, scale=0.1), n(64, scale=0.1)
    return x, res, wq, bq, k, v, wp, bp


def _err(got, want):
    """max|got - want| / max|want|: got the emulation's fp32, want fp32
    (JAX) or float64 (the plain versions)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    assert want.dtype in (np.float32, np.float64)
    got = got.astype(want.dtype)
    return np.abs(got - want).max() / np.abs(want).max()


def _k3_plain(q, k, v):
    t = torch.from_numpy
    return ba.bridge_attention_plain(*(t(a).double() for a in (q, k, v)),
                                     SCALE).numpy()


def _k8_plain_branch(x, res, wq, bq, k, v, wp, bp):
    """The plain version's branch (output minus res) at float64."""
    x, res, wq, bq, k, v, wp, bp = (torch.from_numpy(a).double() for a in
                                    (x, res, wq, bq, k, v, wp, bp))
    out = ba.bridge_attention_folded_plain(x, res, wq.T, bq, k, v, wp.T, bp,
                                           SCALE)
    return (out - res).numpy()


def _k3_emulated(q, k, v, terms=3):
    t = torch.from_numpy
    B, h, N, d = q.shape
    out = attend(t(q).reshape(B * h, N, d), t(k).reshape(B * h, -1, d),
                 t(v).reshape(B * h, -1, d), SCALE, terms)
    return out.reshape(B, h, N, d).numpy()


def _k8_emulated(x, res, wq, bq, k, v, wp, bp, terms=3):
    t = torch.from_numpy
    out = folded(t(x), t(res), t(wq).T, t(bq), t(k), t(v), t(wp).T, t(bp),
                 SCALE, terms)
    return out.numpy()


def test_tf32_rounds_to_nearest_ties_away():
    """tf32() against the rounding written out: 2^-10 ulps of each
    binade, ties (low 13 bits 0x1000) away from zero, both signs."""
    ulp = 2.0 ** -10
    base = np.array([1.0, 1.0 + ulp, 3.0, 1.5 - ulp], dtype=np.float32)
    cases, want = [], []
    for b in base:
        for frac, up in ((0.25, False), (0.5, True), (0.75, True),
                         (0.49, False)):
            e = 2.0 ** np.floor(np.log2(b))
            cases.append(np.float32(b + frac * ulp * e))
            want.append(np.float32(b + (ulp * e if up else 0.0)))
    x = torch.tensor(np.array(cases + [-c for c in cases], np.float32))
    expect = np.array(want + [-w for w in want], np.float32)
    assert np.array_equal(tf32(x).numpy(), expect)
    hi, lo = split(x)
    assert np.array_equal((hi.double() + lo.double()).float().numpy(),
                          x.numpy())
    # lo keeps the rest to 10 mantissa bits of its own: within 2^-22 of x.
    r = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    hi, lo = split(r)
    rel = ((hi.double() + lo.double() - r.double()).abs()
           / r.double().abs()).max().item()
    assert rel <= 2.0 ** -22


@pytest.mark.parametrize("B,N,M", SHAPES)
def test_k3_emulation_matches_pallas_interpret_fp32(B, N, M):
    q, k, v = _k3_inputs(B, N, M)
    want = np.asarray(bridge_softmax_attention(
        *map(jnp.asarray, (q, k, v)), scale=SCALE, interpret=True))
    assert _err(_k3_emulated(q, k, v), want) <= REL


@pytest.mark.parametrize("B,N,M", SHAPES)
def test_k3_emulation_matches_plain(B, N, M):
    q, k, v = _k3_inputs(B, N, M)
    assert _err(_k3_emulated(q, k, v), _k3_plain(q, k, v)) <= REL


@pytest.mark.parametrize("B,N,M", SHAPES)
def test_k8_emulation_matches_pallas_interpret_fp32(B, N, M):
    a = _k8_inputs(B, N, M)
    want = np.asarray(pallas_folded(*map(jnp.asarray, a), scale=SCALE,
                                    interpret=True))
    res = a[1]
    assert _err(_k8_emulated(*a) - res, want - res) <= REL


@pytest.mark.parametrize("B,N,M", SHAPES)
def test_k8_emulation_matches_plain(B, N, M):
    a = _k8_inputs(B, N, M)
    assert _err(_k8_emulated(*a) - a[1], _k8_plain_branch(*a)) <= REL


@pytest.mark.parametrize("which", ["k3", "k8"])
def test_one_tf32_term_fails_the_check(which):
    """The planted fault: hi·hi alone (10 mantissa bits an operand) is not
    an fp32 kernel, and the check above rejects it."""
    B, N, M = SHAPES[0]
    if which == "k3":
        q, k, v = _k3_inputs(B, N, M)
        want = _k3_plain(q, k, v)
        assert _err(_k3_emulated(q, k, v), want) <= REL
        assert _err(_k3_emulated(q, k, v, terms=1), want) > REL
    else:
        a = _k8_inputs(B, N, M)
        want = _k8_plain_branch(*a)
        assert _err(_k8_emulated(*a) - a[1], want) <= REL
        assert _err(_k8_emulated(*a, terms=1) - a[1], want) > REL


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_nan_reaches_the_output_as_in_plain(which, monkeypatch):
    """A NaN in a row of q (that row), a key of k (every row) or a key of
    v (a channel) comes out where the plain version's does, the rest
    within REL; the planted fault, the add and mask on every operand,
    turns the NaN into a zero and is caught."""
    q, k, v = (a[:1] for a in _k3_inputs(*SHAPES[0]))
    # The NaN a CUDA operation produces, 0x7fffffff (the add and mask
    # carries it into the sign bit: -0).
    at = {"q": q[0, 0, 5], "k": k[0, 0, 17], "v": v[0, 0, 17]}[which]
    at.view(np.int32)[3] = 0x7FFFFFFF
    want = _k3_plain(q, k, v)
    nan = np.isnan(want)
    assert nan.any()
    got = _k3_emulated(q, k, v)
    assert np.array_equal(np.isnan(got), nan)
    if not nan.all():
        assert _err(got[~nan], want[~nan]) <= REL
    monkeypatch.setattr(sys.modules[__name__], "tf32", _add_and_mask)
    assert not np.array_equal(np.isnan(_k3_emulated(q, k, v)), nan)
