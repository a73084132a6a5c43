"""The fp32 forms of the port's kernels (the forward kernels K5, K2, K1,
K6, K3, K7 and the train kernels K10, K11, K9): the plain PyTorch versions
at fp32, which the card holds each fp32 kernel against, against the JAX
Pallas kernels run with interpret=True at fp32 on the same numpy inputs;
the fp32 launch plans at the published eval (b = 32) and train (b = 24)
shapes; the kernel launches of the published model's fp32 eval forward
and train steps; and the dtypes each kernel takes.

Tolerance: max|port − JAX| <= 2e-5 · max|JAX|. At fp32 every rounding
point of the Pallas kernels is the identity (`.astype(dt)` to fp32), so
the two differ by the order of fp32 sums and the Pallas erf polynomial
(Abramowitz-Stegun 7.1.26, 1.5e-7 absolute) alone.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu.ops.pallas.bridge_attention_kernel import (
    bridge_attention_folded as pallas_folded,
    bridge_softmax_attention,
    bridge_softmax_attention_bwd,
)
from transception_tpu.ops.pallas.expand_kernel import fused_patch_expand
from transception_tpu.ops.pallas.linear_attention_kernel import (
    efficient_attention_block_folded,
    linear_attention as pallas_linear_attention,
)
from transception_tpu.ops.pallas.mhca_block_kernel import fused_mhca_block
from transception_tpu.ops.pallas.mixffn_kernel import (
    fused_mixffn_ln_skip,
    fused_mixffn_ln_skip_bwd,
    fused_mixffn_skip,
)
from transception_tpu_torch.core.config import TransceptionConfig
from transception_tpu_torch.models.transception import (
    launches_per_forward,
    launches_per_step,
)
from transception_tpu_torch.ops.kernels import bridge_attention as ba
from transception_tpu_torch.ops.kernels import etb_attention as ea
from transception_tpu_torch.ops.kernels import linear_attention as la
from transception_tpu_torch.ops.kernels import mhca_block as mb
from transception_tpu_torch.ops.kernels import mixffn as mf
from transception_tpu_torch.ops.kernels import patch_expand as pe

REL = 2e-5
SMS = 132  # an H100 SXM
FP32 = 4   # bytes of an fp32 element: the plans' `es`
CSRC = pathlib.Path(la.__file__).resolve().parents[2] / "csrc"
WIN = ((3, 2), (5, 3), (7, 3))


def _rng(seed):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=0.3, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)
    return n


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == np.float32 and want.dtype == np.float32
    assert got.shape == want.shape
    err, ref = np.abs(got - want).max(), np.abs(want).max()
    assert err <= REL * ref, (err, ref)


def _lin(k):  # flax Dense (in, out) -> torch Linear (out, in)
    return torch.from_numpy(np.ascontiguousarray(k.T))


def _dw(k):  # flax depthwise (kh, kw, 1, C) -> torch (C, 1, kh, kw)
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


# ---- JAX parity at fp32 ----

@pytest.mark.parametrize("B,s,C,hid", [(2, 8, 64, 256), (1, 6, 128, 512)])
def test_k5_plain_matches_pallas_interpret_fp32(B, s, C, hid):
    n, d = _rng(11), C // 8
    x = n(B, s * s, C, scale=1.0)
    p = [n(3, 3, 1, C), n(C, scale=0.1), n(C, scale=0.1, shift=1.0),
         n(C, scale=0.1), n(C, 3 * C, scale=C ** -0.5), n(3 * C, scale=0.1),
         tuple(n(w, w, 1, h * d, scale=1.0 / w) for w, h in WIN),
         tuple(n(h * d, scale=0.1) for _, h in WIN),
         n(C, C, scale=C ** -0.5), n(C, scale=0.1),
         n(C, scale=0.1, shift=1.0), n(C, scale=0.1),
         n(C, hid, scale=C ** -0.5), n(hid, scale=0.1), n(3, 3, 1, hid),
         n(hid, scale=0.1), n(hid, scale=0.1, shift=1.0), n(hid, scale=0.1),
         n(hid, C, scale=hid ** -0.5), n(C, scale=0.1)]
    jargs = tuple(tuple(map(jnp.asarray, a)) if isinstance(a, tuple)
                  else jnp.asarray(a) for a in p)
    want = fused_mhca_block(jnp.asarray(x), *jargs, s=s, heads=8,
                            hidden=hid, window=WIN, interpret=True)
    t = torch.from_numpy
    (cpe_k, cpe_b, l1s, l1b, qkv_k, qkv_b, crpe_ks, crpe_bs, proj_k, proj_b,
     l2s, l2b, w1, b1, dwk, dwb, ls, lb, w2, b2) = p
    got = mb.mhca_block_plain(
        t(x), _dw(cpe_k), t(cpe_b), t(l1s), t(l1b), _lin(qkv_k), t(qkv_b),
        [_dw(k) for k in crpe_ks], [t(b) for b in crpe_bs], _lin(proj_k),
        t(proj_b), t(l2s), t(l2b), _lin(w1), t(b1), _dw(dwk), t(dwb), t(ls),
        t(lb), _lin(w2), t(b2), s=s, heads=8)
    _close(got, want)


@pytest.mark.parametrize("s,C,hid", [(8, 64, 256), (6, 128, 512)])
def test_k2_plain_matches_pallas_interpret_fp32(s, C, hid):
    n = _rng(12)
    x = n(2, s * s, C, scale=1.0)
    p = (n(C, scale=0.1, shift=1.0), n(C, scale=0.1),
         n(C, hid, scale=C ** -0.5), n(hid, scale=0.1), n(3, 3, hid),
         n(hid, scale=0.1), n(hid, scale=0.1, shift=1.0), n(hid, scale=0.1),
         n(hid, C, scale=hid ** -0.5), n(C, scale=0.1))
    want = fused_mixffn_ln_skip(jnp.asarray(x), *map(jnp.asarray, p), s=s,
                                hidden=hid, groups=1, interpret=True)
    lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2 = map(torch.from_numpy, p)
    got = mf.mixffn_ln_skip_plain(
        torch.from_numpy(x), lts, ltb, w1.T.contiguous(), b1,
        dw.permute(2, 0, 1).unsqueeze(1).contiguous(), dwb, ls, lb,
        w2.T.contiguous(), b2, s=s)
    _close(got, want)


@pytest.mark.parametrize("B,N,C", [(2, 256, 64), (1, 196, 128)])
def test_k1_plain_matches_pallas_interpret_fp32(B, N, C):
    n = _rng(13)
    x = n(B, N, C, scale=1.0)
    ls, lb = n(C, scale=0.1, shift=1.0), n(C, scale=0.1)
    ps = []
    for _ in range(4):
        ps += [n(C, C, scale=C ** -0.5), n(C, scale=0.1)]
    want = efficient_attention_block_folded(
        jnp.asarray(x), jnp.asarray(ls), jnp.asarray(lb),
        *map(jnp.asarray, ps), interpret=True)
    t = torch.from_numpy
    args = [t(ls), t(lb)]
    for i in range(0, 8, 2):
        args += [_lin(ps[i]), t(ps[i + 1])]
    _close(ea.etb_attention_plain(t(x), *args), want)


@pytest.mark.parametrize("shape", [(2, 1, 64, 64), (1, 2, 49, 128)])
@pytest.mark.parametrize("q_softmax", [False, True])
def test_k6_plain_matches_pallas_interpret_fp32(shape, q_softmax):
    n = _rng(14)
    q, k, v = (n(*shape, scale=f) for f in (1.0, 2.0, 1.0))
    want = pallas_linear_attention(*map(jnp.asarray, (q, k, v)),
                                   q_softmax=q_softmax, interpret=True)
    got = la.linear_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                    q_softmax)
    _close(got, want)


@pytest.mark.parametrize("B,h,N,M,d", [(2, 1, 124, 28, 64),
                                       (1, 1, 600, 96, 64)])
def test_k3_plain_matches_pallas_interpret_fp32(B, h, N, M, d):
    n = _rng(15)
    q, k, v = n(B, h, N, d, scale=1.0), n(B, h, M, d, scale=1.0), \
        n(B, h, M, d, scale=1.0)
    want = bridge_softmax_attention(*map(jnp.asarray, (q, k, v)),
                                    scale=d ** -0.5, interpret=True)
    got = ba.bridge_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                    d ** -0.5)
    _close(got, want)


@pytest.mark.parametrize("B,N,M", [(2, 600, 96), (1, 300, 112)])
def test_k8_plain_matches_pallas_interpret_fp32(B, N, M):
    """K8's fp32 plain version (the sp and para bridges' fp32 attention),
    one head of 64: the Pallas kernel pads the stream to 512-row tiles,
    the port's kernel masks its ragged tile. The whole output and the
    branch (output minus res) are held."""
    n = _rng(16)
    x, res, k, v = (n(B, N, 64, scale=1.0), n(B, N, 64, scale=1.0),
                    n(B, 1, M, 64, scale=1.0), n(B, 1, M, 64, scale=1.0))
    wq, wp = n(64, 64, scale=0.5), n(64, 64, scale=0.2)
    bq, bp = n(64, scale=0.1), n(64, scale=0.1)
    want = np.asarray(pallas_folded(
        *map(jnp.asarray, (x, res, wq, bq, k, v, wp, bp)), scale=0.125,
        interpret=True))
    t = torch.from_numpy
    got = ba.bridge_attention_folded_plain(
        t(x), t(res), t(wq).T, t(bq), t(k), t(v), t(wp).T, t(bp), 0.125)
    assert got.dtype == F32
    _close(got, want)
    _close(got - t(res), want - res)


@pytest.mark.parametrize("H,C,p,c", [(8, 128, 2, 64), (4, 512, 2, 256),
                                     (8, 64, 4, 64)])
def test_k7_plain_matches_pallas_interpret_fp32(H, C, p, c):
    """Pre-shuffle order: the Pallas kernel's output (p = 2, and the x4
    expander before the fp32 head)."""
    n = _rng(16)
    x, w = n(2, H * H, C, scale=1.0), n(C, p * p * c, scale=C ** -0.5)
    ls, lb = n(c, scale=0.1, shift=1.0), n(c, scale=0.1)
    want = fused_patch_expand(*map(jnp.asarray, (x, w, ls, lb)), H=H, W=H,
                              p=p, c=c, interpret=True)
    got = pe.patch_expand_plain(torch.from_numpy(x), _lin(w),
                                torch.from_numpy(ls), torch.from_numpy(lb),
                                p=p, c=c)
    _close(got, want)


@pytest.mark.parametrize("B,h,N,M,d", [(2, 1, 124, 28, 64),
                                       (1, 1, 600, 96, 64)])
def test_k10_plain_matches_pallas_interpret_fp32(B, h, N, M, d):
    n = _rng(17)
    q, k, v, g = (n(B, h, r, d, scale=1.0) for r in (N, M, M, N))
    want = bridge_softmax_attention_bwd(*map(jnp.asarray, (q, k, v, g)),
                                        scale=d ** -0.5, interpret=True)
    got = ba.bridge_attention_bwd_plain(*map(torch.from_numpy, (q, k, v, g)),
                                        d ** -0.5)
    for a, b in zip(got, want):
        _close(a, b)


def _ffn_params(n, C, hid):
    """w1 (C, hid), b1, dw (3, 3, hid), dwb, ls, lb, w2 (hid, C), b2 in the
    Pallas kernels' layouts."""
    return (n(C, hid, scale=C ** -0.5), n(hid, scale=0.1), n(3, 3, hid),
            n(hid, scale=0.1), n(hid, scale=0.1, shift=1.0),
            n(hid, scale=0.1), n(hid, C, scale=hid ** -0.5),
            n(C, scale=0.1))


def _ffn_torch(p):
    w1, b1, dw, dwb, ls, lb, w2, b2 = map(torch.from_numpy, p)
    return (_lin(p[0]), b1, _dw(p[2][:, :, None]), dwb, ls, lb, _lin(p[6]),
            b2)


@pytest.mark.parametrize("s,C,hid,groups", [(8, 64, 256, 1),
                                            (8, 128, 512, 2),
                                            (8, 320, 1280, 5)])
def test_k11_plain_matches_pallas_interpret_fp32(s, C, hid, groups):
    """Every gradient (JAX layouts) at the train step's channel and group
    layouts, on an 8 x 8 map."""
    n = _rng(18)
    x, g = n(2, s * s, C, scale=1.0), n(2, s * s, C, scale=1.0)
    lts = np.tile(n(C // groups, scale=0.1, shift=1.0), groups)
    ltb = np.tile(n(C // groups, scale=0.1), groups)
    p = _ffn_params(n, C, hid)
    want = fused_mixffn_ln_skip_bwd(
        *map(jnp.asarray, (x, lts, ltb) + p + (g,)), s=s, hidden=hid,
        groups=groups, interpret=True)
    got = mf.mixffn_ln_skip_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(lts), torch.from_numpy(ltb),
        *_ffn_torch(p), torch.from_numpy(g), s=s, groups=groups)
    dx, dlts, dltb, dw1, db1, ddw, ddwb, dls, dlb, dw2, db2 = (
        t.numpy() for t in got)
    got = (dx, dlts, dltb, dw1.T, db1, ddw[:, 0].transpose(1, 2, 0), ddwb,
           dls, dlb, dw2.T, db2)
    for a, b in zip(got, want):
        _close(np.ascontiguousarray(a), b)


@pytest.mark.parametrize("s,C,hid", [(8, 64, 256), (14, 128, 512)])
def test_k9_plain_matches_pallas_interpret_fp32(s, C, hid):
    """The "pallas" mode's MHCA FFN without LN fold (28² and 14² maps at
    full size; 8² with a row halo and 14² whole here)."""
    n = _rng(19)
    x = n(2, s * s, C, scale=1.0)
    p = _ffn_params(n, C, hid)
    want = fused_mixffn_skip(*map(jnp.asarray, (x,) + p), s=s, hidden=hid,
                             interpret=True)
    got = mf.mixffn_skip_plain(torch.from_numpy(x), *_ffn_torch(p), s=s)
    _close(got, want)


# ---- the fp32 plans at the published shapes (b = 32) ----

def _fits(smem):
    return all(v <= mf.SMEM_LIMIT for v in smem.values())


@pytest.mark.parametrize("s,C,hid", [(56, 64, 256), (28, 128, 512),
                                     (14, 320, 1280)])
def test_k2_fp32_plan(s, C, hid):
    pl = mf.fwd_plan(32, s, C, hid, SMS, FP32)
    assert _fits(pl["smem"]) and min(pl["blocks"].values()) >= SMS
    T = 32 * s * s
    assert pl["workspace"] == {"h": T * hid * 4, "a": T * hid * 4}
    assert mf.fwd_smem_bytes(s, C, hid, FP32) <= mf.SMEM_LIMIT


@pytest.mark.parametrize("s,C", [(28, 64), (14, 128)])
def test_k5_fp32_plan(s, C):
    pl = mb.plan(32, s, C, 8, 4 * C, SMS, FP32)
    assert _fits(pl["smem"]) and _fits(pl["ffn"]["smem"])
    assert min(pl["blocks"].values()) >= SMS
    # The attention stage's taps: a 7 x 7 grid of fp32 a channel.
    d, R = C // 8, pl["band_rows"]
    assert pl["smem"]["attn"] == (d * C * 4 + R * s * C * 4
                                  + (R + 6) * (s + 6) * C * 4 + 49 * C * 4)
    assert pl["workspace"]["qkv"] == 32 * s * s * 3 * C * 4


@pytest.mark.parametrize("N,C", [(3136, 64), (784, 128), (196, 320)])
def test_k1_fp32_plan(N, C):
    pl = ea.plan(32, N, C, SMS, FP32)
    assert _fits(pl["smem"]) and min(pl["blocks"].values()) >= SMS
    assert pl["smem"]["out"] == (64 + 64) * -(-C // 64) * 64 * 4
    assert pl["workspace"]["att"] == 32 * N * C * 4


def test_k6_fp32_plan():
    pl = la.plan(32 * 8, 49, 40, 40, SMS, FP32)
    assert pl["body"] == "head" and _fits(pl["smem"])
    assert pl["blocks"]["head"] >= SMS
    assert pl["smem"]["head"] == la.head_smem(49, 40, 40, FP32)


def test_k3_fp32_smem_and_grid():
    """The 3xTF32 core's block shape (csrc/bridge_softmax.cuh F32_WARPS,
    F32_KC, F32_STAGES, F32_KS) mirrored by the wrapper; K3's and K8's
    fp32 blocks within a block's shared memory (one block an SM: q, the
    output and the sums take more than the registers two would leave);
    the published stream's grid over every SM."""
    src = (CSRC / "bridge_softmax.cuh").read_text()
    consts = {k: re.findall(rf"constexpr int {k} = (\d+);", src)
              for k in ("F32_WARPS", "F32_KC", "F32_STAGES", "F32_KS")}
    assert consts == {"F32_WARPS": [str(ba.F32_WARPS)],
                      "F32_KC": [str(ba.F32_KEY_CHUNK)],
                      "F32_STAGES": [str(ba.F32_STAGES)],
                      "F32_KS": [str(ba.F32_KEY_STEP)]}
    assert ba.F32_KEY_CHUNK % ba.F32_KEY_STEP == 0
    assert ba.f32_smem() < ba.f32_smem(folded=True) <= mf.SMEM_LIMIT
    assert 2 * ba.f32_smem() > mf.SMEM_LIMIT
    assert -(-6076 // (16 * ba.F32_WARPS)) * 32 >= SMS


@pytest.mark.parametrize("N,C,c,p", [(49, 512, 256, 2), (196, 320, 160, 2),
                                     (784, 128, 64, 2), (3136, 64, 64, 4)])
def test_k7_fp32_plan(N, C, c, p):
    pl = pe.plan(32, N, C, c, p, SMS, es=FP32)
    assert pl["smem"] <= pe.SMEM_LIMIT and pl["blocks"] >= SMS
    assert pl["smem"] == pe.smem_bytes(c, C, True, FP32)


# ---- the fp32 train step's plans (b = 24) ----

# The (s, C, hidden, groups) of the flash train step's MixFFN folds
# (chip_smoke.FFN_SHAPES): K2 forward and K11 at each, at fp32 too.
TRAIN_FFN = [(56, 64, 256, 1), (28, 64, 256, 1), (28, 128, 512, 1),
             (28, 128, 512, 2), (14, 128, 512, 1), (14, 320, 1280, 1),
             (14, 320, 1280, 5)]


@pytest.mark.parametrize("s,C,hid,groups", TRAIN_FFN)
def test_k11_and_k2_fp32_train_plans(s, C, hid, groups):
    B, T = 24, 24 * s * s
    pl = mf.bwd_plan(B, s, C, hid, SMS, FP32)
    ws = pl["workspace"]
    assert {k: ws[k] for k in ("xn", "h", "a", "dh")} == {
        "xn": T * C * 4, "h": T * hid * 4, "a": T * hid * 4,
        "dh": T * hid * 4}
    assert ws["da"] == T * hid * 4 and ws["dxn"] == T * C * 4
    # The split products' fp32 partials: within the cap, whole fp32 steps.
    assert ws["pw"] <= max(mf.BWD_SPLIT_BYTES, 2 * hid * C * 4)
    assert pl["kper"] % (mf.BWD_DEPTH // 2) == 0
    assert pl["plan"] == mf.bwd_plan(B, s, C, hid, SMS)["plan"]
    assert mf.bwd_smem_bytes(C, hid, FP32) <= mf.SMEM_LIMIT
    assert mf.bwd_smem_bytes(C, hid, FP32) == mf.bwd_smem_bytes(C, hid)
    fw = mf.fwd_plan(B, s, C, hid, SMS, FP32)
    assert _fits(fw["smem"]) and fw["workspace"]["h"] == T * hid * 4
    mf._check(torch.zeros(1, s * s, C), s, hid, groups)  # K2 fp32 takes it


@pytest.mark.parametrize("s,C", [(28, 64), (14, 128)])
def test_k9_fp32_train_plan(s, C):
    pl = mf.fwd_plan(24, s, C, 4 * C, SMS, FP32)
    assert _fits({k: v for k, v in pl["smem"].items() if k != "fc1_ln"})
    assert min(pl["blocks"].values()) >= SMS
    mf._check(torch.zeros(1, s * s, C), s, 4 * C, 1, ln=False)


def test_k10_fp32_smem():
    """Shared memory of K10's fp32 blocks (3xTF32) from the constants it
    mirrors (csrc/bridge_attention_bwd.cu RW, KC3, RC3, KT3 and
    bridge_softmax.cuh STAGES): the rows block 208 KB, the columns block
    209 KB, each within a block's limit (one block an SM)."""
    src = (CSRC / "bridge_attention_bwd.cu").read_text()
    consts = {k: re.findall(rf"constexpr int {k} = (\d+);", src)
              for k in ("RW", "KC3", "RC3", "KT3")}
    assert consts == {"RW": [str(ba.BWD_F32_WARPS)],
                      "KC3": [str(ba.BWD_F32_KEY_CHUNK)],
                      "RC3": [str(ba.BWD_F32_ROW_CHUNK)],
                      "KT3": [str(ba.BWD_F32_KEY_TILE)]}
    hdr = (CSRC / "bridge_softmax.cuh").read_text()
    assert re.findall(r"constexpr int STAGES = (\d+);", hdr) == [
        str(ba.BWD_F32_STAGES)]
    rows, cols = ba.bwd_f32_smem()
    assert (rows, cols) == (208 * 1024, 209 * 1024)
    assert max(rows, cols) <= mf.SMEM_LIMIT
    assert "RSMEM32" in src and "CSMEM32" in src


MODES = {"default": {}, "flash": dict(ffn_flash_train=True),
         "pallas": dict(use_pallas_train=True, mhca_ffn_fold=True,
                        drop_path_rate=0.1)}


@pytest.mark.parametrize("mode", list(MODES))
def test_fp32_train_step_launches(mode):
    """An fp32 train step launches what a bf16 one does (the fold
    structure does not follow the dtype): K3 and K10 3 in every mode,
    K2 and K11 53 in the flash mode, K9 30 in the "pallas" mode; its
    fp32 launches are told apart by the "fp32" tag of their shape
    tally."""
    got = launches_per_step(TransceptionConfig(dtype="float32",
                                               **MODES[mode]))
    assert got == launches_per_step(TransceptionConfig(**MODES[mode]))
    assert got["bridge_attention"] == got["bridge_attention_bwd"] == 3
    assert got["mixffn_bwd"] == got["mixffn"]
    assert got["expand_head"] == 0
    if mode == "flash":
        assert got["mixffn"] == 53
    if mode == "pallas":
        assert got["mixffn_skip"] == 30


# ---- the fp32 eval forward's launches ----

def test_fp32_forward_launches():
    """Hand count of the published model's fp32 eval forward: K1 in the 2
    ETBs of stage 1 and the 6 of decoders 0-2; K2 in their 8 FFN folds;
    K3 in bridge layers 2-4; K5 in the 11 MHCA blocks of stages 2-3 (3 +
    8) on each of 3 paths; K6 in the 9 stage-4 blocks' attention (3 paths
    x 3 blocks); K7 at the three p = 2 expanders and the x4 expander
    (pre-shuffle, before the fp32 1x1 head), so no K4."""
    got = launches_per_forward(TransceptionConfig(dtype="float32"))
    want = {"etb_attention": 8, "mixffn": 8, "bridge_attention": 3,
            "mhca_block": 33, "linear_attention": 9, "patch_expand": 4,
            "expand_head": 0}
    assert {k: got[k] for k in want} == want
    assert all(n == 0 for k, n in got.items() if k not in want)
    bf16 = launches_per_forward(TransceptionConfig())
    assert {k: bf16[k] for k in ("expand_head", "patch_expand")} == {
        "expand_head": 1, "patch_expand": 3}


# ---- which dtypes each kernel takes ----

BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16


@pytest.mark.parametrize("dts", [(F16,), (F32, BF16), (BF16, F32, F32)])
def test_fp16_and_mixed_dtypes_raise(dts):
    """The fp32 forms take fp32 tensors of one dtype: fp16 and a mix raise
    (K3's check on q, k and v; K6's likewise)."""
    q, k, v = (torch.zeros(1, 1, 64, 64, dtype=dts[i % len(dts)])
               for i in range(3))
    with pytest.raises(ValueError):
        ba._check(q, k, v)
    with pytest.raises(ValueError):
        la._check(q, k, v)


def test_bf16_only_kernels_refuse_fp32():
    """K4 (the bf16 argmax head, bf16-only in both packages) is the one
    kernel without an fp32 form: its check refuses fp32. K8 takes fp32
    since the fp32 sp and para bridges; K9, K10 and K11 (fp32 forms since
    the fp32 train step) take fp32 as K2 and K3 do. K8-K11 refuse fp16."""
    from transception_tpu_torch.ops.kernels import expand_head as eh
    x = torch.zeros(1, 64, 64)
    q = torch.zeros(1, 1, 64, 64)
    w16 = torch.zeros(1024, 64)
    with pytest.raises(ValueError):     # K4
        eh._check(x, w16, torch.zeros(9, 64), p=4, c=64)
    assert ba._check_folded(x, x, q, q) == F32       # K8 at fp32
    assert ba._check_folded(x.bfloat16(), x.bfloat16(), q.bfloat16(),
                            q.bfloat16()) == BF16
    mf._check(x, 8, 256, 1)             # K2 at fp32
    mf._check(x, 8, 256, 1, ln=False)   # K9 and K11 at fp32
    ba._check(q, q, q)                  # K3 and K10 at fp32
    with pytest.raises(ValueError):     # K8 at fp16
        ba._check_folded(x.half(), x.half(), q.half(), q.half())
    with pytest.raises(ValueError):     # K8 with a mix of dtypes
        ba._check_folded(x, x.bfloat16(), q, q)
    with pytest.raises(ValueError):     # K9, K11 at fp16
        mf._check(x.half(), 8, 256, 1, ln=False)
    with pytest.raises(ValueError):     # K10 at fp16
        ba._check(q.half(), q.half(), q.half())


def test_fp32_entry_names():
    from transception_tpu_torch.ops.kernels import _build
    srcs = " ".join(p.read_text() for p in CSRC.glob("*.cu"))
    for base in ("mixffn_ln_skip", "mhca_block", "etb_attention",
                 "linear_attention", "bridge_attention", "patch_expand",
                 "mixffn_skip", "mixffn_ln_skip_bwd", "bridge_attention_bwd",
                 "bridge_attention_folded"):
        assert _build.symbol(base, BF16) == base
        assert _build.symbol(base, F32) == base + "_f32"
        assert re.search(rf"\b{base}_f32\b", srcs), base
