"""The launch plans of the staged MixFFN forward (K2, K9 and the MHCA
block's FFN: ops/kernels/mixffn.py fwd_plan) and of the MHCA block (K5:
ops/kernels/mhca_block.py plan): pure Python, no card and no JAX. The CUDA
stages take the plans' tiles and band rows as they are, so every stage must
launch at least a block per SM at every shape the model gives it, each
block's shared memory must fit the card, and the workspace must be what a
hand count says. Constants are held equal to the CUDA sources'.
"""

import pathlib
import re

import pytest

from transception_tpu_torch.ops.kernels import mhca_block as mb
from transception_tpu_torch.ops.kernels import mixffn as mf

CSRC = pathlib.Path(mf.__file__).resolve().parents[2] / "csrc"
STAGES = CSRC / "mixffn_stages.cuh"
MHCA = CSRC / "mhca_block.cu"
SMS = 132  # an H100 SXM
# (B, s, C, hidden) of every K2, K9 and K5-FFN call of the model: serving
# at b = 32 (ETB stage 1 and decoders, the bridge folds of groups 1, 2 and
# 5 at the same shapes, the MHCA FFN folds of stages 2-3), training at
# b = 24 (chip_smoke.FFN_SHAPES; K9 and the MHCA blocks at 28² x 64 and
# 14² x 128).
SERVING = [(32, 56, 64, 256), (32, 28, 128, 512), (32, 14, 320, 1280),
           (32, 28, 64, 256), (32, 14, 128, 512)]
TRAIN = [(24, 56, 64, 256), (24, 28, 64, 256), (24, 28, 128, 512),
         (24, 14, 128, 512), (24, 14, 320, 1280)]
# (B, s, C) of every MHCA block: serving stages 2 and 3, and stage 2's
# rate-0 blocks in the "pallas" train step.
MHCA_SHAPES = [(32, 28, 64), (32, 14, 128), (24, 28, 64)]
# The card tests' shapes (tests/test_torch_cuda.py) and a few ragged ones.
SMALL = [(2, 8, 64, 256), (2, 7, 128, 512), (2, 14, 320, 1280),
         (3, 14, 128, 512), (2, 2, 512, 2048), (1, 1, 64, 64)]


def _constexpr(path, name):
    return re.findall(rf"constexpr int {name} = (\d+);", path.read_text())


@pytest.mark.parametrize("path,name,value", [
    (STAGES, "GSTAGES", mf.GEMM_STAGES), (STAGES, "BIG", mf.BWD_TILES[0]),
    (STAGES, "SMALL", mf.BWD_TILES[1]), (STAGES, "BK", mf.BWD_DEPTH),
    (STAGES, "SEG", mf.FWD_SEGMENT), (MHCA, "HALO", mb.HALO),
    (STAGES, "THREADS", mb.THREADS)])
def test_constants_match_cuda_source(path, name, value):
    assert _constexpr(path, name) == [str(value)]


@pytest.mark.parametrize("path,enum,names", [
    (STAGES, "FwdPlan", ["FC1_BM", "FC1_BN", "FC2_BM", "FC2_BN",
                         "FWD_PLAN_LEN"]),
    (MHCA, "Plan", ["QKV_BM", "QKV_BN", "PROJ_BM", "PROJ_BN", "BAND_ROWS",
                    "FFN_PLAN"])])
def test_plan_order_matches_cuda_source(path, enum, names):
    """The plans' ints in the order of the sources' enums; K5's plan ends
    with the FFN's."""
    body = re.search(rf"enum {enum} \{{([^}}]*)\}}", path.read_text()).group(1)
    assert [n.strip() for n in body.split(",") if n.strip()] == names
    ffn = mf.fwd_plan(32, 14, 128, 512, SMS)
    assert len(ffn["plan"]) == 4
    p = mb.plan(32, 14, 128, 8, 512, SMS)
    assert p["plan"][5:] == ffn["plan"] and p["plan"][4] == p["band_rows"]


@pytest.mark.parametrize("B,s,C,hid", SERVING + TRAIN)
def test_every_stage_fills_the_card(B, s, C, hid):
    """fc1, the conv/rows stage and fc2 each launch a block per SM."""
    p = mf.fwd_plan(B, s, C, hid, SMS)
    assert set(p["blocks"]) == {"fc1", "rows", "fc2"}
    for stage, n in p["blocks"].items():
        assert n >= SMS, stage


@pytest.mark.parametrize("B,s,C", MHCA_SHAPES)
def test_mhca_stages_fill_the_card(B, s, C):
    """Every stage of K5 (CPE, qkv, contexts, attention bands, proj, the
    FFN's three) launches a block per SM."""
    p = mb.plan(B, s, C, 8, 4 * C, SMS)
    assert len(p["blocks"]) == 8
    for stage, n in p["blocks"].items():
        assert n >= SMS, stage


@pytest.mark.parametrize("B,s,C,hid", SERVING + TRAIN + SMALL)
def test_products_cover_their_outputs(B, s, C, hid):
    """Each product's tiles are the source's sides, and its grid covers
    its T x N outputs; the plan list is the tiles in order."""
    p = mf.fwd_plan(B, s, C, hid, SMS)
    T = B * s * s
    assert p["gemms"]["fc1"][:3] == (T, hid, C)
    assert p["gemms"]["fc2"][:3] == (T, C, hid)
    for name, (M, N, K, bm, bn) in p["gemms"].items():
        assert bm in mf.BWD_TILES and bn in mf.BWD_TILES, name
        assert -(-M // bm) * bm >= M and -(-N // bn) * bn >= N
        assert p["blocks"][name] == -(-M // bm) * -(-N // bn)
    assert p["plan"] == [*p["gemms"]["fc1"][3:], *p["gemms"]["fc2"][3:]]
    assert p["blocks"]["rows"] == B * s


@pytest.mark.parametrize("B,s,C,hid,want", [
    (32, 56, 64, 256, 2 * 32 * 3136 * 256 * 2),     # 98 MiB
    (32, 14, 320, 1280, 2 * 32 * 196 * 1280 * 2)])  # 30.6 MiB
def test_workspace_hand_count(B, s, C, hid, want):
    """The workspace is h and a, bf16, tokens x hidden each: the caller's
    LN is folded into fc1, so no normalised copy of x, and the conv output
    lives only in the rows stage's shared memory."""
    ws = mf.fwd_plan(B, s, C, hid, SMS)["workspace"]
    assert ws == {"h": want // 2, "a": want // 2}
    assert sum(ws.values()) == want


def test_mhca_workspace_hand_count():
    """K5 at (32, 28², 64), 8 heads, hidden 256: x1, att and x2 (T x C),
    q|k|v (T x 3C) and h and a (T x 256), bf16, and the contexts (B x 8 x 8
    x 8) fp32."""
    T = 32 * 784
    ws = mb.plan(32, 28, 64, 8, 256, SMS)["workspace"]
    assert list(ws) == ["x1", "qkv", "ctx", "att", "x2", "h", "a"]
    assert sum(ws.values()) == (3 * T * 64 + T * 192 + 2 * T * 256) * 2 + \
        32 * 8 * 8 * 8 * 4


@pytest.mark.parametrize("B,s,C,hid", SERVING + TRAIN + SMALL)
def test_shared_memory_within_limit(B, s, C, hid):
    """Each instantiation's block fits the card's opt-in shared memory:
    fc1 with and without the folded LN, the conv/rows stage, fc2."""
    smem = mf.fwd_plan(B, s, C, hid, SMS)["smem"]
    assert set(smem) == {"fc1_ln", "fc1", "rows", "fc2"}
    assert max(smem.values()) <= mf.fwd_smem_bytes(s, C, hid) <= \
        mf.SMEM_LIMIT


@pytest.mark.parametrize("B,s,C", MHCA_SHAPES + [(2, 8, 64), (3, 7, 128)])
def test_mhca_shared_memory_within_limit(B, s, C):
    """The attention stage's band (at the plan's rows and at the most the
    plan may pick) and the context stage fit the card."""
    d = C // 8
    p = mb.plan(B, s, C, 8, 4 * C, SMS)
    assert mb.attn_smem(s, C, d, p["band_rows"]) <= \
        mb.attn_smem(s, C, d, mb.BAND_ROWS[0]) <= mb.SMEM_LIMIT
    assert (2 * s * s * d + mb.THREADS) * 4 <= mb.SMEM_LIMIT


def test_plan_is_a_function_of_shape_and_card():
    """The same shape on the same card gives the same plan (no state, so
    two launches give the same bits); a smaller card needs no more."""
    for args in ((32, 56, 64, 256), (24, 14, 320, 1280)):
        assert mf.fwd_plan(*args, SMS) == mf.fwd_plan(*args, SMS)
    assert mb.plan(32, 14, 128, 8, 512, SMS) == \
        mb.plan(32, 14, 128, 8, 512, SMS)
    assert mb.plan(32, 14, 128, 8, 512, 114)["band_rows"] >= \
        mb.plan(32, 14, 128, 8, 512, SMS)["band_rows"]


def test_band_rows_fall_until_the_card_fills():
    """Four map rows a band where that fills the card, two at 14² and b =
    32 (four would leave 128 blocks for 132 SMs), one for tiny batches."""
    assert mb.plan(32, 28, 64, 8, 256, SMS)["band_rows"] == 4
    assert mb.plan(32, 14, 128, 8, 512, SMS)["band_rows"] == 2
    assert mb.plan(1, 8, 64, 8, 256, SMS)["band_rows"] == 1
