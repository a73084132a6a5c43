"""The launch plans of the ETB attention (K1: ops/kernels/etb_attention.py
plan) and the linear attention (K6: ops/kernels/linear_attention.py plan),
which share the linear-attention core (csrc/linear_attention.cuh): pure
Python, no card and no JAX. The CUDA stages take the plans' tiles,
segments and bodies as they are, so every stage must launch at least a
block per SM at every shape the model gives it, each block's shared memory
must fit the card, and the workspace must be what a hand count says.
Constants are held equal to the CUDA sources'.
"""

import pathlib
import re

import pytest

from transception_tpu_torch.ops.kernels import etb_attention as ea
from transception_tpu_torch.ops.kernels import linear_attention as la
from transception_tpu_torch.ops.kernels import mixffn as mf

CSRC = pathlib.Path(la.__file__).resolve().parents[2] / "csrc"
CORE = CSRC / "linear_attention.cuh"
K1 = CSRC / "etb_attention.cu"
K6 = CSRC / "linear_attention.cu"
SMS = 132  # an H100 SXM
# (B, N, C) of every K1 call: ETB stage 1 and decoders 0-2, serving at b =
# 32 and in the "pallas" train step at b = 24.
ETB = [(32, 3136, 64), (32, 784, 128), (32, 196, 320),
       (24, 3136, 64), (24, 784, 128), (24, 196, 320)]
# (B, h, N, d) of every K6 call: the MHCA factorized attention (stage 4,
# and stages 2-3 unfolded) and the ETB attention with etb_attn_fold off.
MHCA = [(B, 8, N, d) for B in (32, 24) for N, d in
        ((49, 40), (784, 8), (196, 16))]
ETB_HEADS = [(B, 1, N, C) for B, N, C in ETB]


def _constexpr(path, name):
    return re.findall(rf"constexpr int {name} = (\d+);", path.read_text())


def _enum(path, name):
    body = re.search(rf"enum {name} \{{([^}}]*)\}}", path.read_text()).group(1)
    return [n.strip() for n in body.split(",") if n.strip()]


@pytest.mark.parametrize("path,name,value", [
    (CORE, "CT", la.CTX_TILE), (CORE, "RC", la.CHUNK_ROWS),
    (CORE, "RO", la.OUT_ROWS), (CORE, "SCOLS", la.STATS_COLS),
    (CORE, "CSTAGES", la.CTX_STAGES), (K6, "HEAD_MAX", la.HEAD_MAX),
    (CSRC / "mixffn_stages.cuh", "THREADS", la.THREADS),
    (K1, "KID", 1), (K6, "KID", 6)])
def test_constants_match_cuda_source(path, name, value):
    assert _constexpr(path, name) == [str(value)]


def test_plan_order_matches_cuda_source():
    """The plans' ints in the order of the sources' enums."""
    assert _enum(K1, "Plan") == ["QKV_BM", "QKV_BN", "PROJ_BM", "PROJ_BN",
                                 "SEGMENTS", "SEGMENT_ROWS", "PLAN_LEN"]
    assert _enum(K6, "Plan") == ["BODY", "SEGMENTS", "SEGMENT_ROWS",
                                 "PLAN_LEN"]
    assert _enum(K6, "Body") == ["BODY_" + b.upper() for b in la.BODIES]
    p = ea.plan(32, 784, 128, SMS)
    assert p["plan"] == [*p["gemms"]["qkv"][3:], *p["gemms"]["proj"][3:],
                         p["core"]["segments"], p["core"]["segment_rows"]]
    assert la.plan(256, 49, 40, 40, SMS)["plan"] == [
        la.BODIES.index("head"), 1, 49]
    q = la.plan(32, 3136, 64, 64, SMS)
    assert q["plan"] == [la.BODIES.index("segmented"), q["segments"],
                         q["segment_rows"]]


@pytest.mark.parametrize("B,h,N,d", MHCA + ETB_HEADS)
def test_k6_body_per_shape(B, h, N, d):
    """Every MHCA shape takes the head body (q, k and v of a head fit a
    block: 11.8 KB at (49, 40), 37.6 KB at (784, 8), 18.8 KB at (196,
    16)), a block a head (192 or 256 blocks), with no workspace; every
    ETB shape the segmented body."""
    p = la.plan(B * h, N, d, d, SMS)
    if h == 8:
        assert p["body"] == "head"
        assert 3 * N * d * 2 < p["smem"]["head"] and p["workspace"] == {}
        assert p["blocks"] == {"head": B * h}
    else:
        assert p["body"] == "segmented"
        assert set(p["blocks"]) <= {"stats", "ctx", "sum", "out"}


@pytest.mark.parametrize("B,h,N,d", MHCA + ETB_HEADS)
def test_k6_stages_fill_the_card(B, h, N, d):
    for stage, n in la.plan(B * h, N, d, d, SMS)["blocks"].items():
        assert n >= SMS, stage


@pytest.mark.parametrize("B,N,C", ETB)
def test_k1_stages_fill_the_card(B, N, C):
    """qkv, stats, ctx, the segments' sum (where there are several), out
    and proj each launch a block per SM."""
    p = ea.plan(B, N, C, SMS)
    want = {"qkv", "stats", "ctx", "out", "proj"}
    assert set(p["blocks"]) == want | ({"sum"} if p["core"]["segments"] > 1
                                       else set())
    for stage, n in p["blocks"].items():
        assert n >= SMS, stage


@pytest.mark.parametrize("B,N,C", ETB + [(2, 200, 64), (1, 196, 320),
                                         (3, 7, 512)])
def test_k1_products_cover_their_outputs(B, N, C):
    """The products' tiles are the shared product's sides, and their grids
    cover T x 3C (qkv) and T x C (proj)."""
    p = ea.plan(B, N, C, SMS)
    T = B * N
    assert p["gemms"]["qkv"][:3] == (T, 3 * C, C)
    assert p["gemms"]["proj"][:3] == (T, C, C)
    for name, (M, Nn, K, bm, bn) in p["gemms"].items():
        assert bm in mf.BWD_TILES and bn in mf.BWD_TILES, name
        assert p["blocks"][name] == -(-M // bm) * -(-Nn // bn)


@pytest.mark.parametrize("B,N,C", ETB + [(2, 200, 64), (5, 1, 128)])
def test_segments_cover_n(B, N, C):
    """Segments are whole 64-row chunks, none empty, and cover N; the
    context stage asks for two blocks per SM, and whole chunks leave it
    at least one (240 at (24, 3136, 64)) where N allows."""
    core = ea.plan(B, N, C, SMS)["core"]
    S, rows = core["segments"], core["segment_rows"]
    assert S >= 1 and rows % la.CHUNK_ROWS == 0
    assert (S - 1) * rows < N <= S * rows
    assert core["blocks"]["ctx"] >= SMS or rows == la.CHUNK_ROWS


def test_k1_workspace_hand_count():
    """K1 at (32, 3136, 64): q|k|v (T x 3C) and att (T x C) in bf16, 51.4
    MB; 9 segments of statistics (B x C (m, l) pairs) and fp32 context
    partials (B x C x C), and the bf16 context."""
    T, C, B, S = 32 * 3136, 64, 32, 9
    ws = ea.plan(B, 3136, C, SMS)["workspace"]
    assert list(ws) == ["qkv", "part", "pctx", "ctx", "att"]
    assert ws["qkv"] + ws["att"] == T * 4 * C * 2 == 51380224
    assert ws == {"qkv": T * 3 * C * 2, "part": S * B * C * 8,
                  "pctx": S * B * C * C * 4, "ctx": B * C * C * 2,
                  "att": T * C * 2}
    assert sum(ws.values()) == 56508416


def test_k6_workspace_hand_count():
    """K6's segmented body at (32, 1, 784, 128): 3 segments of statistics
    and fp32 partials, the bf16 context; with one segment (196 rows) no
    partials."""
    ws = la.plan(32, 784, 128, 128, SMS)["workspace"]
    assert ws == {"part": 3 * 32 * 128 * 8, "pctx": 3 * 32 * 128 * 128 * 4,
                  "ctx": 32 * 128 * 128 * 2}
    assert la.plan(32, 196, 320, 320, SMS)["workspace"]["pctx"] == 0


@pytest.mark.parametrize("B,h,N,d", MHCA + ETB_HEADS + [(1, 2, 100, 64),
                                                        (1, 1, 64, 512)])
def test_k6_shared_memory_within_limit(B, h, N, d):
    assert max(la.plan(B * h, N, d, d, SMS)["smem"].values()) <= \
        la.SMEM_LIMIT


@pytest.mark.parametrize("B,N,C", ETB + [(1, 64, 512)])
def test_k1_shared_memory_within_limit(B, N, C):
    smem = ea.plan(B, N, C, SMS)["smem"]
    assert set(smem) == {"qkv", "stats", "ctx", "out", "proj"}
    assert max(smem.values()) <= la.SMEM_LIMIT


def test_plans_are_functions_of_shape_and_card():
    """The same shape on the same card gives the same plan (no state, so
    two launches give the same bits)."""
    for args in ((32, 3136, 64), (24, 196, 320)):
        assert ea.plan(*args, SMS) == ea.plan(*args, SMS)
    for args in ((256, 784, 8, 8), (32, 3136, 64, 64)):
        assert la.plan(*args, SMS) == la.plan(*args, SMS)
        assert la._launch_plan(*args, SMS) is la._launch_plan(*args, SMS)


# (B, h, N, d) of the legacy models' K6 calls at 224² (models/legacy.py):
# the two-branch encoder's fused sequences at head_count 8, EffMiT's
# stage-4 blocks, ResInception's one-head fused sequences ('15', '135').
LEGACY = [(B, h, N, d) for B in (32, 24) for h, N, d in (
    (8, 1460, 16), (8, 340, 40), (8, 74, 64), (1, 49, 512), (1, 2352, 128),
    (1, 588, 320), (1, 147, 512), (1, 3136, 128), (1, 784, 320),
    (1, 196, 512))]


@pytest.mark.parametrize("es", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("B,h,N,d", LEGACY)
def test_k6_legacy_shapes_fit(B, h, N, d, es):
    """Every legacy shape has a plan within shared memory at both element
    sizes; the head body where a head fits a block."""
    pl = la.plan(B * h, N, d, d, SMS, es)
    assert max(pl["smem"].values()) <= la.SMEM_LIMIT
    fits = d <= la.HEAD_MAX and la.head_smem(N, d, d, es) <= la.SMEM_LIMIT
    assert pl["body"] == ("head" if fits else "segmented")


def test_out_stage_context_pieces():
    """The out stage stages the context's column tile whole beside Q's
    rows where it fits (every bf16 head dim up to 512, fp32 up to 320),
    else in pieces of whole 64-row tiles: fp32 at 512, 384 rows and then
    128, within the card's shared memory; the source's limit is the
    plan's."""
    for d, es in ((512, 2), (320, 4), (64, 4), (8, 2)):
        assert la.out_ctx_rows(d, es) == -(-d // 64) * 64
    assert la.out_ctx_rows(512, 4) == 384
    assert la.out_smem(512, 4) == (64 * 512 + 384 * 64) * 4 <= la.SMEM_LIMIT
    assert re.findall(r"constexpr size_t OUT_SMEM_MAX = (\d+);",
                      CORE.read_text()) == [str(la.SMEM_LIMIT)]
