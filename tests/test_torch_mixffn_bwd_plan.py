"""The launch plan of K11, the MixFFN backward (ops/kernels/mixffn.py
bwd_plan): pure Python, no card and no JAX. The CUDA stages take the
plan's output tiles, split counts and token ranges as they are, so the
plan must cover every output and every token exactly once, fill the card
at the published train step's shapes and keep the workspace under a
stated cap. The tile sizes are the CUDA source's own constants.
"""

import pathlib
import re

import pytest

from transception_tpu_torch.ops.kernels import mixffn as mf

CSRC = pathlib.Path(mf.__file__).resolve().parents[2] / "csrc"
SOURCE = CSRC / "mixffn_bwd.cu"
# The products and their tiling live in the header K11 shares with the
# forward (K2, K9, K5).
STAGES = CSRC / "mixffn_stages.cuh"
SMS = 132  # an H100 SXM
# Every (s, C, hidden) of the flash train step's MixFFN folds (chip_smoke
# FFN_SHAPES) at its batch of 24.
TRAIN = [(24, 56, 64, 256), (24, 28, 64, 256), (24, 28, 128, 512),
         (24, 14, 128, 512), (24, 14, 320, 1280)]
# The card tests' shapes (tests/test_torch_cuda.py) and a few ragged ones.
SMALL = [(3, 8, 64, 256), (3, 6, 128, 512), (3, 14, 128, 512),
         (3, 14, 320, 1280), (3, 28, 64, 256), (3, 2, 512, 2048),
         (1, 1, 64, 64), (2, 7, 64, 256), (1, 56, 128, 256)]
# At most the workspace of one launch (intermediates and partials) at the
# train shapes: about a quarter of a GB at (24, 56², 64, 256).
WORKSPACE_CAP = 256 << 20


@pytest.mark.parametrize("name,const", [
    ("BIG", "BWD_TILES[0]"), ("SMALL", "BWD_TILES[1]"), ("BK", "BWD_DEPTH"),
    ("TT", "BWD_TOKEN_TILE"), ("CH", "BWD_CHANNELS"),
    ("THREADS", "BWD_THREADS")])
def test_tiling_matches_cuda_source(name, const):
    text = SOURCE.read_text() + STAGES.read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert found == [str(eval(f"mf.{const}"))]


def test_plan_order_matches_cuda_source():
    """The plan's ints in the order of the source's Plan enum."""
    text = SOURCE.read_text()
    enum = re.search(r"enum Plan \{([^}]*)\}", text).group(1)
    names = [n.strip() for n in enum.split(",") if n.strip()]
    assert names == ["H_BM", "H_BN", "DA_BM", "DA_BN", "DXN_BM", "DXN_BN",
                     "DW1_BM", "DW1_BN", "DW2_BM", "DW2_BN", "SPLITS",
                     "KPER", "BLOCKS", "TILES_PER_BLOCK", "PLAN_LEN"]
    assert len(mf.bwd_plan(24, 14, 320, 1280, SMS)["plan"]) == len(names) - 1


@pytest.mark.parametrize("B,s,C,hid", TRAIN + SMALL)
def test_token_ranges_cover_tokens_once(B, s, C, hid):
    """Blocks i of the rows and LN-backward kernels take tokens [i·tpb·TT, min(T, (i+1)·tpb·TT)): none empty, all tokens
    once."""
    p = mf.bwd_plan(B, s, C, hid, SMS)
    T, span = B * s * s, p["tiles_per_block"] * mf.BWD_TOKEN_TILE
    seen = [0] * T
    for i in range(p["blocks"]):
        lo, hi = i * span, min(T, (i + 1) * span)
        assert lo < hi, "an empty block"
        for n in range(lo, hi):
            seen[n] += 1
    assert seen == [1] * T


@pytest.mark.parametrize("B,s,C,hid", TRAIN + SMALL)
def test_column_walks_cover_the_map(B, s, C, hid):
    """The conv and depthwise-transpose grids: a warp per map column in
    groups of THREADS/32, a lane per channel in chunks of BWD_CHANNELS;
    every (column, channel) once, and one partial per (batch row, column
    group)."""
    cols = mf.BWD_THREADS // 32
    groups, chunks = -(-s // cols), -(-hid // mf.BWD_CHANNELS)
    seen = {(gx * cols + w, ch * mf.BWD_CHANNELS + l)
            for gx in range(groups) for w in range(cols)
            for ch in range(chunks) for l in range(mf.BWD_CHANNELS)
            if gx * cols + w < s and ch * mf.BWD_CHANNELS + l < hid}
    assert len(seen) == s * hid
    p = mf.bwd_plan(B, s, C, hid, SMS)
    assert p["walk_partials"] == B * groups
    assert p["workspace"]["pd"] == B * groups * 10 * hid * 4


@pytest.mark.parametrize("B,s,C,hid", TRAIN + SMALL)
def test_products_cover_outputs_and_depth(B, s, C, hid):
    """Each product's grid covers its M x N outputs with tiles of the
    source's sides; the split products' token ranges are whole 64-deep
    tiles that cover T once, none empty."""
    p = mf.bwd_plan(B, s, C, hid, SMS)
    T = B * s * s
    for name, (M, N, K, bm, bn) in p["gemms"].items():
        assert bm in mf.BWD_TILES and bn in mf.BWD_TILES, name
        assert -(-M // bm) * bm >= M and -(-N // bn) * bn >= N
    assert p["kper"] % mf.BWD_DEPTH == 0
    assert (p["splits"] - 1) * p["kper"] < T <= p["splits"] * p["kper"]
    assert p["plan"][10:] == [p["splits"], p["kper"], p["blocks"],
                              p["tiles_per_block"]]


@pytest.mark.parametrize("B,s,C,hid", TRAIN)
def test_train_shapes_fill_the_card(B, s, C, hid):
    """At the train step's shapes every product, token kernel and column
    walk launches at least one block per SM."""
    p = mf.bwd_plan(B, s, C, hid, SMS)
    for name, (M, N, K, bm, bn) in p["gemms"].items():
        splits = p["splits"] if name in ("dw1", "dw2") else 1
        assert -(-M // bm) * -(-N // bn) * splits >= SMS, name
    assert p["blocks"] >= SMS
    assert p["walk_partials"] * -(-hid // mf.BWD_CHANNELS) >= SMS


@pytest.mark.parametrize("B,s,C,hid", TRAIN)
def test_workspace_under_cap(B, s, C, hid):
    p = mf.bwd_plan(B, s, C, hid, SMS)
    assert sum(p["workspace"].values()) <= WORKSPACE_CAP
    assert p["workspace"]["pw"] <= mf.BWD_SPLIT_BYTES
    assert mf.bwd_smem_bytes(C, hid) <= mf.SMEM_LIMIT


def test_plan_is_a_function_of_shape_and_card():
    """The same shape on the same card gives the same plan (the partials'
    order, and so the bits, depend on nothing else)."""
    assert mf.bwd_plan(24, 14, 320, 1280, SMS) == \
        mf.bwd_plan(24, 14, 320, 1280, SMS)
    assert mf.bwd_plan(24, 14, 320, 1280, 114)["blocks"] <= \
        mf.bwd_plan(24, 14, 320, 1280, SMS)["blocks"]
