"""The launch plan of K10's columns kernel (ops/kernels/bridge_attention.py
bwd_plan) and the K3/K10 launchers' guards: pure Python, no card and no
JAX. The kernel walks each row segment in whole BWD_ROW_CHUNK-row chunks
and gives each block BWD_KEY_TILE keys, 16 a warp, so the plan must cut
the query rows into whole chunks that cover N exactly without overlap,
its key tiles must cover the M keys, and it must fill the card at the
published train step's shape. The two tile sizes are the CUDA source's
own constants.
"""

import pathlib
import re

import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu_torch.ops.kernels import bridge_attention as ba

BWD_SOURCE = (pathlib.Path(ba.__file__).resolve().parents[2] / "csrc"
              / "bridge_attention_bwd.cu")

# (B·h, N, M, SMs): the published train step (b=24) and forward (b=32),
# the card tests' shapes, a partial last key chunk, an H100 PCIe (114 SMs).
SHAPES = [(24, 6076, 784, 132), (32, 6076, 784, 132), (2, 124, 16, 132),
          (2, 6076, 784, 132), (2, 300, 128, 132), (6, 124, 240, 132),
          (2, 300, 800, 132), (2, 6076, 48, 132), (1, 1, 16, 132),
          (2, 60, 784, 132), (24, 6076, 784, 114), (4, 600, 96, 132)]


def _segments(n, nseg, seg_rows):
    return [(i * seg_rows, min(n, (i + 1) * seg_rows)) for i in range(nseg)]


@pytest.mark.parametrize("bh,n,m,sms", SHAPES)
def test_segments_cover_rows_in_whole_chunks(bh, n, m, sms):
    nseg, seg_rows = ba.bwd_plan(bh, n, m, sms)
    assert nseg >= 1 and seg_rows % ba.BWD_ROW_CHUNK == 0
    seen = [0] * n
    for lo, hi in _segments(n, nseg, seg_rows):
        assert lo < hi, "an empty segment"
        for r in range(lo, hi):
            seen[r] += 1
    assert seen == [1] * n


@pytest.mark.parametrize("bh,n,m,sms", SHAPES)
def test_key_tiles_cover_keys(bh, n, m, sms):
    """The kernel's grid has ceil(M / BWD_KEY_TILE) key tiles of 16-key
    warps (warps past M idle); M is a multiple of 16, so each warp's keys
    lie wholly inside M or wholly past it."""
    kt = ba.BWD_KEY_TILE
    assert kt % 16 == 0 and 16 <= kt <= 128  # 1-8 warps
    tiles = -(-m // kt)
    assert (tiles - 1) * kt < m <= tiles * kt
    assert m % 16 == 0 and all(w + 16 <= m or w >= m
                               for w in range(0, tiles * kt, 16))


@pytest.mark.parametrize("name,const", [("RC", "BWD_ROW_CHUNK"),
                                        ("KT", "BWD_KEY_TILE")])
def test_plan_tiling_matches_cuda_source(name, const):
    found = re.findall(rf"constexpr int {name} = (\d+);",
                       BWD_SOURCE.read_text())
    assert found == [str(getattr(ba, const))]


def test_published_step_fills_the_card():
    nseg, _ = ba.bwd_plan(24, 6076, 784, 132)
    assert -(-784 // ba.BWD_KEY_TILE) * nseg * 24 >= 132


def test_one_segment_when_rows_are_few():
    """N within one chunk: one segment, whose fp32 partial sum_partials
    rounds to bf16."""
    assert ba.bwd_plan(2, 60, 784, 132) == (1, ba.BWD_ROW_CHUNK)


@pytest.mark.parametrize("scale", [0.0, -0.125, float("nan")])
def test_launchers_refuse_a_non_positive_scale(scale):
    """The kernels take the row max on the raw logits, which is the max of
    the scaled ones only for scale > 0: both launchers raise before they
    build or launch anything."""
    q, k, v = (torch.zeros(1, 1, n, 64, dtype=torch.bfloat16)
               for n in (16, 16, 16))
    with pytest.raises(ValueError, match="scale > 0"):
        ba._launch(q, k, v, scale)
    with pytest.raises(ValueError, match="scale > 0"):
        ba._launch_bwd(q, k, v, q, scale)
