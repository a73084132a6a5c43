"""The sp and para bridges and the model without a bridge, the port
against the JAX package at the tiny config (fp32): logits from the same
weights, the weights carried both ways (helpers and tolerances of
tests/test_torch_variants.py). The port's sp and para bridges run their
folded structure (the folded attention K8 and the grouped-LN FFN folds
K2, plain versions on the CPU), JAX its XLA path."""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from test_torch_variants import (
    check_logits,
    check_round_trip,
    jax_pair,
)
from transception_tpu_torch.core.config import fold_switches
from transception_tpu_torch.models.bridge import (
    BridgeBlockPara,
    BridgeBlockSp,
    SpatialAwareTrans,
)
from transception_tpu_torch.ops.common import init_weights

CASES = {
    "sp": ("mstransception_sp", {}),
    "para": ("mstransception_para", {}),
    "none": ("mstransception", dict(have_bridge="none")),
    "sp-num_sp-2": ("mstransception", dict(have_bridge="sp", num_sp=2)),
}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    name, over = CASES[request.param]
    return jax_pair(name, seed=2, **over)


def test_bridge_variant_matches_jax_fp32(pair):
    check_logits(pair, seed=2)


def test_bridge_variant_weights_round_trip(pair):
    check_round_trip(pair)


def test_bridges_fold_by_their_kernel_switch(pair):
    """The sp and para bridges' layers fold by FoldSwitches.sp_bridge: on
    in eval with use_kernels and in every train mode, off in eval without
    use_kernels; the model without a bridge has none."""
    _, _, pm, _ = pair
    cfg = pm.cfg
    if cfg.have_bridge == "none":
        assert pm.bridge is None
        return
    assert isinstance(pm.bridge, (BridgeBlockSp, BridgeBlockPara))
    assert fold_switches(cfg, False).sp_bridge
    assert fold_switches(cfg, True).sp_bridge
    import dataclasses
    off = dataclasses.replace(cfg, use_kernels=False)
    assert not fold_switches(off, False).sp_bridge
    assert fold_switches(off, True).sp_bridge
    sat = getattr(pm.bridge.bridge_layer1, "scale_fuse_att", None)
    assert (sat is not None) == (cfg.have_bridge == "sp")
    if sat is not None:
        assert len(sat.group_attention) == cfg.num_sp


def test_sp_bridge_dropout_follows_its_generator():
    """In training the sp bridge's MLP dropout draws its masks from the
    step's generator: the same seed gives the same maps, another seed
    others; in eval the block is deterministic."""
    sat = SpatialAwareTrans((64, 128, 320, 512), 64, 1, torch.float32)
    init_weights(sat, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(0)
    maps = [torch.randn(2, s, s, c, generator=g)
            for s, c in ((8, 64), (4, 128), (2, 320), (1, 512))]
    sat.train()
    a, b, c = (sat(maps, torch.Generator().manual_seed(s))
               for s in (5, 5, 6))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    with pytest.raises(ValueError, match="Generator"):
        sat(maps)
    sat.eval()
    d, e = sat(maps), sat(maps, torch.Generator().manual_seed(9))
    assert all(torch.equal(x, y) for x, y in zip(d, e))
    assert all(np.isfinite(t.detach().numpy()).all() for t in d)
