"""The model axis's weight layout (parallel/mesh.py) against the JAX
package's TP rules (transception_tpu/parallel/mesh.py param_shard_rules,
shard_params' even-division fallback), for every registry model at
tp 2 and 4, in the stacked MHCA layout (vectorize_paths, the default) and
the per-path one: the port's sharded weights, read through the converter's name
map (convert/from_jax.py flax_path_to_torch_key), are the ones JAX shards.
JAX's shapes come from jax.eval_shape of the model's init (no compute).
Plus: the companions that shard with an FFN's fc1 or a qkv, shard_model
on the modules, the refusal of a shard width the kernels do not take, and
the launch counts of a tp step.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from conftest import tiny_config
from transception_tpu.models.registry import MODEL_REGISTRY
from transception_tpu.parallel.mesh import param_shard_rules as jax_rules
from transception_tpu_torch.convert.from_jax import flax_path_to_torch_key
from transception_tpu_torch.core.config import TransceptionConfig
from transception_tpu_torch.models.registry import PORTED, create_model
from transception_tpu_torch.parallel.mesh import (
    param_shard_rules,
    shard_layout,
)

# The tiny config of tests/conftest.py (dil_conv 0: the legacy models'
# dilated schedules need larger maps in the port).
TINY = dict(img_size=32, dtype="float32", stage1_layers=1,
            num_path=(2, 2, 2), num_layers=(1, 1, 1), num_heads=(8, 8, 8),
            dil_conv=0)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):
            yield from _leaves(v, p)
        else:
            yield p, v


@functools.lru_cache(maxsize=None)
def jax_specs(name, stacked=True):
    """(flax path, shape, PartitionSpec) of every parameter leaf the JAX
    rules shard, for registry model `name` at the tiny config in the
    stacked or (stacked=False) per-path MHCA layout."""
    model = MODEL_REGISTRY[name](tiny_config(dil_conv=0,
                                             vectorize_paths=stacked))
    v = jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x, train=False),
        jnp.zeros((1, 32, 32, 1)))
    return tuple((p, tuple(leaf.shape), tuple(jax_rules(p, leaf)))
                 for p, leaf in _leaves(v["params"])
                 if any(jax_rules(p, leaf)))


def jax_sharded(name, tp, stacked=True):
    """{torch key: sharded dim} of the weights JAX shards for registry
    model `name` at tp (shard_params' fallback: replicated where the
    sharded dim does not divide; a flax kernel is (in, out), its out axis
    the torch weight's dim 0)."""
    # The layout switch reaches the MSTransception backbones only.
    stacked = stacked or not name.startswith("mstransception")
    return {flax_path_to_torch_key(p): 1 - spec.index("model")
            for p, shape, spec in jax_specs(name, stacked)
            if not any(a is not None and d % tp
                       for d, a in zip(shape, spec))}


@pytest.fixture(scope="module")
def port_models():
    return {n: create_model(n, TransceptionConfig(**TINY), "cpu")
            for n in PORTED}


LAYOUTS = {"stacked": True, "per_path": False}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_port_shards_the_jax_rules_set(port_models, name, tp, layout):
    stacked = LAYOUTS[layout]
    sd = port_models[name].state_dict()
    layout = shard_layout(sd, tp, stacked)
    got = {k: d for k, d in layout.items()
           if param_shard_rules(k, sd[k], stacked) is not None}
    assert got == jax_sharded(name, tp, stacked)
    # The rest are the companions of a sharded FFN's fc1 or of a qkv.
    comp = ("fc1.bias", "dwconv.dwconv.weight", "dwconv.dwconv.bias",
            "norm1.weight", "norm1.bias")
    for k in set(layout) - set(got):
        ffn = next((k[:-len(c)] for c in comp if k.endswith(c)), None)
        assert layout[k] == 0 and (ffn is not None and
                                   ffn + "fc1.weight" in got or
                                   k[:-len("bias")] + "weight" in got), k


def test_rules_set_covers_the_ffns_and_the_qkv(port_models):
    """What the rules pick at the tiny config: the ETB FFNs of stage 1 and
    the decoders, never an MHCA block's or a bridge layer's; the sp
    bridge's qkv_linear."""
    lay = shard_layout(port_models["mstransception"].state_dict(), 2)
    fc1 = sorted(k for k in lay if k.endswith("fc1.weight"))
    assert fc1 == ["backbone.block1.0.mlp.fc1.weight"] + [
        f"decoder_{d}.layer_former_{i}.mlp.fc1.weight"
        for d in range(3) for i in (1, 2)]
    assert not [k for k in lay if "mhca_blks" in k or "bridge" in k]
    sp = shard_layout(port_models["mstransception_sp"].state_dict(), 2)
    assert [k for k in sp if "qkv" in k] == [
        "bridge.bridge_layer1.scale_fuse_att.group_attention.0.Attention."
        "qkv_linear.weight",
        "bridge.bridge_layer1.scale_fuse_att.group_attention.0.Attention."
        "qkv_linear.bias"]
    assert shard_layout(port_models["mstransception"].state_dict(), 1) == {}


def test_per_path_layout_shards_the_mhca_blocks(port_models):
    """The per-path layout's rules at the tiny MSTransception (two paths
    a stage): 32 kernels where the stacked layout shards 14; the 18 more
    are every MHCA block's factoratt_crpe qkv (on its output features)
    and its mlp fc1 and fc2, in stages 2-4."""
    assert len(jax_specs("mstransception")) == 14
    assert len(jax_specs("mstransception", False)) == 32
    sd = port_models["mstransception"].state_dict()
    extra = set(shard_layout(sd, 2, False)) - set(shard_layout(sd, 2))
    weights = sorted(k for k in extra if k.endswith("weight") and
                     param_shard_rules(k, sd[k], False) is not None)
    assert len(weights) == 18
    assert all(".mhca_blks." in k and k.endswith((
        "factoratt_crpe.qkv.weight", "mlp.fc1.weight", "mlp.fc2.weight"))
        for k in weights)
    assert {sd[k].shape for k in weights
            if k.endswith("qkv.weight")} == {(192, 64), (384, 128),
                                             (960, 320)}


def test_even_division_fallback():
    """A weight whose sharded dim does not divide by tp stays replicated,
    with its companions."""
    sd = {"a.mlp.fc1.weight": torch.zeros(6, 4),
          "a.mlp.fc1.bias": torch.zeros(6),
          "a.mlp.fc2.weight": torch.zeros(4, 6),
          "b.qkv.weight": torch.zeros(12, 4), "b.qkv.bias": torch.zeros(12)}
    assert shard_layout(sd, 2) == {"a.mlp.fc1.weight": 0,
                                   "a.mlp.fc1.bias": 0,
                                   "a.mlp.fc2.weight": 1,
                                   "b.qkv.weight": 0, "b.qkv.bias": 0}
    assert shard_layout(sd, 4) == {"b.qkv.weight": 0, "b.qkv.bias": 0}


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_model_keeps_each_ranks_block(port_models, tp):
    """shard_model on each rank's copy: every tensor of the layout is the
    rank's block of the full one, the rest unchanged; the blocks in rank
    order are the full tensor (shard_state_dict gives the same)."""
    import copy

    from transception_tpu_torch.parallel.mesh import (
        shard_model,
        shard_state_dict,
    )
    from transception_tpu_torch.parallel.tensor import ModelAxis
    full = port_models["mstransception_sp"]
    sd = full.state_dict()
    parts = []
    for t in range(tp):
        m = copy.deepcopy(full)
        layout = shard_model(m, ModelAxis(tp, t, None))
        assert layout == shard_layout(sd, tp)
        got = m.state_dict()
        want = shard_state_dict(sd, layout, tp, t)
        for k in sd:
            assert torch.equal(got[k], want[k]), k
        parts.append(got)
    for k, dim in layout.items():
        assert torch.equal(torch.cat([p[k] for p in parts], dim), sd[k]), k


def test_check_tp_refuses_a_shard_the_kernels_do_not_take():
    """At the published widths tp 8 leaves the 256-wide ETB FFNs 32
    channels a rank: refused by name on the card with the MixFFN kernels
    in training; tp 2 and 4 pass; the CPU's plain stages take any."""
    from transception_tpu_torch.models.transception import (
        MSTransception,
        check_tp,
    )
    m = MSTransception(TransceptionConfig(ffn_flash_train=True), "cpu")
    with pytest.raises(ValueError, match="backbone.block1.0.mlp's hidden "
                                         "layer of 256 channels would keep "
                                         "32 a rank"):
        check_tp(m, 8, "cuda")
    for tp in (2, 4):
        check_tp(m, tp, "cuda")
    check_tp(m, 8, "cpu")
    check_tp(MSTransception(TransceptionConfig(), "cpu"), 8, "cuda")


def test_launches_per_step_under_tp():
    """The ETB FFN folds (two in stage 1, six in the decoders) move to the
    hidden-sharded K2 and K11 at tp 2 and 4; the other folds stay."""
    from transception_tpu_torch.models.transception import (
        launches_per_step,
    )
    for kw in (dict(ffn_flash_train=True),
               dict(use_pallas_train=True, mhca_ffn_fold=True)):
        cfg = TransceptionConfig(**kw)
        one = launches_per_step(cfg)
        for tp in (2, 4):
            got = launches_per_step(cfg, tp=tp)
            assert got["mixffn_tp"] == got["mixffn_tp_bwd"] == 8
            assert got["mixffn"] == one["mixffn"] - 8
            assert got["mixffn_bwd"] == one["mixffn_bwd"] - 8
            rest = {k: v for k, v in got.items() if "mixffn" not in k}
            assert rest == {k: v for k, v in one.items()
                            if "mixffn" not in k}
    assert launches_per_step(TransceptionConfig(), tp=2) == \
        launches_per_step(TransceptionConfig())
    # 3 divides none of the ETB hidden widths (256, 512, 1280): none
    # shards, and the step launches as at tp 1.
    cfg = TransceptionConfig(ffn_flash_train=True)
    assert launches_per_step(cfg, tp=3) == launches_per_step(cfg)
