"""The model axis beyond the published layout, on the CPU: the legacy
models (transception, missformer, effmissformer, resinception,
resinception_135) sharded by the JAX TP rules (their blocks' FFNs), and
the per-path MHCA layout (TransceptionConfig.vectorize_paths False,
--no_vectorize_paths), whose rules also shard every MHCA block's qkv and
FFN (K5's and K9's sharded forms). Gloo ranks started once a world size
for the module (parallel.mesh.spawn): dp1 x tp2 runs every case of
tests/torch_tp_worker.py LAYOUT_CASES, dp1 x tp4 those of LAYOUT_TP4;
each against the one-process step on the global batch, within
tests/test_torch_tp.py's limits (its `mismatch`).

Also: MISSFormer with bridge_seq_shard_axis "model" (its bridge stays
whole, as the JAX MISSFormer builds it without the axis) equals the
one-process MISSFormer step, with no partial gradients; the tp 2 MISSFormer
checkpoint resumes at tp 1 and the one-process one at tp 2 and 4; each
rank's kernel routes equal launches_per_step (the legacy ones: unchanged
by the axis); the per-path model's sharded eval forward (K5's sharded
form through its operators' CPU implementations) equals the one
process's within 1e-5 of the logits' largest value. Against JAX: the loss
(0.4 CE + 0.6 Dice) of the JAX package's sharded eval forward
(shard_params on the 4 x 2 cpu_mesh; no JAX train step compiled), one
legacy model (MISSFormer) and the per-path MSTransception, each from the
port's weights (convert_state_dict), against the loss of the port's
dp1 x tp2 sharded forward, at 2e-5 relative (tests/test_sp_remat.py:66).
"""

import os
import shutil

import numpy as np
import pytest
import torch
import torch_dp_worker as W
import torch_threads  # noqa: F401 (torch's threads per xdist worker)
import torch_tp_worker as T
from test_torch_tp import EVAL_TOL, JAX_RTOL, LOSS_TOL, mismatch

from transception_tpu_torch.parallel.mesh import spawn

LEGACY = ("transception", "missformer", "effmissformer", "resinception",
          "resinception_135")
PATHS = ("paths_default", "paths_flash", "paths_pallas")
MESHES = {"dp1xtp2": (1, 2, tuple(T.LAYOUT_CASES)),
          "dp1xtp4": (1, 4, T.LAYOUT_TP4)}


@pytest.fixture(scope="module")
def jax_losses(cpu_mesh, tmp_path_factory):
    """The JAX package's sharded eval forward (shard_params on cpu_mesh,
    the batch on its data axis) of MISSFormer and of the per-path
    MSTransception at the tiny config, from the port's seeded weights,
    and the loss of its logits (train.losses.segmentation_loss); the
    port's models, weights and batch saved for the ranks."""
    import jax
    import jax.numpy as jnp

    from conftest import tiny_config
    from torch_legacy import port_config, to_jax
    from transception_tpu.models.registry import MODEL_REGISTRY
    from transception_tpu.parallel.mesh import batch_sharding, shard_params
    from transception_tpu.train.losses import segmentation_loss
    from transception_tpu_torch.models.registry import create_model
    rng = np.random.default_rng(4)
    x = rng.random((8, 32, 32, 1), dtype=np.float32)
    y = rng.integers(0, 9, (8, 32, 32))
    out = tmp_path_factory.mktemp("tp_layouts_jax")
    res = {}
    for name, reg, over in (
            ("missformer", "missformer", dict(dil_conv=0)),
            ("paths", "mstransception", dict(num_path=(1, 1, 1),
                                             vectorize_paths=False))):
        jc = tiny_config(**over)
        jm = MODEL_REGISTRY[reg](jc)
        pm = create_model(reg, port_config(jc), "cpu", seed=3)
        v, _ = to_jax(jm, pm, jnp.zeros((1, 32, 32, 1)))
        with jax.set_mesh(cpu_mesh):
            params = shard_params(v["params"], cpu_mesh)
            variables = dict(v, params=params)
            logits = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
                variables, jax.device_put(x, batch_sharding(cpu_mesh)))
            loss = float(segmentation_loss(logits, jnp.asarray(y), 9)[0])
        torch.save({"name": reg, "cfg": pm.cfg, "sd": pm.state_dict(),
                    "x": x, "y": y}, out / f"{name}.pt")
        res[name] = (loss, str(out / f"{name}.pt"))
    return res


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    """The one-process step of each case at the global batch, the
    one-process per-path eval, and the one-process MISSFormer
    checkpoint's resume."""
    torch.set_num_threads(2)
    out = tmp_path_factory.mktemp("tp_layouts_one")
    res = {n: T.run_case(n, str(out / n)) for n in T.LAYOUT_CASES}
    res["evals"] = {n: T.seq_eval(over, seq=False)
                    for n, over in T.PATH_EVALS.items()}
    res["resumed"] = T.resume(res["missformer"]["ckpt"],
                              str(out / "resume"), name="missformer")
    yield res
    shutil.rmtree(out, ignore_errors=True)


@pytest.fixture(scope="module")
def ranks(one, jax_losses, tmp_path_factory):
    """Every rank's results, per mesh: one launch a world size; the JAX
    comparisons' forwards at dp1 x tp2."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    out = {name: tmp_path_factory.mktemp(f"tp_layouts_{name}")
           for name in MESHES}
    blobs = {n: p for n, (_, p) in jax_losses.items()}
    for name, (dp, tp, cases) in MESHES.items():
        spawn(T.layout_main, dp * tp,
              ([(str(out[name]), dp, tp, cases,
                 blobs if tp == 2 else {})], one["missformer"]["ckpt"]))
    yield {name: [torch.load(out[name] / f"rank{r}.pt", weights_only=False)
                  for r in range(dp * tp)]
           for name, (dp, tp, _) in MESHES.items()}


@pytest.mark.parametrize("case", LEGACY + ("missformer_seq",) + PATHS)
def test_tp2_step_equals_one_process(ranks, one, case):
    for r in ranks["dp1xtp2"]:
        assert not mismatch(r[case], one[case]), r["place"]


@pytest.mark.parametrize("case", T.LAYOUT_TP4)
def test_tp4_step_equals_one_process(ranks, one, case):
    for r in ranks["dp1xtp4"]:
        assert not mismatch(r[case], one[case]), r["place"]


@pytest.mark.parametrize("case", LEGACY + PATHS)
def test_steps_shard_the_rules_set(ranks, case):
    """Each rank shards the JAX rules' set of its model and layout
    (shard_layout, held to JAX's by tests/test_torch_tp_rules.py): the
    legacy blocks' FFNs; in the per-path layout also every MHCA block's
    qkv and FFN."""
    from transception_tpu_torch.models.registry import create_model
    from transception_tpu_torch.parallel.mesh import shard_layout
    reg, over = T.LAYOUT_CASES[case][:2]
    model = create_model(reg, W.model_cfg(**over), "cpu")
    want = sorted(shard_layout(model.state_dict(), 2,
                               model.cfg.vectorize_paths))
    assert [k for k in want if k.endswith(".fc1.weight")]
    if case in PATHS:
        assert [k for k in want if k.endswith("factoratt_crpe.qkv.weight")]
        assert [k for k in want if ".MHCA_layers." in k and
                k.endswith("mlp.fc1.weight")]
    for r in ranks["dp1xtp2"]:
        assert r[case]["sharded"] == want


def test_missformer_bridge_is_not_sequence_sharded(ranks, one):
    """bridge_seq_shard_axis "model" leaves MISSFormer's bridge whole:
    no partial gradient, and the step is the one-process MISSFormer
    step."""
    for r in ranks["dp1xtp2"]:
        assert r["missformer_seq"]["partial"] == []
        assert r["missformer_seq"]["loss"] == r["missformer"]["loss"]
        assert not mismatch(r["missformer_seq"], one["missformer"])


@pytest.mark.parametrize("case", LEGACY + PATHS)
def test_tp_routes_equal_launches_per_step(ranks, case):
    """Every kernel decision of a rank's step, as a card would launch it:
    the legacy models' launches_per_step (no sharded FFN reaches a kernel:
    they run plain, as at tp 1), the per-path model's launches_per_step at
    tp 2 (K5's, K9's and K2's sharded forms on its MHCA blocks)."""
    from transception_tpu_torch.models import legacy
    from transception_tpu_torch.models.transception import (
        launches_per_step,
    )
    reg, over = T.LAYOUT_CASES[case][:2]
    cfg = W.model_cfg(**over)
    if case in PATHS:
        want = launches_per_step(cfg, tp=2)
        # The default mode runs no MixFFN or MHCA kernel in training.
        assert (want != launches_per_step(cfg)) == (case != "paths_default")
    else:
        want = legacy.launches_per_step(reg, cfg)
    fwd = {k: n for k, n in want.items() if n and not k.endswith("_bwd")}
    for r in ranks["dp1xtp2"]:
        assert r[case]["routed"] == fwd, r["place"]
    if case == "paths_pallas":
        assert fwd["mhca_block_tp"] == fwd["mixffn_skip_tp"] == 1


def test_missformer_tp2_checkpoint_resumes_at_tp1(ranks, tmp_path):
    """Rank (0, 0)'s MISSFormer checkpoint holds the full layout; a
    one-process Trainer restores it bit for bit and steps on."""
    rs = ranks["dp1xtp2"]
    r0 = rs[0]["missformer"]
    assert r0["ckpt"] and all(r["missformer"]["ckpt"] is None
                              for r in rs[1:])
    got = T.resume(r0["ckpt"], str(tmp_path), name="missformer")
    for n, t in r0["sd"].items():
        assert torch.equal(got["sd"][n], t), n
    assert np.isfinite(got["next_loss"])


@pytest.mark.parametrize("mesh", MESHES)
def test_missformer_tp1_checkpoint_resumes_sharded(ranks, one, mesh):
    want = one["resumed"]
    for r in ranks[mesh]:
        got = r["resumed"]
        for n, t in want["sd"].items():
            assert torch.equal(got["sd"][n], t), (r["place"], n)
        assert abs(got["next_loss"] - want["next_loss"]) <= \
            LOSS_TOL * abs(want["next_loss"])


@pytest.mark.parametrize("mesh", MESHES)
def test_per_path_eval_forward_equals_one_process(ranks, one, mesh):
    """The sharded per-path model's eval logits (K5's sharded form and
    the sharded FFN folds through their operators) equal the one
    process's; its routes are launches_per_forward's at the mesh's tp."""
    from transception_tpu_torch.models.transception import (
        launches_per_forward,
    )
    tp = MESHES[mesh][1]
    want = one["evals"]["paths"]
    routes = {k: n for k, n in launches_per_forward(
        W.model_cfg(**T.PATH_EVALS["paths"]), argmax=False, tp=tp).items()
        if n}
    assert routes["mhca_block_tp"] == 2
    for r in ranks[mesh]:
        got = r["evals"]["paths"]
        assert float((got - want).abs().max()) <= \
            EVAL_TOL * float(want.abs().max()), r["place"]
        assert r["evals"]["paths_routed"] == routes


@pytest.mark.parametrize("name", ["missformer", "paths"])
def test_port_tp2_loss_equals_jax_sharded_forward(ranks, jax_losses, name):
    want = jax_losses[name][0]
    assert np.isfinite(want)
    for r in ranks["dp1xtp2"]:
        np.testing.assert_allclose(r["jax"][name], want, rtol=JAX_RTOL)
