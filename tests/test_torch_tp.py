"""Tensor parallelism of the port (the 'model' mesh axis: parallel/mesh.py,
parallel/tensor.py, the hidden-sharded K2 and K11) on the CPU: gloo ranks
at dp1 x tp2, dp2 x tp2 and dp1 x tp4, started once each for the module
(parallel.mesh.spawn), against the one-process step on the global batch,
and one dp1 x tp2 step against the JAX package's own sharded step
(make_train_step + shard_params on the 4 x 2 cpu_mesh, as
tests/test_sp_remat.py runs it).

The cases (tests/torch_tp_worker.py) are Trainer steps of
tests/torch_dp_worker.py's tiny fp32 model at quarter widths, in the
default mode (the sharded FFNs plain, with the model axis's autograd
collectives), the flash mode (the sharded FFN folds through MixFFNTP,
the operators' plain stages on the CPU), the sp bridge (its qkv_linear
column-parallel, gathered) and the token_mlp 'mix' and 'mlp' FFNs.
Limits, as the one-process step against JAX
(tests/test_torch_train_step.py) and the data-parallel test:
the loss within 1e-5 relative; each gathered gradient within 1e-4 of its
own largest value plus 1e-6 of the whole gradient's norm (a leaf whose
exact gradient is near 0, a BatchNorm scale before a softmax, holds fp32
noise of ~2e-7 either way); each parameter after
the step within 1e-6 absolute plus 1e-5 relative; the BatchNorm running
statistics and the momentum within 1e-5 of their largest value (at least
1): the same math with the hidden width's sums, and the data axis's, in
another order. The replicated parameters of the ranks of one model group
hold the same bits after two steps; the clip's norm is the whole model's.
Checkpoints hold the full layout and cross tp both ways. Against JAX: the
loss at 2e-5 relative (tests/test_sp_remat.py:66).

The original bridge's sequence sharding (bridge_seq_shard_axis "model",
the worker's "seq" cases) runs in the same launches: the step in the
default and flash modes and two flash steps with the clip, each against
the one process with the limits above; its partial gradients (q, proj
and the split scales' FFNs) are those the bridge reports, its launches
per step launches_per_step's, its bridge weights bit-equal across a model
group after two steps; the eval forward of the sharded model (default
folds, and K8 and K2's folds in the bridge) equals the one process's
within 1e-5 of the logits' largest value (the same math with the sums in
another order); three planted faults (a block's halo rows dropped, the
partial gradients or the attention's dk/dv left unsummed) fail the
comparison. The JAX sharded step above is JAX's SP step (the TP rules
and the bridge's sequence sharding on cpu_mesh, dp4 x tp2, the tiny
model at one path a stage, from the port's weights: one JAX compile
serves both), and the port's sharded eval forward is held against JAX's
SP forward: the logits at 1e-4 relative and 5e-5 absolute
(tests/test_sp_remat.py:57-88).
"""

import os
import shutil

import numpy as np
import pytest
import torch
import torch_dp_worker as W
import torch_threads  # noqa: F401 (torch's threads per xdist worker)
import torch_tp_worker as T

from transception_tpu_torch.parallel.mesh import spawn

MESHES = {"dp1xtp2": (1, 2), "dp2xtp2": (2, 2), "dp1xtp4": (1, 4)}
COMPARED = ("default", "flash", "sp", "mix", "mlp", "seq", "seq_flash",
            "seq_clip2")
LOSS_TOL, GRAD_TOL, GRAD_FLOOR, STAT_TOL = 1e-5, 1e-4, 1e-6, 1e-5
PARAM_ABS, PARAM_REL = 1e-6, 1e-5
STATS = ("running_mean", "running_var")
JAX_RTOL = 2e-5
JAX_FWD_RTOL, JAX_FWD_ATOL = 1e-4, 5e-5
EVAL_TOL = 1e-5


def _batch():
    rng = np.random.default_rng(0)
    return (rng.random((8, 32, 32, 1), dtype=np.float32),
            rng.integers(0, 9, (8, 32, 32)))


@pytest.fixture(scope="module")
def jax_step(cpu_mesh, tmp_path_factory):
    """The JAX package's sharded train step (dp4 x tp2, shard_params) and
    eval forward of the tiny model at one path a stage with the original
    bridge sequence-sharded (bridge_seq_shard_axis 'model', as
    tests/test_sp_remat.py runs it), from the port's seeded weights
    carried into the JAX variables by the JAX package's converter
    (convert/torch2flax.py; no JAX init compiled): the loss and the
    logits, and the port's state with each's batch, for the ranks."""
    import jax
    import jax.numpy as jnp

    from conftest import tiny_config
    from transception_tpu.convert.torch2flax import convert_state_dict
    from transception_tpu.core.config import TrainConfig as JTrainConfig
    from transception_tpu.models.transception import MSTransception as JM
    from transception_tpu.parallel.mesh import batch_sharding, shard_params
    from transception_tpu.train.state import TrainState, make_optimizer
    from transception_tpu.train.trainer import make_train_step
    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.models.transception import MSTransception
    over = dict(num_path=(1, 1, 1), bridge_seq_shard_axis="model")
    model = JM(tiny_config(**over))
    cfg = TransceptionConfig(img_size=32, dtype="float32", stage1_layers=1,
                             num_layers=(1, 1, 1), num_heads=(8, 8, 8),
                             **over)
    port = MSTransception(cfg, "cpu", seed=0)
    x, y = _batch()
    xf = np.random.default_rng(3).random((8, 32, 32, 1), dtype=np.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 1)))
    v, _ = convert_state_dict(
        {k: t.numpy() for k, t in port.state_dict().items()},
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               shapes))
    tx, _ = make_optimizer(JTrainConfig(batch_size=8, dp_size=4, tp_size=2,
                                        max_epochs=1), 4)
    with jax.set_mesh(cpu_mesh):
        params = shard_params(v["params"], cpu_mesh)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=v["batch_stats"],
                           opt_state=tx.init(params), tx=tx)
        ds = batch_sharding(cpu_mesh)
        step = jax.jit(make_train_step(model, 9, 0.4, 0.6, wide_head=True))
        _, met = step(state, jax.device_put(x, ds),
                      jax.device_put(y.astype(np.int32), ds),
                      jax.random.PRNGKey(1))
        logits = np.asarray(jax.jit(
            lambda v, x: model.apply(v, x, train=False))(
                {"params": params, "batch_stats": v["batch_stats"]},
                jax.device_put(xf, ds)))
    out = tmp_path_factory.mktemp("tp_jax")
    for name, batch in (("step", (x, y)), ("forward", (xf, None))):
        torch.save({"cfg": cfg, "sd": port.state_dict(), "x": batch[0],
                    "y": batch[1]}, out / f"{name}.pt")
    return (float(met["loss"]), str(out / "step.pt"), logits,
            str(out / "forward.pt"))


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    """The one-process step of each case at the global batch, the
    one-process sequence-sharded evals, and the one-process resume of the
    default case's checkpoint."""
    torch.set_num_threads(2)
    out = tmp_path_factory.mktemp("tp_one")
    res = {n: T.run_case(n, str(out / n)) for n in T.CASES}
    res["evals"] = {n: T.seq_eval(over) for n, over in T.SEQ_EVALS.items()}
    res["resumed"] = T.resume(res["default"]["ckpt"], str(out / "resume"))
    yield res
    shutil.rmtree(out, ignore_errors=True)


@pytest.fixture(scope="module")
def ranks(one, jax_step, tmp_path_factory):
    """Every rank's results of every case, per mesh (one launch a world:
    dp2 x tp2 and dp1 x tp4 in turn on the same four ranks); at dp1 x
    tp2 also the planted faults and the JAX comparisons."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    blobs = {"step": jax_step[1], "forward": jax_step[3]}
    out = {name: tmp_path_factory.mktemp(f"tp_{name}") for name in MESHES}
    worlds = {}
    for name, (dp, tp) in MESHES.items():
        worlds.setdefault(dp * tp, []).append(
            (str(out[name]), dp, tp, blobs if (dp, tp) == (1, 2) else {}))
    for world, meshes in worlds.items():
        spawn(T.rank_main, world, (meshes, one["default"]["ckpt"]))
    yield {name: [torch.load(out[name] / f"rank{r}.pt", weights_only=False)
                  for r in range(dp * tp)]
           for name, (dp, tp) in MESHES.items()}


def mismatch(got, want):
    """The checks of a rank's case against the one-process case that
    fail (empty: all hold)."""
    bad = []
    if abs(got["loss"] - want["loss"]) > LOSS_TOL * abs(want["loss"]):
        bad.append(f"loss {got['loss']} vs {want['loss']}")
    top = want["grad_norm"]
    for n, w in want["grads"].items():
        d = float((got["grads"][n] - w).abs().max())
        if d > GRAD_TOL * float(w.abs().max()) + GRAD_FLOOR * top:
            bad.append(f"grad {n}: {d:.3g}")
    for n, w in want["sd"].items():
        g = got["sd"][n]
        if g.shape != w.shape:
            bad.append(f"{n}: shape {tuple(g.shape)}")
        elif not w.is_floating_point():
            if not torch.equal(g, w):
                bad.append(n)
        elif n.endswith(STATS):
            if float((g - w).abs().max()) > \
                    STAT_TOL * max(1.0, float(w.abs().max())):
                bad.append(f"{n} (BatchNorm statistics)")
        elif float((g - w).abs().max()) > \
                PARAM_ABS + PARAM_REL * float(w.abs().max()):
            bad.append(f"{n}: {float((g - w).abs().max()):.3g}")
    for n, w in want["mom"].items():
        if float((got["mom"][n] - w).abs().max()) > \
                STAT_TOL * max(1.0, float(w.abs().max())):
            bad.append(f"momentum {n}")
    return bad


@pytest.mark.parametrize("case", COMPARED)
@pytest.mark.parametrize("mesh", MESHES)
def test_tp_step_equals_one_process(ranks, one, mesh, case):
    for r in ranks[mesh]:
        assert not mismatch(r[case], one[case]), r["place"]


@pytest.mark.parametrize("mesh", MESHES)
def test_tp_shards_the_rules_set(ranks, mesh):
    """Every rank shards the ETB FFNs' fc1/fc2 (and their companions) of
    the quarter-width model; the steps ran them sharded."""
    from transception_tpu_torch.models.transception import MSTransception
    from transception_tpu_torch.parallel.mesh import shard_layout
    want = sorted(shard_layout(MSTransception(
        W.model_cfg(), "cpu").state_dict(), MESHES[mesh][1]))
    assert [k for k in want if k.endswith(".fc1.weight")]
    for r in ranks[mesh]:
        assert r["default"]["sharded"] == want


@pytest.mark.parametrize("mesh", MESHES)
def test_tp_step_routes_equal_launches_per_step(ranks, mesh):
    """Every kernel decision of a rank's flash step, as a card would
    launch it (ops.kernels.routed_counts): launches_per_step at the mesh's
    tp's forward counts, the ETB FFN folds on the hidden-sharded K2."""
    from transception_tpu_torch.models.transception import (
        launches_per_step,
    )
    want = launches_per_step(W.model_cfg(ffn_flash_train=True),
                             tp=MESHES[mesh][1])
    assert want["mixffn_tp"] == 7 and want["mixffn_tp_bwd"] == 7
    fwd = {k: n for k, n in want.items() if n and not k.endswith("_bwd")}
    for r in ranks[mesh]:
        assert r["flash"]["routed"] == fwd, r["place"]


@pytest.mark.parametrize("mesh", MESHES)
def test_replicated_params_bit_equal_in_a_model_group(ranks, mesh):
    """After two steps (flash mode) the replicated parameters of the ranks
    of one model group (equal d) hold the same bits, and so do those of
    the data axis's ranks."""
    rs = ranks[mesh]
    base = rs[0]["two_steps"]["replicated"]
    assert len(base) > 100
    for r in rs[1:]:
        for n, t in base.items():
            assert torch.equal(r["two_steps"]["replicated"][n], t), \
                (r["place"], n)


def test_two_steps_equal_one_process(ranks, one):
    """The second step's loss, two updates in (momentum amplifies the
    rounding: 1e-4 relative, as tests/test_torch_train_step.py's three
    steps)."""
    want = one["two_steps"]["loss"]
    for r in (r for rs in ranks.values() for r in rs):
        assert abs(r["two_steps"]["loss"] - want) <= 1e-4 * abs(want)


def test_clip_gives_the_one_process_norm(ranks, one):
    """The clip case's gradients were above its max norm and came out at
    it: the norm of the gathered gradients, the one-process one."""
    assert one["default"]["grad_norm"] > 10 * W.CLIP_NORM
    for r in (r for rs in ranks.values() for r in rs):
        assert r["clip"]["grad_norm"] == pytest.approx(W.CLIP_NORM,
                                                       rel=1e-4)
        assert not mismatch(r["clip"], one["clip"]), r["place"]


def _resumes_at_tp1(rs, scratch_dir):
    """Rank (0, 0)'s checkpoint holds the full layout (the other ranks
    write none): a one-process Trainer restores the ranks' state bit for
    bit and steps on."""
    r0 = rs[0]["default"]
    path = r0["ckpt"]
    assert path and all(r["default"]["ckpt"] is None for r in rs[1:])
    got = T.resume(path, str(scratch_dir))
    for n, t in r0["sd"].items():
        assert torch.equal(got["sd"][n], t), n
    assert np.isfinite(got["next_loss"])


def test_tp2_checkpoint_resumes_at_tp1(ranks, scratch_dir):
    _resumes_at_tp1(ranks["dp1xtp2"], scratch_dir)


def test_tp4_checkpoint_resumes_at_tp1(ranks, scratch_dir):
    _resumes_at_tp1(ranks["dp1xtp4"], scratch_dir)


@pytest.mark.parametrize("mesh", MESHES)
def test_tp1_checkpoint_resumes_at_tp2(ranks, one, mesh):
    """Every rank restores the one-process checkpoint into its shards
    (gathered: the checkpoint's bits) and takes the step the one process
    takes from it."""
    want = one["resumed"]
    for r in ranks[mesh]:
        got = r["resumed"]
        for n, t in want["sd"].items():
            assert torch.equal(got["sd"][n], t), (r["place"], n)
        assert abs(got["next_loss"] - want["next_loss"]) <= \
            LOSS_TOL * abs(want["next_loss"])


def test_port_tp2_equals_jax_sharded_step(ranks, jax_step):
    """The port's dp1 x tp2 step (the TP rules and the bridge's sequence
    sharding) against JAX's sharded SP step: the loss."""
    want = jax_step[0]
    assert np.isfinite(want)
    for r in ranks["dp1xtp2"]:
        np.testing.assert_allclose(r["jax_loss"], want, rtol=JAX_RTOL)


def _model_group(rs, mesh):
    """The ranks of each model group (equal data rank d) of a mesh."""
    tp = MESHES[mesh][1]
    return [rs[d * tp:(d + 1) * tp] for d in range(len(rs) // tp)]


@pytest.mark.parametrize("mesh", MESHES)
def test_seq_partial_grads_are_the_bridge_blocks(ranks, mesh):
    """The parameters whose gradient the sequence sharding leaves partial,
    summed after the backward: the three spatial layers' q and proj (N =
    124 divides by 2 and 4) and the FFNs of the scales whose side divides
    by tp (8, 4 and 2 at tp 2; 8 and 4 at tp 4), in every layer; none of
    them sharded by the TP rules."""
    from transception_tpu_torch.models.transception import MSTransception
    tp = MESHES[mesh][1]
    split = [i + 1 for i, s in enumerate((8, 4, 2, 1)) if s % tp == 0]
    mods = [f"bridge.bridge_layer{k}.mixffn{i}" for k in range(1, 5)
            for i in split] + [f"bridge.bridge_layer{k}.attn.{m}"
                               for k in (2, 3, 4) for m in ("q", "proj")]
    model = MSTransception(W.model_cfg(), "cpu")
    want = sorted(f"{m}.{n}" for m in mods
                  for n, _ in model.get_submodule(m).named_parameters())
    for r in ranks[mesh]:
        assert r["seq"]["partial"] == want, r["place"]
        assert not set(want) & set(r["seq"]["sharded"])
        assert r["default"]["partial"] == []


@pytest.mark.parametrize("mesh", MESHES)
def test_seq_routes_equal_launches_per_step(ranks, mesh):
    """Every kernel decision of a rank's sequence-sharded flash step:
    launches_per_step at the mesh's tp, which equals the unsharded
    model's routes (each rank runs every bridge fold once, on its
    block)."""
    from transception_tpu_torch.models.transception import (
        launches_per_step,
    )
    cfg = W.model_cfg(ffn_flash_train=True, bridge_seq_shard_axis="model")
    tp = MESHES[mesh][1]
    want = launches_per_step(cfg, tp=tp)
    assert want == launches_per_step(W.model_cfg(ffn_flash_train=True),
                                     tp=tp)
    fwd = {k: n for k, n in want.items() if n and not k.endswith("_bwd")}
    for r in ranks[mesh]:
        assert r["seq_flash"]["routed"] == fwd, r["place"]


@pytest.mark.parametrize("mesh", MESHES)
def test_seq_bridge_weights_bit_equal_in_a_model_group(ranks, mesh):
    """After two sequence-sharded flash steps with the clip, every rank of
    a model group holds the same bits of every replicated parameter, the
    bridge's (whose gradients were summed after the backward) among
    them."""
    for group in _model_group(ranks[mesh], mesh):
        base = group[0]["seq_clip2"]["replicated"]
        assert sum(n.startswith("bridge.") for n in base) > 100
        for r in group[1:]:
            for n, t in base.items():
                assert torch.equal(r["seq_clip2"]["replicated"][n], t), \
                    (r["place"], n)


def test_seq_clip_gives_the_one_process_norm(ranks, one):
    """The clip of the sequence-sharded steps counts each summed partial
    gradient once: the gathered gradients' norm is the max norm."""
    for r in (r for rs in ranks.values() for r in rs):
        assert r["seq_clip2"]["grad_norm"] == pytest.approx(W.CLIP_NORM,
                                                            rel=1e-4)


@pytest.mark.parametrize("case", sorted(T.SEQ_EVALS))
@pytest.mark.parametrize("mesh", MESHES)
def test_seq_eval_forward_equals_one_process(ranks, one, mesh, case):
    """The sequence-sharded model's eval logits on each rank's data rows
    equal the one process's rows."""
    dp = MESHES[mesh][0]
    want = one["evals"][case]
    n = len(want) // dp
    for r in ranks[mesh]:
        d = r["place"][0]
        got = r["evals"][case]
        assert got.shape == want[d * n:(d + 1) * n].shape
        assert float((got - want[d * n:(d + 1) * n]).abs().max()) <= \
            EVAL_TOL * float(want.abs().max()), r["place"]


@pytest.mark.parametrize("fault", sorted(T.FAULTS))
def test_seq_planted_faults_fail(ranks, one, fault):
    """Each planted fault of the sequence sharding moves the step past the
    limits on every rank of dp1 x tp2."""
    for r in ranks["dp1xtp2"]:
        assert mismatch(r["faults"][fault], one["seq"]), (fault, r["place"])


def test_port_seq_forward_equals_jax_sp_forward(ranks, jax_step):
    """The port's sequence-sharded eval forward at dp1 x tp2 against JAX's
    SP forward on cpu_mesh: the logits."""
    want = jax_step[2]
    assert np.isfinite(want).all()
    for r in ranks["dp1xtp2"]:
        np.testing.assert_allclose(r["jax_logits"].numpy(), want,
                                   rtol=JAX_FWD_RTOL, atol=JAX_FWD_ATOL)


@pytest.mark.parametrize("value", ["data", "Model", "model ", "x"])
def test_seq_shard_axis_refused_before_any_work(value):
    """Any bridge_seq_shard_axis but "" and "model" is refused by name
    when the model is built."""
    from transception_tpu_torch.models.transception import MSTransception
    with pytest.raises(ValueError, match="bridge_seq_shard_axis must be"):
        MSTransception(W.model_cfg(bridge_seq_shard_axis=value), "cpu")


def test_check_tp_refuses_a_seq_block_the_kernels_do_not_take():
    """On the card with the bridge FFN folds, a split scale's row block
    goes to K2 and K11: the quarter-width bridge's 16-channel groups are
    refused by name before any work; the published widths pass at tp 2
    and 4, and the CPU's plain versions take any."""
    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.models.transception import (
        MSTransception,
        check_tp,
    )
    m = MSTransception(W.model_cfg(ffn_flash_train=True,
                                   bridge_seq_shard_axis="model"), "cpu")
    with pytest.raises(ValueError, match="bridge's scale-1 FFN block of 5 "
                                         "rows of 8"):
        check_tp(m, 2, "cuda")
    check_tp(m, 2, "cpu")
    big = MSTransception(TransceptionConfig(
        ffn_flash_train=True, bridge_seq_shard_axis="model"), "cpu")
    for tp in (2, 4):
        check_tp(big, tp, "cuda")


@pytest.fixture
def scratch_dir(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)
