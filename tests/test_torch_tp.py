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
COMPARED = ("default", "flash", "sp", "mix", "mlp")
LOSS_TOL, GRAD_TOL, GRAD_FLOOR, STAT_TOL = 1e-5, 1e-4, 1e-6, 1e-5
PARAM_ABS, PARAM_REL = 1e-6, 1e-5
STATS = ("running_mean", "running_var")
JAX_RTOL = 2e-5


def _batch():
    rng = np.random.default_rng(0)
    return (rng.random((8, 32, 32, 1), dtype=np.float32),
            rng.integers(0, 9, (8, 32, 32)))


@pytest.fixture(scope="module")
def jax_step(cpu_mesh, tmp_path_factory):
    """The JAX package's sharded train step (dp4 x tp2, shard_params) of
    the tiny model at one path a stage and no bridge: its loss, and the
    port's state of its initial weights with the batch, for the ranks."""
    import jax

    from conftest import tiny_config
    from transception_tpu.core.config import TrainConfig as JTrainConfig
    from transception_tpu.models.transception import MSTransception as JM
    from transception_tpu.parallel.mesh import batch_sharding, shard_params
    from transception_tpu.train.state import create_train_state
    from transception_tpu.train.trainer import make_train_step
    from transception_tpu_torch.convert.from_jax import load_jax_variables
    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.models.transception import MSTransception
    over = dict(num_path=(1, 1, 1), have_bridge="none")
    jcfg = tiny_config(**over)
    x, y = _batch()
    model = JM(jcfg)
    tcfg = JTrainConfig(batch_size=8, dp_size=4, tp_size=2, max_epochs=1)
    with jax.set_mesh(cpu_mesh):
        state = create_train_state(model, tcfg, steps_per_epoch=4,
                                   sample_batch=x,
                                   rng=jax.random.PRNGKey(0))
        host = jax.device_get({"params": state.params,
                               "batch_stats": state.batch_stats})
        state = state.replace(params=shard_params(state.params, cpu_mesh))
        ds = batch_sharding(cpu_mesh)
        step = jax.jit(make_train_step(model, 9, 0.4, 0.6, wide_head=True))
        _, met = step(state, jax.device_put(x, ds),
                      jax.device_put(y.astype(np.int32), ds),
                      jax.random.PRNGKey(1))
    cfg = TransceptionConfig(img_size=32, dtype="float32", stage1_layers=1,
                             num_layers=(1, 1, 1), num_heads=(8, 8, 8),
                             **over)
    port = load_jax_variables(MSTransception(cfg, "cpu"), host, "cpu")
    path = tmp_path_factory.mktemp("tp_jax") / "blob.pt"
    torch.save({"cfg": cfg, "sd": port.state_dict(), "x": x, "y": y}, path)
    return float(met["loss"]), str(path)


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    """The one-process step of each case at the global batch, and the
    one-process resume of the default case's checkpoint."""
    torch.set_num_threads(2)
    out = tmp_path_factory.mktemp("tp_one")
    res = {n: T.run_case(n, str(out / n)) for n in T.CASES}
    res["resumed"] = T.resume(res["default"]["ckpt"], str(out / "resume"))
    yield res
    shutil.rmtree(out, ignore_errors=True)


@pytest.fixture(scope="module")
def ranks(one, jax_step, tmp_path_factory):
    """Every rank's results of every case, per mesh (one launch each)."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    res = {}
    for name, (dp, tp) in MESHES.items():
        out = tmp_path_factory.mktemp(f"tp_{name}")
        spawn(T.rank_main, dp * tp, (str(out), dp, tp,
                                     one["default"]["ckpt"],
                                     jax_step[1] if (dp, tp) == (1, 2)
                                     else ""))
        res[name] = [torch.load(out / f"rank{r}.pt", weights_only=False)
                     for r in range(dp * tp)]
    yield res


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
    want = jax_step[0]
    assert np.isfinite(want)
    for r in ranks["dp1xtp2"]:
        np.testing.assert_allclose(r["jax_loss"], want, rtol=JAX_RTOL)


@pytest.fixture
def scratch_dir(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)
