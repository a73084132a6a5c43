"""The training slice of the PyTorch port against the JAX package: one and
three train steps of the tiny model (tests/conftest.py tiny_config, fp32,
at 64² so that train-mode BatchNorm has more than a handful of values per
channel in the deepest stage) from the same weights (load_jax_variables)
and the same numpy batches, against JAX make_train_step, with the wide
head (as the Trainer runs it) and without, in three train modes: the
default, ffn_flash_train, and "pallas" (use_pallas_train with
mhca_ffn_fold, drop_path_rate 0: the eval kernels' structure in training,
K1, K2 and K5 folds included). On the CPU both packages run their plain
paths, so the flash mode must give the default mode's result; and every
JAX kernel facade gates on _target_platform() == "tpu"
(ops/pallas/mixffn.py:27, linear_attention.py:66,77, mhca_block.py:35,
patch_expand.py:29), so the JAX use_pallas_train step is the same XLA
program as its default step, and one JAX reference serves all three
modes. Plus the port alone: drop path at rate 0.1 (the same generator
seed gives the same step, another seed another; the kernel wrappers'
routing decisions against launches_per_step), and the Trainer's
checkpoint and resume.

Tolerances (fp32, the same math in another summation order):
  * loss, ce, dice: 1e-5 relative at step 1, 1e-4 over three steps (two
    updates with momentum amplify the rounding);
  * gradients: each leaf within 1e-4 of its own max, plus 1e-6 of the
    largest gradient: a bias before a train-mode BatchNorm or before the
    linear attention's softmax over tokens has an exact gradient of 0 and
    holds fp32 noise in both packages;
  * parameters and BatchNorm running stats after the step: 1e-6 absolute
    plus 1e-5 relative; after three steps 1e-4 relative / 1e-5 absolute.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from transception_tpu.core.config import TrainConfig as JTrainConfig
from transception_tpu.models.transception import MSTransception as JModel
from transception_tpu.train.losses import (
    segmentation_loss as j_loss,
    shuffle_labels_wide as j_shuffle,
)
from transception_tpu.train.state import TrainState as JState
from transception_tpu.train.state import make_optimizer
from transception_tpu.train.trainer import make_train_step as j_make_step
from transception_tpu_torch.convert.from_jax import load_jax_variables
from transception_tpu_torch.core.config import (
    DataConfig,
    TrainConfig,
    TransceptionConfig,
)
from transception_tpu_torch.models.transception import (
    MSTransception,
    launches_per_step,
)
from transception_tpu_torch.ops import kernels
from transception_tpu_torch.train.state import TrainState
from transception_tpu_torch.train.trainer import Trainer, make_train_step

IMG, B, STEPS, SPE = 64, 2, 3, 4
TC = dict(batch_size=B, max_epochs=2)
# The port's train modes (config overrides).
MODES = {"default": {}, "flash": dict(ffn_flash_train=True),
         "pallas": dict(use_pallas_train=True, mhca_ffn_fold=True,
                        drop_path_rate=0.0)}


def _port_config(jc, **kw):
    names = {f.name for f in dataclasses.fields(TransceptionConfig)}
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)
              if f.name in names}
    fields.update(kw)
    return TransceptionConfig(**fields)


@pytest.fixture(scope="module")
def setup():
    jc = tiny_config(img_size=IMG)
    jm = JModel(jc)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 1))))
    rng = np.random.default_rng(0)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (rng.random(a.shape) + 0.5).astype(np.float32),
        v["batch_stats"])
    xs = [rng.random((B, IMG, IMG, 1)).astype(np.float32)
          for _ in range(STEPS)]
    ys = [rng.integers(0, 9, (B, IMG, IMG)).astype(np.int32)
          for _ in range(STEPS)]
    return jc, jm, v, xs, ys


@pytest.fixture(scope="module", params=[True, False], ids=["wide", "std"])
def jax_run(request, setup):
    """JAX: gradients of step 1 and make_train_step over three steps (one
    jit holding both)."""
    wide = request.param
    jc, jm, v, xs, ys = setup
    tx, _ = make_optimizer(JTrainConfig(**TC), SPE)
    step = j_make_step(jm, 9, 0.4, 0.6, wide_head=wide)

    def loss_fn(params, bs, x, y):
        out, _ = jm.apply({"params": params, "batch_stats": bs}, x,
                          train=True, mutable=["batch_stats"],
                          wide_head=wide)
        return j_loss(out, j_shuffle(y) if wide else y, 9, 0.4, 0.6)[0]

    both = jax.jit(lambda st, x, y: (
        jax.grad(loss_fn)(st.params, st.batch_stats, x, y),
        step(st, x, y, jax.random.PRNGKey(0))))
    st = JState(step=jnp.zeros((), jnp.int32), params=v["params"],
                batch_stats=v["batch_stats"],
                opt_state=tx.init(v["params"]), tx=tx)
    out = []
    for x, y in zip(xs, ys):
        grads, (st, metrics) = both(st, x, y)
        out.append(dict(grads=jax.tree_util.tree_map(np.asarray, grads),
                        metrics={k: float(m) for k, m in metrics.items()},
                        variables=jax.tree_util.tree_map(
                            np.asarray, {"params": st.params,
                                         "batch_stats": st.batch_stats})))
    return wide, out


def _port_tensors(jc, variables):
    """A JAX {'params', 'batch_stats'} tree as port-layout tensors (the
    converter into a second model)."""
    m = MSTransception(_port_config(jc), device="cpu")
    load_jax_variables(m, variables, device="cpu")
    return m.state_dict()


def _port_run(setup, wide, mode):
    jc, jm, v, xs, ys = setup
    m = MSTransception(_port_config(jc, **MODES[mode]), device="cpu")
    load_jax_variables(m, v, device="cpu")
    st = TrainState(m, TrainConfig(**TC), SPE)
    fn = make_train_step(st, 9, 0.4, 0.6, wide_head=wide)
    out = []
    for x, y in zip(xs, ys):
        metrics = fn(torch.from_numpy(x), torch.from_numpy(y).long())
        out.append(dict(
            metrics={k: float(t) for k, t in metrics.items()},
            grads={n: p.grad.clone() for n, p in m.named_parameters()},
            state={k: t.clone() for k, t in m.state_dict().items()}))
    return out


@pytest.fixture(scope="module")
def port_run(setup):
    """_port_run by (wide, mode), each run once per module: the
    flash-equals-default check reuses the wide runs of the JAX
    comparison."""
    runs = {}

    def get(wide, mode):
        if (wide, mode) not in runs:
            runs[wide, mode] = _port_run(setup, wide, mode)
        return runs[wide, mode]
    return get


@pytest.mark.parametrize("mode", list(MODES))
def test_train_step_matches_jax(setup, jax_run, port_run, mode):
    wide, jout = jax_run
    jc, _, v, _, _ = setup
    pout = port_run(wide, mode)
    # Step 1: losses, every gradient leaf, the updated state.
    for k, want in jout[0]["metrics"].items():
        assert pout[0]["metrics"][k] == pytest.approx(want, rel=1e-5), k
    jg = _port_tensors(jc, {"params": jout[0]["grads"],
                            "batch_stats": v["batch_stats"]})
    top = max(t.abs().max().item() for t in jg.values())
    for n, g in pout[0]["grads"].items():
        want = jg[n]
        assert g is not None and g.shape == want.shape, n
        err = (g - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item() + 1e-6 * top, n
    nonzero = [n for n in jg if n in pout[0]["grads"]
               and jg[n].abs().max() > 1e-6 * top]
    assert all(pout[0]["grads"][n].abs().max() > 0 for n in nonzero)
    js = _port_tensors(jc, jout[0]["variables"])
    for n, t in pout[0]["state"].items():
        torch.testing.assert_close(t, js[n], rtol=1e-5, atol=1e-6, msg=n)
    # Three steps: the losses track, the state stays close.
    for k in ("loss", "loss_ce", "loss_dice"):
        assert [o["metrics"][k] for o in pout] == pytest.approx(
            [o["metrics"][k] for o in jout], rel=1e-4), k
    js = _port_tensors(jc, jout[-1]["variables"])
    for n, t in pout[-1]["state"].items():
        torch.testing.assert_close(t, js[n], rtol=1e-4, atol=1e-5, msg=n)


def test_flash_mode_equals_default_on_cpu(port_run):
    a, b = (port_run(True, mode) for mode in ("default", "flash"))
    for k in a[0]["metrics"]:
        assert b[0]["metrics"][k] == pytest.approx(a[0]["metrics"][k],
                                                   rel=1e-6)
    top = max(g.abs().max().item() for g in a[0]["grads"].values())
    for n, g in a[0]["grads"].items():
        err = (b[0]["grads"][n] - g).abs().max().item()
        assert err <= 1e-5 * g.abs().max().item() + 1e-6 * top, n


def test_wide_head_is_the_shuffled_standard_head(setup):
    jc, _, v, xs, _ = setup
    m = MSTransception(_port_config(jc), device="cpu")
    load_jax_variables(m, v, device="cpu")
    x = torch.from_numpy(xs[0])
    with torch.no_grad():
        std, wide = m(x), m(x, wide_head=True)
    h = IMG // 4
    assert wide.shape == (B, h * h, 16, 9) and wide.dtype == torch.float32
    unshuf = wide.reshape(B, h, h, 4, 4, 9).permute(0, 1, 3, 2, 4, 5)
    torch.testing.assert_close(unshuf.reshape(B, IMG, IMG, 9), std,
                               rtol=1e-5, atol=1e-5)


def _drop_path_step(seed):
    """One step of a tiny "pallas"-mode model at drop_path_rate 0.1 (MHCA
    maps 4², 2², 1²: layer 0 of stage 2 at rate 0 takes the block fold,
    the others drop path with K9 on the even maps) with the drop-path
    generator seeded `seed`: the loss, the gradients and the kernel
    wrappers' routing decisions."""
    cfg = TransceptionConfig(img_size=32, dtype="float32", stage1_layers=1,
                             num_path=(1, 1, 1), num_layers=(2, 1, 1),
                             use_pallas_train=True, mhca_ffn_fold=True,
                             drop_path_rate=0.1)
    m = MSTransception(cfg, device="cpu", seed=3)
    rng = np.random.default_rng(7)
    n = 8  # 48 draws a step at keep 0.93-0.97: some samples drop
    x = torch.from_numpy(rng.random((n, 32, 32, 1)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 9, (n, 32, 32))).long()
    st = TrainState(m, TrainConfig(batch_size=n, max_epochs=2), SPE)
    kernels.reset_launches()
    fn = make_train_step(st, 9, 0.4, 0.6, wide_head=True,
                         gen=torch.Generator().manual_seed(seed))
    loss = float(fn(x, y)["loss"])
    return (cfg, loss, {n: p.grad for n, p in m.named_parameters()},
            kernels.routed_counts())


def test_drop_path_step_follows_its_generator():
    cfg, a, ga, routed = _drop_path_step(0)
    _, b, gb, _ = _drop_path_step(0)
    _, c, _, _ = _drop_path_step(1)
    assert np.isfinite(a) and a == b and a != c
    assert all(torch.equal(ga[n], gb[n]) for n in ga)
    # Every forward kernel decision of the step, as a card would launch
    # it: launches_per_step's forward counts (K10 and K11 follow K3, K2).
    want = launches_per_step(cfg)
    assert want["mixffn_skip"] == 2 and want["mhca_block"] == 1
    assert routed == {k: n for k, n in want.items()
                      if n and k not in ("bridge_attention_bwd",
                                         "mixffn_bwd")}
    assert want["bridge_attention_bwd"] == want["bridge_attention"]
    assert want["mixffn_bwd"] == want["mixffn"]


def _tiny_trainer(tmp_path, **kw):
    """The Trainer of a tiny fp32 model on the on-device synthetic stream
    (device_data)."""
    cfg = TransceptionConfig(img_size=32, dtype="float32", stage1_layers=1,
                             num_path=(1, 1, 1), num_layers=(1, 1, 1),
                             drop_path_rate=0.5)
    tcfg = TrainConfig(batch_size=2, max_epochs=3, output_dir=str(tmp_path),
                       ckpt_every=10, **kw)
    return Trainer(cfg, tcfg, DataConfig(dataset="synthetic",
                                         synthetic_len=4, img_size=32,
                                         device_data=True),
                   device="cpu")


def _logged_losses(log):
    return [float(v) for v in re.findall(r"iteration \d+ : lr \S+ loss "
                                         r"(\S+)", log)]


def test_trainer_checkpoints_and_resumes(tmp_path, monkeypatch):
    """Drop path at 0.5 (MHCA rates 0, 0.25, 0.5): the checkpoint keeps
    the drop-path generator's state, so the resumed step draws the masks
    of the uninterrupted run, and the resumed run's weights after step 3
    are the uninterrupted run's. Each train() ends with the in-training
    eval, here on one small synthetic volume (make_test_dataset
    monkeypatched)."""
    from transception_tpu_torch.data.synapse import SyntheticVolumeDataset
    from transception_tpu_torch.train import trainer as ptrainer
    monkeypatch.setattr(ptrainer, "make_test_dataset", lambda cfg:
                        SyntheticVolumeDataset(length=1, hw=32))
    st, hist = _tiny_trainer(tmp_path / "a").train(max_steps=2)
    assert st.step == 2 and len(hist["dice"]) == len(hist["hd95"]) == 1
    assert np.isfinite(hist["dice"] + hist["hd95"]).all()
    losses = _logged_losses((tmp_path / "a" / "log.txt").read_text())
    assert len(losses) == 1 and np.isfinite(losses).all()
    ckpt = tmp_path / "a" / "ckpt" / "step_00000002.pt"
    assert ckpt.exists()
    sd = torch.load(ckpt, weights_only=True)
    assert set(sd) == {"model", "optimizer", "schedule", "step", "gen"}
    assert sd["step"] == 2 and sd["schedule"]["updates"] == 2
    fresh = torch.Generator().manual_seed(TrainConfig().seed).get_state()
    assert not torch.equal(sd["gen"], fresh)  # the state moved on
    st, more = _tiny_trainer(tmp_path / "a").train(max_steps=3)
    assert st.step == 3 and len(more["dice"]) == 1
    log = (tmp_path / "a" / "log.txt").read_text()
    assert "resumed from" in log and "iteration 3 : lr" in log
    assert os.path.exists(tmp_path / "a" / "ckpt" / "step_00000003.pt")
    # The resumed run continues the uninterrupted one (the stream replays
    # from the epoch boundary at step 2, the masks from the checkpointed
    # generator).
    straight = _tiny_trainer(tmp_path / "b")
    _, _ = straight.train(max_steps=3)
    resumed = _logged_losses(log)[-1]
    assert resumed == pytest.approx(_logged_losses(
        (tmp_path / "b" / "log.txt").read_text())[-1], rel=1e-4)
    want = straight.model.state_dict()
    for n, t in st.model.state_dict().items():
        torch.testing.assert_close(t, want[n], rtol=1e-5, atol=1e-6, msg=n)


def test_trainer_refuses_other_datasets(tmp_path):
    """Synapse slices now train (tests/test_torch_train_cli.py); ISIC is
    not ported and raises, naming ROADMAP.md §1 item 5."""
    tr = _tiny_trainer(tmp_path)
    tr.data_cfg = DataConfig(dataset="isic")
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 5"):
        tr.train(max_steps=1)
