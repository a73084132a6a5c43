"""ISIC 2018 training in the port against the JAX package: a 2-class
train step of the tiny model on 3-channel synthetic lesions (the wide
head's label shuffle and the Dice over 2 classes) against JAX
make_train_step, from the same weights (convert/from_jax.py) and the same
numpy batches, at the tolerances of tests/test_torch_train_step.py (fp32,
the same math in another summation order); the host loader's NHWC
batches of (H, W, 3) images against JAX's HostDataLoader; and the train
CLI with --dataset ISIC."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from conftest import tiny_config
from test_torch_train_step import _port_config, _port_tensors
from transception_tpu.core.config import TrainConfig as JTrainConfig
from transception_tpu.data import isic as jisic
from transception_tpu.data.loader import HostDataLoader as JLoader
from transception_tpu.models.transception import MSTransception as JModel
from transception_tpu.train.losses import (
    segmentation_loss as j_loss,
    shuffle_labels_wide as j_shuffle,
)
from transception_tpu.train.state import TrainState as JState
from transception_tpu.train.state import make_optimizer
from transception_tpu.train.trainer import make_train_step as j_make_step
from transception_tpu_torch.convert.from_jax import load_jax_variables
from transception_tpu_torch.core.config import TrainConfig
from transception_tpu_torch.data import isic as pisic
from transception_tpu_torch.data.loader import HostDataLoader, to_device
from transception_tpu_torch.models.transception import MSTransception
from transception_tpu_torch.train.state import TrainState
from transception_tpu_torch.train.trainer import make_train_step

IMG, B, STEPS, SPE, NC = 64, 2, 3, 4, 2
TC = dict(batch_size=B, max_epochs=2)


def _batches():
    """STEPS batches of the synthetic lesions through the port's loader
    (the items' own generators), which must be JAX's loader's."""
    ds = pisic.SyntheticISICDataset(length=B * STEPS, img_size=IMG,
                                    augment=False)
    got = list(HostDataLoader(ds, B, seed=5, num_workers=2))
    want = list(JLoader(jisic.SyntheticISICDataset(B * STEPS, IMG), B,
                        seed=5, num_workers=2))
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        for k in ("image", "label"):
            np.testing.assert_array_equal(g[k], w[k])
        assert g["case_name"] == w["case_name"]
    return got


def test_loader_stacks_rgb_into_nhwc():
    """(H, W, 3) ISIC images stack into the model's (B, H, W, 3) batch and
    reach the device as fp32 images and int64 labels, as JAX's loader
    stacks them (the model repeats a 1-channel Synapse slice to 3, an ISIC
    image passes through)."""
    batch = _batches()[0]
    x, y = to_device(batch, torch.device("cpu"))
    assert x.shape == (B, IMG, IMG, 3) and x.dtype == torch.float32
    assert y.shape == (B, IMG, IMG) and y.dtype == torch.int64
    assert set(torch.unique(y).tolist()) <= {0, 1}


@pytest.fixture(scope="module")
def runs():
    jc = tiny_config(img_size=IMG, num_classes=NC)
    jm = JModel(jc)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, IMG, IMG, 3))))
    rng = np.random.default_rng(0)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (rng.random(a.shape) + 0.5).astype(np.float32),
        v["batch_stats"])
    batches = _batches()
    xs = [b["image"] for b in batches]
    ys = [b["label"] for b in batches]
    # JAX: the step-1 gradients and three make_train_step steps.
    tx, _ = make_optimizer(JTrainConfig(**TC), SPE)
    step = j_make_step(jm, NC, 0.4, 0.6, wide_head=True)

    def loss_fn(params, bs, x, y):
        out, _ = jm.apply({"params": params, "batch_stats": bs}, x,
                          train=True, mutable=["batch_stats"],
                          wide_head=True)
        return j_loss(out, j_shuffle(y), NC, 0.4, 0.6)[0]

    both = jax.jit(lambda st, x, y: (
        jax.grad(loss_fn)(st.params, st.batch_stats, x, y),
        step(st, x, y, jax.random.PRNGKey(0))))
    st = JState(step=jnp.zeros((), jnp.int32), params=v["params"],
                batch_stats=v["batch_stats"],
                opt_state=tx.init(v["params"]), tx=tx)
    jout = []
    for x, y in zip(xs, ys):
        grads, (st, metrics) = both(st, x, y)
        jout.append(dict(grads=jax.tree_util.tree_map(np.asarray, grads),
                         metrics={k: float(m) for k, m in metrics.items()},
                         variables=jax.tree_util.tree_map(
                             np.asarray, {"params": st.params,
                                          "batch_stats": st.batch_stats})))
    # The port: the same weights, the same batches.
    m = MSTransception(_port_config(jc), device="cpu")
    load_jax_variables(m, v, device="cpu")
    pst = TrainState(m, TrainConfig(**TC), SPE)
    fn = make_train_step(pst, NC, 0.4, 0.6, wide_head=True)
    pout = []
    for x, y in zip(xs, ys):
        metrics = fn(torch.from_numpy(x), torch.from_numpy(y).long())
        pout.append(dict(
            metrics={k: float(t) for k, t in metrics.items()},
            grads={n: p.grad.clone() for n, p in m.named_parameters()},
            state={k: t.clone() for k, t in m.state_dict().items()}))
    return jc, v, jout, pout


def test_two_class_step_matches_jax(runs):
    jc, v, jout, pout = runs
    for k, want in jout[0]["metrics"].items():
        assert pout[0]["metrics"][k] == pytest.approx(want, rel=1e-5), k
    jg = _port_tensors(jc, {"params": jout[0]["grads"],
                            "batch_stats": v["batch_stats"]})
    top = max(t.abs().max().item() for t in jg.values())
    for n, g in pout[0]["grads"].items():
        want = jg[n]
        assert g.shape == want.shape, n
        err = (g - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item() + 1e-6 * top, n
    js = _port_tensors(jc, jout[0]["variables"])
    for n, t in pout[0]["state"].items():
        torch.testing.assert_close(t, js[n], rtol=1e-5, atol=1e-6, msg=n)


def test_two_class_steps_track_jax(runs):
    jc, _, jout, pout = runs
    for k in ("loss", "loss_ce", "loss_dice"):
        assert [o["metrics"][k] for o in pout] == pytest.approx(
            [o["metrics"][k] for o in jout], rel=1e-4), k
    js = _port_tensors(jc, jout[-1]["variables"])
    for n, t in pout[-1]["state"].items():
        torch.testing.assert_close(t, js[n], rtol=1e-4, atol=1e-5, msg=n)


def test_train_cli_isic(tmp_path):
    """cli.train --dataset ISIC on the CPU: 2 classes whatever
    --num_classes says, the synthetic lesions (no data at --root_path),
    two steps, the in-training eval through dice_eval (its per-case and
    summary lines in log.txt, HD95 0.0)."""
    from transception_tpu_torch.cli import train as ptrain
    from transception_tpu_torch.train import trainer as ptrainer
    absent = str(tmp_path / "absent")
    argv = ["--dataset", "ISIC", "--img_size", "32", "--stage1_layers", "1",
            "--num_path", "1,1,1", "--num_layers", "1,1,1", "--dtype",
            "float32", "--batch_size", "2", "--root_path", absent,
            "--test_path", absent, "--max_steps", "2", "--output_dir",
            str(tmp_path / "run"), "--dp_size", "1", "--no_augment"]
    orig = ptrainer.make_test_dataset
    ptrainer.make_test_dataset = lambda cfg: pisic.SyntheticISICDataset(
        length=3, img_size=cfg.img_size)
    try:
        state, hist = ptrain.main(argv, device="cpu")
    finally:
        ptrainer.make_test_dataset = orig
    assert state.step == 2 and hist["hd95"] == [0.0]
    assert state.model.cfg.num_classes == 2
    log = (tmp_path / "run" / "log.txt").read_text()
    assert "case synthetic_isic_2 dice" in log
    assert "ISIC eval: mean_dice" in log and "over 3 images" in log


def test_trainer_isic_eval_runs_in_eval_mode(tmp_path, monkeypatch):
    """The Trainer's in-training ISIC eval scores the model as JAX's
    train=False forward does: with drop-path on it does not raise, the
    BatchNorm running statistics after the eval are those the train step
    left, the model is back in train mode after it, and the dice it logs
    is dice_eval's of the same weights in eval mode."""
    from transception_tpu_torch.core.config import (
        DataConfig,
        TransceptionConfig,
    )
    from transception_tpu_torch.train import trainer as ptrainer
    seen = {}

    def spy(model, ds, *a, **kw):
        seen["ds"] = ds
        seen["before"] = {n: b.clone() for n, b in model.named_buffers()}
        d = pisic.dice_eval(model, ds, *a, **kw)
        seen["after"] = {n: b.clone() for n, b in model.named_buffers()}
        seen["training"] = model.training
        return d

    monkeypatch.setattr(ptrainer, "dice_eval", spy)
    cfg = TransceptionConfig(img_size=32, dtype="float32", stage1_layers=1,
                             num_path=(1, 1, 1), num_layers=(1, 1, 1),
                             num_classes=2, drop_path_rate=0.3)
    absent = str(tmp_path / "absent")
    tr = ptrainer.Trainer(
        cfg, TrainConfig(batch_size=2, max_epochs=1,
                         output_dir=str(tmp_path / "run")),
        DataConfig(dataset="isic", root_path=absent, test_path=absent,
                   img_size=32, num_classes=2, augment=False),
        device="cpu")
    st, hist = tr.train(max_steps=1)
    assert st.step == 1 and seen["training"]
    assert any("running_mean" in n for n in seen["before"])
    for n, b in seen["before"].items():
        assert torch.equal(seen["after"][n], b), n
    tr.model.eval()
    want = pisic.dice_eval(tr.model, seen["ds"], 32, device="cpu", log=None)
    assert hist["dice"] == [want]
