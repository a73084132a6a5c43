"""The port's train loop and train CLI (train/trainer.py Trainer.train,
cli/train.py) against the JAX package's, on the CPU at a tiny config
(32², fp32, one layer a stage, batch 2): the eval schedule over a grid of
epochs, results.tsv byte for byte against the JAX Trainer's pandas file,
the synthetic train batches against JAX HostDataLoader(SyntheticSliceDataset)
bit for bit (the port once streamed its on-device batches by default,
where JAX streams these), the loop's log, eval lines and returned
histories with the test volumes cut to one small SyntheticVolumeDataset
(make_test_dataset monkeypatched), TensorBoard, and cli.train.main with
--max_steps, --throughput and --profile, build_configs with the train
flags against JAX's, and the refusals."""

import dataclasses
import re
import shlex
import sys
import types

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu.cli import common as jcommon
from transception_tpu.data.loader import HostDataLoader as JLoader
from transception_tpu.data.synapse import (
    SyntheticSliceDataset as JSyntheticSlices,
)
from transception_tpu.train import trainer as jtrainer
from transception_tpu_torch.cli import common as pcommon
from transception_tpu_torch.cli import train as pcli
from transception_tpu_torch.core.config import (
    DataConfig,
    TrainConfig,
    TransceptionConfig,
)
from transception_tpu_torch.data.synapse import SyntheticVolumeDataset
from transception_tpu_torch.train import trainer as ptrainer

TINY = ["--img_size", "32", "--stage1_layers", "1", "--num_path", "1,1,1",
        "--num_layers", "1,1,1", "--dtype", "float32", "--batch_size", "2"]
CFG = TransceptionConfig(img_size=32, dtype="float32", stage1_layers=1,
                         num_path=(1, 1, 1), num_layers=(1, 1, 1))


@pytest.fixture(autouse=True)
def _tiny_test_volumes(monkeypatch):
    """The in-training eval on one 18 x 40 x 40 synthetic volume (the
    default test set is two volumes of 512², minutes of HD95 here)."""
    monkeypatch.setattr(ptrainer, "make_test_dataset", lambda cfg:
                        SyntheticVolumeDataset(length=1, hw=40,
                                               num_classes=cfg.num_classes))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the schedule and results.tsv ----

def test_reference_eval_schedule_equals_jax():
    for max_epochs in (1, 5, 150, 400, 500):
        for interval in (1, 3, 20):
            for epoch in range(max_epochs):
                assert ptrainer.reference_eval_schedule(
                    epoch, max_epochs, interval) == \
                    jtrainer.reference_eval_schedule(epoch, max_epochs,
                                                     interval)


@pytest.mark.parametrize("hist", [
    ([0.5], [3.25]),
    ([0.1, 1.0, 2.0 / 3, 1e-5], [3.0, 4.5, 1e16, 0.0]),
    ([0.25, float("nan")], [float("inf"), 7.0]),
])
def test_results_tsv_bytes_equal_jax(tmp_path, hist):
    dice, hd95 = hist
    (tmp_path / "j").mkdir()
    jself = types.SimpleNamespace(
        cfg=types.SimpleNamespace(output_dir=str(tmp_path / "j")))
    jtrainer.Trainer._plot_results(jself, list(dice), list(hd95))
    ptrainer.write_results_tsv(str(tmp_path / "p.tsv"), dice, hd95)
    assert (tmp_path / "p.tsv").read_bytes() == \
        (tmp_path / "j" / "results.tsv").read_bytes()


# ---- the train loop on the CPU ----

def _trainer(tmp_path, data=None, **kw):
    tcfg = TrainConfig(**dict(dict(batch_size=2, max_epochs=3,
                                   output_dir=str(tmp_path)), **kw))
    dcfg = data or DataConfig(dataset="synthetic", synthetic_len=6,
                              img_size=32, num_workers=2)
    return ptrainer.Trainer(CFG, tcfg, dcfg, device="cpu")


def test_host_synthetic_batches_equal_jax(tmp_path, monkeypatch):
    """dataset="synthetic" without device_data streams SyntheticSliceDataset
    (augmented) through the host loader, as the JAX Trainer does: the
    batches the step receives over two epochs equal JAX's bit for bit."""
    seen = []
    make = ptrainer.make_train_step

    def recording(*a, **k):
        step = make(*a, **k)

        def run(images, labels):
            seen.append((images.numpy().copy(), labels.numpy().copy()))
            return step(images, labels)
        return run

    monkeypatch.setattr(ptrainer, "make_train_step", recording)
    tr = _trainer(tmp_path, max_epochs=2, ckpt_every=10, eval_interval=10)
    tr.train()
    ds = JSyntheticSlices(length=6, img_size=32, num_classes=9, augment=True)
    ld = JLoader(ds, 2, shuffle=True, seed=TrainConfig().seed,
                 num_workers=2)
    want = []
    for ep in range(2):
        ld.set_epoch(ep)
        want += [(b["image"], b["label"]) for b in ld]
    assert len(seen) == len(want) == 6
    for (gi, gl), (wi, wl) in zip(seen, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl.astype(np.int64))


def test_device_data_is_synthetic_only(tmp_path):
    tr = _trainer(tmp_path, data=DataConfig(dataset="synapse",
                                            device_data=True))
    with pytest.raises(AssertionError, match="synthetic"):
        tr.train(max_steps=1)


def test_train_logs_evals_and_histories(tmp_path):
    """Three epochs of three steps with the 'interval' schedule every
    epoch: three checkpoints and evals, their per-class lines in the log,
    the histories returned and in results.tsv, TensorBoard's directory."""
    tr = _trainer(tmp_path, ckpt_every=1, eval_interval=1)
    state, hist = tr.train()
    assert state.step == 9 and set(hist) == {"dice", "hd95"}
    assert len(hist["dice"]) == len(hist["hd95"]) == 3
    assert np.isfinite(hist["dice"] + hist["hd95"]).all()
    log = (tmp_path / "log.txt").read_text()
    assert "3 iterations per epoch, 9 max iterations" in log
    assert re.search(r"iteration 9 : lr [0-9.]+ loss [0-9.]+ ce [0-9.]+ "
                     r"dice [0-9.]+ \([0-9.]+ img/s\)", log)
    assert log.count("Mean class 8 mean_dice") == 3
    assert log.count("Testing performance in best val model") == 3
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        f"step_{s:08d}.pt" for s in (3, 6, 9)]
    rows = (tmp_path / "results.tsv").read_text().splitlines()
    assert rows[0] == "\tmean_dice\tmean_hd95" and len(rows) == 4
    assert float(rows[3].split("\t")[1]) == hist["dice"][2]
    assert (tmp_path / "tb").is_dir()


def test_reference_schedule_evaluates_the_last_epoch(tmp_path):
    tr = _trainer(tmp_path, eval_schedule="reference", eval_interval=20)
    _, hist = tr.train()
    assert len(hist["dice"]) == 1  # the last epoch's (and the end's) only


def test_without_tensorboard_one_line(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    _trainer(tmp_path).train(max_steps=1)
    log = (tmp_path / "log.txt").read_text()
    assert log.count("TensorBoard scalars and images are not written") == 1
    assert not (tmp_path / "tb").exists()


def test_log_images():
    from transception_tpu_torch.models.transception import MSTransception
    added = []
    writer = types.SimpleNamespace(
        add_image=lambda tag, img, it: added.append((tag, img, it)))
    m = MSTransception(CFG, "cpu").train()
    x = torch.rand(2, 32, 32, 1)
    y = torch.randint(0, 9, (2, 32, 32))
    ptrainer._log_images(writer, m, x, y, 200)
    assert m.training
    assert [(t, i.shape, i.dtype, it) for t, i, it in added] == [
        ("train/Image", (1, 32, 32), np.float32, 200),
        ("train/Prediction", (1, 32, 32), np.uint8, 200),
        ("train/GroundTruth", (1, 32, 32), np.uint8, 200)]
    # x50 in uint8, wrapping above class 5 as the JAX package's does.
    np.testing.assert_array_equal(added[2][1][0],
                                  (y[0].numpy() * 50).astype(np.uint8))


# ---- cli.train.main ----

def test_cli_max_steps_resume_and_profile(tmp_path, capsys):
    argv = TINY + ["--dataset", "synthetic", "--output_dir", str(tmp_path),
                   "--num_workers", "2"]
    state, hist = pcli.main(argv + ["--max_steps", "2"], device="cpu")
    assert state.step == 2 and len(hist["dice"]) == 1
    assert (tmp_path / "ckpt" / "step_00000002.pt").exists()
    out = capsys.readouterr().out
    assert "iteration 2 : lr" in out and "Training Finished!" in out
    state, hist = pcli.main(argv + ["--max_steps", "3", "--profile"],
                            device="cpu")
    assert state.step == 3 and np.isfinite(hist["hd95"]).all()
    assert (tmp_path / "profile" / "trace.json").stat().st_size > 0
    log = (tmp_path / "log.txt").read_text()
    assert "resumed from" in log and "iteration 3 : lr" in log
    assert "profiler trace written to" in capsys.readouterr().out


def test_cli_throughput(capsys):
    assert pcli.main(TINY + ["--throughput"], device="cpu") == (None, None)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"train throughput: [0-9.]+ imgs/s \([0-9.]+ "
                        r"ms/step at batch 2\)", line)


def test_cli_without_a_card_raises_before_any_work(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would train on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        pcli.main(TINY + ["--output_dir", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


TRAIN_ARGVS = [
    "--root_path /r --num_workers 2 --no_augment --max_steps 3 --profile",
    "--dataset synthetic --device_data --num_workers 0",
]


@pytest.mark.parametrize("argv", TRAIN_ARGVS)
def test_build_configs_with_train_flags_equal_jax(argv):
    import argparse
    p, j = argparse.ArgumentParser(), argparse.ArgumentParser()
    for name in ("add_model_args", "add_data_args", "add_train_args"):
        getattr(pcommon, name)(p)
        getattr(jcommon, name)(j)
    pa, ja = p.parse_args(shlex.split(argv)), j.parse_args(shlex.split(argv))
    assert vars(pa) == vars(ja)
    for pc, jc in zip(pcommon.build_configs(pa), jcommon.build_configs(ja)):
        jf = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
        for f in dataclasses.fields(pc):
            if f.name in jf:
                assert getattr(pc, f.name) == jf[f.name], f.name
    data = pcommon.build_configs(pa)[1]
    assert dataclasses.asdict(data) == {
        k: v for k, v in dataclasses.asdict(
            jcommon.build_configs(ja)[1]).items()}
