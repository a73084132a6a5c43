"""The legacy models through the port's CLIs on the CPU at a tiny config
(32², one layer a stage where the config says, fp32): cli.test.main
--model NAME for each legacy registry name with --head_count and
--dil_conv (the flags only these models read) on two tiny Synapse-layout
volumes, against run_inference of the same weights (the argmax of the
fp32 logits: the legacy models have no fused argmax); cli.train.main
--model resinception for two steps, its checkpoint holding the MultiRes
branches' BatchNorm statistics bit for bit, a resume to step 3;
--model missformer for one step and --throughput (no wide head)."""

import re

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu_torch.cli import test as test_cli
from transception_tpu_torch.cli import train as train_cli
from transception_tpu_torch.core.config import TrainConfig, TransceptionConfig
from transception_tpu_torch.data.synapse import (
    SynapseVolumeDataset,
    SyntheticVolumeDataset,
)
from transception_tpu_torch.eval.inference import run_inference
from transception_tpu_torch.models.registry import LEGACY, create_model
from transception_tpu_torch.train import trainer as ptrainer
from transception_tpu_torch.train.state import TrainState

TINY = ["--img_size", "32", "--stage1_layers", "1", "--num_path", "1,1,1",
        "--num_layers", "1,1,1", "--dtype", "float32"]
# registry name -> its model flags here (--head_count / --dil_conv)
FLAGS = {"transception": ["--head_count", "4", "--dil_conv", "0"],
         "missformer": ["--head_count", "2"],
         "effmissformer": [],
         "resinception": ["--dil_conv", "1"],
         "resinception_135": ["--dil_conv", "0"]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two tiny Synapse-layout volumes ({case}.npy.h5 and test_vol.txt)."""
    import h5py
    root = tmp_path_factory.mktemp("synapse")
    (root / "vol").mkdir()
    (root / "lists").mkdir()
    rng = np.random.default_rng(0)
    names = ["case0001", "case0002"]
    for n in names:
        with h5py.File(root / "vol" / f"{n}.npy.h5", "w") as f:
            f["image"] = rng.random((3, 40, 36)).astype(np.float32)
            f["label"] = rng.integers(0, 9, (3, 40, 36)).astype(np.float32)
    (root / "lists" / "test_vol.txt").write_text("\n".join(names) + "\n")
    return root


def _cfg(name):
    """The TransceptionConfig that TINY and FLAGS[name] build."""
    args = dict(zip(FLAGS[name][::2], FLAGS[name][1::2]))
    return TransceptionConfig(
        img_size=32, stage1_layers=1, num_path=(1, 1, 1),
        num_layers=(1, 1, 1), num_heads=(8, 8, 8), dtype="float32",
        head_count=int(args.get("--head_count", 8)),
        dil_conv=int(args.get("--dil_conv", 1)))


@pytest.mark.parametrize("name", LEGACY)
def test_test_cli_runs_legacy_models(tmp_path, data, name):
    cfg = _cfg(name)
    model = create_model(name, cfg, device="cpu", seed=3)
    torch.save(model.state_dict(), tmp_path / "w.pth")
    got = test_cli.main(
        ["--model", name, "--dataset", "Synapse", "--test_path",
         str(data / "vol"), "--list_dir", str(data / "lists"),
         "--output_dir", str(tmp_path / "out"), "--weight_pth",
         str(tmp_path / "w.pth"), "--eval_batch", "4", *TINY,
         *FLAGS[name]], device="cpu")
    ds = SynapseVolumeDataset(str(data / "vol"), str(data / "lists"))
    assert got == run_inference(model, ds, 9, 32, 4, log=None,
                                device="cpu")
    assert all(np.isfinite(got))


@pytest.fixture
def _tiny_eval(monkeypatch):
    """The in-training eval on one 18 x 40 x 40 synthetic volume."""
    monkeypatch.setattr(ptrainer, "make_test_dataset", lambda cfg:
                        SyntheticVolumeDataset(length=1, hw=40,
                                               num_classes=cfg.num_classes))


def _train_argv(name, out, *extra):
    return ["--model", name, *TINY, *FLAGS[name], "--batch_size", "2",
            "--dataset", "synthetic", "--num_workers", "0", "--dp_size",
            "1", "--output_dir", str(out), *extra]


def test_train_cli_resinception_checkpoint_and_resume(tmp_path, _tiny_eval):
    argv = _train_argv("resinception", tmp_path)
    state, hist = train_cli.main(argv + ["--max_steps", "2"], device="cpu")
    assert type(state.model).__name__ == "ResInceptionTransception"
    assert state.step == 2 and np.isfinite(hist["dice"]).all()
    bn = {k: t for k, t in state.model.state_dict().items()
          if "running_" in k}
    assert bn and all(not torch.equal(t, torch.zeros_like(t)) and
                      not torch.equal(t, torch.ones_like(t))
                      for t in bn.values())
    fresh = create_model("resinception", state.model.cfg, device="cpu",
                         seed=9)
    TrainState(fresh, TrainConfig(), 1).load_state_dict(torch.load(
        tmp_path / "ckpt" / "step_00000002.pt", weights_only=True))
    back = fresh.state_dict()
    assert all(torch.equal(back[k], t) for k, t in bn.items())
    state, hist = train_cli.main(argv + ["--max_steps", "3"], device="cpu")
    assert state.step == 3
    log = (tmp_path / "log.txt").read_text()
    assert "resumed from" in log and "(step 2)" in log


def test_train_cli_missformer_step_and_throughput(tmp_path, _tiny_eval,
                                                  capsys):
    state, hist = train_cli.main(
        _train_argv("missformer", tmp_path, "--max_steps", "1"),
        device="cpu")
    assert type(state.model).__name__ == "MISSFormer" and state.step == 1
    assert state.model.cfg.head_count == 2
    assert np.isfinite(hist["hd95"]).all()
    assert train_cli.main(_train_argv("missformer", tmp_path / "t",
                                      "--throughput"),
                          device="cpu") == (None, None)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"train throughput: [0-9.]+ imgs/s \([0-9.]+ "
                        r"ms/step at batch 2\)", line)
