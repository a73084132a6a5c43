"""ISIC 2018 in the port against the JAX package (data/isic.py, the
dataset factories' ISIC branches, dice_eval, the test and train CLIs):
the items of the three datasets bit for bit, the factories' choice for
raw, preprocessed and missing paths, dice_eval's per-case dice and IoU
and its mean against JAX's dice_eval at fp32 (the same weights through
convert/from_jax.py), and the argmax / threshold convention."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from conftest import tiny_config
from transception_tpu.core.config import DataConfig as JDataConfig
from transception_tpu.data import isic as jisic
from transception_tpu.data import synapse as jsyn
from transception_tpu.models.transception import MSTransception as JModel
from transception_tpu_torch.convert.from_jax import load_jax_variables
from transception_tpu_torch.core.config import (
    DataConfig,
    TransceptionConfig,
)
from transception_tpu_torch.data import isic as pisic
from transception_tpu_torch.data import synapse as psyn
from transception_tpu_torch.models.transception import MSTransception

IMG = 32


def _same_item(a, b):
    assert set(a) == set(b)
    assert a["case_name"] == b["case_name"]
    for k in ("image", "label"):
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _write_raw(root, names=("ISIC_0000000", "ISIC_0000001"), ext=".jpg",
               hw=(80, 100)):
    from PIL import Image
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir()
    rng = np.random.default_rng(0)
    for name in names:
        Image.fromarray((rng.random(hw + (3,)) * 255).astype(np.uint8)).save(
            root / "images" / f"{name}{ext}")
        Image.fromarray((rng.random(hw) > 0.5).astype(np.uint8) * 255).save(
            root / "masks" / f"{name}_segmentation.png")
    return root


def _write_npz(path, gray=False, n=3, hw=96):
    rng = np.random.default_rng(1)
    shape = (n, hw, hw) if gray else (n, hw, hw, 3)
    np.savez(path, image=rng.random(shape).astype(np.float32),
             label=(rng.random((n, hw, hw)) > 0.5).astype(np.float32))
    return path


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("layout", ["synthetic", "raw_jpg", "raw_png",
                                    "npz_rgb", "npz_gray"])
def test_items_equal_jax(tmp_path, layout, augment):
    """Every item of every layout, with and without the augmentation (the
    same generator), equals the JAX package's bit for bit: the order-1
    RGB zoom, the nearest mask zoom, the _segmentation.png pairing, the
    gray preprocessed images repeated to 3 channels, the 5000 + idx seeds
    of the synthetic lesions."""
    if layout == "synthetic":
        args, cls = (4, IMG, augment), "SyntheticISICDataset"
    elif layout.startswith("raw"):
        root = _write_raw(tmp_path, ext=".jpg" if layout == "raw_jpg"
                          else ".png")
        args, cls = (str(root / "images"), str(root / "masks"), 64,
                     augment), "ISICDataset"
    else:
        path = _write_npz(tmp_path / "isic.npz", gray=layout == "npz_gray")
        args, cls = (str(path), 64, augment), "ISICPreprocessedDataset"
    got, want = getattr(pisic, cls)(*args), getattr(jisic, cls)(*args)
    assert len(got) == len(want) >= 2
    for i in range(len(got)):
        _same_item(got.get(i, np.random.default_rng(7 + i)),
                   want.get(i, np.random.default_rng(7 + i)))
    item = got.get(0, np.random.default_rng(0))
    side = IMG if layout == "synthetic" else 64
    assert item["image"].shape == (side, side, 3)
    assert set(np.unique(item["label"])) <= {0, 1}


@pytest.mark.parametrize("case", ["raw", "raw_official", "npz", "missing",
                                  "npz_missing"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_factories_pick_like_jax(tmp_path, case, split):
    """make_train_dataset / make_test_dataset with dataset="isic" pick
    JAX's dataset for a raw directory (images/masks or the official ISIC
    names), a preprocessed .npz, and the synthetic lesions for a missing
    path; the test split is never augmented."""
    if case == "raw":
        path = str(_write_raw(tmp_path / "root"))
    elif case == "raw_official":
        root = _write_raw(tmp_path / "root")
        (root / "images").rename(root / "ISIC2018_Task1-2_Training_Input")
        (root / "masks").rename(root / "ISIC2018_Task1_Training_GroundTruth")
        path = str(root)
    elif case == "npz":
        path = str(_write_npz(tmp_path / "isic.npz"))
    else:
        path = str(tmp_path / ("absent.npz" if case == "npz_missing"
                               else "absent"))
    kw = dict(dataset="isic", root_path=path, test_path=path, img_size=IMG,
              num_classes=2)
    make = f"make_{split}_dataset"
    got = getattr(psyn, make)(DataConfig(**kw))
    want = getattr(jsyn, make)(JDataConfig(**kw))
    assert type(got).__name__ == type(want).__name__
    assert len(got) == len(want)
    assert got.augment == want.augment == (split == "train")
    _same_item(got.get(0, np.random.default_rng(3)),
               want.get(0, np.random.default_rng(3)))


def test_argmax_is_the_threshold_convention():
    """For a 2-class head, argmax over the logits (ties to class 0) is
    p(lesion) > 0.5, the convention tests/test_cli_isic.py pins for JAX;
    dice_eval takes that argmax of the model's logits."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(4, 8, 8, 2)).astype(
        np.float32))
    logits[0, 0, 0] = torch.tensor([0.25, 0.25])  # a tie: background
    by_argmax = logits.argmax(-1)
    by_threshold = (torch.softmax(logits, -1)[..., 1] > 0.5).long()
    assert torch.equal(by_argmax, by_threshold)
    assert by_argmax[0, 0, 0] == 0
    np.testing.assert_array_equal(
        by_argmax.numpy(), np.asarray(jnp.argmax(jnp.asarray(logits), -1)))


@pytest.fixture(scope="module")
def models():
    """A tiny 2-class JAX model with random weights and the port's model
    holding the same weights (load_jax_variables), fp32, on the CPU."""
    jc = tiny_config(num_classes=2)
    jm = JModel(jc)
    v = jax.jit(jm.init, static_argnames=("train",))(
        jax.random.PRNGKey(3), jnp.zeros((1, IMG, IMG, 3)), train=False)
    names = {f.name for f in dataclasses.fields(TransceptionConfig)}
    pc = TransceptionConfig(**{f.name: getattr(jc, f.name)
                               for f in dataclasses.fields(jc)
                               if f.name in names})
    pm = MSTransception(pc, device="cpu")
    load_jax_variables(pm, jax.tree_util.tree_map(np.asarray, v),
                       device="cpu")
    return jm, v, pm


def _cases(lines):
    return [(m.group(1), float(m.group(2)), float(m.group(3)))
            for m in (re.match(r"case (\S+) dice (\S+) iou (\S+)", ln)
                      for ln in lines) if m]


def test_dice_eval_matches_jax(models, tmp_path):
    """dice_eval over 5 synthetic lesions in batches of 2 (the last padded):
    per case the same name, dice and IoU as JAX's dice_eval within 1e-6,
    the same mean, and the summary line; the exported masks reproduce the
    logged dice."""
    jm, v, pm = models
    ds = pisic.SyntheticISICDataset(length=5, img_size=IMG)
    jl, pl = [], []
    want = jisic.dice_eval(jm, v, jisic.SyntheticISICDataset(5, IMG), IMG,
                           batch=2, log=jl.append)
    got = pisic.dice_eval(pm, ds, IMG, batch=2, log=pl.append,
                          save_path=str(tmp_path / "pred"), device="cpu")
    assert got == pytest.approx(want, abs=1e-6)
    jc, pc = _cases(jl), _cases(pl)
    assert len(pc) == len(jc) == 5
    for (pn, pd, pi), (jn, jd, ji) in zip(pc, jc):
        assert pn == jn
        assert pd == pytest.approx(jd, abs=1e-6)
        assert pi == pytest.approx(ji, abs=1e-6)
    assert re.match(r"ISIC eval: mean_dice \S+ mean_iou \S+ over 5 images",
                    pl[-1])
    from PIL import Image

    from transception_tpu_torch.eval.metrics import dice_coefficient
    for i, (name, dice, _) in enumerate(pc):
        mask = np.asarray(Image.open(tmp_path / "pred" /
                                     f"{name}_pred.png")) > 127
        gt = ds.get(i, np.random.default_rng(0))["label"] > 0
        assert dice_coefficient(mask, gt) == pytest.approx(dice, abs=1e-6)


def test_dice_eval_writes_npy_without_pil(models, tmp_path, monkeypatch):
    """Where PIL is missing (the card's machine lists none) the masks go
    to {case}_pred.npy, as JAX writes them."""
    import builtins
    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    _, _, pm = models
    ds = pisic.SyntheticISICDataset(length=2, img_size=IMG)
    pisic.dice_eval(pm, ds, IMG, batch=2, log=None,
                    save_path=str(tmp_path), device="cpu")
    saved = np.load(tmp_path / "synthetic_isic_1_pred.npy")
    assert saved.shape == (IMG, IMG) and saved.dtype == np.uint8
    assert set(np.unique(saved)) <= {0, 1}


def test_dice_eval_uses_the_logits_not_the_argmax_head(models):
    """dice_eval runs the logits forward (no fused argmax head, K4): the
    routed calls of one batch are those of launches_per_forward(argmax=
    False) with the kernels routed on (no_grad on the CPU)."""
    from transception_tpu_torch.models.transception import (
        launches_per_forward,
    )
    from transception_tpu_torch.ops import kernels
    _, _, pm = models
    kernels.reset_launches()
    pisic.dice_eval(pm, pisic.SyntheticISICDataset(length=2, img_size=IMG),
                    IMG, batch=2, log=None, device="cpu")
    want = {k: n for k, n in launches_per_forward(pm.cfg, argmax=False)
            .items() if n}
    assert kernels.routed_counts() == want
    assert "expand_head" not in kernels.routed_counts()


def test_test_cli_isic(models, tmp_path):
    """cli.test --dataset ISIC on the CPU: the synthetic lesions (no data
    at --test_path), dice_eval with --eval_batch, --is_savenii as the PNG
    directory, HD95 0.0; the result equals dice_eval's."""
    from transception_tpu_torch.cli import test as pcli
    _, _, pm = models
    pth = tmp_path / "w.pth"
    torch.save(pm.state_dict(), pth)
    argv = ["--dataset", "ISIC", "--img_size", str(IMG), "--stage1_layers",
            "1", "--num_path", "2,2,2", "--num_layers", "1,1,1",
            "--weight_pth", str(pth), "--output_dir", str(tmp_path / "out"),
            "--test_path", str(tmp_path / "absent"), "--eval_batch", "16",
            "--is_savenii"]
    dice, hd95 = pcli.main(argv, device="cpu")
    assert hd95 == 0.0
    want = pisic.dice_eval(pm, pisic.SyntheticISICDataset(img_size=IMG),
                           IMG, batch=16, log=None, device="cpu")
    assert dice == want
    log = (tmp_path / "out" / "test_log" / "eval.txt").read_text()
    assert "over 256 images" in log
    assert (tmp_path / "out" / "predictions" /
            "synthetic_isic_255_pred.png").exists()
