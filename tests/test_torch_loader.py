"""The port's host loader (transception_tpu_torch/data/loader.py) and train
datasets (data/synapse.py) against the JAX package's: the same batches bit
for bit over two epochs, for the synthetic slices (augment on and off)
and for Synapse .npz slices in a temporary directory; the epoch
reshuffle, drop_last and the early-break shutdown; make_train_dataset's
choices; to_device. Every test body runs in a thread joined with a
timeout of its own (pytest-timeout is not installed), so a loader that
hangs fails its test instead of the run."""

import threading
import time

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu.core.config import DataConfig as JDataConfig
from transception_tpu.data import loader as jloader
from transception_tpu.data import synapse as jsyn
from transception_tpu_torch.core.config import DataConfig
from transception_tpu_torch.data import loader as ploader
from transception_tpu_torch.data import synapse as psyn

JOIN_S = 60.0


def bounded(fn):
    """fn() in a daemon thread, joined within JOIN_S seconds; its
    exception is raised here."""
    err = []

    def run():
        try:
            fn()
        except BaseException as e:  # re-raised on the test's thread
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(JOIN_S)
    assert not t.is_alive(), f"did not finish within {JOIN_S} s"
    if err:
        raise err[0]


def _batches(loader, epochs=(0, 1)):
    out = []
    for ep in epochs:
        loader.set_epoch(ep)
        out.extend(list(loader))
    return out


def _same_batches(a, b):
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert x["case_name"] == y["case_name"]
        for k in ("image", "label"):
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
def test_synthetic_batches_equal_jax(augment):
    def body():
        kw = dict(length=10, img_size=24, num_classes=9, augment=augment)
        lk = dict(batch_size=4, seed=7, num_workers=3)
        got = _batches(ploader.HostDataLoader(
            psyn.SyntheticSliceDataset(**kw), **lk))
        want = _batches(jloader.HostDataLoader(
            jsyn.SyntheticSliceDataset(**kw), **lk))
        _same_batches(got, want)
        assert got[0]["image"].shape == (4, 24, 24, 1)
        assert got[0]["label"].dtype == np.int32
    bounded(body)


@pytest.fixture(scope="module")
def npz_slices(tmp_path_factory):
    """Six Synapse-layout train slices ({case}_sliceNNN.npz with 'image'
    and 'label' of 40 x 36) and lists/train.txt."""
    root = tmp_path_factory.mktemp("synapse_train")
    (root / "npz").mkdir()
    (root / "lists").mkdir()
    rng = np.random.default_rng(0)
    names = [f"case{c:04d}_slice{s:03d}" for c in (5, 6) for s in range(3)]
    for n in names:
        np.savez(root / "npz" / f"{n}.npz",
                 image=rng.random((40, 36)).astype(np.float32),
                 label=rng.integers(0, 9, (40, 36)).astype(np.float32))
    (root / "lists" / "train.txt").write_text("\n".join(names) + "\n")
    return root


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
def test_synapse_npz_batches_equal_jax(npz_slices, augment):
    def body():
        args = (str(npz_slices / "npz"), str(npz_slices / "lists"))
        kw = dict(img_size=32, augment=augment)
        lk = dict(batch_size=2, seed=3, num_workers=2)
        got = _batches(ploader.HostDataLoader(
            psyn.SynapseSliceDataset(*args, **kw), **lk))
        want = _batches(jloader.HostDataLoader(
            jsyn.SynapseSliceDataset(*args, **kw), **lk))
        _same_batches(got, want)
        assert got[0]["image"].shape == (2, 32, 32, 1)
    bounded(body)


def test_make_train_dataset_follows_jax(npz_slices, tmp_path):
    for kw in (dict(dataset="synthetic", synthetic_len=5, img_size=16),
               dict(dataset="synapse", root_path=str(tmp_path / "absent"),
                    synthetic_len=6, augment=False),
               dict(dataset="synapse", root_path=str(npz_slices / "npz"),
                    list_dir=str(npz_slices / "lists"), img_size=32)):
        got = psyn.make_train_dataset(DataConfig(**kw))
        want = jsyn.make_train_dataset(JDataConfig(**kw))
        assert type(got).__name__ == type(want).__name__
        assert len(got) == len(want)
        assert vars(got) == vars(want)
    # ISIC: a missing root_path gives the synthetic lesions, as in JAX
    # (the raw and preprocessed layouts: tests/test_torch_isic.py).
    kw = dict(dataset="isic", root_path=str(tmp_path / "absent"),
              img_size=32, augment=False)
    got = psyn.make_train_dataset(DataConfig(**kw))
    want = jsyn.make_train_dataset(JDataConfig(**kw))
    assert type(got).__name__ == type(want).__name__ == \
        "SyntheticISICDataset"
    assert vars(got) == vars(want)


def test_epoch_reshuffle_and_drop_last():
    def body():
        ds = psyn.SyntheticSliceDataset(length=11, img_size=8)
        ld = ploader.HostDataLoader(ds, 4, seed=1, num_workers=2)
        assert len(ld) == 2  # the last 3 items dropped
        e0 = [n for b in _batches(ld, (0,)) for n in b["case_name"]]
        e0b = [n for b in _batches(ld, (0,)) for n in b["case_name"]]
        e1 = [n for b in _batches(ld, (1,)) for n in b["case_name"]]
        assert e0 == e0b and e0 != e1 and len(e0) == len(e1) == 8
        assert len(set(e0)) == 8
        keep = ploader.HostDataLoader(ds, 4, seed=1, num_workers=2,
                                      drop_last=False)
        assert len(keep) == 3
        names = [n for b in _batches(keep, (0,)) for n in b["case_name"]]
        assert sorted(names) == sorted(f"synthetic_{i:05d}"
                                       for i in range(11))
        plain = ploader.HostDataLoader(ds, 4, shuffle=False, num_workers=1)
        assert [n for b in _batches(plain, (0, 1)) for n in b[
            "case_name"]] == [f"synthetic_{i:05d}" for i in range(8)] * 2
    bounded(body)


def test_early_break_stops_the_producer():
    """Breaking out after one batch (max_steps mid-epoch) must not leave
    the producer blocked on the full prefetch queue."""
    def body():
        before = threading.active_count()
        ds = psyn.SyntheticSliceDataset(length=64, img_size=8)
        ld = ploader.HostDataLoader(ds, 2, seed=0, num_workers=2,
                                    prefetch=1)
        for _ in ld:
            break
        deadline = time.time() + 10
        while threading.active_count() > before and time.time() < deadline:
            time.sleep(0.05)
        assert threading.active_count() <= before
        assert len(list(ld)) == 32  # a fresh iteration is whole
    bounded(body)


def test_one_process_only():
    """Process 1 of 2 takes its shard of each global batch of 4: rows
    2-3 of the one-process batch (tests/test_torch_data_parallel.py holds
    every shard against JAX's)."""
    ds = psyn.SyntheticSliceDataset(length=8, img_size=8)

    def body():
        whole = list(ploader.HostDataLoader(ds, 4, num_workers=1))
        shard = list(ploader.HostDataLoader(ds, 4, num_workers=1,
                                            process_index=1,
                                            process_count=2))
        assert len(shard) == len(whole) == 2
        for s, w in zip(shard, whole):
            for k in ("image", "label"):
                np.testing.assert_array_equal(s[k], w[k][2:4])
            assert s["case_name"] == w["case_name"][2:4]
    bounded(body)


def test_to_device():
    ds = psyn.SyntheticSliceDataset(length=4, img_size=8)
    batch = next(iter(ploader.HostDataLoader(ds, 2, num_workers=1)))
    img, lbl = ploader.to_device(batch, torch.device("cpu"))
    assert img.dtype == torch.float32 and img.shape == (2, 8, 8, 1)
    assert lbl.dtype == torch.int64 and lbl.shape == (2, 8, 8)
    assert torch.equal(img, torch.from_numpy(batch["image"]))
    assert torch.equal(lbl, torch.from_numpy(batch["label"]).long())
    on = {"image": img, "label": lbl}
    assert ploader.to_device(on, torch.device("cpu")) == (img, lbl)
