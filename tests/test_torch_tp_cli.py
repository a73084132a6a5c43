"""The train CLI under tensor parallelism on the CPU: cli.train
--tp_size 2 and 4, alone and with --dp_size 2, start their ranks
(parallel.mesh.spawn, gloo) and train as --tp_size 1 does, through the
end-of-run eval (tests/test_torch_tp.py holds the Trainer's sharded step
itself). At a global batch of 4: at 2, the deepest stage's train-mode
BatchNorm normalises over two values a channel, and two steps amplify the
order of the fp32 sums past any limit (parameters moved by 5e-2 between
the two runs, both ways of summing).

Limits: the end-of-run eval's mean Dice within 1e-4 relative, every
checkpoint tensor within 1e-5 of its largest value (at least 1).
"""

import os
import shutil

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)


@pytest.fixture
def scratch_dir(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    """Two tiny Synapse-layout test volumes ({case}.npy.h5 and
    test_vol.txt)."""
    import h5py
    root = tmp_path_factory.mktemp("tp_synapse")
    (root / "vol").mkdir()
    (root / "lists").mkdir()
    rng = np.random.default_rng(0)
    names = ["case0001", "case0002"]
    for n in names:
        with h5py.File(root / "vol" / f"{n}.npy.h5", "w") as f:
            f["image"] = rng.random((5, 40, 36)).astype(np.float32)
            f["label"] = rng.integers(0, 9, (5, 40, 36)).astype(np.float32)
    (root / "lists" / "test_vol.txt").write_text("\n".join(names) + "\n")
    return root


def _argv(volumes, out, dp, tp):
    return ["--dataset", "Synapse", "--root_path", str(out / "no_slices"),
            "--test_path", str(volumes / "vol"), "--list_dir",
            str(volumes / "lists"), "--output_dir", str(out),
            "--batch_size", "4", "--max_steps", "2", "--num_workers", "1",
            "--img_size", "32", "--stage1_layers", "1", "--num_path",
            "1,1,1", "--num_layers", "1,1,1", "--dtype", "float32",
            "--dp_size", str(dp), "--tp_size", str(tp)]


def _ckpt(d):
    return torch.load(d / "ckpt" / "step_00000002.pt",
                      weights_only=True)["model"]


@pytest.fixture(scope="module")
def tp1(volumes, tmp_path_factory):
    """The --dp_size 1 --tp_size 1 run: its output directory and history."""
    from transception_tpu_torch.cli import train as ptrain_cli
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    out = tmp_path_factory.mktemp("tp_cli_one")
    _, h = ptrain_cli.main(_argv(volumes, out, 1, 1), device="cpu")
    yield out, h
    shutil.rmtree(out, ignore_errors=True)


def _equals_tp1(volumes, tp1, out, dp, tp):
    """cli.train at dp x tp against the --tp_size 1 run: the end-of-run
    eval's mean Dice (every rank's data group scores; rank (0, 0) logs),
    rank (0, 0)'s log and full-layout checkpoint."""
    from transception_tpu_torch.cli import train as ptrain_cli
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    st, h = ptrain_cli.main(_argv(volumes, out, dp, tp), device="cpu")
    assert st is None
    assert len(h["dice"]) == len(tp1[1]["dice"]) == 1
    np.testing.assert_allclose(h["dice"], tp1[1]["dice"], rtol=1e-4)
    log = (out / "log.txt").read_text()
    assert f"tensor parallel over {tp} ranks" in log
    if dp > 1:
        assert f"data parallel over {dp} ranks" in log
    assert "iteration 2 : lr" in log
    assert "Testing performance in best val model" in log
    a, b = _ckpt(out), _ckpt(tp1[0])
    assert set(a) == set(b)
    for n, w in b.items():
        assert a[n].shape == w.shape, n
        if w.is_floating_point():
            assert float((a[n] - w).abs().max()) <= \
                1e-5 * max(1.0, float(w.abs().max())), n


def test_train_cli_tp2_equals_tp1(volumes, tp1, scratch_dir):
    """--tp_size 2: two steps with the ETB FFNs hidden-sharded, the
    end-of-run eval on the gathered weights."""
    _equals_tp1(volumes, tp1, scratch_dir, 1, 2)


def test_train_cli_dp2_tp2_equals_tp1(volumes, tp1, scratch_dir):
    """--dp_size 2 --tp_size 2: four ranks; the eval's data groups (ranks
    of equal t) each score from their own first rank."""
    _equals_tp1(volumes, tp1, scratch_dir, 2, 2)


def test_train_cli_tp4_equals_tp1(volumes, tp1, scratch_dir):
    _equals_tp1(volumes, tp1, scratch_dir, 1, 4)


def test_train_cli_dp2_tp4_equals_tp1(volumes, tp1, scratch_dir):
    _equals_tp1(volumes, tp1, scratch_dir, 2, 4)
