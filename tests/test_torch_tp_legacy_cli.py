"""The train CLI with a legacy model under tensor parallelism on the CPU:
cli.train --tp_size 2 --model missformer starts its two ranks
(parallel.mesh.spawn, gloo), shards MISSFormer's blocks' FFNs (the JAX
rules; its bridge layers stay whole) and trains as --tp_size 1 does,
through the end-of-run eval (tests/test_torch_tp_layouts.py holds the
Trainer's sharded step itself). The limits of tests/test_torch_tp_cli.py:
the end-of-run eval's mean Dice within 1e-4 relative, every checkpoint
tensor within 1e-5 of its largest value (at least 1).
"""

import os
import shutil

import numpy as np
import torch_threads  # noqa: F401 (torch's threads per xdist worker)
from test_torch_tp_cli import _ckpt, volumes  # noqa: F401 (fixture)


def _argv(volumes, out, tp):  # noqa: F811
    return ["--dataset", "Synapse", "--root_path", str(out / "no_slices"),
            "--test_path", str(volumes / "vol"), "--list_dir",
            str(volumes / "lists"), "--output_dir", str(out),
            "--batch_size", "4", "--max_steps", "2", "--num_workers", "1",
            "--img_size", "32", "--model", "missformer", "--dil_conv", "0",
            "--dtype", "float32", "--dp_size", "1", "--tp_size", str(tp)]


def test_train_cli_missformer_tp2_equals_tp1(volumes, tmp_path):  # noqa: F811
    from transception_tpu_torch.cli import train as ptrain_cli
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    one, two = tmp_path / "tp1", tmp_path / "tp2"
    try:
        _, h1 = ptrain_cli.main(_argv(volumes, one, 1), device="cpu")
        st, h2 = ptrain_cli.main(_argv(volumes, two, 2), device="cpu")
        assert st is None
        assert len(h2["dice"]) == len(h1["dice"]) == 1
        np.testing.assert_allclose(h2["dice"], h1["dice"], rtol=1e-4)
        log = (two / "log.txt").read_text()
        assert "tensor parallel over 2 ranks" in log
        assert "Testing performance in best val model" in log
        a, b = _ckpt(two), _ckpt(one)
        assert set(a) == set(b)
        assert any(k.endswith("mlp.fc1.weight") for k in a)
        for n, w in b.items():
            assert a[n].shape == w.shape, n
            if w.is_floating_point():
                assert float((a[n] - w).abs().max()) <= \
                    1e-5 * max(1.0, float(w.abs().max())), n
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
