"""Data parallelism of the port (parallel/mesh.py) on the CPU: two gloo
ranks, started once for the module (parallel.mesh.spawn), against the
one-process step on the global batch, which tests/test_torch_train_step.py
holds against JAX.

Each case (tests/torch_dp_worker.py) is one Trainer step of the tiny fp32
model (quarter widths) at a global batch of 4, 2 rows a rank: the default, flash and
"pallas" (drop path 0.1) train modes, grad_accum_steps 2, and grad
clipping (its max norm set below the step's gradient norm, so that it
scales). Limits: the loss within 1e-5 relative; each parameter within
1e-5 of its norm, plus 1e-4 of its own update and 1e-7 of the whole
model's update. The ranks sum the batch in another order than one
process. Where a gradient is a sum of terms that cancel (the biases),
that order moves a leaf by up to ~3e-5 of its update, measured over one
and two steps, and a small leaf's norm is about its update. A leaf whose
exact gradient is 0 (a bias before a train-mode BatchNorm, the keys'
bias under a softmax over tokens) is rounding noise of ~1e-11 either
way, below the last term (~1e-8 here). The BatchNorm running
statistics and the momentum buffers within 1e-5 of their largest value
(at least 1). The two global reductions are necessary: with the Dice or
the BatchNorm moments taken per rank, the same check fails on the
parameters, and so it does where the reductions' backward is left out
(each rank's gradient through them its own share, 1/R of the global one
after DDP's mean, while the loss is unchanged). The ranks hold the same
bits.

Also: checkpoints cross world sizes both ways; the slice-sharded eval
(both predictors, both resample paths, run_inference) gives the
one-process maps bit for bit and the same per-case lines (at the tiny
config's full widths: torch_dp_worker.EVAL_CFG says why); the loader's
and the device stream's rank shards; the CLIs under --dp_size 2 (they
start their ranks) against --dp_size 1; and the refusals.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch
import torch_dp_worker as W
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu.data import loader as jloader
from transception_tpu.data import synapse as jsyn
from transception_tpu_torch.cli import test as ptest_cli
from transception_tpu_torch.cli import train as ptrain_cli
from transception_tpu_torch.data import loader as ploader
from transception_tpu_torch.data import synapse as psyn
from transception_tpu_torch.data.device_synthetic import DeviceSyntheticStream
from transception_tpu_torch.parallel.mesh import spawn

TRAIN = [n for n in W.CASES if not n.startswith("per_rank")]
SENSITIVITY = ["per_rank_dice", "per_rank_bn", "per_rank_backward"]
LOSS_TOL, LEAF_TOL, UPDATE_TOL, MODEL_TOL, STAT_TOL = \
    1e-5, 1e-5, 1e-4, 1e-7, 1e-5
STATS = ("running_mean", "running_var")


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    """The one-process step of each case at the global batch, and the
    one-process eval (its files removed after the module)."""
    torch.set_num_threads(2)
    out = tmp_path_factory.mktemp("one")
    res = {n: W.run_case(n, str(out / n)) for n in TRAIN}
    res["before"] = W.initial_state()
    res["eval"] = W.eval_case()
    yield res
    shutil.rmtree(out, ignore_errors=True)


@pytest.fixture(scope="module")
def ranks(one, tmp_path_factory):
    """Every rank's results of every case (two ranks, one launch); the
    ranks also resume the one-process default case's checkpoint."""
    out = tmp_path_factory.mktemp("ranks")
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    spawn(W.rank_main, 2, (str(out), one["default"]["ckpt"]))
    res = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    yield res
    shutil.rmtree(out, ignore_errors=True)


@pytest.fixture
def scratch(tmp_path):
    """tmp_path, emptied after the test (the CLIs write checkpoints of
    the full-width tiny model, ~170 MB each)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def mismatch(got, want, before):
    """The checks of `got` against `want`, both stepped from the state
    `before`, that fail (empty: all hold)."""
    bad = []
    moved = {n: w - before[n] for n, w in want["sd"].items()
             if w.is_floating_point() and not n.endswith(STATS)}
    floor = MODEL_TOL * float(torch.norm(torch.stack(
        [u.norm() for u in moved.values()])))
    if abs(got["loss"] - want["loss"]) > LOSS_TOL * abs(want["loss"]):
        bad.append(f"loss {got['loss']} vs {want['loss']}")
    for n, w in want["sd"].items():
        g = got["sd"][n]
        if not w.is_floating_point():
            if not torch.equal(g, w):
                bad.append(n)
        elif n.endswith(STATS):
            lim = STAT_TOL * max(1.0, float(w.abs().max()))
            if float((g - w).abs().max()) > lim:
                bad.append(f"{n} (BatchNorm statistics)")
        elif float((g - w).norm()) > LEAF_TOL * float(w.norm()) + \
                UPDATE_TOL * float(moved[n].norm()) + floor:
            bad.append(f"{n}: |d| {float((g - w).norm()):.3g} of "
                       f"|p| {float(w.norm()):.3g}")
    return bad


@pytest.mark.parametrize("name", TRAIN)
def test_two_ranks_equal_one_process(ranks, one, name):
    assert not mismatch(ranks[0][name], one[name], one["before"])


@pytest.mark.parametrize("name", TRAIN)
def test_momentum_and_counters_equal_one_process(ranks, one, name):
    got, want = ranks[0][name], one[name]
    assert (got["step"], got["updates"]) == (want["step"], want["updates"])
    for n, w in want["mom"].items():
        lim = STAT_TOL * max(1.0, float(w.abs().max()))
        assert float((got["mom"][n] - w).abs().max()) <= lim, n


@pytest.mark.parametrize("name", TRAIN)
def test_ranks_hold_equal_state(ranks, name):
    a, b = ranks[0][name], ranks[1][name]
    assert a["loss"] == b["loss"]
    for n, t in a["sd"].items():
        assert torch.equal(t, b["sd"][n]), n


@pytest.mark.parametrize("name", SENSITIVITY)
def test_per_rank_reduction_fails_the_check(ranks, one, name):
    """Each fault fails the check on the parameters, not on the loss or
    the BatchNorm statistics alone; the backward's fault (the factor R)
    leaves the loss as it is, so that only the parameters catch it."""
    bad = mismatch(ranks[0][name], one["default"], one["before"])
    assert [b for b in bad if ": |d| " in b], bad
    if name == "per_rank_backward":
        assert not [b for b in bad if b.startswith("loss ")], bad


def test_clipping_scaled_the_gradients(ranks, one):
    """The clip case's gradients were above its max norm and came out at
    it, on both paths."""
    assert one["default"]["grad_norm"] > 10 * W.CLIP_NORM
    for got in (one["clip"], ranks[0]["clip"]):
        assert got["grad_norm"] == pytest.approx(W.CLIP_NORM, rel=1e-4)


def test_dp_checkpoint_resumes_in_one_process(ranks, one, scratch):
    """Rank 0's checkpoint holds the bare model's keys; a one-process
    Trainer restores from it the state the ranks ended with."""
    path = ranks[0]["default"]["ckpt"]
    sd = torch.load(path, weights_only=True)
    assert not [k for k in sd["model"] if k.startswith("module.")]
    tr = W.trainer("default", str(scratch))
    state, step = tr.init_state(steps_per_epoch=10)
    tr.restore_checkpoint(state, path)
    assert (state.step, state.updates) == (1, 1)
    for n, t in tr.model.state_dict().items():
        assert torch.equal(t, ranks[0]["default"]["sd"][n]), n
    img, lbl = W.batches(1)[0]
    met = step(torch.from_numpy(img), torch.from_numpy(lbl).long())
    assert np.isfinite(float(met["loss"]))


@pytest.mark.parametrize("rank", [0, 1])
def test_one_process_checkpoint_resumes_in_each_rank(ranks, one, rank):
    for n, t in one["default"]["sd"].items():
        assert torch.equal(ranks[rank]["resumed"][n], t), n


@pytest.mark.parametrize("kind", ["maps", "raw_maps", "device_maps"])
def test_sharded_eval_maps_equal_one_process(ranks, one, kind):
    """Both ranks hold the whole volumes' maps, the one-process bits
    (chunks of 4 slices over volumes of 16-23: the last chunk leaves a
    rank with padding or nothing)."""
    for r in ranks:
        for got, want in zip(r["eval"][kind], one["eval"][kind]):
            np.testing.assert_array_equal(got, want)


def test_sharded_run_inference_equals_one_process(ranks, one):
    assert ranks[0]["eval"]["lines"] == one["eval"]["lines"]
    assert any(re.match(r"idx 1 case synthetic_vol_1 mean_dice", x)
               for x in one["eval"]["lines"])
    assert ranks[1]["eval"]["lines"] == []
    for r in ranks:
        assert r["eval"]["means"] == one["eval"]["means"]


def _shards(make, n_ranks):
    return [next(iter(make(r, n_ranks))) for r in range(n_ranks)]


def test_loader_shards_equal_one_process_and_jax():
    """Rank r's batch is rows [r·b/R, (r+1)·b/R) of the one-process batch,
    augmentation included, and JAX HostDataLoader's shard of process r."""
    pds = psyn.SyntheticSliceDataset(length=16, img_size=16)
    jds = jsyn.SyntheticSliceDataset(length=16, img_size=16)

    def port(r, n):
        ld = ploader.HostDataLoader(pds, 4, seed=3, num_workers=1,
                                    process_index=r, process_count=n)
        ld.set_epoch(1)
        return ld

    def jax(r, n):
        ld = jloader.HostDataLoader(jds, 4, seed=3, num_workers=1,
                                    process_index=r, process_count=n)
        ld.set_epoch(1)
        return ld

    whole = _shards(port, 1)[0]
    for n in (2, 4):
        shards, jshards = _shards(port, n), _shards(jax, n)
        for k in ("image", "label"):
            np.testing.assert_array_equal(
                np.concatenate([s[k] for s in shards]), whole[k])
            for s, j in zip(shards, jshards):
                np.testing.assert_array_equal(s[k], j[k])
        assert sum((s["case_name"] for s in shards), []) == \
            whole["case_name"]
    with pytest.raises(AssertionError, match="divide"):
        ploader.HostDataLoader(pds, 4, process_index=0, process_count=3)


def test_device_stream_shards_equal_one_process():
    def stream(r, n):
        return DeviceSyntheticStream(4, 8, 9, 16, 7, "cpu", r, n)

    whole = stream(0, 1).batch(5)
    for k in ("image", "label"):
        np.testing.assert_array_equal(
            torch.cat([stream(r, 2).batch(5)[k] for r in range(2)]),
            whole[k])


TINY = ["--img_size", "32", "--stage1_layers", "1", "--num_path", "1,1,1",
        "--num_layers", "1,1,1", "--dtype", "float32"]
CLI_CFG = W.EVAL_CFG  # the model the TINY flags build


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    """Two tiny Synapse-layout test volumes ({case}.npy.h5 and
    test_vol.txt)."""
    import h5py
    root = tmp_path_factory.mktemp("synapse")
    (root / "vol").mkdir()
    (root / "lists").mkdir()
    rng = np.random.default_rng(0)
    names = ["case0001", "case0002"]
    for n in names:
        with h5py.File(root / "vol" / f"{n}.npy.h5", "w") as f:
            f["image"] = rng.random((7, 40, 36)).astype(np.float32)
            f["label"] = rng.integers(0, 9, (7, 40, 36)).astype(np.float32)
    (root / "lists" / "test_vol.txt").write_text("\n".join(names) + "\n")
    return root


def _train_argv(volumes, out, *extra, batch=4, steps=2):
    return ["--dataset", "Synapse", "--root_path", str(out / "no_slices"),
            "--test_path", str(volumes / "vol"), "--list_dir",
            str(volumes / "lists"), "--output_dir", str(out),
            "--batch_size", str(batch), "--max_steps", str(steps),
            "--num_workers", "1", *TINY, *extra]


def test_train_cli_two_ranks_equal_one_process(volumes, scratch):
    """cli.train --dp_size 2 starts its two ranks: two steps on the host
    loader's shards, rank 0's checkpoint and log, the sharded end-of-run
    eval; against --dp_size 1 on the same flags."""
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    _, h1 = ptrain_cli.main(_train_argv(volumes, scratch / "one",
                                        "--dp_size", "1"), device="cpu")
    st2, h2 = ptrain_cli.main(_train_argv(volumes, scratch / "two",
                                          "--dp_size", "2"), device="cpu")
    assert st2 is None and h2 == h1
    log = (scratch / "two" / "log.txt").read_text()
    assert "data parallel over 2 ranks: 2 of each global batch of 4" in log
    assert "iteration 2 : lr" in log

    def ckpt(d):
        return torch.load(d / "ckpt" / "step_00000002.pt",
                          weights_only=True)

    a, b = ckpt(scratch / "two"), ckpt(scratch / "one")
    assert set(a["model"]) == set(b["model"])
    assert not mismatch({"loss": 1.0, "sd": a["model"]},
                        {"loss": 1.0, "sd": b["model"]},
                        W.initial_state(CLI_CFG, seed=1234))


def test_test_cli_two_ranks_equal_one_process(volumes, scratch):
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    from transception_tpu_torch.models.transception import MSTransception
    pth = scratch / "w.pth"
    torch.save(MSTransception(CLI_CFG, "cpu", seed=3).state_dict(), pth)

    def run(dp, out):
        return ptest_cli.main(
            ["--dataset", "Synapse", "--test_path", str(volumes / "vol"),
             "--list_dir", str(volumes / "lists"), "--output_dir", str(out),
             "--weight_pth", str(pth), "--eval_batch", "4", "--dp_size",
             str(dp), "--is_savenii", *TINY], device="cpu")

    assert run(2, scratch / "two") == run(1, scratch / "one")

    def lines(d):
        text = (d / "test_log" / "eval.txt").read_text()
        return re.findall(r"\] (idx .*|Mean class .*|Testing .*)", text)

    assert lines(scratch / "two") == lines(scratch / "one")
    from transception_tpu_torch.eval.nifti import load_nifti
    for case in ("case0001", "case0002"):
        got, want = (load_nifti(str(d / "predictions" /
                                    f"{case}_pred.nii.gz"))[0]
                     for d in (scratch / "two", scratch / "one"))
        np.testing.assert_array_equal(got, want)


def test_train_cli_three_ranks_shard_the_eval(volumes, scratch):
    """At 3 ranks the in-training eval's chunk is the next multiple of 3
    above 32 (33), so the end-of-run eval splits over the ranks; its
    history is the one-process run's."""
    from transception_tpu_torch.train.trainer import eval_batch
    assert [eval_batch(w) for w in (1, 2, 3, 4, 6)] == [32, 32, 33, 32, 36]
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    _, h3 = ptrain_cli.main(_train_argv(volumes, scratch / "three",
                                        "--dp_size", "3", batch=6, steps=1),
                            device="cpu")
    log = (scratch / "three" / "log.txt").read_text()
    assert "data parallel over 3 ranks: 2 of each global batch of 6" in log
    assert len(h3["dice"]) == len(h3["hd95"]) == 1
    assert np.isfinite(h3["dice"] + h3["hd95"]).all()


def test_trainer_takes_one_rank_outside_a_launch(monkeypatch, scratch):
    """A Trainer built outside a launch on a host of two cards trains on
    one (dp_size -1 means the launch's world; the CLIs start the ranks for
    every visible card); dp_size 2 there needs the ranks started."""
    from transception_tpu_torch.core.config import DataConfig, TrainConfig
    from transception_tpu_torch.models.transception import MSTransception
    from transception_tpu_torch.train.trainer import Trainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    cfg = W.model_cfg()
    model = MSTransception(cfg, "cpu", seed=0)
    tr = Trainer(cfg, TrainConfig(output_dir=str(scratch)), DataConfig(),
                 device="cuda", model=model)
    assert (tr.mesh.rank, tr.mesh.world, tr.mesh.group) == (0, 1, None)
    assert tr.device == torch.device("cuda")
    with pytest.raises(RuntimeError, match="dp_size 2 needs 2 ranks"):
        Trainer(cfg, TrainConfig(output_dir=str(scratch), dp_size=2),
                DataConfig(), device="cuda", model=model)


def test_refusals(volumes, tmp_path):
    """Before any work: a global batch that does not divide over the
    ranks, an eval batch that does not, more ranks than cards, and the TP
    axis."""
    with pytest.raises(ValueError, match="does not divide over --dp_size 3"):
        ptrain_cli.main(_train_argv(volumes, tmp_path, "--dp_size", "3"),
                        device="cpu")
    with pytest.raises(ValueError, match="not divisible by the mesh 'data'"):
        ptest_cli.main(["--weight_pth", str(tmp_path / "none.pth"),
                        "--eval_batch", "4", "--dp_size", "3", *TINY],
                       device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs 2 cards, have 0"):
            ptrain_cli.main(_train_argv(volumes, tmp_path, "--dp_size", "2"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 4"):
        ptrain_cli.main(_train_argv(volumes, tmp_path, "--tp_size", "2"),
                        device="cpu")
