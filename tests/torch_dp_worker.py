"""The cases of tests/test_torch_data_parallel.py, run by each rank of a
data-parallel launch (parallel.mesh.spawn, gloo on the CPU) and, at the
global batch, by the one-process reference in the test itself. Imports
torch and the port only (the ranks start fast and never load JAX).

A case is one Trainer step (two under accumulation) of the tiny fp32
model at quarter widths (dims 16/32/80/128: the same structure, 1.4M
parameters, so that each rank's results stay small on disk) from the
seeded weights on a seeded global batch of 4 slices of 32²: the rank
feeds its rows of it. Its result is the mean loss the step
reports, the model's state (parameters and BatchNorm statistics) and the
SGD momentum buffers after the step.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import numpy as np
import torch

from transception_tpu_torch.core.config import (
    DataConfig,
    TrainConfig,
    TransceptionConfig,
)

GLOBAL_BATCH = 4
IMG = 32
EVAL_BATCH = 4
EVAL_HW = 40

# name -> (TransceptionConfig overrides, TrainConfig overrides, patches)
CASES = {
    "default": ({}, {}, ()),
    "flash": (dict(ffn_flash_train=True), {}, ()),
    "pallas": (dict(use_pallas_train=True, mhca_ffn_fold=True,
                    drop_path_rate=0.1), {}, ()),
    "accum2": ({}, dict(grad_accum_steps=2), ()),
    "clip": ({}, dict(grad_clipping=True), ("clip",)),
    # Sensitivity: each of the two global reductions taken per rank, and
    # the factor R: the summing all-reduce's backward left out, so that
    # each rank's gradient through the BatchNorm moments and the Dice sums
    # is its own share alone and DDP's mean leaves 1/R of it (the loss is
    # the global one all the same).
    "per_rank_dice": ({}, {}, ("dice",)),
    "per_rank_bn": ({}, {}, ("bn",)),
    "per_rank_backward": ({}, {}, ("backward",)),
}


def model_cfg(**kw) -> TransceptionConfig:
    return TransceptionConfig(img_size=IMG, dtype="float32",
                              stage1_layers=1, num_path=(1, 1, 1),
                              num_layers=(1, 1, 1), dims=(16, 32, 80, 128),
                              bridge_dim=16, **kw)


def initial_state(cfg: Optional[TransceptionConfig] = None,
                  seed: int = 5) -> Dict[str, torch.Tensor]:
    """The state of the model of `cfg` (default model_cfg()) before any
    step (the Trainer's model of TrainConfig.seed `seed`)."""
    from transception_tpu_torch.models.transception import MSTransception
    return MSTransception(cfg or model_cfg(), "cpu", seed=seed).state_dict()


def batches(n: int):
    rng = np.random.default_rng(11)
    return [(rng.random((GLOBAL_BATCH, IMG, IMG, 1), dtype=np.float32),
             rng.integers(0, 9, (GLOBAL_BATCH, IMG, IMG)))
            for _ in range(n)]


# The clipping case's max norm: below this step's global gradient norm
# (about 0.1 here), so that the clip scales the gradients (the recipe's 5
# would leave them as they are).
CLIP_NORM = 0.01


@contextlib.contextmanager
def patched(patches):
    """"clip": clip at CLIP_NORM. The sensitivity cases undo a global
    reduction: "dice" sums the Dice terms over this rank's pixels only,
    "bn" takes BatchNorm's moments of this rank's rows, "backward" sums
    the forward over the ranks but not the backward."""
    from transception_tpu_torch.ops import conv
    from transception_tpu_torch.parallel import mesh
    from transception_tpu_torch.train import losses
    from transception_tpu_torch.train.state import TrainState
    saved = (losses.global_sum, conv.active, TrainState.CLIP_NORM,
             mesh._AllReduceSum.backward)
    if "dice" in patches:
        losses.global_sum = lambda x: x
    if "bn" in patches:
        conv.active = lambda: None
    if "clip" in patches:
        TrainState.CLIP_NORM = CLIP_NORM
    if "backward" in patches:
        mesh._AllReduceSum.backward = staticmethod(
            lambda ctx, g: (g, None))
    try:
        yield
    finally:
        (losses.global_sum, conv.active, TrainState.CLIP_NORM,
         mesh._AllReduceSum.backward) = saved


def trainer(name: str, out_dir: str, mesh=None):
    from transception_tpu_torch.train.trainer import Trainer
    mkw, tkw, _ = CASES[name]
    tc = TrainConfig(**dict(dict(batch_size=GLOBAL_BATCH, seed=5,
                                 output_dir=out_dir, max_epochs=2), **tkw))
    return Trainer(model_cfg(**mkw), tc,
                   DataConfig(dataset="synthetic", img_size=IMG,
                              synthetic_len=8),
                   device="cpu", mesh=mesh)


def run_case(name: str, out_dir: str, mesh=None) -> Dict:
    """One case on this process: its rows of each global batch when
    `mesh` is given, the whole of it otherwise."""
    tr = trainer(name, out_dir, mesh)
    state, step = tr.init_state(steps_per_epoch=10)
    rows = mesh.rows(GLOBAL_BATCH) if mesh is not None else slice(None)
    k = tr.cfg.grad_accum_steps
    with patched(CASES[name][2]):
        for img, lbl in batches(k):
            met = step(torch.from_numpy(img[rows]),
                       torch.from_numpy(lbl[rows]).long())
    opt = state.optimizer
    mom = {n: opt.state[p]["momentum_buffer"].clone()
           for n, p in tr.model.named_parameters()}
    grads = [p.grad for p in tr.model.parameters()]
    out = {"loss": float(met["loss"]), "step": state.step,
           "grad_norm": float(torch.norm(torch.stack(
               [g.norm() for g in grads]))),
           "updates": state.updates,
           "sd": {n: t.detach().clone()
                  for n, t in tr.model.state_dict().items()},
           "mom": mom}
    if name == "default":
        if mesh is None or mesh.is_main:
            out["ckpt"] = tr.save_checkpoint(state)
    return out


# The eval case's model: the tiny config at its full widths. Bit
# equality of the sharded maps needs a forward whose rounding does not
# depend on the rows a call takes; the CPU's products do (logits move by
# ~1e-6 between 2 and 4 rows), so a pixel whose top two logits are that
# close can flip: 1 of 17408 did at quarter widths, none at these.
EVAL_CFG = TransceptionConfig(img_size=IMG, dtype="float32",
                              stage1_layers=1, num_path=(1, 1, 1),
                              num_layers=(1, 1, 1))


def eval_case(mesh=None) -> Dict:
    """The volume eval of EVAL_CFG's seeded model: class maps through
    both predictors and run_inference's per-case log lines and means."""
    from transception_tpu_torch.data.synapse import SyntheticVolumeDataset
    from transception_tpu_torch.eval.inference import (
        make_device_predictor,
        make_predictor,
        run_inference,
    )
    from transception_tpu_torch.models.transception import MSTransception
    model = MSTransception(EVAL_CFG, "cpu", seed=5)
    ds = SyntheticVolumeDataset(length=2, hw=EVAL_HW)
    out = {"maps": [], "device_maps": [], "raw_maps": []}
    host = make_predictor(model, IMG, EVAL_BATCH, device="cpu", mesh=mesh)
    raw = make_predictor(model, IMG, EVAL_BATCH, device="cpu",
                         device_resample=True, mesh=mesh)
    dev = make_device_predictor(model, IMG, EVAL_BATCH, device="cpu",
                                mesh=mesh)
    for i in range(len(ds)):
        vol = ds.get(i)["image"]
        out["maps"].append(host.predict_volume(vol))
        out["raw_maps"].append(raw.predict_volume(vol))
        out["device_maps"].append(dev(vol))
    lines = []
    out["means"] = run_inference(model, ds, 9, patch_size=IMG,
                                 batch=EVAL_BATCH, log=lines.append,
                                 device="cpu", mesh=mesh)
    out["lines"] = lines
    return out


def resume(path: str, out_dir: str, mesh) -> Dict:
    """The model state a default-case Trainer of this rank restores from
    the checkpoint at `path`."""
    tr = trainer("default", out_dir, mesh)
    state, _ = tr.init_state(steps_per_epoch=10)
    tr.restore_checkpoint(state, path)
    return {n: t.detach().clone() for n, t in tr.model.state_dict().items()}


def rank_main(out_dir: str, resume_from: str) -> None:
    """Every case on this rank of a launch, and the resume of the
    one-process checkpoint `resume_from`; results to out_dir/rank{r}.pt."""
    from transception_tpu_torch.parallel.mesh import make_mesh
    torch.set_num_threads(2)
    mesh = make_mesh(int(os.environ["WORLD_SIZE"]), device="cpu")
    try:
        res: Dict[str, Optional[Dict]] = {
            name: run_case(name, os.path.join(out_dir, f"dp_{name}"), mesh)
            for name in CASES}
        res["resumed"] = resume(resume_from,
                                os.path.join(out_dir, "resume"), mesh)
        res["eval"] = eval_case(mesh)
        res["world"] = mesh.world
        torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    finally:
        mesh.close()
