"""The cases of tests/test_torch_tp.py, run by each rank of a (data, model)
launch (parallel.mesh.spawn, gloo on the CPU) and, at the global batch,
by the one-process reference in the test itself. Imports torch and the
port only (the ranks never load JAX).

A case is one Trainer step (two where the replicated parameters are held
bit-equal across a model group) of tests/torch_dp_worker.py's tiny fp32
model at quarter widths from the seeded weights on its seeded global batch
of 4: the rank feeds its data rank's rows. Its result: the mean loss, the
gathered gradients (the full layout, on every rank), the gathered state
(parameters and BatchNorm statistics) and momentum after the step, and the
rank's replicated parameters.
"""

from __future__ import annotations

import os
from typing import Dict

import torch
import torch_dp_worker as W

from transception_tpu_torch.core.config import DataConfig, TrainConfig
from transception_tpu_torch.ops import kernels

GLOBAL_BATCH = W.GLOBAL_BATCH
# name -> (TransceptionConfig overrides, TrainConfig overrides, patches,
# steps)
CASES = {
    "default": ({}, {}, (), 1),
    "flash": (dict(ffn_flash_train=True), {}, (), 1),
    "clip": ({}, dict(grad_clipping=True), ("clip",), 1),
    "two_steps": (dict(ffn_flash_train=True), {}, (), 2),
    # The sp bridge: its qkv_linear column-parallel and gathered.
    "sp": (dict(have_bridge="sp", num_sp=1), {}, (), 1),
    # The ETB FFNs of token_mlp 'mix' (MixFFN) and 'mlp' (MLPFFN): fc1
    # column-parallel, fc2 row-parallel (ops/common.py Linear).
    "mix": (dict(token_mlp="mix"), {}, (), 1),
    "mlp": (dict(token_mlp="mlp"), {}, (), 1),
}


def trainer(name: str, out_dir: str, mesh=None, tp: int = 1, model=None,
            **tkw):
    from transception_tpu_torch.train.trainer import Trainer
    mkw, ckw, _, _ = CASES.get(name, ({}, {}, (), 1))
    tc = TrainConfig(**dict(dict(batch_size=GLOBAL_BATCH, seed=5,
                                 output_dir=out_dir, max_epochs=2,
                                 tp_size=tp), **ckw, **tkw))
    cfg = model.cfg if model is not None else W.model_cfg(**mkw)
    return Trainer(cfg, tc, DataConfig(dataset="synthetic",
                                       img_size=W.IMG, synthetic_len=8),
                   device="cpu", mesh=mesh, model=model)


def _full(tr, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A rank's tensors (by parameter or state key) in the full layout."""
    from transception_tpu_torch.parallel.mesh import gather_state_dict
    if tr.mesh.tp == 1:
        return {n: t.detach().clone() for n, t in tensors.items()}
    return {n: t.clone() for n, t in gather_state_dict(
        tensors, tr.layout, tr.mesh.axis).items()}


def run_case(name: str, out_dir: str, mesh=None) -> Dict:
    """One case on this process: its data rank's rows of each global batch
    when `mesh` is given, the whole of it otherwise."""
    tp = mesh.tp if mesh is not None else 1
    tr = trainer(name, out_dir, mesh, tp)
    state, step = tr.init_state(steps_per_epoch=10)
    rows = mesh.rows(GLOBAL_BATCH) if mesh is not None else slice(None)
    kernels.reset_launches()
    with W.patched(CASES[name][2]):
        for img, lbl in W.batches(CASES[name][3]):
            met = step(torch.from_numpy(img[rows]),
                       torch.from_numpy(lbl[rows]).long())
    opt = state.optimizer
    params = dict(tr.model.named_parameters())
    grads = _full(tr, {n: p.grad for n, p in params.items()})
    out = {"loss": float(met["loss"]), "step": state.step,
           "updates": state.updates,
           "grad_norm": float(torch.norm(torch.stack(
               [g.norm() for g in grads.values()]))),
           "grads": grads,
           "sd": _full(tr, tr.model.state_dict()),
           "mom": _full(tr, {n: opt.state[p]["momentum_buffer"]
                             for n, p in params.items()}),
           "replicated": {n: p.detach().clone() for n, p in params.items()
                          if n not in tr.layout},
           "sharded": sorted(tr.layout),
           "routed": kernels.routed_counts()}
    if name == "default":
        out["ckpt"] = tr.save_checkpoint(state)
    return out


def resume(path: str, out_dir: str, mesh=None) -> Dict:
    """The full-layout model state that a default-case Trainer of this
    rank restores from the checkpoint at `path`, and the loss of its next
    step."""
    tr = trainer("default", out_dir, mesh, mesh.tp if mesh else 1)
    state, step = tr.init_state(steps_per_epoch=10)
    tr.restore_checkpoint(state, path)
    sd = _full(tr, tr.model.state_dict())
    rows = mesh.rows(GLOBAL_BATCH) if mesh is not None else slice(None)
    img, lbl = W.batches(2)[1]
    met = step(torch.from_numpy(img[rows]),
               torch.from_numpy(lbl[rows]).long())
    return {"sd": sd, "next_loss": float(met["loss"])}


def jax_case(path: str, out_dir: str, mesh) -> float:
    """The loss of one step of the model, weights and batch saved at
    `path` (the JAX comparison's: cfg, sd, x, y)."""
    from transception_tpu_torch.models.transception import MSTransception
    blob = torch.load(path, weights_only=False)
    model = MSTransception(blob["cfg"], "cpu")
    model.load_state_dict(blob["sd"])
    tr = trainer("default", out_dir, mesh, mesh.tp, model=model,
                 batch_size=len(blob["x"]))
    _, step = tr.init_state(steps_per_epoch=4)
    rows = mesh.rows(len(blob["x"]))
    met = step(torch.from_numpy(blob["x"][rows]),
               torch.from_numpy(blob["y"][rows]).long())
    return float(met["loss"])


def rank_main(out_dir: str, dp: int, tp: int, resume_from: str,
              jax_blob: str) -> None:
    """Every case on this rank of a dp x tp launch, the resume of the
    one-process checkpoint `resume_from`, and (at dp 1) the JAX
    comparison's step; results to out_dir/rank{r}.pt."""
    from transception_tpu_torch.parallel.mesh import make_mesh
    torch.set_num_threads(1)
    mesh = make_mesh(dp, tp, device="cpu")
    r = mesh.rank * mesh.tp + mesh.t
    try:
        res: Dict = {name: run_case(name, os.path.join(out_dir, name), mesh)
                     for name in CASES}
        res["resumed"] = resume(resume_from,
                                os.path.join(out_dir, "resume"), mesh)
        if jax_blob:
            res["jax_loss"] = jax_case(jax_blob,
                                       os.path.join(out_dir, "jax"), mesh)
        res["place"] = (mesh.rank, mesh.t)
        torch.save(res, os.path.join(out_dir, f"rank{r}.pt"))
    finally:
        mesh.close()
