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
rank's replicated parameters. The "seq" cases run the original bridge's
sequence sharding (bridge_seq_shard_axis "model"); FAULTS plant a fault
in it each (run on the dp1 x tp2 mesh only), which the comparison must
see. SEQ_EVALS are eval forwards of the sequence-sharded model.
"""

from __future__ import annotations

import contextlib
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
    # The original bridge's sequence sharding: its query rows and its
    # divisible scales' FFN map rows (8², 4², 2² at tp 2; 8², 4² at tp 4)
    # split over the model axis, in the default mode (the plain FFN on
    # row blocks, K3's and K10's plain versions on query rows) and the
    # flash mode (the FFN folds on row blocks: K2's and K11's plain
    # versions); two flash steps with the clip.
    "seq": (dict(bridge_seq_shard_axis="model"), {}, (), 1),
    "seq_flash": (dict(bridge_seq_shard_axis="model", ffn_flash_train=True),
                  {}, (), 1),
    "seq_clip2": (dict(bridge_seq_shard_axis="model", ffn_flash_train=True),
                  dict(grad_clipping=True), ("clip",), 2),
}
# Planted faults of the sequence sharding, each on the "seq" case: a
# block's halo rows dropped, the partial gradients left unsummed, the
# attention's dk/dv left unsummed.
FAULTS = {"seq_no_halo": "halo", "seq_no_grad_sum": "grad_sum",
          "seq_no_dkdv_sum": "dkdv"}
# Eval forwards of the sequence-sharded model: the default folds (K3 on
# the query rows, the plain FFN on map rows) and the bridge's folds on
# (K8 on the query rows, K2 on map rows).
SEQ_EVALS = {"seq": {}, "seq_folds": dict(bridge_attn_fold=True,
                                          bridge_ffn_use_pallas=True)}
# The cases of tests/test_torch_tp_layouts.py: the legacy models and the
# per-path MHCA layout (vectorize_paths False), name -> (registry model,
# TransceptionConfig overrides, TrainConfig overrides, patches, steps).
# The legacy models at dil_conv 0 (their dilated schedules need larger
# maps); the ResInceptions at 64², whose MultiRes branches' train-mode
# BatchNorms at 32² normalise the 1 x 1 deepest maps over the batch's 4
# values a channel: ResInception-135's one-process step then moves by
# 0.17 of the gradient limit between two torch thread counts, and the
# hidden width's sums in another order move it past the limit (at 64²:
# 0.16 of it); MISSFormer with bridge_seq_shard_axis "model", which its bridge
# ignores (as the JAX MISSFormer's); the per-path MSTransception in the
# default mode (its MHCA blocks' sharded qkv and FFNs plain), the flash
# mode (their FFN folds on the hidden-sharded K2 and K11 at the even
# sides) and the "pallas" mode (the rate-0 block as K5's sharded form,
# the drop-path block's FFN as K9's).
LEGACY = dict(dil_conv=0)
PER_PATH = dict(vectorize_paths=False)
LAYOUT_CASES = {
    **{n: (n, LEGACY, {}, (), 1) for n in (
        "transception", "missformer", "effmissformer")},
    **{n: (n, dict(LEGACY, img_size=64), {}, (), 1) for n in (
        "resinception", "resinception_135")},
    "missformer_seq": ("missformer", dict(LEGACY,
                                          bridge_seq_shard_axis="model"),
                       {}, (), 1),
    "paths_default": ("mstransception", PER_PATH, {}, (), 1),
    "paths_flash": ("mstransception", dict(PER_PATH, ffn_flash_train=True),
                    {}, (), 1),
    "paths_pallas": ("mstransception", dict(
        PER_PATH, use_pallas_train=True, mhca_ffn_fold=True,
        drop_path_rate=0.1), {}, (), 1),
}
# The cases of the dp1 x tp4 launch.
LAYOUT_TP4 = ("missformer", "paths_pallas")
# Eval forwards of the sharded per-path model (K5's sharded form).
PATH_EVALS = {"paths": dict(PER_PATH)}


@contextlib.contextmanager
def seq_fault(fault):
    """The planted fault `fault` of FAULTS in the sequence sharding."""
    from transception_tpu_torch.models import bridge
    from transception_tpu_torch.ops.kernels import mixffn
    from transception_tpu_torch.parallel.tensor import ModelAxis
    saved = (mixffn.halo_rows, ModelAxis.sum_grads_,
             bridge.MEfficientSelfAtten.forward)
    if fault == "halo":
        mixffn.halo_rows = lambda s, r0, r1: (r0, r1)
    if fault == "grad_sum":
        ModelAxis.sum_grads_ = lambda self, tensors: None
    if fault == "dkdv":
        attend = bridge.MEfficientSelfAtten.forward

        def forward(self, x, residual=None, axis=None):
            # The forward's first copy is K and V's: made the identity
            # both ways, each rank keeps its partial dk/dv.
            copy, first = ModelAxis.copy, []

            def once(ax, t):
                if not first:
                    first.append(t)
                    return t.view_as(t)
                return copy(ax, t)

            ModelAxis.copy = once
            try:
                return attend(self, x, residual, axis)
            finally:
                ModelAxis.copy = copy

        bridge.MEfficientSelfAtten.forward = forward
    try:
        yield
    finally:
        (mixffn.halo_rows, ModelAxis.sum_grads_,
         bridge.MEfficientSelfAtten.forward) = saved


def case(name: str):
    """(registry model, TransceptionConfig overrides, TrainConfig
    overrides, patches, steps) of a case of CASES or LAYOUT_CASES."""
    if name in LAYOUT_CASES:
        return LAYOUT_CASES[name]
    return ("mstransception",) + CASES.get(name, ({}, {}, (), 1))


def trainer(name: str, out_dir: str, mesh=None, tp: int = 1, model=None,
            **tkw):
    from transception_tpu_torch.models.registry import create_model
    from transception_tpu_torch.train.trainer import Trainer
    reg, mkw, ckw, _, _ = case(name)
    tc = TrainConfig(**dict(dict(batch_size=GLOBAL_BATCH, seed=5,
                                 output_dir=out_dir, max_epochs=2,
                                 tp_size=tp), **ckw, **tkw))
    if model is None and reg != "mstransception":
        model = create_model(reg, W.model_cfg(**mkw), "cpu", seed=5)
    cfg = model.cfg if model is not None else W.model_cfg(**mkw)
    return Trainer(cfg, tc, DataConfig(dataset="synthetic",
                                       img_size=cfg.img_size,
                                       synthetic_len=8),
                   device="cpu", mesh=mesh, model=model)


def _full(tr, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A rank's tensors (by parameter or state key) in the full layout."""
    from transception_tpu_torch.parallel.mesh import gather_state_dict
    if tr.mesh.tp == 1:
        return {n: t.detach().clone() for n, t in tensors.items()}
    return {n: t.clone() for n, t in gather_state_dict(
        tensors, tr.layout, tr.mesh.axis).items()}


def run_case(name: str, out_dir: str, mesh=None, fault: str = "") -> Dict:
    """One case on this process: its data rank's rows of each global batch
    when `mesh` is given, the whole of it otherwise; with the planted
    fault `fault` (FAULTS)."""
    tp = mesh.tp if mesh is not None else 1
    tr = trainer(name, out_dir, mesh, tp)
    state, step = tr.init_state(steps_per_epoch=10)
    rows = mesh.rows(GLOBAL_BATCH) if mesh is not None else slice(None)
    kernels.reset_launches()
    _, _, _, patches, steps = case(name)
    with W.patched(patches), seq_fault(fault):
        for img, lbl in W.batches(steps, tr.model.cfg.img_size):
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
           "partial": sorted(tr.partial),
           "routed": kernels.routed_counts()}
    if name in ("default", "missformer"):
        out["ckpt"] = tr.save_checkpoint(state)
    return out


def resume(path: str, out_dir: str, mesh=None, name: str = "default"
           ) -> Dict:
    """The full-layout model state that a Trainer of case `name` (the
    default case's by default) of this rank restores from the checkpoint
    at `path`, and the loss of its next step."""
    tr = trainer(name, out_dir, mesh, mesh.tp if mesh else 1)
    state, step = tr.init_state(steps_per_epoch=10)
    tr.restore_checkpoint(state, path)
    sd = _full(tr, tr.model.state_dict())
    rows = mesh.rows(GLOBAL_BATCH) if mesh is not None else slice(None)
    img, lbl = W.batches(2)[1]
    met = step(torch.from_numpy(img[rows]),
               torch.from_numpy(lbl[rows]).long())
    return {"sd": sd, "next_loss": float(met["loss"])}


def seq_eval(over: Dict, mesh=None, seq: bool = True) -> torch.Tensor:
    """The eval logits of the seeded model with the sequence sharding
    (seq) and `over` on this rank's data rows of the global batch, its
    model sharded over the mesh's model axis (shard_model); the
    launches the forward routed (routed_counts) as seq_eval.routed."""
    from transception_tpu_torch.models.transception import MSTransception
    from transception_tpu_torch.parallel.mesh import shard_model
    if seq:
        over = dict(over, bridge_seq_shard_axis="model")
    model = MSTransception(W.model_cfg(**over), "cpu", seed=5)
    if mesh is not None and mesh.tp > 1:
        shard_model(model, mesh.axis)
    rows = mesh.rows(GLOBAL_BATCH) if mesh is not None else slice(None)
    kernels.reset_launches()
    with torch.no_grad():
        out = model(torch.from_numpy(W.batches(1)[0][0][rows]))
    seq_eval.routed = kernels.routed_counts()
    return out


def jax_forward(path: str, mesh) -> torch.Tensor:
    """The eval logits of the model, weights and batch saved at `path`
    (the JAX comparison's: cfg, sd, x, and the registry name) on this
    rank's data rows, sharded over the mesh's model axis."""
    from transception_tpu_torch.models.registry import create_model
    from transception_tpu_torch.parallel.mesh import shard_model
    blob = torch.load(path, weights_only=False)
    model = create_model(blob.get("name", "mstransception"), blob["cfg"],
                         "cpu")
    model.load_state_dict(blob["sd"])
    shard_model(model, mesh.axis)
    with torch.no_grad():
        return model(torch.from_numpy(blob["x"][mesh.rows(len(blob["x"]))]))


def jax_loss(path: str, mesh) -> float:
    """The train loss (0.4 CE + 0.6 Dice, train.losses) of jax_forward's
    logits on the labels saved at `path`."""
    from transception_tpu_torch.train.losses import segmentation_loss
    logits = jax_forward(path, mesh)
    y = torch.load(path, weights_only=False)["y"]
    return float(segmentation_loss(
        logits, torch.from_numpy(y[mesh.rows(len(y))]).long(),
        logits.shape[-1])[0])


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


def layout_main(meshes, resume_from: str) -> None:
    """On this rank, for each mesh of `meshes` in turn ((out_dir, dp, tp,
    names, jax_blobs), as rank_main's): the LAYOUT_CASES `names`, the
    per-path eval forwards, the resume of the one-process MISSFormer
    checkpoint `resume_from` and, where jax_blobs are given (name -> the
    path of a JAX comparison's blob), the loss of each one's sharded
    forward; results to out_dir/rank{r}.pt."""
    from transception_tpu_torch.parallel.mesh import make_mesh
    torch.set_num_threads(1)
    made = []
    try:
        for out_dir, dp, tp, names, jax_blobs in meshes:
            mesh = make_mesh(dp, tp, device="cpu")
            made.append(mesh)
            res: Dict = {name: run_case(name, os.path.join(out_dir, name),
                                        mesh) for name in names}
            res["evals"] = {}
            for name, over in PATH_EVALS.items():
                res["evals"][name] = seq_eval(over, mesh, seq=False)
                res["evals"][name + "_routed"] = seq_eval.routed
            res["resumed"] = resume(resume_from,
                                    os.path.join(out_dir, "resume"), mesh,
                                    "missformer")
            res["jax"] = {n: jax_loss(p, mesh) for n, p in jax_blobs.items()}
            res["place"] = (mesh.rank, mesh.t)
            r = mesh.rank * mesh.tp + mesh.t
            torch.save(res, os.path.join(out_dir, f"rank{r}.pt"))
    finally:
        for mesh in reversed(made):
            mesh.close()


def rank_main(meshes, resume_from: str) -> None:
    """On this rank, for each mesh of `meshes` in turn ((out_dir, dp, tp,
    jax_blobs), dp·tp the launch's world each: one launch runs the meshes
    of one world on one process group, each mesh its own data and model
    groups): every case and sequence-sharded eval, the resume of the
    one-process checkpoint `resume_from`, and, where jax_blobs are given
    (at dp 1), the planted faults and the JAX comparisons' step and
    forward (jax_blobs: "step", "forward"); results to
    out_dir/rank{r}.pt."""
    from transception_tpu_torch.parallel.mesh import make_mesh
    torch.set_num_threads(1)
    made = []
    try:
        for out_dir, dp, tp, jax_blobs in meshes:
            mesh = make_mesh(dp, tp, device="cpu")
            made.append(mesh)
            res: Dict = {name: run_case(name, os.path.join(out_dir, name),
                                        mesh) for name in CASES}
            res["evals"] = {name: seq_eval(over, mesh)
                            for name, over in SEQ_EVALS.items()}
            res["resumed"] = resume(resume_from,
                                    os.path.join(out_dir, "resume"), mesh)
            if jax_blobs:
                res["faults"] = {
                    name: run_case("seq", os.path.join(out_dir, name), mesh,
                                   fault) for name, fault in FAULTS.items()}
                res["jax_loss"] = jax_case(jax_blobs["step"],
                                           os.path.join(out_dir, "jax"), mesh)
                res["jax_logits"] = jax_forward(jax_blobs["forward"], mesh)
            res["place"] = (mesh.rank, mesh.t)
            r = mesh.rank * mesh.tp + mesh.t
            torch.save(res, os.path.join(out_dir, f"rank{r}.pt"))
    finally:
        for mesh in reversed(made):  # the first owns the process group
            mesh.close()
