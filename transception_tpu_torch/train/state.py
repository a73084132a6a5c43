"""Optimizer state of the train step, PyTorch port of
transception_tpu/train/state.py.

The recipe of the reference (trainer.py:125-157): SGD with momentum 0.9
and coupled weight decay 1e-4 (decay added to the gradient before the
momentum buffer: torch.optim.SGD's own rule, and optax's
add_decayed_weights -> trace -> lr chain), the learning rate from a cosine
schedule stepped per iteration to T = epochs · steps_per_epoch (or the
(1 − t/T)^0.9 poly schedule without the scheduler), lr(0) on the first
update as optax counts. Optional clip_grad_norm_(5) before the update and
gradient accumulation over grad_accum_steps (optax MultiSteps: the update
takes the mean of the micro-steps' gradients; the schedule counts
updates). Under tensor parallelism (parallel.mesh.shard_model) the
sharded parameters' momentum lives on the shards, the clip takes the
whole model's norm, and checkpoints hold the full layout; under the
bridge's sequence sharding the partial gradients of its replicated
weights are summed over the model axis before the clip and the update.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from transception_tpu_torch.core.config import TrainConfig


def make_lr_schedule(cfg: TrainConfig,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """lr(count) for the count-th optimizer update (0-based)."""
    total = cfg.max_epochs * steps_per_epoch
    base = cfg.scaled_lr()
    if cfg.use_scheduler:
        # optax.cosine_decay_schedule(base, total, alpha=0):
        # CosineAnnealingLR with eta_min 0, per iteration.
        def cosine(count: int) -> float:
            c = min(count, total)
            return base * 0.5 * (1.0 + math.cos(math.pi * c / total))
        return cosine

    # optax.polynomial_schedule(base, 0, power=0.9, transition_steps=total).
    def poly(count: int) -> float:
        c = min(max(count, 0), total)
        return base * (1.0 - c / total) ** 0.9
    return poly


class TrainState:
    """Model, optimizer and counters of a training run. `step` counts
    train steps (micro-steps under accumulation, as the JAX TrainState's
    step); `updates` counts optimizer updates (the schedule's count).
    `gen`, the drop-path generator, is checkpointed with them."""

    CLIP_NORM = 5.0  # clip_grad_norm max_norm (trainer.py:147-148)

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig,
                 steps_per_epoch: int,
                 gen: Optional[torch.Generator] = None,
                 tp: Optional[Tuple[Dict[str, int], object]] = None,
                 partial: Sequence[str] = ()):
        """tp: (layout, axis) of a model sharded over the model axis
        (parallel.mesh.shard_model): its sharded parameters and their
        momentum live on the shards, the clip's norm counts each once,
        and state_dict / load_state_dict hold the full layout. partial:
        the replicated parameters whose gradient each rank holds in part
        (the model's partial_grads, parallel.mesh.shard_model), summed
        over the axis in one bucketed all_reduce after the backward."""
        self.model, self.cfg, self.gen = model, cfg, gen
        self.tp = tp
        self.partial = tuple(partial)
        if self.partial and tp is None:
            raise ValueError("partial gradients need the model axis (tp)")
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)
        self.optimizer = torch.optim.SGD(
            model.parameters(), lr=self.schedule(0), momentum=cfg.momentum,
            dampening=0.0, weight_decay=cfg.weight_decay, nesterov=False)
        self.step = 0
        self.updates = 0

    def ends_window(self) -> bool:
        """Whether the step about to run ends an accumulation window (its
        apply_gradients takes the update)."""
        return (self.step + 1) % self.cfg.grad_accum_steps == 0

    def zero_grad(self) -> None:
        """Clear the gradients at the start of an accumulation window."""
        if self.step % self.cfg.grad_accum_steps == 0:
            self.optimizer.zero_grad(set_to_none=True)

    def apply_gradients(self) -> None:
        """After loss.backward(): count the step, and at the end of an
        accumulation window sum the partial gradients over the model axis,
        average, clip, and take one optimizer update at lr(updates).
        Raises if a parameter got no gradient (a cut graph: optax would
        have updated it)."""
        self.step += 1
        k = self.cfg.grad_accum_steps
        if self.step % k:
            return
        params = [p for p in self.model.parameters() if p.requires_grad]
        missing = [n for n, p in self.model.named_parameters()
                   if p.requires_grad and p.grad is None]
        if missing:
            raise RuntimeError(f"{len(missing)} parameters got no gradient "
                               f"(cut graph?): {missing[:8]}")
        if self.partial:
            named = dict(self.model.named_parameters())
            self.tp[1].sum_grads_([named[n].grad for n in self.partial])
        if k > 1:
            for p in params:
                p.grad.div_(k)
        if self.cfg.grad_clipping and self.tp is None:
            torch.nn.utils.clip_grad_norm_(params, self.CLIP_NORM)
        elif self.cfg.grad_clipping:
            self._clip_sharded()
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.updates)
        self.optimizer.step()
        self.updates += 1

    def _clip_sharded(self) -> None:
        """clip_grad_norm_ of the whole model's gradient under TP: the
        squares of the sharded parameters' gradients summed over the model
        group, each replicated parameter's counted once (every rank holds
        the same), then torch's rule, max_norm / (norm + 1e-6) at most 1."""
        layout, axis = self.tp
        sq = {True: [], False: []}
        for n, p in self.model.named_parameters():
            if p.requires_grad:
                sq[n in layout].append(
                    torch.linalg.vector_norm(p.grad.float()) ** 2)
        z = torch.zeros((), device=next(self.model.parameters()).device)
        shard = axis.all_reduce_(torch.stack(sq[True]).sum() if sq[True]
                                 else z.clone())
        rep = torch.stack(sq[False]).sum() if sq[False] else z
        norm = torch.sqrt(rep + shard)
        coef = torch.clamp(self.CLIP_NORM / (norm + 1e-6), max=1.0)
        for p in self.model.parameters():
            if p.requires_grad:
                p.grad.mul_(coef.to(p.grad.dtype))

    def _names(self):
        """Parameter names in the optimizer's index order."""
        return [n for n, _ in self.model.named_parameters()]

    def state_dict(self) -> dict:
        """Model, optimizer, schedule, step and generator; under TP the
        full layout (a collective: every rank of the model group calls
        it)."""
        model, opt = self.model.state_dict(), self.optimizer.state_dict()
        if self.tp is not None:
            from transception_tpu_torch.parallel.mesh import (
                gather_state_dict,
            )
            layout, axis = self.tp
            model = gather_state_dict(model, layout, axis)
            names = self._names()
            bufs = {names[i]: st["momentum_buffer"]
                    for i, st in opt["state"].items()
                    if st.get("momentum_buffer") is not None}
            full = gather_state_dict(bufs, layout, axis)
            opt = dict(opt, state={
                i: dict(st, momentum_buffer=full[names[i]])
                if names[i] in full else st
                for i, st in opt["state"].items()})
        sd = {"model": model,
              "optimizer": opt,
              "schedule": {"updates": self.updates,
                           "lr": self.schedule(self.updates)},
              "step": self.step}
        if self.gen is not None:
            sd["gen"] = self.gen.get_state()
        return sd

    def load_state_dict(self, sd: dict) -> None:
        """A state_dict of the full layout (any tp); under TP this rank
        takes its shards."""
        model, opt = sd["model"], sd["optimizer"]
        if self.tp is not None:
            from transception_tpu_torch.parallel.mesh import (
                shard_state_dict,
            )
            layout, axis = self.tp
            model = shard_state_dict(model, layout, axis.size, axis.rank)
            names = self._names()
            bufs = shard_state_dict(
                {names[i]: st["momentum_buffer"]
                 for i, st in opt["state"].items()
                 if st.get("momentum_buffer") is not None},
                layout, axis.size, axis.rank)
            opt = dict(opt, state={
                i: dict(st, momentum_buffer=bufs[names[i]])
                if names[i] in bufs else st
                for i, st in opt["state"].items()})
        self.model.load_state_dict(model)
        self.optimizer.load_state_dict(opt)
        self.updates = int(sd["schedule"]["updates"])
        self.step = int(sd["step"])
        if self.gen is not None and "gen" in sd:
            self.gen.set_state(sd["gen"].cpu())
