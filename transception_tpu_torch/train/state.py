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
updates).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

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
                 gen: Optional[torch.Generator] = None):
        self.model, self.cfg, self.gen = model, cfg, gen
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
        accumulation window average, clip, and take one optimizer update
        at lr(updates). Raises if a parameter got no gradient (a cut
        graph: optax would have updated it)."""
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
        if k > 1:
            for p in params:
                p.grad.div_(k)
        if self.cfg.grad_clipping:
            torch.nn.utils.clip_grad_norm_(params, self.CLIP_NORM)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.updates)
        self.optimizer.step()
        self.updates += 1

    def state_dict(self) -> dict:
        sd = {"model": self.model.state_dict(),
              "optimizer": self.optimizer.state_dict(),
              "schedule": {"updates": self.updates,
                           "lr": self.schedule(self.updates)},
              "step": self.step}
        if self.gen is not None:
            sd["gen"] = self.gen.get_state()
        return sd

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.updates = int(sd["schedule"]["updates"])
        self.step = int(sd["step"])
        if self.gen is not None and "gen" in sd:
            self.gen.set_state(sd["gen"].cpu())
