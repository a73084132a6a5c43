"""The train step and the train loop, PyTorch port of
transception_tpu/train/trainer.py:90-151,308-389.

One step: the forward in train mode (batch-statistics BatchNorm, the
wide head when TrainConfig.wide_loss), 0.4·CE + 0.6·Dice, backward, and
the SGD update with its per-iteration schedule (train.state). The kernels
that run are those of the JAX package's train_step_model (trainer.py:
90-119), which the model picks in train mode (ops.kernels.kernel_set).
The step takes no random generator: on the published
config the JAX step's dropout key reaches nothing (MixFFN_skip has no
dropout, drop_path_rate is 0, and the MLP FFN whose dropout it would feed
is not ported).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

from transception_tpu_torch.core.config import (
    DataConfig,
    TrainConfig,
    TransceptionConfig,
)
from transception_tpu_torch.core.device import DeviceLike, resolve_device
from transception_tpu_torch.data.device_synthetic import DeviceSyntheticStream
from transception_tpu_torch.models.transception import MSTransception
from transception_tpu_torch.train.losses import (
    segmentation_loss,
    shuffle_labels_wide,
)
from transception_tpu_torch.train.state import TrainState

logger = logging.getLogger("transception_tpu_torch")


def make_train_step(state: TrainState, num_classes: int, ce_w: float,
                    dice_w: float, wide_head: bool = False):
    """step(images, labels) -> {loss, loss_ce, loss_dice} (detached
    tensors): forward in train mode, loss, backward, update. wide_head:
    logits in pre-pixel-shuffle order against the permuted labels
    (the same loss up to fp32 summation order)."""
    model = state.model

    def train_step(images: torch.Tensor,
                   labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        model.train()
        state.zero_grad()
        out = model(images, wide_head=wide_head)
        if wide_head:
            labels = shuffle_labels_wide(labels)
        total, ce, dc = segmentation_loss(out, labels, num_classes, ce_w,
                                          dice_w)
        total.backward()
        state.apply_gradients()
        return {"loss": total.detach(), "loss_ce": ce.detach(),
                "loss_dice": dc.detach()}

    return train_step


class Trainer:
    """Training on the synthetic on-device stream.

    Ported: the train step, the iteration log line (every 50 iterations,
    as the JAX loop, and after the last), checkpoints of model,
    optimizer, schedule and step (torch.save, output_dir/ckpt/
    step_XXXXXXXX.pt, every ckpt_every epochs and at the end) and
    auto-resume from the newest. Not ported yet: the in-training volume
    eval (run_inference and the metrics), the host Synapse/ISIC loaders
    with their augment, TensorBoard and the reference eval schedule;
    `train` raises for a dataset other than "synthetic"."""

    def __init__(self, model_cfg: TransceptionConfig, train_cfg: TrainConfig,
                 data_cfg: DataConfig, device: DeviceLike = "cuda"):
        self.model_cfg, self.cfg, self.data_cfg = model_cfg, train_cfg, \
            data_cfg
        self.device = resolve_device(device)
        self.model = MSTransception(model_cfg, self.device,
                                    seed=train_cfg.seed)
        os.makedirs(train_cfg.output_dir, exist_ok=True)

    def _use_wide_head(self) -> bool:
        return self.cfg.wide_loss and self.data_cfg.img_size % 4 == 0

    def _ckpt_dir(self) -> str:
        return os.path.abspath(os.path.join(self.cfg.output_dir, "ckpt"))

    def save_checkpoint(self, state: TrainState) -> str:
        os.makedirs(self._ckpt_dir(), exist_ok=True)
        path = os.path.join(self._ckpt_dir(), f"step_{state.step:08d}.pt")
        torch.save(state.state_dict(), path + ".tmp")
        os.replace(path + ".tmp", path)
        logger.info("saved checkpoint to %s", path)
        return path

    def latest_checkpoint(self) -> Optional[str]:
        d = self._ckpt_dir()
        if not os.path.isdir(d):
            return None
        steps = sorted(p for p in os.listdir(d)
                       if p.startswith("step_") and p.endswith(".pt"))
        return os.path.join(d, steps[-1]) if steps else None

    def restore_checkpoint(self, state: TrainState, path: str) -> None:
        state.load_state_dict(torch.load(path, map_location=self.device,
                                         weights_only=True))

    def train(self, max_steps: Optional[int] = None
              ) -> Tuple[TrainState, Dict[str, List[float]]]:
        """Run the loop to max_steps train steps in all (or max_epochs).
        Returns the state and the per-step loss, ce and dice of this run."""
        if self.data_cfg.dataset != "synthetic":
            raise NotImplementedError(
                "the port trains on the synthetic on-device stream only; "
                "the Synapse/ISIC loaders are not ported yet")
        handler = logging.FileHandler(
            os.path.join(self.cfg.output_dir, "log.txt"))
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s.%(msecs)03d] %(message)s", datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        try:
            return self._train_loop(max_steps)
        finally:
            logger.removeHandler(handler)
            handler.close()

    def _train_loop(self, max_steps):
        cfg, dc = self.cfg, self.data_cfg
        loader = DeviceSyntheticStream(cfg.batch_size, dc.img_size,
                                       dc.num_classes, dc.synthetic_len,
                                       cfg.seed, self.device)
        steps_per_epoch = len(loader)
        logger.info("%d iterations per epoch, %d max iterations",
                    steps_per_epoch, steps_per_epoch * cfg.max_epochs)
        state = TrainState(self.model, cfg, steps_per_epoch)
        latest = self.latest_checkpoint() if cfg.resume else None
        if latest:
            self.restore_checkpoint(state, latest)
            logger.info("resumed from %s (step %d)", latest, state.step)
        step_fn = make_train_step(state, dc.num_classes, cfg.ce_weight,
                                  cfg.dice_weight, self._use_wide_head())
        hist: List[Dict[str, torch.Tensor]] = []
        it = state.step
        total_steps = max_steps or steps_per_epoch * cfg.max_epochs
        t0, it0 = time.time(), it
        done = it >= total_steps
        for epoch in range(it // max(steps_per_epoch, 1), cfg.max_epochs):
            if done:
                break
            loader.set_epoch(epoch)
            for batch in loader:
                metrics = step_fn(batch["image"], batch["label"])
                hist.append(metrics)
                it += 1
                done = it >= total_steps
                if it % 50 == 0 or done:
                    m = {k: float(v) for k, v in metrics.items()}
                    logger.info(
                        "iteration %d : lr %.6f loss %.4f ce %.4f dice %.4f "
                        "(%.1f img/s)", it, state.schedule(it), m["loss"],
                        m["loss_ce"], m["loss_dice"],
                        (it - it0) * cfg.batch_size
                        / max(time.time() - t0, 1e-9))
                    t0, it0 = time.time(), it
                if done:
                    break
            if done or (epoch + 1) % cfg.ckpt_every == 0:
                self.save_checkpoint(state)
        keys = ("loss", "loss_ce", "loss_dice")
        out = {k: (torch.stack([h[k] for h in hist]).tolist() if hist
                   else []) for k in keys}
        return state, out
