"""The train step and the train loop, PyTorch port of
transception_tpu/train/trainer.py:41-450.

One step: the forward in train mode (batch-statistics BatchNorm, the
wide head when TrainConfig.wide_loss), 0.4·CE + 0.6·Dice, backward, and
the SGD update with its per-iteration schedule (train.state). The kernels
that run are those of the JAX package's train_step_model (trainer.py:
90-119), which the model picks in train mode (ops.kernels.kernel_set).
The step's random generator is the JAX step's dropout key: it draws the
MHCA blocks' drop-path masks (drop_path_rate > 0) and the dropout masks of
the sp bridge's MLP FFN. The Trainer makes it on
the model's device from TrainConfig.seed, each step advances it, and the
checkpoint keeps its state, so that a resumed run draws the masks an
uninterrupted one would.

The loop (Trainer.train) is the JAX one: Synapse, ISIC 2018 or synthetic
slices through HostDataLoader (or, with DataConfig.device_data, the
synthetic batches made on the device), the iteration log line every 50
steps, checkpoints and the in-training eval (run_inference over volumes;
data.isic.dice_eval over ISIC images) on the 'interval' or 'reference'
schedule and at the end, TensorBoard scalars
and images, results.tsv and the curves.

Data parallelism (TrainConfig.dp_size, parallel.mesh): each rank loads
its shard of every global batch (TrainConfig.batch_size is the global
batch, and the learning rate scales by it), the model runs under
DistributedDataParallel, and the step runs inside
parallel.mesh.data_parallel, which makes the BatchNorm moments, the Dice
sums and the drop-path and dropout masks those of the global batch: the
step is the one-process step on the global batch. Under accumulation the
micro-steps skip the gradient all-reduce (no_sync). Checkpoints hold the
bare model's keys (no "module." prefix), so a run of any world size
resumes any other's; logs, TensorBoard, results.tsv and checkpoints come
from rank 0, and every rank takes its shard of the in-training eval
(chunks of eval_batch(world) slices).
"""

from __future__ import annotations

import contextlib
import csv
import inspect
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from transception_tpu_torch.core.config import (
    DataConfig,
    TrainConfig,
    TransceptionConfig,
)
from transception_tpu_torch.core.device import DeviceLike, fp32_exact
from transception_tpu_torch.data.device_synthetic import DeviceSyntheticStream
from transception_tpu_torch.data.isic import dice_eval
from transception_tpu_torch.data.loader import HostDataLoader, to_device
from transception_tpu_torch.data.synapse import (
    make_test_dataset,
    make_train_dataset,
)
from transception_tpu_torch.eval.inference import class_ids, run_inference
from transception_tpu_torch.models.transception import MSTransception
from transception_tpu_torch.parallel.mesh import (
    DataMesh,
    data_parallel,
    launch_world,
    launched,
    make_mesh,
    mean_over_ranks,
)
from transception_tpu_torch.train.losses import (
    segmentation_loss,
    shuffle_labels_wide,
)
from transception_tpu_torch.train.state import TrainState

logger = logging.getLogger("transception_tpu_torch")

# Slices per chunk of the in-training eval (run_inference's default); under
# a mesh the chunk is the least multiple of the world at or above it, so
# that it splits over the ranks (eval_batch).
EVAL_BATCH = 32


def eval_batch(world: int) -> int:
    """The in-training eval's chunk for a data axis of `world` ranks:
    EVAL_BATCH where the world divides it (1, 2, 4, 8, ...), else the next
    multiple of the world (33 at 3 ranks)."""
    return -(-EVAL_BATCH // world) * world


def reference_eval_schedule(epoch: int, max_epoch: int, eval_interval: int,
                            initial_interval: int = 20
                            ) -> Tuple[bool, bool]:
    """Recipe-exact checkpoint/eval cadence of the reference
    (trainer.py:179-226), as (save, evaluate) for 0-based `epoch`:

    - phase 1 (epoch in [max/2, max-100)): every `initial_interval` epochs;
    - phase 2 (epoch >= max-100): every `eval_interval` epochs;
    - last epoch: always save; evaluate via whichever branch applies
      (the reference's last-epoch block skips eval only when the phase-2
      rule already ran it that same epoch).
    """
    phase1 = (int(max_epoch / 2) <= epoch < int(max_epoch - 100)
              and (epoch + 1) % initial_interval == 0)
    phase2 = (epoch >= int(max_epoch - 100)
              and (epoch + 1) % eval_interval == 0)
    last = epoch >= max_epoch - 1
    save = phase1 or phase2 or last
    evaluate = phase1 or phase2 or (last and (epoch + 1) % eval_interval != 0)
    return save, evaluate


def make_train_step(state: TrainState, num_classes: int, ce_w: float,
                    dice_w: float, wide_head: bool = False,
                    gen: Optional[torch.Generator] = None,
                    net: Optional[torch.nn.Module] = None,
                    mesh: Optional[DataMesh] = None):
    """step(images, labels) -> {loss, loss_ce, loss_dice} (detached
    tensors): forward in train mode, loss, backward, update. wide_head:
    logits in pre-pixel-shuffle order against the permuted labels
    (the same loss up to fp32 summation order). gen: the drop-path and
    dropout generator, on the model's device (needed with drop_path_rate
    > 0 and by the sp bridge's MLP dropout). net: what runs the forward,
    state.model or its DistributedDataParallel wrapper; with `mesh` the
    step takes this rank's rows of the global batch inside
    data_parallel(mesh), and the metrics are the global batch's (the
    ranks' means averaged)."""
    model = state.model
    net = model if net is None else net
    ddp = isinstance(net, torch.nn.parallel.DistributedDataParallel)
    # The generator where the model draws masks (MSTransception); the wide
    # head where asked (the legacy models have neither).
    kw = {"gen": gen} if "gen" in inspect.signature(
        model.forward).parameters else {}
    if wide_head:
        kw["wide_head"] = True

    def train_step(images: torch.Tensor,
                   labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        net.train()
        state.zero_grad()
        sync = not ddp or state.ends_window()
        with data_parallel(mesh), \
                (contextlib.nullcontext() if sync else net.no_sync()):
            out = net(images, **kw)
            if wide_head:
                labels = shuffle_labels_wide(labels)
            total, ce, dc = segmentation_loss(out, labels, num_classes,
                                              ce_w, dice_w)
            total.backward()
        state.apply_gradients()
        m = mean_over_ranks(torch.stack([total, ce, dc]).detach(), mesh)
        return {"loss": m[0], "loss_ce": m[1], "loss_dice": m[2]}

    return train_step


def _log_images(writer, model, images, labels, it):
    """TensorBoard image triplets (trainer.py:167-174 of the reference):
    sample 0's input normalised to [0, 1], its argmax prediction x50 and
    its label x50."""
    img = images[0, :, :, 0].float().cpu().numpy()
    rng = img.max() - img.min()
    img = (img - img.min()) / (rng if rng > 0 else 1.0)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            pred = class_ids(model, images[:1])[0].cpu().numpy()
    finally:
        model.train(was_training)
    writer.add_image("train/Image", img[None], it)
    writer.add_image("train/Prediction",
                     (pred.astype(np.int64) * 50).astype(np.uint8)[None], it)
    writer.add_image("train/GroundTruth",
                     (labels[0].cpu().numpy() * 50).astype(np.uint8)[None],
                     it)


def _tsv_cell(v) -> str:
    """A value as pandas' DataFrame.to_csv writes a float64 cell: numpy's
    shortest repr, NaN as the empty string."""
    v = np.float64(v)
    return "" if np.isnan(v) else str(v)


def write_results_tsv(path: str, dice_hist: List[float],
                      hd95_hist: List[float]) -> None:
    """results.tsv as the JAX package writes it (pandas.DataFrame({
    "mean_dice", "mean_hd95"}).to_csv(sep="\t"), trainer.py:436-438):
    the same bytes, with the csv module."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator=os.linesep)
        w.writerow(["", "mean_dice", "mean_hd95"])
        for i, (d, h) in enumerate(zip(dice_hist, hd95_hist)):
            w.writerow([str(i), _tsv_cell(d), _tsv_cell(h)])


class Trainer:
    """End-to-end Synapse (or ISIC 2018) trainer (the reference's
    trainer_synapse), on the card unless `device` says otherwise.

    Checkpoints keep model, optimizer, schedule, step and the drop-path
    generator's state (torch.save, output_dir/ckpt/step_XXXXXXXX.pt);
    train() resumes from the newest. Logs go to output_dir/log.txt,
    TensorBoard's to output_dir/tb (when the tensorboard package is
    installed), the eval histories to output_dir/results.tsv.

    mesh: this process's place on the data axis (parallel.mesh.DataMesh);
    by default the launch's: make_mesh of train_cfg.dp_size where it is
    above 0, else of the launch's world (torchrun, or the CLI's
    --dp_size), which is 1 in a process that no launch started. A
    Trainer never starts ranks, so "every visible card" (dp_size -1) is
    the CLI's to carry out. tp_size > 1 is refused."""

    def __init__(self, model_cfg: TransceptionConfig, train_cfg: TrainConfig,
                 data_cfg: DataConfig, device: DeviceLike = "cuda",
                 model: Optional[torch.nn.Module] = None,
                 mesh: Optional[DataMesh] = None):
        if train_cfg.tp_size > 1:
            raise NotImplementedError(
                f"tp_size {train_cfg.tp_size}: the TP axis is not ported "
                f"(ROADMAP.md §1 item 4); train with tp_size 1")
        self.model_cfg, self.cfg, self.data_cfg = model_cfg, train_cfg, \
            data_cfg
        # The data axis: this process's rank (make_mesh raises, before any
        # work, for more ranks than cards or than the launch has); a world
        # of one has no group.
        if mesh is None:
            dp = train_cfg.dp_size if train_cfg.dp_size > 0 else (
                launch_world() if launched() else 1)
            mesh = make_mesh(dp, 1, device)
        self.mesh = mesh
        self.device = self.mesh.device
        self.main = self.mesh.is_main
        # Any registry model (the CLIs pass models.registry.create_model's);
        # by default the MSTransception of model_cfg.
        self.model = model if model is not None else MSTransception(
            model_cfg, self.device, seed=train_cfg.seed)
        os.makedirs(train_cfg.output_dir, exist_ok=True)

    def _use_wide_head(self) -> bool:
        """The wide-layout loss (TrainConfig.wide_loss): MSTransception
        only (the legacy models have no wide head, JAX trainer.py:
        202-209), and the label shuffle needs img_size % 4 == 0."""
        return (self.cfg.wide_loss and isinstance(self.model, MSTransception)
                and self.data_cfg.img_size % 4 == 0)

    def _ckpt_dir(self) -> str:
        return os.path.abspath(os.path.join(self.cfg.output_dir, "ckpt"))

    def _dp(self) -> Optional[DataMesh]:
        """The mesh where this run has a process group, else None."""
        return self.mesh if self.mesh.group is not None else None

    def init_state(self, steps_per_epoch: int):
        """(TrainState, step function) of a run: the drop-path generator
        seeded TrainConfig.seed on the device, and under a process group
        the model wrapped in DistributedDataParallel (the bare model stays
        the state's, so checkpoints keep its keys)."""
        cfg, dc = self.cfg, self.data_cfg
        gen = torch.Generator(device=self.device)
        gen.manual_seed(cfg.seed)
        state = TrainState(self.model, cfg, steps_per_epoch, gen)
        net = self.model
        if self._dp() is not None:
            net = torch.nn.parallel.DistributedDataParallel(
                self.model,
                device_ids=([self.device] if self.device.type == "cuda"
                            else None),
                broadcast_buffers=False)
        step_fn = make_train_step(state, dc.num_classes, cfg.ce_weight,
                                  cfg.dice_weight, self._use_wide_head(),
                                  gen, net, self._dp())
        return state, step_fn

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

    def _loader(self):
        cfg, dc = self.cfg, self.data_cfg
        if dc.device_data:
            assert dc.dataset == "synthetic", (
                "--device_data generates random batches on the device; it "
                "is only meaningful for the synthetic dataset")
            return DeviceSyntheticStream(cfg.batch_size, dc.img_size,
                                         dc.num_classes, dc.synthetic_len,
                                         cfg.seed, self.device,
                                         self.mesh.rank, self.mesh.world)
        return HostDataLoader(make_train_dataset(dc), cfg.batch_size,
                              shuffle=True, seed=cfg.seed,
                              num_workers=dc.num_workers,
                              process_index=self.mesh.rank,
                              process_count=self.mesh.world)

    def train(self, max_steps: Optional[int] = None
              ) -> Tuple[TrainState, Dict[str, List[float]]]:
        """Run the loop to max_steps train steps in all (or max_epochs),
        with the evals of the schedule and one at the end. Returns the
        state and the mean dice and HD95 of each eval, as the JAX
        Trainer."""
        test_ds = make_test_dataset(self.data_cfg)
        loader = self._loader()
        handler = None
        if self.main:
            handler = logging.FileHandler(
                os.path.join(self.cfg.output_dir, "log.txt"))
            handler.setFormatter(logging.Formatter(
                "[%(asctime)s.%(msecs)03d] %(message)s",
                datefmt="%H:%M:%S"))
            logger.addHandler(handler)
            logger.setLevel(logging.INFO)
        exact = (self.device.type == "cuda"
                 and self.model_cfg.compute_dtype == torch.float32)
        try:
            with fp32_exact(exact, self._log):
                return self._train_loop(loader, test_ds, max_steps)
        finally:
            if handler is not None:
                logger.removeHandler(handler)
                handler.close()

    def _log(self, msg: str) -> None:
        if self.main:
            logger.info(msg)

    def _writer(self):
        """A TensorBoard SummaryWriter under output_dir/tb, or None (with
        one log line) where the tensorboard package is not installed."""
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            logger.info("TensorBoard scalars and images are not written: %s",
                        e)
            return None
        return SummaryWriter(os.path.join(self.cfg.output_dir, "tb"))

    def _train_loop(self, loader, test_ds, max_steps):
        cfg, dc = self.cfg, self.data_cfg
        steps_per_epoch = len(loader)
        self._log(f"{steps_per_epoch} iterations per epoch, "
                  f"{steps_per_epoch * cfg.max_epochs} max iterations")
        if self._dp() is not None:
            self._log(f"data parallel over {self.mesh.world} ranks: "
                      f"{cfg.batch_size // self.mesh.world} of each global "
                      f"batch of {cfg.batch_size} a rank")
        state, step_fn = self.init_state(steps_per_epoch)
        latest = self.latest_checkpoint() if cfg.resume else None
        if latest:
            self.restore_checkpoint(state, latest)
            self._log(f"resumed from {latest} (step {state.step})")
        writer = self._writer() if self.main else None

        def flush(pending):
            for tb_it, tb_m in pending:
                writer.add_scalar("info/lr", state.schedule(tb_it), tb_it)
                for k, v in tb_m.items():
                    writer.add_scalar(f"info/{k}", float(v), tb_it)
            pending.clear()

        dice_hist: List[float] = []
        hd95_hist: List[float] = []
        tb_pending: list = []
        it = state.step
        total_steps = max_steps or steps_per_epoch * cfg.max_epochs
        t0, it0 = time.time(), it
        done = it >= total_steps
        for epoch in range(it // max(steps_per_epoch, 1), cfg.max_epochs):
            if done:
                break
            loader.set_epoch(epoch)
            for batch in loader:
                images, labels = to_device(batch, self.device)
                metrics = step_fn(images, labels)
                it += 1
                done = it >= total_steps
                if writer is not None and it % 10 == 0:
                    # Device scalars, read at the 50-step line: reading one
                    # here would wait for the card every 10 steps.
                    tb_pending.append((it, metrics))
                if writer is not None and it % 200 == 0:
                    _log_images(writer, self.model, images, labels, it)
                if self.main and (it % 50 == 0 or done):
                    if writer is not None:
                        flush(tb_pending)
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
            # 'interval': every-N knobs; 'reference': the recipe-exact
            # two-phase cadence (trainer.py:179-226).
            if cfg.eval_schedule == "reference":
                do_save, do_eval = reference_eval_schedule(
                    epoch, cfg.max_epochs, cfg.eval_interval)
            else:
                do_save = (epoch + 1) % cfg.ckpt_every == 0
                do_eval = (epoch + 1) % cfg.eval_interval == 0
            if (done or do_save) and self.main:
                self.save_checkpoint(state)
            if done or do_eval:
                if dc.dataset == "isic":
                    # Every rank scores the whole split (no collective);
                    # no HD95 (0.0, as the JAX Trainer reports).
                    d = dice_eval(self.model, test_ds, dc.img_size,
                                  log=logger.info if self.main else None,
                                  device=self.device)
                    h = 0.0
                else:
                    d, h = run_inference(
                        self.model, test_ds, dc.num_classes,
                        patch_size=dc.img_size,
                        batch=eval_batch(self.mesh.world),
                        log=logger.info if self.main else None,
                        device_resample=cfg.eval_device_resample,
                        device=self.device, mesh=self._dp())
                dice_hist.append(d)
                hd95_hist.append(h)
        if writer is not None:
            flush(tb_pending)
            writer.close()
        if self.main:
            self._plot_results(dice_hist, hd95_hist)
        return state, {"dice": dice_hist, "hd95": hd95_hist}

    def _plot_results(self, dice_hist, hd95_hist):
        """results.tsv (write_results_tsv) and the curves (trainer.py:50-69
        of the reference; best-effort, as in the JAX package)."""
        if not dice_hist:
            return
        write_results_tsv(os.path.join(self.cfg.output_dir, "results.tsv"),
                          dice_hist, hd95_hist)
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig, axes = plt.subplots(1, 2, figsize=(10, 4))
            axes[0].plot(dice_hist)
            axes[0].set_title("Mean Dice")
            axes[1].plot(hd95_hist)
            axes[1].set_title("Mean HD95")
            fig.savefig(os.path.join(self.cfg.output_dir, "curves.png"),
                        dpi=150)
            plt.close(fig)
        except Exception as e:
            logger.warning("plotting failed: %s", e)
