"""Training CLI of the port, the counterpart of transception_tpu/cli/train.py
(the reference's train_MSTransception.py).

    python -m transception_tpu_torch.cli.train --dataset Synapse \
        --root_path .../train_npz --test_path .../test_vol_h5 \
        [--dtype float32] [--max_steps N]

Trains on the card (Trainer: the train slices through the host loader
with augment, checkpoints and resume, the in-training volume eval,
TensorBoard, results.tsv) and logs to {output_dir}/log.txt and to stdout.
The default dtype is bfloat16 (the JAX CLI's); --dtype float32, the
reference recipe's, runs the fp32 forms of the CUDA kernels with TF32
off. --throughput times the train step on zero batches and exits;
--profile records a torch.profiler trace of the first steps under
{output_dir}/profile.

Data parallelism: --dp_size N trains over N cards, one rank a card, on
global batches of --batch_size (parallel.mesh; the default -1 takes every
visible card). Under torchrun (--nproc_per_node N) each process is one
rank; without it the CLI starts its N ranks itself. Rank 0 writes the
logs, checkpoints and results.

Tensor parallelism: --tp_size T shards the weights of the JAX package's
TP rules over T ranks of a model axis (Trainer; dp·tp ranks, one a card,
rank r at (d, t) = divmod(r, T)); the CLI starts the dp·tp ranks itself
outside torchrun. Every registry model shards (the legacy ones their
blocks' FFNs); with --no_vectorize_paths the MHCA blocks' qkv and FFNs
shard too. More ranks than cards, and a T that leaves a sharded layer a
width its kernels do not take, are refused before any work.

--debug_nans raises FloatingPointError at the first module whose output
holds a NaN and in the backward (cli.common.nan_checks): every module
synchronises the card, so it is for debugging only.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import torch

from transception_tpu_torch.cli.common import (
    add_data_args,
    add_model_args,
    add_train_args,
    build_configs,
    check_card_dtype,
    nan_checks,
)
from transception_tpu_torch.core.device import DeviceLike, fp32_exact
from transception_tpu_torch.parallel.mesh import (
    data_size,
    launched,
    make_mesh,
    spawn,
)

logger = logging.getLogger("transception_tpu_torch")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    add_data_args(p)
    add_train_args(p)
    p.add_argument("--throughput", action="store_true",
                   help="measure train-step imgs/sec and exit (the "
                        "reference parsed-but-dead flag, made real)")
    return p


def throughput(trainer, img_size: int, steps: int = 20) -> float:
    """Seconds per train step of the trainer's step on zero global batches
    of train_cfg.batch_size, this rank's rows of each (the JAX CLI's
    --throughput: one warm-up step, then `steps` steps, the card
    synchronised before the clock stops); rank 0 prints the JAX line."""
    b, device = trainer.cfg.batch_size, trainer.device
    nb = b // trainer.mesh.world
    x = torch.zeros((nb, img_size, img_size, 1), device=device)
    y = torch.zeros((nb, img_size, img_size), dtype=torch.long,
                    device=device)
    _, step = trainer.init_state(100)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    step(x, y)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(x, y)
    sync()
    dt = (time.perf_counter() - t0) / steps
    if trainer.main:
        print(f"train throughput: {b / dt:.1f} imgs/s "
              f"({dt * 1000:.1f} ms/step at batch {b})", flush=True)
    return dt


def _rank(argv, device):
    """One rank of a run the CLI started itself: its history (the state
    stays in the rank; the checkpoint holds it)."""
    return main(argv, device)[1]


def main(argv=None, device: DeviceLike = "cuda"):
    """Parse `argv` (sys.argv by default) and train on `device`. Returns
    (TrainState, {"dice": [...], "hd95": [...]}) as the JAX CLI, or
    (None, None) after --throughput; (None, rank 0's history) where the
    CLI started the --dp_size ranks itself."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)

    from transception_tpu_torch.models.registry import create_model
    from transception_tpu_torch.train.trainer import Trainer

    model_cfg, data_cfg, train_cfg = build_configs(args)
    on_card = torch.device(device).type == "cuda"
    check_card_dtype(model_cfg, on_card)
    # The mesh, checked before any work: the cards, the global batch's
    # split over the data axis, and the model axis's shards.
    tp = max(train_cfg.tp_size, 1)
    dp = data_size(train_cfg.dp_size, device, tp)
    if train_cfg.batch_size % dp:
        raise ValueError(f"--batch_size {train_cfg.batch_size} does not "
                         f"divide over --dp_size {dp} ranks")
    if tp > 1 and not launched():
        from transception_tpu_torch.models.transception import check_tp
        check_tp(create_model(args.model, model_cfg, device="cpu"), tp,
                 device)
    if dp * tp > 1 and not launched():
        return None, spawn(_rank, dp * tp, (argv, device))
    mesh = make_mesh(dp, tp, device)
    dev = mesh.device
    model = create_model(args.model, model_cfg, device=dev,
                         seed=train_cfg.seed)
    trainer = Trainer(model.cfg, train_cfg, data_cfg, device=dev,
                      model=model, mesh=mesh)

    if args.throughput:
        try:
            with fp32_exact(on_card and model_cfg.dtype == "float32"), \
                    nan_checks(model, args.debug_nans):
                throughput(trainer, args.img_size)
        finally:
            mesh.close()
        return None, None

    to_stdout = logging.StreamHandler(sys.stdout)
    to_stdout.setFormatter(logging.Formatter("%(message)s"))
    if mesh.is_main:
        logger.addHandler(to_stdout)
    logger.setLevel(logging.INFO)
    try:
        logger.info(str(args))
        max_steps = args.max_steps or (10 if args.profile else None)
        if args.profile and mesh.is_main:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else [])
            out = os.path.join(train_cfg.output_dir, "profile")
            os.makedirs(out, exist_ok=True)
            with profile(activities=acts) as prof, \
                    nan_checks(model, args.debug_nans):
                state, hist = trainer.train(max_steps=max_steps)
            path = os.path.join(out, "trace.json")
            prof.export_chrome_trace(path)
            logger.info("profiler trace written to %s", path)
        else:
            with nan_checks(model, args.debug_nans):
                state, hist = trainer.train(max_steps=max_steps)
        logger.info("Training Finished!")
        return state, hist
    finally:
        logger.removeHandler(to_stdout)
        to_stdout.close()
        mesh.close()


if __name__ == "__main__":
    main()
