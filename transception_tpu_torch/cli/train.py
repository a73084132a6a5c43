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
)
from transception_tpu_torch.core.device import (
    DeviceLike,
    fp32_exact,
    resolve_device,
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


def throughput(model, model_cfg, train_cfg, img_size: int,
               device: torch.device, steps: int = 20) -> float:
    """Seconds per train step of `model` on zero batches of
    train_cfg.batch_size (the JAX CLI's --throughput: one warm-up step,
    then `steps` steps, the card synchronised before the clock stops);
    prints the JAX line."""
    from transception_tpu_torch.train.state import TrainState
    from transception_tpu_torch.train.trainer import make_train_step
    b = train_cfg.batch_size
    x = torch.zeros((b, img_size, img_size, 1), device=device)
    y = torch.zeros((b, img_size, img_size), dtype=torch.long, device=device)
    gen = torch.Generator(device=device).manual_seed(train_cfg.seed)
    state = TrainState(model, train_cfg, 100, gen)
    step = make_train_step(state, model_cfg.num_classes, train_cfg.ce_weight,
                           train_cfg.dice_weight, gen=gen)

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
    print(f"train throughput: {b / dt:.1f} imgs/s "
          f"({dt * 1000:.1f} ms/step at batch {b})", flush=True)
    return dt


def main(argv=None, device: DeviceLike = "cuda"):
    """Parse `argv` (sys.argv by default) and train on `device`. Returns
    (TrainState, {"dice": [...], "hd95": [...]}) as the JAX CLI, or
    (None, None) after --throughput."""
    args = _parser().parse_args(argv)

    from transception_tpu_torch.models.registry import create_model
    from transception_tpu_torch.train.trainer import Trainer

    model_cfg, data_cfg, train_cfg = build_configs(args)
    on_card = torch.device(device).type == "cuda"
    check_card_dtype(model_cfg, on_card)
    dev = resolve_device(device)  # no card: raise before any work
    model = create_model(args.model, model_cfg, device=dev,
                         seed=train_cfg.seed)

    if args.throughput:
        with fp32_exact(on_card and model_cfg.dtype == "float32"):
            throughput(model, model_cfg, train_cfg, args.img_size, dev)
        return None, None

    trainer = Trainer(model_cfg, train_cfg, data_cfg, device=dev,
                      model=model)
    to_stdout = logging.StreamHandler(sys.stdout)
    to_stdout.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(to_stdout)
    logger.setLevel(logging.INFO)
    try:
        logger.info(str(args))
        if args.profile:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else [])
            out = os.path.join(train_cfg.output_dir, "profile")
            os.makedirs(out, exist_ok=True)
            with profile(activities=acts) as prof:
                state, hist = trainer.train(max_steps=args.max_steps or 10)
            path = os.path.join(out, "trace.json")
            prof.export_chrome_trace(path)
            logger.info("profiler trace written to %s", path)
        else:
            state, hist = trainer.train(max_steps=args.max_steps)
        logger.info("Training Finished!")
        return state, hist
    finally:
        logger.removeHandler(to_stdout)
        to_stdout.close()


if __name__ == "__main__":
    main()
