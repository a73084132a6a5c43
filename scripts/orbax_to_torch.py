"""Convert a JAX package Trainer checkpoint (an orbax directory) into a
port checkpoint.

    python scripts/orbax_to_torch.py --orbax_dir RUN/ckpt/step_00001000 \
        --output_dir PORT_RUN [the JAX run's model, data and train flags]

Writes PORT_RUN/ckpt/step_XXXXXXXX.pt, a TrainState.state_dict() of the
PyTorch port (model, SGD momentum buffers, step and schedule count), which
`python -m transception_tpu_torch.cli.test --weight_pth` takes, and which
`python -m transception_tpu_torch.cli.train --output_dir PORT_RUN`
resumes from. The flags are the CLIs' (cli/common.py), and must be the
JAX run's: the model's, and the train recipe's (--grad_clipping,
--accumulation_steps, --batch_size, --max_epochs, --base_lr). The
schedule's steps per epoch are the train set's slices over the batch, as
the JAX Trainer counts them, unless --steps_per_epoch is given.

Reading orbax needs orbax and JAX, so this script lives outside the port
(whose card machine has neither); it restores the raw pytree without a
target and imports nothing of the JAX package. A checkpoint taken inside
an accumulation window is refused (convert.from_jax.train_state_from_jax).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from transception_tpu_torch.cli.common import (  # noqa: E402
    add_data_args,
    add_model_args,
    add_train_args,
    build_configs,
)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    add_data_args(p)
    add_train_args(p)
    p.add_argument("--orbax_dir", type=str, required=True,
                   help="a JAX Trainer checkpoint, RUN/ckpt/step_XXXXXXXX")
    p.add_argument("--steps_per_epoch", type=int, default=None,
                   help="the JAX run's iterations per epoch (default: the "
                        "train set's length over --batch_size)")
    return p


def restore_raw(path: str) -> dict:
    """The checkpoint's pytree as orbax restores it without a target:
    nested dicts and lists of arrays."""
    import orbax.checkpoint as ocp
    return ocp.StandardCheckpointer().restore(os.path.abspath(path))


def main(argv=None) -> str:
    """Convert and write; returns the written path."""
    from transception_tpu_torch.convert.from_jax import train_state_from_jax
    from transception_tpu_torch.data.synapse import make_train_dataset
    from transception_tpu_torch.models.registry import create_model

    args = _parser().parse_args(argv)
    model_cfg, data_cfg, train_cfg = build_configs(args)
    spe = args.steps_per_epoch
    if spe is None:
        spe = len(make_train_dataset(data_cfg)) // train_cfg.batch_size
    model = create_model(args.model, model_cfg, device="cpu",
                         seed=train_cfg.seed)
    sd = train_state_from_jax(restore_raw(args.orbax_dir), model, train_cfg,
                              spe)
    ckpt = os.path.join(os.path.abspath(train_cfg.output_dir), "ckpt")
    os.makedirs(ckpt, exist_ok=True)
    path = os.path.join(ckpt, f"step_{sd['step']:08d}.pt")
    torch.save(sd, path)
    print(f"wrote {path} (step {sd['step']}, {sd['schedule']['updates']} "
          f"updates, lr {sd['schedule']['lr']:.8g})")
    return path


if __name__ == "__main__":
    main()
