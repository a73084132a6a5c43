"""Shared CLI argument handling of the port (train_MSTransception.py:18-95
knob set): the flags and defaults of transception_tpu/cli/common.py:15-106,
and build_configs onto the port's configs; nan_checks, the port's
--debug_nans.

A flag whose field the port's configs lack would be listed in UNSUPPORTED,
accepted at its default and refused (ValueError) at any other value,
naming what is missing, never silently ignored; the port now has every
flag's field, so the table is empty.
"""

from __future__ import annotations

import argparse
import contextlib
import functools

import torch

from transception_tpu_torch.core.config import (
    DataConfig,
    TrainConfig,
    TransceptionConfig,
    br_config_to_ch_att_list,
)

# Flags the port's configs have no field for: argparse dest -> (default,
# what is missing). None left.
UNSUPPORTED: dict = {}


def add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--model", type=str, default="mstransception",
                   help="registry name (models/registry.py): "
                        "mstransception, mstransception_4stage, "
                        "mstransception_casa, mstransception_sp, "
                        "mstransception_para; the legacy models "
                        "transception, missformer, effmissformer, "
                        "resinception, resinception_135")
    p.add_argument("--num_classes", type=int, default=9)
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--head_count", type=int, default=8)
    p.add_argument("--MSViT_config", type=int, default=2)
    p.add_argument("--concat", type=str, default="coord",
                   help="IFF: normal|3d|se|skn|cbam|coord|cam|cam_fact")
    p.add_argument("--have_bridge", type=str, default="original",
                   help="original|sp|para|none")
    p.add_argument("--use_sa_config", type=int, default=1)
    p.add_argument("--sa_ker", type=int, default=7)
    p.add_argument("--Stage_3or4", type=int, default=3)
    p.add_argument("--inter", type=str, default="res")
    p.add_argument("--num_sp", type=int, default=1)
    p.add_argument("--br_config", type=int, default=2)
    p.add_argument("--dil_conv", type=int, default=1)
    p.add_argument("--token_mlp", type=str, default="mix_skip",
                   help="mix|mix_skip|mlp")
    p.add_argument("--num_layers", type=str, default="3,8,3",
                   help="comma-separated MHCA layers per stage")
    p.add_argument("--num_path", type=str, default="3,3,3",
                   help="comma-separated RIPM paths per stage")
    p.add_argument("--stage1_layers", type=int, default=2)
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--remat", action="store_true",
                   help="recompute each MHCA stage of the 3-stage backbone "
                        "in the backward (torch.utils.checkpoint): less "
                        "memory a train step")
    p.add_argument("--no_pallas", action="store_true",
                   help="run the plain PyTorch versions in place of the "
                        "CUDA kernels (use_kernels=False)")
    p.add_argument("--drop_path_rate", type=float, default=0.0)
    p.add_argument("--no_vectorize_paths", action="store_true",
                   help="the JAX package's per-path MHCA parameter layout "
                        "(one encoder per path): under --tp_size each MHCA "
                        "block's qkv and FFN shard; the same model at tp 1")
    p.add_argument("--debug_nans", action="store_true",
                   help="raise FloatingPointError at the first module whose "
                        "output holds a NaN, and in the backward (autograd "
                        "anomaly mode); each check synchronises the card: "
                        "debugging only")


def add_data_args(p: argparse.ArgumentParser):
    p.add_argument("--dataset", type=str, default="Synapse",
                   help="Synapse | ISIC | synthetic")
    p.add_argument("--root_path", type=str,
                   default="./data/Synapse/train_npz",
                   help="the train slices ({case}.npz; synthetic slices "
                        "when it is not a directory)")
    # --volume_path is the reference test.py's name for the same thing
    # (test.py:26), accepted as an alias.
    p.add_argument("--test_path", "--volume_path", type=str,
                   default="./data/Synapse/test_vol_h5")
    p.add_argument("--list_dir", type=str, default="./lists/lists_Synapse")
    p.add_argument("--num_workers", type=int, default=4,
                   help="host loader threads (decode and augment)")
    p.add_argument("--z_spacing", type=int, default=1)
    p.add_argument("--device_data", action="store_true",
                   help="synthetic only: make the training batches on the "
                        "card (no host-to-card copy a step)")
    p.add_argument("--no_augment", action="store_true",
                   help="disable train-time augmentation (the host "
                        "loader's imgaug-equivalent pipeline)")


def add_train_args(p: argparse.ArgumentParser):
    p.add_argument("--output_dir", type=str, default="./output")
    p.add_argument("--max_epochs", type=int, default=400)
    p.add_argument("--batch_size", type=int, default=24)
    p.add_argument("--base_lr", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--eval_interval", type=int, default=20)
    p.add_argument("--eval_schedule", type=str, default="interval",
                   help="'interval' (every N epochs) or 'reference' "
                        "(the recipe-exact two-phase cadence, "
                        "trainer.py:179-226)")
    p.add_argument("--model_name", type=str, default="transception_tpu")
    p.add_argument("--grad_clipping", action="store_true")
    p.add_argument("--no_scheduler", action="store_true",
                   help="use poly decay instead of cosine")
    p.add_argument("--accumulation_steps", type=int, default=1)
    p.add_argument("--dp_size", type=int, default=-1)
    p.add_argument("--tp_size", type=int, default=1)
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--max_steps", type=int, default=None,
                   help="stop after this many train steps in all")
    p.add_argument("--eval_device_resample", action="store_true",
                   help="in-training evals resample slices on the card")
    p.add_argument("--profile", action="store_true",
                   help="torch.profiler trace of the first steps under "
                        "{output_dir}/profile")


def check_card_dtype(model_cfg, on_card: bool) -> None:
    """Raise, before any work, for a dtype the CUDA kernels do not take
    (fp16) on the card with the kernels on, naming the ways out."""
    if on_card and model_cfg.use_kernels and \
            model_cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"--dtype {model_cfg.dtype} on the card: the CUDA kernels take "
            f"fp32 and bf16; pass --dtype float32 or --dtype bfloat16 to "
            f"run them, or --no_pallas for the plain PyTorch path at "
            f"{model_cfg.dtype}")


def _refuse_unsupported(args) -> None:
    bad = [f"--{dest} ({what})" for dest, (default, what)
           in UNSUPPORTED.items()
           if getattr(args, dest, default) != default]
    if bad:
        raise ValueError("not in the PyTorch port, so only the default is "
                         "accepted: " + "; ".join(bad))


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (list, tuple)):
        for o in out:
            yield from _tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _tensors(o)


def _raise_on_nan(name, module, inputs, output) -> None:
    for t in _tensors(output):
        if t.is_floating_point() and bool(torch.isnan(t).any()):
            raise FloatingPointError(
                f"NaN in the output of {name or 'the model'} "
                f"({type(module).__name__})")


@contextlib.contextmanager
def nan_checks(model: torch.nn.Module, on: bool = True):
    """--debug_nans (the JAX CLIs' jax_debug_nans): inside, a forward hook
    on every module of `model` raises FloatingPointError naming the first
    module (the innermost: hooks run as each module returns) whose output
    holds a NaN, and the backward runs under autograd's anomaly mode with
    its NaN check (torch.autograd.set_detect_anomaly(True,
    check_nan=True)), which raises at the first backward function that
    returns a NaN. Each check reads a flag back from the card, so every
    module synchronises: a debug switch only. off: nothing is installed."""
    if not on:
        yield
        return
    handles = [m.register_forward_hook(functools.partial(_raise_on_nan, n))
               for n, m in model.named_modules()]
    try:
        with torch.autograd.set_detect_anomaly(True, check_nan=True):
            yield
    finally:
        for h in handles:
            h.remove()


def build_configs(args):
    """(TransceptionConfig, DataConfig, TrainConfig) of parsed flags, as
    transception_tpu/cli/common.py:116 builds the JAX ones; --no_pallas is
    use_kernels=False."""
    _refuse_unsupported(args)
    num_classes = 2 if args.dataset.lower() == "isic" else args.num_classes
    num_layers = tuple(int(v) for v in
                       getattr(args, "num_layers", "3,8,3").split(","))
    num_path = tuple(int(v) for v in
                     getattr(args, "num_path", "3,3,3").split(","))
    model_cfg = TransceptionConfig(
        num_classes=num_classes,
        img_size=args.img_size,
        num_layers=num_layers,
        num_path=num_path,
        num_heads=(8,) * len(num_layers),
        stage1_layers=getattr(args, "stage1_layers", 2),
        concat=args.concat,
        have_bridge=args.have_bridge,
        br_ch_att_list=br_config_to_ch_att_list(args.br_config),
        stage_3or4=args.Stage_3or4,
        use_sa_config=args.use_sa_config,
        sa_ker=args.sa_ker,
        inter=args.inter,
        num_sp=args.num_sp,
        head_count=args.head_count,
        dil_conv=args.dil_conv,
        token_mlp=args.token_mlp,
        dtype=args.dtype,
        use_kernels=not getattr(args, "no_pallas", False),
        drop_path_rate=getattr(args, "drop_path_rate", 0.0),
        remat=getattr(args, "remat", False),
        vectorize_paths=not getattr(args, "no_vectorize_paths", False),
    ).validate()
    data_cfg = DataConfig(
        dataset=args.dataset.lower(),
        root_path=args.root_path,
        test_path=args.test_path,
        list_dir=args.list_dir,
        img_size=args.img_size,
        num_classes=num_classes,
        num_workers=args.num_workers,
        augment=not getattr(args, "no_augment", False),
        device_data=getattr(args, "device_data", False),
    )
    train_cfg = TrainConfig(
        base_lr=getattr(args, "base_lr", 0.05),
        batch_size=getattr(args, "batch_size", 24),
        max_epochs=getattr(args, "max_epochs", 400),
        use_scheduler=not getattr(args, "no_scheduler", False),
        grad_clipping=getattr(args, "grad_clipping", False),
        grad_accum_steps=getattr(args, "accumulation_steps", 1),
        seed=getattr(args, "seed", 1234),
        eval_interval=getattr(args, "eval_interval", 20),
        eval_schedule=getattr(args, "eval_schedule", "interval"),
        output_dir=getattr(args, "output_dir", "./output"),
        model_name=getattr(args, "model_name", "transception_tpu"),
        dp_size=getattr(args, "dp_size", -1),
        tp_size=getattr(args, "tp_size", 1),
        resume=not getattr(args, "no_resume", False),
        eval_device_resample=getattr(args, "eval_device_resample", False),
    )
    return model_cfg, data_cfg, train_cfg
