"""Evaluation CLI of the port, the counterpart of transception_tpu/cli/test.py.

    python -m transception_tpu_torch.cli.test --dataset Synapse \
        --weight_pth path/to/weights.pth

Runs slice-batched volume inference over the test list on the card and
reports per-class and mean DSC/HD95 (the reference's test.py:104-123
protocol), logging to {output_dir}/test_log/eval.txt and to stdout.
--is_savenii writes img/pred/gt .nii.gz volumes with (1, 1, z_spacing)
spacing like utils.py:100-109. --dataset ISIC scores ISIC 2018 images
instead (data.isic.dice_eval: per-case dice and IoU, the mean; HD95 is
reported as 0.0), --is_savenii then writing {case}_pred.png masks. The default dtype is float32, the
published protocol, and runs the fp32 forms of the CUDA kernels on the
card with TF32 off; --dtype bfloat16 runs their bf16 forms, --no_pallas
the plain PyTorch path. Weights: a reference .pth/.pt state_dict or a port
checkpoint (load_weights); a JAX package's orbax checkpoint directory
converts to a port checkpoint with scripts/orbax_to_torch.py. --dp_size N
evaluates over N cards, each rank forwarding its share of every chunk of
--eval_batch slices (parallel.mesh; rank 0 scores and logs); under
torchrun each process is one rank, without it the CLI starts its N ranks
itself.
"""

from __future__ import annotations

import argparse
import logging
import os
import re
import sys

import torch

from transception_tpu_torch.cli.common import (
    add_data_args,
    add_model_args,
    build_configs,
    check_card_dtype,
)
from transception_tpu_torch.core.device import (
    DeviceLike,
    fp32_exact,
    resolve_device,
)
from transception_tpu_torch.parallel.mesh import (
    data_size,
    launched,
    make_mesh,
    spawn,
)

logger = logging.getLogger(__name__)

# Reference parameters the published model never calls, so the port does
# not instantiate them (convert/torch2flax.py:11-13 of the JAX package;
# tests/test_parity_reference.py lists what a live reference model
# carries): MixFFN_skip.norm2/norm3, the backbone's conv1_1_s* and stage-1
# cpe (and the cpe/crpe aliases torch registers under every MHCA layer),
# the channel attention's scale_reduce, fc{1-4}_back, CAM crpe, the sp
# bridge's scale_fuse_att beyond layer 1, decoder_3's concat path (it
# takes no skip), and BatchNorm's num_batches_tracked.
DEAD_KEYS = re.compile(
    r"(^|\.)(norm2|norm3|cpe|crpe|scale_reduce)\.|(^|\.)conv1_1_s\d|"
    r"(^|\.)fc\d_back\.|^bridge\.bridge_layer([2-9]|\d\d+)\.scale_fuse_att\.|"
    r"^decoder_3\.(concat_linear|layer_former)|num_batches_tracked$")


def _reference_tensor(src: torch.Tensor, want: torch.Tensor, key: str
                      ) -> torch.Tensor:
    """A reference tensor in the port's layout: the same shape, or a 1x1
    conv (O, I, 1, 1) where the port has a Linear (O, I), as
    torch2flax._to_flax_tensor reads it."""
    if src.shape == want.shape:
        return src
    if src.dim() == 4 and src.shape[2:] == (1, 1) and \
            tuple(src.shape[:2]) == tuple(want.shape):
        return src.reshape(want.shape)
    raise ValueError(f"{key}: shape {tuple(src.shape)} in the checkpoint, "
                     f"{tuple(want.shape)} in the port")


def load_weights(weight_pth: str, model: torch.nn.Module) -> torch.nn.Module:
    """Fill `model` in place from `weight_pth`:
      * a port checkpoint (Trainer.save_checkpoint's step_*.pt, a
        TrainState.state_dict()): its model part, strictly;
      * a reference .pth/.pt state_dict, optionally under a "state_dict"
        entry and with DataParallel's "module." prefix: the port's keys
        are the reference names, so every port tensor must be filled;
        keys the port lacks are allowed only among the reference's dead
        parameters (DEAD_KEYS), which are logged. Anything else raises.
    An orbax checkpoint directory (the JAX package's) raises
    NotImplementedError naming its converter: reading orbax needs JAX,
    which the port does not import."""
    if os.path.isdir(weight_pth):
        raise NotImplementedError(
            f"{weight_pth} is a directory (an orbax checkpoint of the JAX "
            f"package?): the port reads no orbax (it needs JAX); convert it "
            f"to a port checkpoint with scripts/orbax_to_torch.py, where "
            f"JAX and orbax are installed, and pass the step_*.pt it "
            f"writes")
    sd = torch.load(weight_pth, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and {"model", "optimizer", "step"} <= set(sd):
        model.load_state_dict(sd["model"])
        logger.info("loaded the model of port checkpoint %s (step %d)",
                    weight_pth, int(sd["step"]))
        return model
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}
    targets = model.state_dict()
    missing = sorted(set(targets) - set(sd))
    extra = sorted(set(sd) - set(targets))
    unknown = [k for k in extra if not DEAD_KEYS.search(k)]
    if missing or unknown:
        raise KeyError(
            f"load_weights({weight_pth}): {len(missing)} port tensors not "
            f"in the checkpoint {missing[:20]}; {len(unknown)} checkpoint "
            f"keys the port does not have {unknown[:20]}")
    with torch.no_grad():
        for k, t in targets.items():
            t.copy_(_reference_tensor(sd[k], t, k))
    logger.info("loaded %d tensors from %s", len(targets), weight_pth)
    dead = [k for k in extra if not k.endswith("num_batches_tracked")]
    if dead:
        logger.info("%d dead reference parameters not instantiated by the "
                    "port: %s", len(dead), ", ".join(dead))
    return model


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    add_data_args(p)
    p.add_argument("--weight_pth", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="./output")
    p.add_argument("--is_savenii", action="store_true",
                   help="save img/pred/gt volumes as .nii.gz with "
                        "(1,1,z_spacing) like the reference "
                        "(utils.py:100-109; pure-numpy NIfTI-1 writer)")
    p.add_argument("--hd95_in_mm", action="store_true",
                   help="compute hd95 with (z_spacing,1,1) voxel spacing; "
                        "default is the published protocol (medpy called "
                        "with no spacing, utils.py:54)")
    p.add_argument("--eval_batch", type=int, default=32)
    p.add_argument("--dp_size", type=int, default=1,
                   help="data-parallel eval over this many cards (each "
                        "chunk of --eval_batch slices split over them)")
    p.add_argument("--device_resample", action="store_true",
                   help="run the protocol's order-3 spline input resample "
                        "on the card (float64 products against exact "
                        "scipy-derived operators) instead of on the host")
    # Published-protocol evaluation runs fp32 by default (bf16 flips ~0.8%
    # of argmax pixels); the CUDA kernels take float32 and bfloat16.
    p.set_defaults(dtype="float32")
    return p


def main(argv=None, device: DeviceLike = "cuda"):
    """Parse `argv` (sys.argv by default), evaluate on `device` and return
    (mean dice, mean hd95)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)

    from transception_tpu_torch.data.synapse import make_test_dataset
    from transception_tpu_torch.eval.inference import run_inference
    from transception_tpu_torch.models.registry import create_model

    model_cfg, data_cfg, _ = build_configs(args)
    on_card = torch.device(device).type == "cuda"
    check_card_dtype(model_cfg, on_card)
    # The data axis, checked before any work (the cards, the chunks'
    # split); a process group already up (a launch) is joined.
    mesh = None
    if args.dp_size > 1 or launched():
        dp = data_size(args.dp_size, device)
        if args.eval_batch % dp:
            raise ValueError(
                f"eval batch {args.eval_batch} not divisible by the mesh "
                f"'data' axis ({dp}); pick a multiple so chunks shard "
                f"evenly")
        if not launched():
            return spawn(main, dp, (argv, device))
        mesh = make_mesh(dp, 1, device)
        device = mesh.device
    resolve_device(device)  # no card: raise before any work
    test_ds = make_test_dataset(data_cfg)

    main_rank = mesh is None or mesh.is_main
    handlers = ()
    if main_rank:
        log_dir = os.path.join(args.output_dir, "test_log")
        os.makedirs(log_dir, exist_ok=True)
        to_file = logging.FileHandler(os.path.join(log_dir, "eval.txt"))
        to_file.setFormatter(logging.Formatter(
            "[%(asctime)s.%(msecs)03d] %(message)s", datefmt="%H:%M:%S"))
        handlers = (to_file, logging.StreamHandler(sys.stdout))
    for h in handlers:
        logger.addHandler(h)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    try:
        logger.info(str(args))
        with fp32_exact(on_card and model_cfg.dtype == "float32",
                        logger.info):
            model = create_model(args.model, model_cfg, device=device,
                                 seed=0)
            load_weights(args.weight_pth, model)

            save_dir = None
            if args.is_savenii and main_rank:
                save_dir = os.path.join(args.output_dir, "predictions")
                os.makedirs(save_dir, exist_ok=True)
            if data_cfg.dataset == "isic":
                # Images, not volumes: each rank scores the whole split,
                # rank 0 logs it; no HD95 (0.0, as the JAX CLI reports).
                from transception_tpu_torch.data.isic import dice_eval
                mean_dice = dice_eval(
                    model, test_ds, args.img_size, batch=args.eval_batch,
                    log=logger.info if main_rank else None,
                    save_path=save_dir, device=device)
                mean_hd95 = 0.0
            else:
                hd95_spacing = ((float(args.z_spacing), 1.0, 1.0)
                                if args.hd95_in_mm else None)
                mean_dice, mean_hd95 = run_inference(
                    model, test_ds, data_cfg.num_classes,
                    patch_size=args.img_size, batch=args.eval_batch,
                    log=logger.info, save_path=save_dir,
                    z_spacing=args.z_spacing, hd95_spacing=hd95_spacing,
                    device_resample=args.device_resample, device=device,
                    mesh=mesh)
        if save_dir is not None:
            logger.info("saved volumes to %s", save_dir)
        return mean_dice, mean_hd95
    finally:
        for h in handlers:
            logger.removeHandler(h)
            h.close()
        if mesh is not None:
            mesh.close()


if __name__ == "__main__":
    main()
