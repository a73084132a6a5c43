"""Serving-export CLI of the port, the counterpart of
transception_tpu/cli/export.py: bake trained weights into a torch.export
artifact.

    python -m transception_tpu_torch.cli.export --weight_pth W.pth \
        --out model.pt2 --export_batch 32 [--platforms cuda|cpu] \
        [--plain_xla]

The artifact (serve/export.py) is deployable without the model source:
`load_exported(path)` returns the forward, and imports only the kernels'
operator registration. --platforms names the device the program is made
for: cuda (the default, the card's kernels) or cpu (their plain
versions); a program holds its weights on one device. --plain_xla
exports with the kernels switched off (ops.kernels.enabled(False)), so the
program holds PyTorch's own operators alone. --weight_pth is what the test
CLI loads (cli.test.load_weights): a reference .pth, a port checkpoint
(a JAX package's orbax checkpoint converts to one with
scripts/orbax_to_torch.py).
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import sys

from transception_tpu_torch.cli.common import (
    add_data_args,
    add_model_args,
    build_configs,
    check_card_dtype,
)
from transception_tpu_torch.core.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    add_data_args(p)
    p.add_argument("--weight_pth", type=str, required=True,
                   help="a reference .pth or a port checkpoint")
    p.add_argument("--out", type=str, required=True,
                   help="output artifact path (e.g. model.pt2)")
    p.add_argument("--export_batch", type=int, default=32)
    p.add_argument("--platforms", type=str, default=None,
                   help="the device the program is made for: cuda or cpu "
                        "(default: the CLI's device)")
    p.add_argument("--plain_xla", action="store_true",
                   help="export with the CUDA kernels switched off (the "
                        "program holds PyTorch's own operators alone)")
    return p


def main(argv=None, device: DeviceLike = "cuda"):
    """Parse `argv` (sys.argv by default), build the model on the device
    --platforms names (else `device`), load the weights, write the
    artifact and return its path."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)

    from transception_tpu_torch.cli.test import load_weights
    from transception_tpu_torch.models.registry import create_model
    from transception_tpu_torch.ops import kernels
    from transception_tpu_torch.serve.export import (
        export_model,
        platform_of,
        save_exported,
    )

    logging.basicConfig(level=logging.INFO)
    platforms = args.platforms.split(",") if args.platforms else None
    dev = resolve_device(platform_of(platforms) or device)
    model_cfg, _, _ = build_configs(args)
    check_card_dtype(model_cfg, dev.type == "cuda" and not args.plain_xla)
    model = create_model(args.model, model_cfg, device=dev, seed=0)
    load_weights(args.weight_pth, model)
    scope = (kernels.enabled(False) if args.plain_xla
             else contextlib.nullcontext())
    with scope:
        data = export_model(model, args.export_batch, args.img_size,
                            platforms=platforms)
    save_exported(args.out, data)
    logger.info("wrote %s (%d bytes, batch=%d, img=%d, platform=%s, "
                "kernels %s)", args.out, len(data), args.export_batch,
                args.img_size, dev.type,
                "off" if args.plain_xla else "on")
    return args.out


if __name__ == "__main__":
    main()
