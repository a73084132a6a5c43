"""Serving export: torch.export artifacts of the eval-mode forward, the
port's counterpart of transception_tpu/serve/export.py.

`export_model` traces the eval-mode logits forward, (B, H, W, in_ch) fp32
-> (B, H, W, num_classes), at a fixed batch through torch.export.export,
with the trained weights held in the program, and returns the artifact's
bytes (torch.export.save's). Every kernel the eager forward launches is a
torch.library operator of the namespace `transception_torch`
(ops.kernels), so the program calls the same operators, and a loaded
program launches (and counts, ops.kernels.launch_counts) the same
kernels as the eager forward. Exported with the kernels switched off
(ops.kernels.enabled(False), the CLI's --plain_xla) the program holds
PyTorch's own operators alone and runs wherever PyTorch does on its
device.

The artifact is deployable without the model source: `load_exported`
imports only the operators' registration (transception_tpu_torch.ops.
kernels), never transception_tpu_torch.models. A program is made for one
device, the one the model's weights lie on: "cuda" (the kernels) or
"cpu" (their plain versions, the operators' CPU implementations).
"""

from __future__ import annotations

import io
from typing import Callable, Optional, Sequence

import torch

MAGIC = b"TXTORCH1\n"
# The JAX package's artifacts (StableHLO, transception_tpu/serve/export.py).
JAX_MAGIC = b"TXTPU1\n"
PLATFORMS = ("cuda", "cpu")


def platform_of(platforms: Optional[Sequence[str]]) -> Optional[str]:
    """The one device `platforms` names, cuda or cpu (None for None);
    raises for anything else, and for more than one: a torch.export
    program holds its weights on one device and runs there."""
    if platforms is None:
        return None
    names = list(platforms)
    bad = [p for p in names if p not in PLATFORMS]
    if bad:
        raise ValueError(f"platforms {bad}: a torch.export program of the "
                         f"port runs on one of {PLATFORMS}")
    if len(names) != 1:
        raise ValueError(f"platforms {names}: a torch.export program holds "
                         f"its weights on one device; export once per "
                         f"device")
    return names[0]


def export_model(model: torch.nn.Module, batch: int, img_size: int = 224,
                 in_ch: int = 1,
                 platforms: Optional[Sequence[str]] = None) -> bytes:
    """The eval-mode forward of `model` with its weights, traced by
    torch.export.export at input (batch, img_size, img_size, in_ch) fp32
    on the model's device, which `platforms` (platform_of) must name
    where it is given, as torch.export.save's bytes. The kernels on (ops.kernels.enabled) are operators of the
    program; the model is left in the mode it was in."""
    dev = next(model.parameters()).device
    want = platform_of(platforms)
    if want is not None and want != dev.type:
        raise ValueError(f"platforms {list(platforms)}: the model's weights "
                         f"lie on {dev.type}; build the model on {want} to "
                         f"export for it")
    x = torch.zeros(batch, img_size, img_size, in_ch, device=dev)
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(model, (x,))
    finally:
        model.train(was)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_model(data: bytes) -> Callable:
    """The forward of an artifact's bytes (export_model's): a callable
    taking a (B, H, W, in_ch) tensor or array, moved to the program's
    device, and returning the logits there, under no_grad. Registers the
    port's kernel operators first (importing ops.kernels, not the
    models)."""
    import transception_tpu_torch.ops.kernels  # noqa: F401  (operators)
    program = torch.export.load(io.BytesIO(data))
    module = program.module()
    state = list(program.state_dict.values())
    dev = state[0].device if state else torch.device("cpu")

    def fn(x) -> torch.Tensor:
        x = torch.as_tensor(x).to(dev, torch.float32)
        with torch.no_grad():
            return module(x)

    fn.program = program
    fn.device = dev
    return fn


def save_exported(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(data)


def load_exported(path: str) -> Callable:
    """The forward of the artifact at `path` (load_model). Raises
    ValueError for anything but the port's artifact, naming a JAX
    package's StableHLO artifact as such."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob.startswith(JAX_MAGIC):
        raise ValueError(
            f"{path} is a JAX package artifact (StableHLO, {JAX_MAGIC!r}): "
            f"load it with transception_tpu.serve.export.load_exported; "
            f"the port reads its own torch.export artifacts ({MAGIC!r})")
    if not blob.startswith(MAGIC):
        raise ValueError(f"{path} is not a transception_tpu_torch export "
                         f"artifact")
    return load_model(blob[len(MAGIC):])
