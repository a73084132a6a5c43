"""Device selection shared by the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent
    (the entry points never slide to the CPU on their own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


@contextlib.contextmanager
def fp32_exact(on: bool, log: Optional[Callable[[str], None]] = None):
    """TF32 off for matmuls and cuDNN convolutions while `on` (fp32 on the
    card is fp32 throughout: PyTorch's cuDNN default would run the plain
    layers' convolutions in TF32), said through `log`; the previous
    switches restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    if on:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if log:
            log("fp32 on the card: TF32 off for matmuls and cuDNN "
                "convolutions")
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
