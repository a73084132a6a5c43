"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Union

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
