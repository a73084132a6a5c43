"""Model registry of the port, by the names of the JAX package's
(transception_tpu/models/registry.py:30-57).

Only the published MSTransception is ported; every other name the JAX
registry knows raises NotImplementedError, and a name neither registry
knows raises KeyError, as the JAX create_model does.
"""

from __future__ import annotations

from typing import Optional

from transception_tpu_torch.core.config import TransceptionConfig
from transception_tpu_torch.core.device import DeviceLike

PORTED = ("mstransception",)
# The JAX registry's other models: backbone and bridge variants, the legacy
# two-branch encoder and the baselines.
NOT_PORTED = ("mstransception_4stage", "mstransception_casa",
              "mstransception_sp", "mstransception_para", "transception",
              "missformer", "effmissformer", "resinception",
              "resinception_135")


def create_model(name: str, cfg: Optional[TransceptionConfig] = None,
                 device: DeviceLike = "cuda", seed: int = 0):
    """The model registered as `name` (case-insensitive) with config `cfg`
    (the published one by default), weights drawn from `seed`, on
    `device`."""
    key = name.lower()
    if key in NOT_PORTED:
        raise NotImplementedError(
            f"model '{name}' is not ported yet (ROADMAP.md §1 item 5); "
            f"the port has {list(PORTED)}")
    if key not in PORTED:
        raise KeyError(f"unknown model '{name}'; have "
                       f"{sorted(PORTED + NOT_PORTED)}")
    from transception_tpu_torch.models.transception import MSTransception
    return MSTransception(cfg or TransceptionConfig(), device, seed)
