"""Model registry of the port, by the names of the JAX package's
(transception_tpu/models/registry.py:31-57).

The published MSTransception and its four ablation variants are ported:
each variant is the published config with the fields the JAX registry
sets. The legacy models (the two-branch encoder and the baselines) raise
NotImplementedError, and a name neither registry knows raises KeyError, as
the JAX create_model does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from transception_tpu_torch.core.config import TransceptionConfig
from transception_tpu_torch.core.device import DeviceLike

# Registry name -> the TransceptionConfig fields it sets (JAX
# models/registry.py:35-45).
VARIANTS = {
    "mstransception": {},
    "mstransception_4stage": dict(stage_3or4=4),
    "mstransception_casa": dict(stage_3or4=0, concat="cbam"),
    "mstransception_sp": dict(have_bridge="sp", num_sp=1),
    "mstransception_para": dict(have_bridge="para"),
}
PORTED = tuple(VARIANTS)
# The JAX registry's other models: the legacy two-branch encoder and the
# baselines (ROADMAP.md §1 item 5).
NOT_PORTED = ("transception", "missformer", "effmissformer", "resinception",
              "resinception_135")


def model_config(name: str, cfg: Optional[TransceptionConfig] = None
                 ) -> TransceptionConfig:
    """The config registry model `name` runs: `cfg` (the published one by
    default) with the fields the name sets."""
    key = name.lower()
    if key in NOT_PORTED:
        raise NotImplementedError(
            f"model '{name}' is not ported yet (ROADMAP.md §1 item 5: the "
            f"legacy models); the port has {list(PORTED)}")
    if key not in PORTED:
        raise KeyError(f"unknown model '{name}'; have "
                       f"{sorted(PORTED + NOT_PORTED)}")
    return dataclasses.replace(cfg or TransceptionConfig(), **VARIANTS[key])


def create_model(name: str, cfg: Optional[TransceptionConfig] = None,
                 device: DeviceLike = "cuda", seed: int = 0):
    """The model registered as `name` (case-insensitive) with config `cfg`
    (the published one by default), weights drawn from `seed`, on
    `device`."""
    from transception_tpu_torch.models.transception import MSTransception
    return MSTransception(model_config(name, cfg), device, seed)
