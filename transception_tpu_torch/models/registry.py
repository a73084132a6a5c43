"""Model registry of the port, by the names of the JAX package's
(transception_tpu/models/registry.py:31-57).

The published MSTransception and its four ablation variants: each variant
is the published config with the fields the JAX registry sets. The legacy
models (the two-branch Transception, MISSFormer, EffMISSFormer and the
ResInception pair, models/legacy.py) take the caller's config as it is,
as the JAX registry passes it. A name the registry does not know raises
KeyError, as the JAX create_model does.
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
# The legacy models (models/legacy.py MODELS; JAX registry.py:46-57).
LEGACY = ("transception", "missformer", "effmissformer", "resinception",
          "resinception_135")
PORTED = tuple(VARIANTS) + LEGACY
NOT_PORTED = ()


def model_config(name: str, cfg: Optional[TransceptionConfig] = None
                 ) -> TransceptionConfig:
    """The config registry model `name` runs: `cfg` (the published one by
    default) with the fields the name sets (none for a legacy model)."""
    key = name.lower()
    if key not in PORTED:
        raise KeyError(f"unknown model '{name}'; have {sorted(PORTED)}")
    return dataclasses.replace(cfg or TransceptionConfig(),
                               **VARIANTS.get(key, {}))


def create_model(name: str, cfg: Optional[TransceptionConfig] = None,
                 device: DeviceLike = "cuda", seed: int = 0):
    """The model registered as `name` (case-insensitive) with config `cfg`
    (the published one by default), weights drawn from `seed`, on
    `device`."""
    cfg = model_config(name, cfg)
    if name.lower() in LEGACY:
        from transception_tpu_torch.models import legacy
        return legacy.build(name.lower(), cfg, device, seed)
    from transception_tpu_torch.models.transception import MSTransception
    return MSTransception(cfg, device, seed)
