"""Hand-written CUDA kernels of the port, one module each.

Every module holds the kernel's plain PyTorch version (same rounding points
as the Pallas kernel it replaces), a wrapper that runs the plain version
for CPU tensors (or with the kernel switched off, `enabled(...)`) and
launches the kernel (or raises) for CUDA tensors, and an integer
`launches` counter bumped once per launch. bridge_attention and mixffn
also hold their backward kernels (K10, K11) with a `bwd_launches` counter,
and join forward and backward in a torch.autograd.Function; the other
kernels have no backward and refuse to run where autograd records
(_build.forward_only).
"""

from transception_tpu_torch.ops.kernels import (  # noqa: F401
    bridge_attention,
    etb_attention,
    expand_head,
    linear_attention,
    mhca_block,
    mixffn,
    patch_expand,
)
from transception_tpu_torch.ops.kernels._build import (  # noqa: F401
    SWITCHES,
    active,
    enabled,
)

# (count name, module, counter attribute) of every kernel.
COUNTERS = tuple((m.NAME, m, "launches") for m in (
    etb_attention, mixffn, bridge_attention, expand_head, mhca_block,
    linear_attention, patch_expand)) + (
    (bridge_attention.BWD_NAME, bridge_attention, "bwd_launches"),
    (mixffn.BWD_NAME, mixffn, "bwd_launches"))


def kernel_set(cfg, training: bool) -> frozenset:
    """The kernels a model with config `cfg` runs: every kernel in eval;
    in training only those with a backward kernel, as the JAX package's
    train_step_model (train/trainer.py:90-119) gates them: the bridge
    attention (K3 + K10), plus the MixFFN folds (K2 + K11) with
    ffn_flash_train; none with use_kernels=False."""
    if not cfg.use_kernels:
        return frozenset()
    if not training:
        return SWITCHES
    return frozenset({"bridge_attention"}
                     | ({"mixffn"} if cfg.ffn_flash_train else set()))


def reset_launches() -> None:
    for _, m, attr in COUNTERS:
        setattr(m, attr, 0)


def launch_counts() -> dict:
    return {name: getattr(m, attr) for name, m, attr in COUNTERS}
