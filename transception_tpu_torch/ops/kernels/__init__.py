"""Hand-written CUDA kernels of the port, one module each.

Every module holds the kernel's plain PyTorch version (same rounding points
as the Pallas kernel it replaces), a wrapper that runs the plain version
for CPU tensors (or with the kernel switched off, `enabled(...)`) and
launches the kernel (or raises) for CUDA tensors, and an integer
`launches` counter bumped once per launch, beside a tally of the launch's
shape (`shape_counts`). bridge_attention and mixffn also hold their
backward kernels (K10, K11) with a `bwd_launches` counter, and join
forward and backward in a torch.autograd.Function; bridge_attention also
holds the folded bridge attention (K8, `folded_launches`), mixffn the
unfolded MixFFN_skip (K9, `skip_launches`). The forward kernels without a
backward kernel (K1, K5-K9) are differentiated through their plain
versions (_build.with_plain_backward, as the JAX custom VJPs through their
jnp mirrors); K4, the eval argmax head, refuses to run where autograd
records (_build.forward_only).
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
from transception_tpu_torch.ops.kernels import _build
from transception_tpu_torch.ops.kernels._build import (  # noqa: F401
    SWITCHES,
    enabled,
)

# (count name, module, counter attribute) of every kernel.
COUNTERS = tuple((m.NAME, m, "launches") for m in (
    etb_attention, mixffn, bridge_attention, expand_head, mhca_block,
    linear_attention, patch_expand)) + (
    (bridge_attention.BWD_NAME, bridge_attention, "bwd_launches"),
    (mixffn.BWD_NAME, mixffn, "bwd_launches"),
    (bridge_attention.FOLDED_NAME, bridge_attention, "folded_launches"),
    (mixffn.SKIP_NAME, mixffn, "skip_launches"))


def kernel_set(cfg, training: bool) -> frozenset:
    """The kernels a model with config `cfg` runs: every kernel in eval
    (which of them a block calls follows its fold switches,
    core.config.fold_switches); in training, as the JAX package's
    train_step_model (train/trainer.py:90-119) gates them, every kernel
    with use_pallas_train (those without a backward kernel differentiated
    through their plain versions), else only those with a backward kernel:
    the bridge attention (K3 + K10), plus the MixFFN folds (K2 + K11) with
    ffn_flash_train; none with use_kernels=False."""
    if not cfg.use_kernels:
        return frozenset()
    if not training or cfg.use_pallas_train:
        return SWITCHES
    return frozenset({"bridge_attention"}
                     | ({"mixffn"} if cfg.ffn_flash_train else set()))


def reset_launches() -> None:
    for _, m, attr in COUNTERS:
        setattr(m, attr, 0)
    _build.shape_launches.clear()
    _build.routed.clear()


def launch_counts() -> dict:
    return {name: getattr(m, attr) for name, m, attr in COUNTERS}


def shape_counts() -> dict:
    """Launches since reset_launches per (name, shape key) as the wrappers
    tallied them (_build.tally): the counters of launch_counts split by
    the shapes they ran at."""
    return dict(_build.shape_launches)


def routed_counts() -> dict:
    """Wrapper calls since reset_launches that chose their kernel, per
    switch name (_build.plain), on any device: on the CPU the count of
    forward launches a card would make."""
    return dict(_build.routed)
