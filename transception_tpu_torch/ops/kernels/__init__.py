"""Hand-written CUDA kernels of the port, one module each.

Every module holds the kernel's plain PyTorch version (same rounding points
as the Pallas kernel it replaces), a wrapper that runs the plain version
for CPU tensors (or with the kernels switched off, `enabled(False)`) and
launches the kernel (or raises) for CUDA tensors, and an integer
`launches` counter bumped once per launch.
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
from transception_tpu_torch.ops.kernels._build import enabled  # noqa: F401

MODULES = (etb_attention, mixffn, bridge_attention, expand_head, mhca_block,
           linear_attention, patch_expand)


def reset_launches() -> None:
    for m in MODULES:
        m.launches = 0


def launch_counts() -> dict:
    return {m.NAME: m.launches for m in MODULES}
