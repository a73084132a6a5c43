"""Port kernel K8 (folded bridge attention, res + proj(MHA(x·Wq + bq))):
the plain PyTorch version against the Pallas kernel in interpret mode
(bf16) and against its jnp mirror `_reference_folded` (fp32), and the
bridge layer's folded route against its unfolded one.

Tolerances: fp32 to reassociation (2e-5 of the output scale, as K3's
test). bf16: both sides round q, e = exp(l − m), the attention output, the
projection and the sum at the same points and differ only where another
fp32 summation order flips one of those roundings; the branch (output
minus res) is held within 2 bf16 ulps of its scale (as K3's bf16 test),
with under 2% of its elements off at all.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu.ops.pallas.bridge_attention import _reference_folded
from transception_tpu.ops.pallas.bridge_attention_kernel import (
    bridge_attention_folded as pallas_folded,
)
from transception_tpu_torch.ops.kernels import bridge_attention as ba


def _inputs(B, N, C, heads, M, seed=0):
    """numpy x, res, wq, bq, k, v, wp, bp; wq/wp in the JAX (in, out)
    layout."""
    rng = np.random.default_rng(seed)

    def r(*shape, f=1.0):
        return (rng.normal(size=shape) * f).astype(np.float32)

    d = C // heads
    return (r(B, N, C), r(B, N, C), r(C, C, f=0.2), r(C, f=0.1),
            r(B, heads, M, d), r(B, heads, M, d), r(C, C, f=0.2), r(C, f=0.1))


def _torch(args, dtype=torch.float32):
    """The numpy inputs as the port takes them: weights (out, in), the
    streams and k/v in `dtype`."""
    x, res, wq, bq, k, v, wp, bp = (torch.from_numpy(np.array(a))
                                    for a in args)
    return (x.to(dtype), res.to(dtype), wq.T, bq, k.to(dtype), v.to(dtype),
            wp.T, bp)


@pytest.mark.parametrize("B,N,C,heads,M", [(2, 600, 64, 1, 96),
                                           (1, 512, 64, 8, 32)])
def test_plain_matches_reference_fp32(B, N, C, heads, M):
    args = _inputs(B, N, C, heads, M, seed=1)
    scale = (C // heads) ** -0.5
    want = np.asarray(_reference_folded(*map(jnp.asarray, args), scale))
    got = ba.bridge_attention_folded_plain(*_torch(args), scale).numpy()
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


def test_plain_matches_pallas_interpret_bf16():
    """The published head (d = 64) on a 600-row stream: the Pallas kernel
    pads it to two 512-row tiles, the port masks its ragged tile."""
    args = _inputs(2, 600, 64, 1, 96, seed=2)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in args]
    x, res = (np.asarray(t.astype(jnp.float32)) for t in bf[:2])
    k, v = (np.asarray(t.astype(jnp.float32)) for t in bf[4:6])
    want = np.asarray(pallas_folded(
        bf[0], bf[1], args[2], args[3], bf[4], bf[5], args[6], args[7],
        scale=0.125, interpret=True), np.float32)
    got = ba.bridge_attention_folded(*_torch(
        (x, res, args[2], args[3], k, v, args[6], args[7]), torch.bfloat16),
        0.125).float().numpy()
    branch_got, branch_want = got - res, want - res
    err = np.abs(branch_got - branch_want)
    assert err.max() <= 2 * 2.0 ** -8 * np.abs(branch_want).max()
    assert (err > 0).mean() <= 0.02


def test_cpu_dispatch_runs_plain_and_counts_nothing():
    args = _torch(_inputs(1, 100, 64, 1, 32, seed=3), torch.bfloat16)
    before = ba.folded_launches
    out = ba.bridge_attention_folded(*args, 0.125)
    assert ba.folded_launches == before
    assert torch.equal(out, ba.bridge_attention_folded_plain(*args, 0.125))


@pytest.mark.parametrize("case", ["fp32", "heads", "M"])
def test_kernel_checks_raise(case):
    x = torch.zeros(1, 100, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 1, 32, 64, dtype=torch.bfloat16)
    if case == "fp32":
        x = x.float()
    elif case == "heads":
        k = torch.zeros(1, 2, 32, 32, dtype=torch.bfloat16)
    else:
        k = torch.zeros(1, 1, 30, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ba._check_folded(x, x, k, k)


@pytest.mark.parametrize("scale", [0.0, -0.125])
def test_folded_launcher_refuses_a_non_positive_scale(scale):
    """K8 takes the row max on the raw logits (bridge_softmax.cuh
    softmax_av), which is the max of the scaled ones only for scale > 0:
    its launcher raises before it checks shapes or touches the card."""
    x = torch.zeros(1, 100, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 1, 32, 64, dtype=torch.bfloat16)
    w, b = torch.zeros(64, 64), torch.zeros(64)
    with pytest.raises(ValueError, match="scale > 0"):
        ba._launch_folded(x, x, w, b, k, k, w, b, scale)


def test_bridge_layer_folded_route_matches_unfolded_fp32():
    """MEfficientSelfAtten with bridge_attn_fold (the folded kernel's
    plain version) gives the unfolded chain's result: q Dense -> K3 ->
    proj -> + residual."""
    from transception_tpu_torch.core.config import (
        TransceptionConfig,
        fold_table,
    )
    from transception_tpu_torch.models.bridge import (
        BridgeGeometry,
        MEfficientSelfAtten,
    )
    from transception_tpu_torch.ops.common import init_weights
    geo = BridgeGeometry(32, (64, 128, 320, 512), 64)
    mods = [MEfficientSelfAtten(64, 1, geo, (1, 2, 4, 8), torch.float32,
                                fold_table(TransceptionConfig(
                                    bridge_attn_fold=f)))
            for f in (False, True)]
    init_weights(mods[0], torch.Generator().manual_seed(0))
    mods[1].load_state_dict(mods[0].state_dict())
    g = torch.Generator().manual_seed(1)
    x, res = (torch.randn(2, geo.total, 64, generator=g) for _ in range(2))
    with torch.no_grad():
        a, b = (m.eval()(x, residual=res) for m in mods)
    assert torch.allclose(a, b, rtol=0, atol=2e-5 * a.abs().max().item())
