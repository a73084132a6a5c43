"""The port's IFF fusion blocks and the ablation FFNs against the JAX
package's modules (transception_tpu/ops/fusion.py:75-333,
ops/common.py:209-355) at fp32 on small NHWC inputs: the same weights
(JAX init with random biases, BatchNorm statistics and CAM gammas, into
the port by load_jax_variables under the stage's 'aggregate' name, where
the converter's fusion renames apply), in eval (running statistics) and
in train mode (batch statistics). Tolerance: max|port − JAX| ≤ 1e-5 ·
max|JAX| (fp32 reassociation)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

import transception_tpu.ops.common as jc
import transception_tpu.ops.fusion as jf
from transception_tpu_torch.convert.from_jax import load_jax_variables
from transception_tpu_torch.ops import common as pc
from transception_tpu_torch.ops import fusion as pf

B, S, C, P, OUT = 2, 6, 32, 3, 48
F32 = torch.float32


def _maps(seed, n=P, c=C):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, S, c)).astype(np.float32)
            for _ in range(n)]


# name -> (JAX module, port module, inputs: "cat" (the concatenated
# paths), "list" (the paths), "stack" ((B, P, H, W, C)), "map" (one
# map), "tokens" ((B, S², C)); whether it takes `train`, the container
# name).
CASES = {
    "se": (jf.SEBlock(OUT, r=16, dtype=jnp.float32),
           pf.SEBlock(C * P, OUT, 16, F32), "cat", True),
    "skn": (jf.SKBlock(C, OUT, num_path=P, reduction=8, dtype=jnp.float32),
            pf.SKBlock(C, OUT, P, 8, dtype=F32), "list", True),
    "channel_attention_cbam": (
        jf.ChannelAttentionCBAM(dtype=jnp.float32),
        pf.ChannelAttentionCBAM(C * P, 16, F32), "cat", False),
    "spatial_attention_cbam": (
        jf.SpatialAttentionCBAM(kernel_size=5, dtype=jnp.float32),
        pf.SpatialAttentionCBAM(5, F32), "cat", False),
    "cbam": (jf.CBAMBlock(OUT, use_sa=True, kernel_size=7,
                          dtype=jnp.float32),
             pf.CBAMBlock(C * P, OUT, True, 16, 7, F32), "cat", True),
    "cbam-no-sa": (jf.CBAMBlock(OUT, use_sa=False, dtype=jnp.float32),
                   pf.CBAMBlock(C * P, OUT, False, dtype=F32), "cat", True),
    "cbam_casa-res": (
        jf.CBAMBlockCasa(OUT, use_sa=True, inter="res", dtype=jnp.float32),
        pf.CBAMBlockCasa(C * P, OUT, True, inter="res", dtype=F32),
        "list", True),
    "cbam_casa-out": (
        jf.CBAMBlockCasa(OUT, use_sa=True, kernel_size=3, inter="out",
                         dtype=jnp.float32),
        pf.CBAMBlockCasa(C * P, OUT, True, kernel_size=3, inter="out",
                         dtype=F32), "list", True),
    "cam": (jf.CAMModule(dtype=jnp.float32), pf.CAMModule(), "stack",
            False),
    "cam_fact": (jf.CAMFactorizedModule(dtype=jnp.float32),
                 pf.CAMFactorizedModule(C, dtype=F32), "stack", False),
    "conv3d": (jf.Conv3dBNConcat(OUT, dtype=jnp.float32),
               pf.Conv3dBNConcat(C, OUT, P, F32), "list", True),
    "conv3d_cam": (
        jf.Conv3dBNChannelAttentionConcat(OUT, cam="cam", dtype=jnp.float32),
        pf.Conv3dBNChannelAttentionConcat(C, OUT, P, "cam", F32), "list",
        True),
    "conv3d_cam_fact": (
        jf.Conv3dBNChannelAttentionConcat(OUT, cam="cam_fact",
                                          dtype=jnp.float32),
        pf.Conv3dBNChannelAttentionConcat(C, OUT, P, "cam_fact", F32),
        "list", True),
    "mix_ffn": (jc.MixFFN(C, 4 * C, dtype=jnp.float32),
                pc.MixFFN(C, 4 * C, F32), "tokens", False),
    "mlp_ffn": (jc.MLPFFN(C, 4 * C, dtype=jnp.float32),
                pc.MLPFFN(C, 4 * C, dtype=F32), "tokens", False),
}


def _inputs(kind, seed):
    maps = _maps(seed)
    if kind == "cat":
        return (np.concatenate(maps, -1),)
    if kind == "list":
        return (maps,)
    if kind == "stack":
        return (np.stack(maps, 1),)
    return (maps[0].reshape(B, S * S, C),)


def _call_jax(name, jm, v, xs, train):
    kind = CASES[name][2]
    if kind == "tokens":
        args = xs + ((S, S) if name == "mix_ffn" else ())
        return jm.apply(v, *args), None
    if not CASES[name][3]:
        return jm.apply(v, *xs), None
    if not train:
        return jm.apply(v, *xs, train=False), None
    out, upd = jm.apply(v, *xs, train=True, mutable=["batch_stats"])
    return out, upd


def _call_port(name, pm, xs):
    kind = CASES[name][2]
    t = [torch.from_numpy(a) for a in xs[0]] if kind == "list" else \
        torch.from_numpy(xs[0])
    if name == "mix_ffn":
        return pm(t, S, S)
    return pm(t)


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    name = request.param
    jm, pm, kind, _ = CASES[name]
    xs = _inputs(kind, 0)
    v = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), *(
            xs + ((S, S) if name == "mix_ffn" else ()))))
    rng = np.random.default_rng(1)

    def spice(path, a):
        last = str(getattr(path[-1], "key", path[-1]))
        if last == "bias" or last.endswith("_bias"):
            return (a + rng.normal(size=a.shape) * 0.05).astype(np.float32)
        if last == "gamma":
            return np.full(a.shape, 0.5, np.float32)
        if last == "var":
            return (rng.random(a.shape) + 0.5).astype(np.float32)
        if last == "mean":
            return (rng.random(a.shape) * 0.2 - 0.1).astype(np.float32)
        return a
    v = jax.tree_util.tree_map_with_path(spice, dict(v))
    box = torch.nn.Module()
    where = "mlp" if kind == "tokens" else "aggregate"
    box.add_module(where, pm)
    load_jax_variables(box, {coll: {where: tree}
                             for coll, tree in v.items()}, device="cpu")
    return name, jm, v, pm


def _close(got, want):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_fusion_block_matches_jax_eval(pair):
    name, jm, v, pm = pair
    xs = _inputs(CASES[name][2], 2)
    want, _ = _call_jax(name, jm, v, xs, train=False)
    pm.eval()
    with torch.no_grad():
        _close(_call_port(name, pm, xs), want)


def test_fusion_block_matches_jax_train(pair):
    """Train mode: BatchNorm on the batch statistics (the running ones
    updated as flax's); dropout stays off (the MLP FFN called
    deterministic)."""
    name, jm, v, pm = pair
    xs = _inputs(CASES[name][2], 3)
    want, upd = _call_jax(name, jm, v, xs, train=True)
    saved = {k: t.clone() for k, t in pm.state_dict().items()}
    pm.train()
    try:
        with torch.no_grad():
            _close(_call_port(name, pm, xs), want)
        if upd is not None:
            stats = {k: t for k, t in pm.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}
            flat = jax.tree_util.tree_leaves(upd["batch_stats"])
            assert len(stats) == len(flat)
            for t in stats.values():
                assert torch.isfinite(t).all()
    finally:
        pm.load_state_dict(saved)
        pm.eval()


def test_mlp_ffn_dropout():
    """MLPFFN's dropout (rate 0.1, flax's form: kept values divided by
    0.9, the rest 0) runs only where deterministic is False, its masks
    drawn from the given generator; without one it raises."""
    m = pc.MLPFFN(8, 32, dtype=F32)
    pc.init_weights(m, torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(1))
    det = m(x)
    a = m(x, False, torch.Generator().manual_seed(4))
    b = m(x, False, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, det)
    with pytest.raises(ValueError, match="Generator"):
        m(x, False)
    h = torch.ones(1000, 100)
    d = pc.dropout(h, 0.1, torch.Generator().manual_seed(0))
    kept = d != 0
    assert torch.allclose(d[kept], torch.full_like(d[kept], 1 / 0.9))
    assert 0.08 < 1 - kept.float().mean().item() < 0.12
