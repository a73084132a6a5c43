"""TransceptionConfig.remat in the port: each MHCA stage of the 3-stage
backbone recomputed in the backward (torch.utils.checkpoint), where the
JAX package applies nn.remat (msvit.py:198-199). On the CPU, over two
train steps with drop path on, remat on and off give the same losses,
gradients, BatchNorm statistics, weights and drop-path generator state
bit for bit (the recompute redraws the forward's masks and does not
commit the BatchNorm statistics twice); against JAX with remat=True
(tests/test_sp_remat.py:174's counterpart), the same eval forward and
the same gradients and BatchNorm statistics of a train-mode loss;
launches_per_step counts the recompute's launches; the casa and 4-stage
backbones take no remat, as in JAX."""

import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from conftest import tiny_config
from test_torch_train_step import _port_config, _port_tensors
from transception_tpu.models.transception import MSTransception as JModel
from transception_tpu_torch.convert.from_jax import load_jax_variables
from transception_tpu_torch.core.config import TrainConfig, TransceptionConfig
from transception_tpu_torch.models import msvit
from transception_tpu_torch.models.transception import (
    MSTransception,
    launches_per_step,
)
from transception_tpu_torch.ops import kernels
from transception_tpu_torch.train.state import TrainState
from transception_tpu_torch.train.trainer import make_train_step

# Drop path on (MHCA rates 0 ... 0.3 over 2 layers a stage), "pallas"
# mode (every kernel's wrapper routed, K9 on the drop-path blocks).
CFG = TransceptionConfig(img_size=32, dtype="float32", stage1_layers=1,
                         num_path=(2, 2, 2), num_layers=(2, 2, 2),
                         drop_path_rate=0.3, use_pallas_train=True,
                         mhca_ffn_fold=True)


def _two_steps(remat: bool, cfg=CFG):
    m = MSTransception(dataclasses.replace(cfg, remat=remat), device="cpu",
                       seed=3)
    gen = torch.Generator().manual_seed(5)
    st = TrainState(m, TrainConfig(batch_size=4, max_epochs=2), 4, gen)
    step = make_train_step(st, 9, 0.4, 0.6, wide_head=True, gen=gen)
    rng = np.random.default_rng(0)
    out, routed = [], Counter()
    for _ in range(2):
        x = torch.from_numpy(rng.random((4, 32, 32, 1), dtype=np.float32))
        y = torch.from_numpy(rng.integers(0, 9, (4, 32, 32)))
        with torch.no_grad():
            logits = m.eval()(x)
        kernels.reset_launches()
        metrics = {k: v.item() for k, v in step(x, y).items()}
        routed.update(kernels.routed_counts())
        out.append(dict(metrics=metrics, logits=logits,
                        grads={n: p.grad.clone()
                               for n, p in m.named_parameters()}))
    return out, {k: v.clone() for k, v in m.state_dict().items()}, \
        gen.get_state(), dict(routed)


@pytest.fixture(scope="module")
def runs():
    return _two_steps(False), _two_steps(True)


def test_remat_steps_equal_plain_steps_bit_for_bit(runs):
    (a, sa, ga, _), (b, sb, gb, _) = runs
    for sa_, sb_ in zip(a, b):
        assert sa_["metrics"] == sb_["metrics"]
        assert torch.equal(sa_["logits"], sb_["logits"])
        for n, g in sa_["grads"].items():
            assert torch.equal(g, sb_["grads"][n]), n
    for k, t in sa.items():  # weights and BatchNorm statistics
        assert torch.equal(t, sb[k]), k
    assert torch.equal(ga, gb)  # the next draw is the same


def test_remat_recompute_counts_in_launches_per_step(runs):
    """The recompute routes each MHCA stage's kernels once more, as
    launches_per_step(remat=True) counts them (two steps)."""
    (_, _, _, ra), (_, _, _, rb) = runs
    for remat, routed in ((False, ra), (True, rb)):
        want = launches_per_step(dataclasses.replace(CFG, remat=remat))
        assert routed == {k: 2 * n for k, n in want.items()
                          if n and k not in ("bridge_attention_bwd",
                                             "mixffn_bwd")}
    assert rb["linear_attention"] > ra["linear_attention"]
    assert rb["etb_attention"] == ra["etb_attention"]


def test_recompute_redraws_the_forward_masks():
    """A stage whose recompute drew new masks would differ from the
    forward: run_stage's second call sees the generator as the first
    did, and leaves it where the first left it."""
    gen = torch.Generator().manual_seed(11)
    draws = []

    class Stage(torch.nn.Module):
        def forward(self, xs, g):
            u = torch.rand(xs[0].shape, generator=g)
            draws.append(u)
            return xs[0] * u

    x = torch.ones(3, requires_grad=True)
    y = msvit.remat_stage(Stage(), [x], gen)
    after = gen.get_state()
    y.sum().backward()
    assert len(draws) == 2 and torch.equal(draws[0], draws[1])
    assert torch.equal(gen.get_state(), after)
    assert torch.equal(x.grad, draws[0])


@pytest.mark.parametrize("stage_3or4,concat", [(4, "coord"), (0, "cbam")])
def test_casa_and_4stage_take_no_remat(stage_3or4, concat):
    cfg = dataclasses.replace(CFG, remat=True, stage_3or4=stage_3or4,
                              concat=concat)
    m = MSTransception(cfg, device="cpu")
    assert not getattr(m.backbone, "remat", False)
    assert launches_per_step(cfg) == launches_per_step(
        dataclasses.replace(cfg, remat=False))


@pytest.fixture(scope="module")
def jax_remat():
    """JAX with remat=True: the eval forward, and the gradients and
    updated batch_stats of mean((logits - 1)²) in train mode."""
    jc = tiny_config(remat=True, img_size=64)
    jm = JModel(jc)
    x = np.random.default_rng(5).random((2, 64, 64, 1)).astype(np.float32)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(
        jm.init, static_argnames=("train",))(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)), train=False))

    def loss(params, bs, x):
        o, upd = jm.apply({"params": params, "batch_stats": bs}, x,
                          train=True, mutable=["batch_stats"])
        return jnp.mean((o - 1.0) ** 2), upd["batch_stats"]

    out = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x)
    (_, bs), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"], v["batch_stats"], x)
    return jc, v, x, np.asarray(out), jax.tree_util.tree_map(
        np.asarray, g), jax.tree_util.tree_map(np.asarray, bs)


def test_remat_matches_jax_remat(jax_remat):
    jc, v, x, jout, jg, jbs = jax_remat
    m = MSTransception(_port_config(jc), device="cpu")
    assert m.cfg.remat and m.backbone.remat
    load_jax_variables(m, v, device="cpu")
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out = m(xt).numpy()
    np.testing.assert_allclose(out, jout, rtol=1e-5, atol=1e-5)
    m.train()
    loss = ((m(xt) - 1.0) ** 2).mean()
    loss.backward()
    want = _port_tensors(jc, {"params": jg, "batch_stats": v["batch_stats"]})
    top = max(t.abs().max().item() for t in want.values())
    for n, p in m.named_parameters():
        err = (p.grad - want[n]).abs().max().item()
        assert err <= 1e-4 * want[n].abs().max().item() + 1e-6 * top, n
    # The BatchNorm statistics committed once, as flax's nn.remat does.
    stats = _port_tensors(jc, {"params": v["params"], "batch_stats": jbs})
    for k, t in m.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(t, stats[k], rtol=1e-5, atol=1e-6,
                                       msg=k)
