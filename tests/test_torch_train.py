"""The port's training pieces against the JAX package: BatchNorm in train
mode, the losses and the wide-label permutation, the learning-rate
schedule, and the optimizer's decay, clipping and accumulation; plus the
on-device synthetic stream's contract.

Tolerances: BatchNorm 1e-6 (fp32, the same formula); losses 1e-6
relative (fp32 reductions in another order); schedule 1e-7 relative
(optax evaluates in fp32, the port in Python floats); optimizer 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)
from flax import linen as fnn

from transception_tpu.core.config import TrainConfig as JTrainConfig
from transception_tpu.train import losses as jl
from transception_tpu.train.state import make_lr_schedule as j_schedule
from transception_tpu.train.state import make_optimizer
from transception_tpu_torch.core.config import TrainConfig
from transception_tpu_torch.data.device_synthetic import DeviceSyntheticStream
from transception_tpu_torch.ops.conv import BatchNorm
from transception_tpu_torch.train import losses as pl
from transception_tpu_torch.train.state import TrainState, make_lr_schedule


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_train_matches_flax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 4, 16)) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=16)).astype(np.float32)
    bias = (0.1 * rng.normal(size=16)).astype(np.float32)
    mean0 = rng.normal(size=16).astype(np.float32)
    var0 = (rng.random(16) + 0.5).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(xt.float().numpy())  # the same (rounded) input
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jnp.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, upd = bn.apply(variables, xj, mutable=["batch_stats"])
    m = BatchNorm(16, dtype=dtype).train()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(mean0))
        m.running_var.copy_(torch.from_numpy(var0))
    got = m(xt)
    assert got.dtype == dtype
    np.testing.assert_allclose(
        got.detach().float().numpy(),
        np.asarray(jnp.asarray(want).astype(jnp.bfloat16 if dtype ==
                                            torch.bfloat16 else jnp.float32)
                   .astype(jnp.float32)),
        rtol=1e-6 if dtype == torch.float32 else 2 ** -7, atol=1e-6)
    np.testing.assert_allclose(m.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(m.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)


def test_batchnorm_eval_uses_running_stats():
    m = BatchNorm(4, dtype=torch.float32).eval()
    with torch.no_grad():
        m.running_mean.fill_(1.0)
        m.running_var.fill_(4.0)
    x = torch.full((2, 3, 3, 4), 3.0)
    torch.testing.assert_close(m(x), torch.full_like(x, 2 / (4 + 1e-5) ** .5))
    assert torch.equal(m.running_mean, torch.ones(4))


@pytest.mark.parametrize("wide", [False, True])
def test_segmentation_loss_matches_jax(wide):
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(2, 8, 8, 9)) * 3).astype(np.float32)
    labels = rng.integers(0, 9, (2, 8, 8)).astype(np.int32)
    lj, yj = jnp.asarray(logits), jnp.asarray(labels)
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels).long()
    if wide:
        yj, yt = jl.shuffle_labels_wide(yj), pl.shuffle_labels_wide(yt)
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        lj = lj.reshape(2, 4, 16, 9)
        lt = lt.reshape(2, 4, 16, 9)
    want = jl.segmentation_loss(lj, yj, 9, 0.4, 0.6)
    got = pl.segmentation_loss(lt, yt, 9, 0.4, 0.6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    np.testing.assert_allclose(float(pl.cross_entropy_loss(lt, yt)),
                               float(jl.cross_entropy_loss(lj, yj)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(pl.dice_loss(lt, yt, 9)),
                               float(jl.dice_loss(lj, yj, 9)), rtol=1e-6)


def test_loss_gradients_match_jax():
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(2, 4, 16, 9)) * 2).astype(np.float32)
    labels = rng.integers(0, 9, (2, 4, 16)).astype(np.int32)
    want = jax.grad(lambda z: jl.segmentation_loss(
        z, jnp.asarray(labels), 9)[0])(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    pl.segmentation_loss(lt, torch.from_numpy(labels), 9)[0].backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-8)


@pytest.mark.parametrize("use_scheduler", [True, False])
def test_schedule_matches_optax(use_scheduler):
    kw = dict(base_lr=0.05, batch_size=24, max_epochs=10,
              use_scheduler=use_scheduler)
    want = j_schedule(JTrainConfig(**kw), steps_per_epoch=10)
    got = make_lr_schedule(TrainConfig(**kw), steps_per_epoch=10)
    for t in (0, 1, 2, 3, 50, 99, 100, 120):
        assert got(t) == pytest.approx(float(want(t)), rel=1e-6, abs=1e-9)


def _model(w):
    m = torch.nn.Linear(len(w), 1, bias=False)
    with torch.no_grad():
        m.weight.copy_(torch.tensor([w]))
    return m


def test_weight_decay_is_coupled():
    """decay enters the momentum buffer: update = -lr·(g + wd·p)
    (tests/test_train_step.py:128-138)."""
    cfg = TrainConfig(base_lr=1.0, batch_size=24, max_epochs=1,
                      use_scheduler=False, weight_decay=0.1, momentum=0.0)
    m = _model([2.0, 0.0])
    st = TrainState(m, cfg, 10)
    m.weight.grad = torch.tensor([[1.0, 0.0]])
    st.apply_gradients()
    torch.testing.assert_close(m.weight.detach(), torch.tensor([[0.8, 0.0]]))


def _optax_steps(cfg, grads, p0):
    tx, _ = make_optimizer(cfg, steps_per_epoch=10)
    params = {"w": jnp.asarray(p0)}
    s = tx.init(params)
    for g in grads:
        upd, s = tx.update({"w": jnp.asarray(g)}, s, params)
        params = optax.apply_updates(params, upd)
    return np.asarray(params["w"])


@pytest.mark.parametrize("clip,accum", [(False, 1), (True, 1), (False, 2)])
def test_optimizer_matches_optax(clip, accum):
    """SGD momentum + coupled decay + schedule, with clipping to norm 5
    and accumulation over two micro-steps, against the optax chain."""
    kw = dict(base_lr=0.05, batch_size=24, max_epochs=2, grad_clipping=clip,
              grad_accum_steps=accum)
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=(1, 4)).astype(np.float32)
    grads = [(rng.normal(size=(1, 4)) * 4).astype(np.float32)
             for _ in range(4)]
    want = _optax_steps(JTrainConfig(**kw), grads, p0)
    m = _model(p0[0].tolist())
    st = TrainState(m, TrainConfig(**kw), 10)
    for g in grads:
        st.zero_grad()
        gt = torch.from_numpy(g)
        m.weight.grad = gt.clone() if m.weight.grad is None else \
            m.weight.grad + gt
        st.apply_gradients()
    assert st.step == 4 and st.updates == 4 // accum
    np.testing.assert_allclose(m.weight.detach().numpy(), want, rtol=1e-6,
                               atol=1e-7)


def test_accumulation_equals_one_large_batch():
    """Two micro-steps of half batches == one step on the whole batch
    (loss means over the batch)."""
    rng = np.random.default_rng(4)
    xa, xb = (torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))
              for _ in range(2))
    base = TrainConfig(base_lr=0.1, max_epochs=1, use_scheduler=False,
                       weight_decay=0.0)
    full, acc = _model([0.5] * 4), _model([0.5] * 4)
    sf = TrainState(full, base, 100)
    sa = TrainState(acc, dataclasses.replace(base, grad_accum_steps=2), 100)
    sf.zero_grad()
    (full(torch.cat([xa, xb])) ** 2).mean().backward()
    sf.apply_gradients()
    for x in (xa, xb):
        sa.zero_grad()
        (acc(x) ** 2).mean().backward()
        sa.apply_gradients()
    torch.testing.assert_close(acc.weight, full.weight, rtol=1e-6, atol=0)


def test_cut_graph_raises():
    m = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.Linear(2, 2))
    st = TrainState(m, TrainConfig(), 10)
    m[1](torch.ones(1, 2)).sum().backward()  # m[0] gets no gradient
    with pytest.raises(RuntimeError, match="no gradient"):
        st.apply_gradients()


def test_synthetic_stream_contract():
    s = DeviceSyntheticStream(2, 16, 9, length=7, seed=5, device="cpu")
    assert len(s) == 3
    b0 = list(s)
    s.set_epoch(1)
    b1 = list(s)
    assert len(b0) == 3
    img, lbl = b0[0]["image"], b0[0]["label"]
    assert img.shape == (2, 16, 16, 1) and img.dtype == torch.float32
    assert lbl.shape == (2, 16, 16) and lbl.dtype == torch.int64
    assert 0 <= img.min() and img.max() < 1 and lbl.max() < 9
    assert torch.equal(b1[0]["image"], s.batch(3)["image"])
    assert not torch.equal(b0[0]["image"], b1[0]["image"])
    s2 = DeviceSyntheticStream(2, 16, 9, length=7, seed=5, device="cpu")
    assert torch.equal(list(s2)[1]["label"], b0[1]["label"])
