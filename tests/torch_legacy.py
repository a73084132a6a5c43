"""Shared pieces of the legacy-model tests (tests/test_torch_legacy_*.py):
the port's config of a JAX one, seeded perturbations of the port's init,
and the port's weights carried into a JAX variable tree by the JAX
package's own converter (convert/torch2flax.py convert_state_dict), with
no JAX init compiled."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from transception_tpu.convert.torch2flax import convert_state_dict
from transception_tpu_torch.convert.from_jax import load_jax_variables
from transception_tpu_torch.core.config import TransceptionConfig


def port_config(jc, **kw):
    """The port's TransceptionConfig of a JAX one (the shared fields)."""
    names = {f.name for f in dataclasses.fields(TransceptionConfig)}
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)
              if f.name in names}
    fields.update(kw)
    return TransceptionConfig(**fields)


def perturb(model, seed):
    """Random biases and BatchNorm statistics, in place (zero biases and
    unit statistics would hide their paths)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_mean"):
                t.copy_(torch.rand(t.shape, generator=g) * 0.2 - 0.1)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif name.endswith("bias"):
                t.add_(torch.randn(t.shape, generator=g) * 0.02)


def flax_named(sd):
    """The port's state_dict with the SK fusion's Sequential keys under
    the legacy encoder's sk_concat{s} (conv_bn_ac.0/.2) renamed to the
    flax names conv/bn: the JAX converter tries the Sequential placements
    only under 'aggregate' (torch2flax.py:122-139); the port's converter
    under sk_concat{s} too (convert/from_jax.py _candidate_keys)."""
    out = {}
    for k, t in sd.items():
        k = re.sub(r"(sk_concat\d)\.conv_bn_ac\.0\.", r"\1.conv.", k)
        out[re.sub(r"(sk_concat\d)\.conv_bn_ac\.2\.", r"\1.bn.", k)] = t
    return out


def to_jax(module, pm, *init_args, **init_kw):
    """(JAX variables of flax `module` holding the port module pm's
    weights, the converter's report): the variable tree's shapes from
    jax.eval_shape of module.init(key, *init_args, **init_kw)."""
    shapes = jax.eval_shape(lambda k: module.init(k, *init_args, **init_kw),
                            jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    # Copies: JAX on the CPU may alias numpy memory, and its calls run
    # asynchronously, so a view of a port buffer that the port's next
    # train-mode forward updates in place could be read after it.
    sd = flax_named({k: t.numpy().copy()
                     for k, t in pm.state_dict().items()})
    v, report = convert_state_dict(sd, zeros)
    return jax.tree_util.tree_map(np.asarray, v), report


def model_pair(jm, pm, img, seed=1):
    """The port model pm, perturbed from `seed`, and the JAX variables of
    flax model jm holding its weights (an (1, img, img, 1) input)."""
    perturb(pm, seed)
    v, report = to_jax(jm, pm, jnp.zeros((1, img, img, 1)))
    return jm, v, pm, report


def image(n=2, img=32, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, img, img, 1)).astype(np.float32)


def check_logits(pair, img):
    """fp32 logits of the pair's port model against the JAX model's on
    the same numpy input: within 1e-4 of max|JAX logit|."""
    jm, v, pm, _ = pair
    x = image(img=img)
    want = np.asarray(jax.jit(jm.apply)(v, x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, img, img, 9)
    assert got.dtype == np.float32 and np.isfinite(want).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def check_round_trip(pair, rebuild):
    """Every port tensor reaches a JAX leaf, and the JAX variables load
    back strictly into a fresh port model, bit for bit."""
    jm, v, pm, report = pair
    assert report["unused_torch_keys"] == []
    back = rebuild()
    load_jax_variables(back, v, device="cpu")
    want = pm.state_dict()
    assert set(back.state_dict()) == set(want)
    for k, t in back.state_dict().items():
        assert torch.equal(t, want[k]), k


def train_step_pair(name, jc, seed=1, batch=2):
    """One train step of registry model `name` at JAX config jc in both
    packages, from the same weights (the port's seeded init, perturbed,
    carried into JAX) on the same numpy batch, without the wide head:
    JAX make_train_step (and jax.grad of its loss for the gradients)
    against the port's make_train_step. Returns (JAX metrics, gradients
    and variables after the step, each as port-layout tensors; the port's
    metrics, gradients and state_dict after the step)."""
    from transception_tpu.core.config import TrainConfig as JTrainConfig
    from transception_tpu.models.registry import create_model as jcreate
    from transception_tpu.train.losses import segmentation_loss as j_loss
    from transception_tpu.train.state import TrainState as JState
    from transception_tpu.train.state import make_optimizer
    from transception_tpu.train.trainer import make_train_step as j_step
    from transception_tpu_torch.core.config import TrainConfig
    from transception_tpu_torch.models.registry import create_model
    from transception_tpu_torch.train.state import TrainState
    from transception_tpu_torch.train.trainer import make_train_step

    img, spe = jc.img_size, 4
    tc = dict(batch_size=batch, max_epochs=2)
    jm = jcreate(name, jc)
    pm = create_model(name, port_config(jc), device="cpu", seed=seed)
    _, v, _, _ = model_pair(jm, pm, img, seed)
    rng = np.random.default_rng(seed)
    x = rng.random((batch, img, img, 1)).astype(np.float32)
    y = rng.integers(0, 9, (batch, img, img)).astype(np.int32)

    tx, _ = make_optimizer(JTrainConfig(**tc), spe)
    step = j_step(jm, 9, 0.4, 0.6)

    def loss_fn(params, bs):
        out, _ = jm.apply({"params": params, "batch_stats": bs}, x,
                          train=True, mutable=["batch_stats"])
        return j_loss(out, y, 9, 0.4, 0.6)[0]

    bs = v.get("batch_stats", {})
    st = JState(step=jnp.zeros((), jnp.int32), params=v["params"],
                batch_stats=bs, opt_state=tx.init(v["params"]), tx=tx)
    grads, (st, metrics) = jax.jit(lambda st: (
        jax.grad(loss_fn)(st.params, st.batch_stats),
        step(st, x, y, jax.random.PRNGKey(0))))(st)

    def port_tensors(tree):
        m = create_model(name, pm.cfg, device="cpu")
        load_jax_variables(m, jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")
        return m.state_dict()

    jax_out = ({k: float(t) for k, t in metrics.items()},
               port_tensors({"params": grads, "batch_stats": bs}),
               port_tensors({"params": st.params,
                             "batch_stats": st.batch_stats}))
    pst = TrainState(pm, TrainConfig(**tc), spe)
    met = make_train_step(pst, 9, 0.4, 0.6)(
        torch.from_numpy(x), torch.from_numpy(y).long())
    port_out = ({k: float(t) for k, t in met.items()},
                {n: p.grad.clone() for n, p in pm.named_parameters()},
                {k: t.clone() for k, t in pm.state_dict().items()})
    return jax_out, port_out


def check_train_step(jax_out, port_out):
    """tests/test_torch_train_step.py's tolerances: losses within 1e-5
    relative and each gradient leaf within 1e-4 of its own max plus 1e-6
    of the largest gradient, none zero where JAX's is not (its step 1,
    :185-194); the parameters and BatchNorm statistics after the update
    within 1e-4 relative plus 1e-5 elementwise (:197-204: a running mean
    near 0 holds the fp32 noise of a batch moment, 1e-6 of the map's
    scale)."""
    (jm, jg, js), (pm, pg, ps) = jax_out, port_out
    for k, want in jm.items():
        assert abs(pm[k] - want) <= 1e-5 * abs(want), k
    top = max(t.abs().max().item() for n, t in jg.items() if n in pg)
    for n, g in pg.items():
        want = jg[n]
        assert g.shape == want.shape, n
        err = (g - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item() + 1e-6 * top, n
        if want.abs().max() > 1e-6 * top:
            assert g.abs().max() > 0, n
    for n, t in ps.items():
        torch.testing.assert_close(t, js[n], rtol=1e-4, atol=1e-5, msg=n)
