"""A legacy model's JAX orbax checkpoint into the port: a JAX Trainer
checkpoint of ResInception ('resinception', tests/conftest.py
tiny_config), saved by the JAX Trainer's own save_checkpoint
(trainer.py:223-233), converted by scripts/orbax_to_torch.py --model
resinception into a port step_*.pt. The JAX train state comes from
create_train_state with seeded random momentum (optax trace) leaves and
BatchNorm statistics (the MultiRes branches'), and a non-zero step and
schedule count.

Tolerances (tests/test_torch_orbax.py's): the converted model's fp32
eval logits within 1e-4 of the largest JAX logit; the BatchNorm
statistics and the momentum buffers equal to the JAX leaves in the port's
layout, bit for bit; step and update count exactly."""

import dataclasses
import importlib.util
import logging
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from conftest import tiny_config
from torch_legacy import port_config
from transception_tpu.core.config import DataConfig as JDataConfig
from transception_tpu.core.config import TrainConfig as JTrainConfig
from transception_tpu.models.registry import create_model as jcreate
from transception_tpu.ops import common as jcommon
from transception_tpu.train.state import create_train_state
from transception_tpu.train.trainer import Trainer as JTrainer
from transception_tpu_torch.cli.test import load_weights
from transception_tpu_torch.convert.from_jax import load_jax_variables
from transception_tpu_torch.core.config import DataConfig, TrainConfig
from transception_tpu_torch.models.registry import create_model
from transception_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "orbax_to_torch.py"
NAME = "resinception"
SPE, COUNT, B, EPOCHS = 10, 7, 4, 3
FLAGS = ["--model", NAME, "--img_size", "32", "--stage1_layers", "1",
         "--num_path", "2,2,2", "--num_layers", "1,1,1", "--dtype",
         "float32", "--batch_size", str(B), "--max_epochs", str(EPOCHS),
         "--steps_per_epoch", str(SPE)]


def _script():
    spec = importlib.util.spec_from_file_location("orbax_to_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    jc = tiny_config()
    jtc = JTrainConfig(batch_size=B, max_epochs=EPOCHS)
    state = create_train_state(jcreate(NAME, jc), jtc, SPE,
                               jnp.zeros((1, 32, 32, 1)),
                               jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)

    def rand(tree, lo=-1.0):
        return jax.tree_util.tree_map(
            lambda a: rng.uniform(lo, 1.0, a.shape).astype(np.float32), tree)

    opt = tuple(s._replace(trace=rand(s.trace)) if "trace" in s._fields
                else s._replace(count=jnp.asarray(COUNT, jnp.int32))
                if "count" in s._fields else s for s in state.opt_state)
    state = state.replace(opt_state=opt,
                          batch_stats=rand(state.batch_stats, lo=0.5),
                          step=jnp.asarray(COUNT, jnp.int32))
    out = tmp_path_factory.mktemp("orbax_resinception")
    # The JAX Trainer's save_checkpoint; its depthwise kernel-grad switch
    # and log handler put back after (trainer.py:196-198 set the one
    # module-wide and never restore it).
    switch = jcommon._SAFE_DWCONV_KERNEL_GRAD
    jlog = logging.getLogger("transception_tpu")
    handlers = list(jlog.handlers)
    try:
        tr = JTrainer(jc, dataclasses.replace(jtc, output_dir=str(out)),
                      JDataConfig(dataset="synthetic", img_size=32))
        tr.save_checkpoint(state, COUNT)
        src = Path(tr._ckpt_dir()) / f"step_{COUNT:08d}"
    finally:
        jcommon.set_safe_dwconv_kernel_grad(switch)
        for h in set(jlog.handlers) - set(handlers):
            jlog.removeHandler(h)
            h.close()
    path = _script().main(["--orbax_dir", str(src), "--output_dir",
                           str(out / "port"), *FLAGS])
    tc = TrainConfig(batch_size=B, max_epochs=EPOCHS,
                     output_dir=str(out / "port"))
    yield jc, tc, state, Path(path)
    shutil.rmtree(out, ignore_errors=True)


def _model(jc):
    return create_model(NAME, port_config(jc), device="cpu")


def test_load_weights_gives_jax_logits(converted):
    jc, _, state, path = converted
    m = load_weights(str(path), _model(jc))
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 1)).astype(
        np.float32)
    jm = jcreate(NAME, jc)
    want = np.asarray(jax.jit(jm.apply)(
        {"params": state.params, "batch_stats": state.batch_stats}, x))
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_batchnorm_statistics_and_momentum_are_jax_leaves(converted):
    """The MultiRes branches' running statistics are the checkpoint's
    batch_stats, and each momentum buffer its trace leaf, in the port's
    layout (load_jax_variables of the same trees), bit for bit; step and
    schedule count exactly."""
    jc, _, state, path = converted
    sd = torch.load(path, weights_only=True)
    assert (sd["step"], sd["schedule"]["updates"]) == (COUNT, COUNT)
    ref = load_jax_variables(_model(jc), jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats}), device="cpu")
    stats = [k for k in ref.state_dict() if "running_" in k]
    assert stats and all(".resInception" in k for k in stats)
    for k in stats:
        assert torch.equal(sd["model"][k], ref.state_dict()[k]), k
    trace = next(s.trace for s in state.opt_state if "trace" in s._fields)
    mom = load_jax_variables(_model(jc), jax.tree_util.tree_map(
        np.asarray, {"params": trace, "batch_stats": state.batch_stats}),
        device="cpu")
    bufs = sd["optimizer"]["state"]
    for i, (n, p) in enumerate(mom.named_parameters()):
        assert torch.equal(bufs[i]["momentum_buffer"], p.detach()), n


def test_resume_takes_the_converted_checkpoint(converted):
    jc, tc, state, path = converted
    tr = Trainer(port_config(jc), tc,
                 DataConfig(dataset="synthetic", img_size=32), device="cpu",
                 model=_model(jc))
    assert tr.latest_checkpoint() == str(path)
    st, _ = tr.init_state(SPE)
    tr.restore_checkpoint(st, tr.latest_checkpoint())
    assert (st.step, st.updates) == (COUNT, COUNT)
    sd = torch.load(path, weights_only=True)
    for n, t in tr.model.state_dict().items():
        assert torch.equal(t, sd["model"][n]), n
