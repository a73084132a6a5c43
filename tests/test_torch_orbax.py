"""The JAX package's orbax checkpoints into the port: a JAX Trainer
checkpoint of the tiny model (tests/conftest.py tiny_config), saved by the
JAX Trainer's own save_checkpoint (trainer.py:223-233), converted by
scripts/orbax_to_torch.py into a port step_*.pt, which the port's
load_weights and Trainer.restore_checkpoint (--resume) take.

The JAX train state comes from create_train_state, with seeded random
momentum (optax trace) leaves and BatchNorm statistics, and non-zero
step and schedule count, for the recipe's three optimizer chains: plain,
grad_clipping, and accumulation over 2 micro-steps at a window boundary;
and the plain chain in the per-path MHCA layout (vectorize_paths False,
the script's --no_vectorize_paths). A checkpoint taken inside a window
is refused.

Tolerances: the converted model's fp32 eval logits within 1e-4 of the
largest JAX logit (the fp32 parity tolerance of tests/test_torch_model.py);
the momentum buffers equal to the trace leaves in the port's layout, bit
for bit; step and update count exactly; the learning rate exactly the
port schedule's at that count, and equal to optax's (which evaluates in
fp32) once rounded to fp32.
"""

import ast
import dataclasses
import functools
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
from transception_tpu.core.config import DataConfig as JDataConfig
from transception_tpu.core.config import TrainConfig as JTrainConfig
from transception_tpu.models.transception import MSTransception as JModel
from transception_tpu.ops import common as jcommon
from transception_tpu.train.state import create_train_state
from transception_tpu.train.state import make_lr_schedule as j_schedule
from transception_tpu.train.trainer import Trainer as JTrainer
from transception_tpu_torch.cli.test import load_weights
from transception_tpu_torch.convert.from_jax import load_jax_variables
from transception_tpu_torch.core.config import (
    DataConfig,
    TrainConfig,
    TransceptionConfig,
)
from transception_tpu_torch.models.transception import MSTransception
from transception_tpu_torch.train.state import make_lr_schedule
from transception_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "orbax_to_torch.py"
SPE, COUNT, B, EPOCHS = 10, 7, 4, 3
FLAGS = ["--img_size", "32", "--stage1_layers", "1", "--num_path", "2,2,2",
         "--num_layers", "1,1,1", "--dtype", "float32", "--batch_size",
         str(B), "--max_epochs", str(EPOCHS), "--steps_per_epoch", str(SPE)]
# name -> (grad_clipping, grad_accum_steps, vectorize_paths)
RECIPES = {"plain": (False, 1, True), "clip": (True, 1, True),
           "accum2": (False, 2, True), "per_path": (False, 1, False)}


def _script():
    spec = importlib.util.spec_from_file_location("orbax_to_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_config(jc):
    names = {f.name for f in dataclasses.fields(TransceptionConfig)}
    return TransceptionConfig(**{f.name: getattr(jc, f.name)
                                 for f in dataclasses.fields(jc)
                                 if f.name in names})


@functools.lru_cache(maxsize=None)
def _jax_state(jtc, stacked=True):
    """create_train_state's state with random trace leaves and BatchNorm
    statistics, COUNT updates done, at a window boundary (the stacked or
    the per-path MHCA layout)."""
    jc = tiny_config(vectorize_paths=stacked)
    state = create_train_state(JModel(jc), jtc, SPE,
                               jnp.zeros((1, 32, 32, 1)),
                               jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)

    def rand(tree, lo=-1.0):
        return jax.tree_util.tree_map(
            lambda a: rng.uniform(lo, 1.0, a.shape).astype(np.float32), tree)

    k = jtc.grad_accum_steps
    opt = state.opt_state
    inner = opt.inner_opt_state if k > 1 else opt
    inner = tuple(s._replace(trace=rand(s.trace)) if "trace" in s._fields
                  else s._replace(count=jnp.asarray(COUNT, jnp.int32))
                  if "count" in s._fields else s for s in inner)
    if k > 1:
        opt = opt._replace(inner_opt_state=inner,
                           gradient_step=jnp.asarray(COUNT, jnp.int32))
    else:
        opt = inner
    return jc, state.replace(
        opt_state=opt, batch_stats=rand(state.batch_stats, lo=0.5),
        step=jnp.asarray(COUNT * k, jnp.int32))


def _save(jc, jtc, state, out):
    """The JAX Trainer's save_checkpoint; its depthwise kernel-grad switch
    and log handler are put back after (trainer.py:196-198 set the one
    module-wide and never restore it)."""
    switch = jcommon._SAFE_DWCONV_KERNEL_GRAD
    jlog = logging.getLogger("transception_tpu")
    handlers = list(jlog.handlers)
    try:
        tr = JTrainer(jc, dataclasses.replace(jtc, output_dir=str(out)),
                      JDataConfig(dataset="synthetic", img_size=32))
        step = int(state.step)
        tr.save_checkpoint(state, step)
        return Path(tr._ckpt_dir()) / f"step_{step:08d}"
    finally:
        jcommon.set_safe_dwconv_kernel_grad(switch)
        for h in set(jlog.handlers) - set(handlers):
            jlog.removeHandler(h)
            h.close()


def _recipe_flags(clip, k, stacked=True):
    return (["--grad_clipping"] if clip else []) + \
        ["--accumulation_steps", str(k)] + \
        ([] if stacked else ["--no_vectorize_paths"])


@pytest.fixture(scope="module", params=list(RECIPES))
def converted(request, tmp_path_factory):
    clip, k, stacked = RECIPES[request.param]
    jtc = JTrainConfig(batch_size=B, max_epochs=EPOCHS, grad_clipping=clip,
                       grad_accum_steps=k)
    jc, state = _jax_state(jtc, stacked)
    out = tmp_path_factory.mktemp(f"orbax_{request.param}")
    src = _save(jc, jtc, state, out / "jax")
    path = _script().main(["--orbax_dir", str(src), "--output_dir",
                           str(out / "port"), *FLAGS,
                           *_recipe_flags(clip, k, stacked)])
    tc = TrainConfig(batch_size=B, max_epochs=EPOCHS, grad_clipping=clip,
                     grad_accum_steps=k, output_dir=str(out / "port"))
    yield jc, jtc, tc, state, Path(path)
    shutil.rmtree(out, ignore_errors=True)  # ~340 MB of checkpoints


@pytest.fixture(scope="module")
def jax_forward():
    """The JAX forward of a config's model (jitted once a config)."""
    return functools.lru_cache(maxsize=None)(
        lambda jc: jax.jit(lambda v, x: JModel(jc).apply(v, x)))


def test_counters_and_lr_equal_jax(converted):
    jc, jtc, tc, state, path = converted
    sd = torch.load(path, weights_only=True)
    assert path.name == f"step_{int(state.step):08d}.pt"
    assert sd["step"] == int(state.step)
    assert sd["schedule"]["updates"] == COUNT
    lr = sd["schedule"]["lr"]
    assert lr == make_lr_schedule(tc, SPE)(COUNT)
    assert np.float32(lr) == np.float32(j_schedule(jtc, SPE)(COUNT))


def test_momentum_buffers_are_the_trace(converted):
    """Each parameter's momentum buffer is its trace leaf in the port's
    layout: load_jax_variables of the trace as params gives the same
    tensors."""
    jc, jtc, tc, state, path = converted
    opt = state.opt_state
    inner = opt.inner_opt_state if jtc.grad_accum_steps > 1 else opt
    trace = next(s.trace for s in inner if "trace" in s._fields)
    ref = load_jax_variables(
        MSTransception(_port_config(jc), device="cpu"),
        {"params": jax.tree_util.tree_map(np.asarray, trace),
         "batch_stats": jax.tree_util.tree_map(np.asarray,
                                               state.batch_stats)},
        device="cpu")
    sd = torch.load(path, weights_only=True)
    bufs = sd["optimizer"]["state"]
    names = [n for n, _ in ref.named_parameters()]
    assert len(bufs) == len(names)
    for i, (n, p) in enumerate(ref.named_parameters()):
        assert torch.equal(bufs[i]["momentum_buffer"], p.detach()), n


def test_load_weights_gives_jax_logits(converted, jax_forward):
    jc, _, _, state, path = converted
    m = load_weights(str(path), MSTransception(_port_config(jc),
                                               device="cpu"))
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 1)).astype(
        np.float32)
    want = np.asarray(jax_forward(jc)({"params": state.params,
                                       "batch_stats": state.batch_stats},
                                      x))
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_resume_takes_the_converted_checkpoint(converted):
    """--resume's path: the port Trainer of output_dir finds the file as
    its latest checkpoint and restores model, momentum and counters."""
    jc, _, tc, state, path = converted
    tr = Trainer(_port_config(jc), tc,
                 DataConfig(dataset="synthetic", img_size=32), device="cpu")
    assert tr.latest_checkpoint() == str(path)
    st, _ = tr.init_state(SPE)
    tr.restore_checkpoint(st, tr.latest_checkpoint())
    assert (st.step, st.updates) == (int(state.step), COUNT)
    sd = torch.load(path, weights_only=True)
    for n, t in tr.model.state_dict().items():
        assert torch.equal(t, sd["model"][n]), n
    for i, p in enumerate(tr.model.parameters()):
        assert torch.equal(st.optimizer.state[p]["momentum_buffer"],
                           sd["optimizer"]["state"][i]["momentum_buffer"])


def test_mid_window_checkpoint_raises(tmp_path):
    """One micro-step into the window after the accumulation recipe's."""
    jtc = JTrainConfig(batch_size=B, max_epochs=EPOCHS, grad_accum_steps=2)
    jc, state = _jax_state(jtc)
    state = state.replace(
        opt_state=state.opt_state._replace(
            mini_step=jnp.asarray(1, jnp.int32)),
        step=state.step + 1)
    src = _save(jc, jtc, state, tmp_path / "jax")
    try:
        with pytest.raises(ValueError, match="1 micro-steps into an "
                                             "accumulation window of 2"):
            _script().main(["--orbax_dir", str(src), "--output_dir",
                            str(tmp_path / "port"), *FLAGS,
                            *_recipe_flags(False, 2)])
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


def test_recipe_mismatch_raises(converted, tmp_path):
    """A chain that is not the flags' recipe is refused, not misread."""
    jc, jtc, tc, state, path = converted
    src = next(Path(tc.output_dir).parent.glob("jax/ckpt/step_*"))
    clip, k = jtc.grad_clipping, jtc.grad_accum_steps
    with pytest.raises(ValueError, match="optimizer chain|MultiSteps"):
        _script().main(["--orbax_dir", str(src), "--output_dir",
                        str(tmp_path), *FLAGS,
                        *_recipe_flags(not clip, 3 - k,
                                       jc.vectorize_paths)])


def test_script_imports_nothing_of_the_jax_package():
    tree = ast.parse(SCRIPT.read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names] + [n.module for n in ast.walk(tree)
                                 if isinstance(n, ast.ImportFrom)]
    assert not [m for m in mods if m.split(".")[0] == "transception_tpu"]
    assert "orbax.checkpoint" in mods
