"""The fold switches of the PyTorch port: the tiny-config model under every
fold configuration of the grid (chip_smoke.FOLD_GRID: the JAX package's
sweep, scripts/measure_folds.py:56-67, plus the MHCA block unfolded with
its FFN fold off and on) against JAX MSTransception, and the
expected-launch helper that chip_smoke.py holds the card's counters to.

On the CPU no JAX fold kernel engages (every can_fold_* facade is false
off the TPU), so every fold configuration of the JAX model computes the
same function in XLA: the reference is built once, with the default
switches, and one case shows that the all-on JAX model gives the same
logits. Tolerance, fp32: max |port − JAX| ≤ 1e-5 · max |JAX logit| (the
port's folded and unfolded routes are the same math in another fp32
summation order; measured ≤ 1.5e-6 here, test_torch_model.py allows 1e-4
through the same ~40 layers).
"""

import dataclasses
from collections import Counter

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from chip_smoke import FOLD_GRID
from conftest import tiny_config
from test_torch_model import _image, _pair, _port_config
from transception_tpu.models.transception import MSTransception as JModel
from transception_tpu_torch.core.config import TransceptionConfig
from transception_tpu_torch.models.transception import (
    MSTransception,
    launches_per_forward,
)
from transception_tpu_torch.ops import kernels

TOL = 1e-5
GRID = dict(FOLD_GRID)


@pytest.fixture(scope="module")
def reference():
    """JAX logits of the tiny model with the default switches, the
    variables, and the port's state_dict of the same weights."""
    jm, v, pm = _pair(tiny_config())
    x = _image(2, 32)
    return v, x, np.asarray(jax.jit(jm.apply)(v, x)), pm.state_dict()


@pytest.mark.parametrize("name", [n for n, _ in FOLD_GRID])
def test_fold_config_matches_jax_fp32(reference, name):
    _, x, want, sd = reference
    m = MSTransception(_port_config(tiny_config(), **GRID[name]),
                       device="cpu")
    m.load_state_dict(sd)
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_jax_all_on_equals_default_on_cpu(reference):
    """The premise of the single reference: the JAX model with every fold
    on gives the default model's logits within the tolerance."""
    v, x, want, _ = reference
    jm = JModel(dataclasses.replace(tiny_config(), **GRID["all-on"]))
    got = np.asarray(jax.jit(jm.apply)(v, x))
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def _wrapper_calls(monkeypatch):
    """Count the calls of every kernel wrapper by the model (on the CPU
    each runs its plain version; on the card each is one launch)."""
    from transception_tpu_torch.ops.kernels import (
        bridge_attention,
        etb_attention,
        expand_head,
        linear_attention,
        mhca_block,
        mixffn,
        patch_expand,
    )
    calls = Counter()
    for mod, fn, name in (
            (etb_attention, "etb_attention", "etb_attention"),
            (mixffn, "mixffn_ln_skip", "mixffn"),
            (bridge_attention, "bridge_attention", "bridge_attention"),
            (bridge_attention, "bridge_attention_folded",
             "bridge_attention_folded"),
            (expand_head, "expand_head", "expand_head"),
            (mhca_block, "mhca_block", "mhca_block"),
            (linear_attention, "linear_attention", "linear_attention"),
            (patch_expand, "patch_expand", "patch_expand")):
        def counted(*a, _f=getattr(mod, fn), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(mod, fn, counted)
    return calls


@pytest.mark.parametrize("name", [n for n, _ in FOLD_GRID])
def test_launch_helper_matches_the_routes(monkeypatch, name):
    """launches_per_forward at the tiny config (img 32: ETB maps 8, 2, 4;
    MHCA maps 4, 2, 1; bridge scales 8, 4, 2, 1) equals the kernel
    wrapper calls of one bf16 argmax forward."""
    cfg = TransceptionConfig(img_size=32, stage1_layers=1,
                             num_path=(1, 1, 1), num_layers=(1, 1, 1),
                             **GRID[name])
    m = MSTransception(cfg, device="cpu")
    calls = _wrapper_calls(monkeypatch)
    with torch.no_grad():
        m(torch.zeros(1, 32, 32, 1), argmax=True)
    want = {k: n for k, n in launches_per_forward(cfg).items() if n}
    assert dict(calls) == want


def test_launch_helper_hand_worked_counts():
    """The published model at 224, per forward: ETB maps 56 (x2 stage 1,
    x2 decoder 0), 28 and 14 (x2 each); MHCA stages at 28, 14, 7 with
    9 / 24 / 9 blocks; bridge layers 2-4 spatial, scales 56/28/14/7."""
    def counts(**kw):
        c = launches_per_forward(TransceptionConfig(**kw))
        return {k: n for k, n in c.items() if n}

    assert counts() == {  # the default: 8/8/3/1/33/9/3 for K1-K7
        "etb_attention": 8, "mixffn": 8, "bridge_attention": 3,
        "expand_head": 1, "mhca_block": 33, "linear_attention": 9,
        "patch_expand": 3}
    assert counts(**GRID["all-on"]) == {
        "etb_attention": 8, "mixffn": 8 + 12, "bridge_attention_folded": 3,
        "expand_head": 1, "mhca_block": 33, "linear_attention": 9,
        "patch_expand": 3}
    # measure_folds' "folds-off" keeps the ETB FFN fold on.
    assert counts(**GRID["folds-off"]) == {
        "mixffn": 8, "bridge_attention": 3, "expand_head": 1,
        "mhca_block": 33, "linear_attention": 9 + 8, "patch_expand": 3}
    assert counts(**GRID["mhca-ffn-fold"]) == {
        "etb_attention": 8, "mixffn": 8 + 9 + 24, "bridge_attention": 3,
        "expand_head": 1, "linear_attention": 9 + 9 + 24, "patch_expand": 3}
    assert set(launches_per_forward(
        TransceptionConfig(use_kernels=False)).values()) == {0}
    assert launches_per_forward(TransceptionConfig(), argmax=False)[
        "patch_expand"] == 4
    assert set(launches_per_forward(TransceptionConfig())) == {
        name for name, _, _ in kernels.COUNTERS}
