"""Guards of the PyTorch port: config parity with the JAX package, no JAX
imports in the port or chip_smoke.py, and entry points that refuse to
slide to the CPU when CUDA is absent."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu.core import config as jcfg
from transception_tpu_torch.core import config as pcfg

ROOT = Path(__file__).resolve().parents[1]
MODEL_FIELDS = (
    "num_classes", "img_size", "in_chans", "dims", "stage1_layers",
    "num_path", "num_layers", "num_heads", "mlp_ratio", "token_mlp",
    "concat", "have_bridge", "br_ch_att_list", "stage_3or4", "bridge_dim",
    "bridge_heads", "reduction_ratios", "dtype", "drop_rate",
    "drop_path_rate", "use_pallas_train", "ffn_flash_train",
    "bridge_attn_fold",
    "bridge_ffn_use_pallas", "etb_attn_fold", "etb_ffn_fold", "mhca_ffn_fold",
    "mhca_block_fold", "use_sa_config", "sa_ker", "inter", "num_sp",
    "head_count", "dil_conv", "remat", "bridge_seq_shard_axis",
    "vectorize_paths")
# DataConfig fields the port mirrors (those its train loop and its test
# volumes read).
DATA_FIELDS = ("dataset", "root_path", "test_path", "list_dir", "img_size",
               "num_classes", "num_workers", "augment", "synthetic_len",
               "device_data")


@pytest.mark.parametrize("name", MODEL_FIELDS)
def test_config_field_matches_jax(name):
    jf = {f.name: f for f in dataclasses.fields(jcfg.TransceptionConfig)}
    pf = {f.name: f for f in dataclasses.fields(pcfg.TransceptionConfig)}
    assert pf[name].default == jf[name].default


def test_config_helpers_match_jax():
    j, p = jcfg.TransceptionConfig(), pcfg.TransceptionConfig()
    assert p.decoder_in_chans() == j.decoder_in_chans()
    assert p.bridge_token_splits() == j.bridge_token_splits()
    assert pcfg.CRPE_WINDOW == jcfg.CRPE_WINDOW
    for k in range(5):
        assert (pcfg.br_config_to_ch_att_list(k)
                == jcfg.br_config_to_ch_att_list(k))
    extra = {f.name for f in dataclasses.fields(pcfg.TransceptionConfig)}
    assert extra - set(MODEL_FIELDS) == {"use_kernels", "sp_bridge_fold"}
    for k in range(6):
        for concat in ("cbam", "coord"):
            for stage in (3, 4, 0):
                assert pcfg.use_sa_config_to_list(k, concat, stage) == \
                    jcfg.use_sa_config_to_list(k, concat, stage)


def test_train_config_matches_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.TrainConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(pcfg.TrainConfig)}
    assert pf == jf
    for bs in (16, 24, 30):
        assert (pcfg.TrainConfig(batch_size=bs).scaled_lr()
                == jcfg.TrainConfig(batch_size=bs).scaled_lr())


@pytest.mark.parametrize("name", DATA_FIELDS)
def test_data_config_field_matches_jax(name):
    jf = {f.name: f for f in dataclasses.fields(jcfg.DataConfig)}
    pf = {f.name: f for f in dataclasses.fields(pcfg.DataConfig)}
    assert set(pf) == set(DATA_FIELDS)
    assert pf[name].default == jf[name].default


def _port_files():
    files = sorted((ROOT / "transception_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(mod):
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "flax") or top == "transception_tpu"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def _needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def _tiny():
    return pcfg.TransceptionConfig(img_size=32, stage1_layers=1,
                                   num_path=(1, 1, 1), num_layers=(1, 1, 1))


def test_model_without_device_raises_without_cuda():
    _needs_no_cuda()
    from transception_tpu_torch.models.transception import MSTransception
    with pytest.raises(RuntimeError, match="CUDA"):
        MSTransception(_tiny())


def test_predictor_without_device_raises_without_cuda():
    _needs_no_cuda()
    from transception_tpu_torch.eval.inference import make_predictor
    from transception_tpu_torch.models.transception import MSTransception
    m = MSTransception(_tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_predictor(m, 32)


def test_load_jax_variables_without_device_raises_without_cuda():
    _needs_no_cuda()
    from transception_tpu_torch.convert.from_jax import load_jax_variables
    from transception_tpu_torch.models.transception import MSTransception
    m = MSTransception(_tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_jax_variables(m, {"params": {}})


def test_cpu_predictor_runs_plain_path():
    from transception_tpu_torch.eval.inference import make_predictor
    from transception_tpu_torch.models.transception import MSTransception
    from transception_tpu_torch.ops import kernels
    kernels.reset_launches()
    m = MSTransception(_tiny(), device="cpu")
    vol = np.random.default_rng(0).random((5, 40, 40), dtype=np.float32)
    out = make_predictor(m, 32, batch=4, device="cpu").predict_volume(vol)
    assert out.shape == (5, 32, 32) and out.dtype == np.uint8
    assert out.max() < 9
    assert set(kernels.launch_counts().values()) == {0}


def test_kernel_switch_is_scoped():
    """The kernel set reaches the wrappers through one scoped switch:
    per kernel inside, restored after, nested scopes respected."""
    from transception_tpu_torch.ops.kernels import _build, enabled
    x = torch.zeros(1, device="meta")  # a tensor off the CPU
    assert not _build.plain("mixffn", x)
    with enabled(False):
        assert _build.plain("mixffn", x)
        with enabled(True):
            assert not _build.plain("mixffn", x)
        with enabled({"bridge_attention"}):
            assert _build.plain("mixffn", x)
            assert not _build.plain("bridge_attention", x)
        assert _build.plain("bridge_attention", x)
    assert not _build.plain("mixffn", x)
    assert _build.plain("mixffn", torch.zeros(1))
    with pytest.raises(ValueError, match="unknown"):
        with enabled({"no_such_kernel"}):
            pass


def test_shape_tallies_split_the_counters():
    """Each launch is tallied by shape beside its counter; reset_launches
    clears both, and the CPU path tallies nothing."""
    from transception_tpu_torch.ops import kernels
    from transception_tpu_torch.ops.kernels import _build
    from transception_tpu_torch.ops.kernels import linear_attention as la
    kernels.reset_launches()
    _build.tally("mixffn", (2, 64, 16), 64, 1)
    _build.tally("mixffn", (2, 64, 16), 64, 1)
    _build.tally("mixffn", (2, 64, 16), 64, 2)
    assert kernels.shape_counts() == {("mixffn", (2, 64, 16), 64, 1): 2,
                                      ("mixffn", (2, 64, 16), 64, 2): 1}
    kernels.reset_launches()
    assert kernels.shape_counts() == {}
    q = torch.zeros(1, 2, 16, 8, dtype=torch.bfloat16)
    la.linear_attention(q, q, q)
    assert kernels.shape_counts() == {}


def test_forward_only_guard_decides_on_graph():
    """A kernel without a backward must not return a result without a
    graph: the guard raises where autograd records and an input requires
    grad (lists of tensors included), and lets everything else pass."""
    from transception_tpu_torch.ops.kernels import _build
    w = torch.zeros(2, requires_grad=True)
    x = torch.zeros(2)
    assert _build.needs_graph(x, w)
    assert _build.needs_graph(x, [x, w])
    assert not _build.needs_graph(x, [x])
    with pytest.raises(RuntimeError, match="no backward"):
        _build.forward_only("expand_head", x, w)
    with torch.no_grad():
        assert not _build.needs_graph(x, w)
        _build.forward_only("expand_head", x, w)
    with torch.inference_mode():
        _build.forward_only("expand_head", x, w)


@pytest.mark.parametrize("use_kernels,flash", [(True, False), (True, True),
                                               (False, False),
                                               (False, True)])
def test_kernel_sets_match_jax_train_step_gating(use_kernels, flash):
    """The port's train-step kernels mirror JAX train_step_model
    (tests/test_train_step.py:141-157): the bridge attention keeps its
    kernel, the MixFFN folds only with ffn_flash_train, every eval-only
    kernel is off; eval keeps them all."""
    from transception_tpu.train.trainer import train_step_model
    from transception_tpu_torch.ops import kernels
    from transception_tpu.models.transception import MSTransception
    jc = train_step_model(MSTransception(jcfg.TransceptionConfig(
        use_pallas=use_kernels, ffn_flash_train=flash))).cfg
    pc = pcfg.TransceptionConfig(use_kernels=use_kernels,
                                 ffn_flash_train=flash)
    got = kernels.kernel_set(pc, training=True)
    assert ("bridge_attention" in got) == bool(
        jc.bridge_use_pallas if jc.bridge_use_pallas is not None
        else jc.use_pallas)
    assert ("mixffn" in got) == bool(jc.bridge_ffn_use_pallas
                                     and jc.etb_ffn_fold and jc.mhca_ffn_fold)
    for eval_only in ("etb_attention", "expand_head", "mhca_block",
                      "linear_attention", "patch_expand",
                      "bridge_attention_folded"):
        assert eval_only not in got
    assert not jc.mhca_block_fold or not use_kernels
    want_eval = kernels.SWITCHES if use_kernels else frozenset()
    assert kernels.kernel_set(pc, training=False) == want_eval
    # The train step's fold switches are JAX's train model's (with the
    # kernels on; the port keeps that structure for its plain path too).
    sw = pcfg.fold_switches(pc, training=True)
    if use_kernels:
        def on(v):  # JAX's None follows its (off) use_pallas
            return bool(jc.use_pallas if v is None else v)
        assert sw == pcfg.FoldSwitches(
            bridge_attn=on(jc.bridge_attn_fold),
            bridge_ffn=on(jc.bridge_ffn_use_pallas),
            etb_attn=on(jc.etb_attn_fold), etb_ffn=on(jc.etb_ffn_fold),
            mhca_block=on(jc.mhca_block_fold), mhca_ffn=on(jc.mhca_ffn_fold),
            sp_bridge=on(jc.bridge_use_pallas))
    assert sw == pcfg.fold_switches(
        pcfg.TransceptionConfig(use_kernels=True, ffn_flash_train=flash),
        training=True)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("bridge", ["sp", "para"])
def test_sp_and_para_bridges_keep_their_kernels_in_training(bridge, flash):
    """JAX's train step keeps the bridge's kernel switch on
    (bridge_use_pallas=True, train/trainer.py:104), and its sp and para
    bridges take no attn_fold or ffn_use_pallas (models/transception.py:
    63-73): their folded attention (K8) and FFN folds (K2 + K11) run in
    training, in the port as in JAX."""
    from transception_tpu.models.transception import MSTransception
    from transception_tpu.train.trainer import train_step_model
    from transception_tpu_torch.ops import kernels
    jc = train_step_model(MSTransception(jcfg.TransceptionConfig(
        have_bridge=bridge, ffn_flash_train=flash))).cfg
    assert jc.bridge_use_pallas is True
    pc = pcfg.TransceptionConfig(have_bridge=bridge, ffn_flash_train=flash)
    got = kernels.kernel_set(pc, training=True)
    assert {"bridge_attention_folded", "mixffn"} <= got
    assert pcfg.fold_switches(pc, training=True).sp_bridge
    off = dataclasses.replace(pc, use_kernels=False)
    assert kernels.kernel_set(off, training=True) == frozenset()
    assert pcfg.fold_switches(off, training=True).sp_bridge
    assert not pcfg.fold_switches(off, training=False).sp_bridge


@pytest.mark.parametrize("use_kernels", [True, False])
def test_pallas_train_keeps_the_eval_kernels_and_folds(use_kernels):
    """With use_pallas_train the JAX train_step_model returns the model as
    it is (train/trainer.py:107): the port's train step keeps every kernel
    and the eval fold switches, a switch of None following
    use_pallas_train (with use_kernels=False too, so that the plain path
    runs the kernel path's structure)."""
    from transception_tpu.models.transception import MSTransception
    from transception_tpu.train.trainer import train_step_model
    from transception_tpu_torch.ops import kernels
    jm = MSTransception(jcfg.TransceptionConfig(
        use_pallas=True, use_pallas_train=True, mhca_ffn_fold=True))
    assert train_step_model(jm) is jm
    jc = jm.cfg
    pc = pcfg.TransceptionConfig(use_kernels=use_kernels,
                                 use_pallas_train=True, mhca_ffn_fold=True)
    assert kernels.kernel_set(pc, training=True) == (
        kernels.SWITCHES if use_kernels else frozenset())

    def on(v):
        return bool(jc.use_pallas if v is None else v)

    assert pcfg.fold_switches(pc, training=True) == pcfg.FoldSwitches(
        bridge_attn=on(jc.bridge_attn_fold),
        bridge_ffn=on(jc.bridge_ffn_use_pallas),
        etb_attn=on(jc.etb_attn_fold), etb_ffn=on(jc.etb_ffn_fold),
        mhca_block=on(jc.mhca_block_fold), mhca_ffn=on(jc.mhca_ffn_fold),
        sp_bridge=on(jc.bridge_use_pallas))
