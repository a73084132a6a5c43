"""The port's model registry and CLI against the JAX package's: the same
registry names, the same flags and defaults, build_configs giving the same
values for every field the two packages' configs share, and
cli.test.main on the CPU at a tiny config (weights from a port .pth, a
reference-layout .pth and a port checkpoint; NIfTI export; the refusals)."""

import argparse
import dataclasses
import shlex

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu.cli import common as jcommon
from transception_tpu.models.registry import MODEL_REGISTRY
from transception_tpu_torch.cli import common as pcommon
from transception_tpu_torch.cli import test as pcli
from transception_tpu_torch.core import config as pcfg
from transception_tpu_torch.eval.inference import run_inference
from transception_tpu_torch.eval.nifti import load_nifti
from transception_tpu_torch.models import registry
from transception_tpu_torch.models.transception import MSTransception

TINY = ["--img_size", "32", "--stage1_layers", "1", "--num_path", "1,1,1",
        "--num_layers", "1,1,1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny model's ops are too small for intra-op threads; with
    several test workers on one host their spinning threads only take
    cores from the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_cfg(**kw):
    return pcfg.TransceptionConfig(img_size=32, stage1_layers=1,
                                   num_path=(1, 1, 1), num_layers=(1, 1, 1),
                                   **kw)


# ---- registry ----

def test_registry_names_cover_jax():
    assert set(registry.PORTED + registry.NOT_PORTED) == set(MODEL_REGISTRY)
    m = registry.create_model("MSTransception", _tiny_cfg(), device="cpu",
                              seed=4)
    assert isinstance(m, MSTransception) and m.cfg == _tiny_cfg()
    ref = MSTransception(_tiny_cfg(), device="cpu", seed=4)
    for (k, a), (_, b) in zip(m.state_dict().items(),
                              ref.state_dict().items()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("name", registry.LEGACY)
def test_registry_builds_legacy_models(name):
    """Each legacy name builds the JAX registry's model class with the
    caller's config as it is (head_count and dil_conv included), both
    CLIs' --model takes it, and the model runs: fp32 logits of the
    input's shape."""
    from transception_tpu.core.config import TransceptionConfig as JConfig
    from transception_tpu_torch.cli import train as ptrain
    jm = MODEL_REGISTRY[name](JConfig(img_size=32, dil_conv=0))
    cfg = _tiny_cfg(dtype="float32", dil_conv=0, head_count=4)
    m = registry.create_model(name.upper(), cfg, device="cpu")
    assert type(m).__name__ == type(jm).__name__ and m.cfg == cfg
    with torch.no_grad():
        out = m(torch.rand(2, 32, 32, 1))
    assert out.shape == (2, 32, 32, 9) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    for parser, extra in ((pcli._parser(), ["--weight_pth", "w.pth"]),
                          (ptrain._parser(), [])):
        args = parser.parse_args(["--model", name, "--dtype", "float32",
                                  "--dil_conv", "0", "--head_count", "4"]
                                 + TINY + extra)
        assert registry.model_config(
            args.model, pcommon.build_configs(args)[0]) == cfg


@pytest.mark.parametrize("name", registry.VARIANTS)
def test_registry_builds_ported_models(name):
    """Each ported name builds the JAX registry's config (every shared
    field equal), and both CLIs' --model takes it."""
    from transception_tpu.core.config import TransceptionConfig as JConfig
    jcfg = MODEL_REGISTRY[name](JConfig(img_size=32, stage1_layers=1,
                                        num_path=(1, 1, 1),
                                        num_layers=(1, 1, 1))).cfg
    m = registry.create_model(name.upper(), _tiny_cfg(), device="cpu")
    assert isinstance(m, MSTransception)
    for f in dataclasses.fields(m.cfg):
        if hasattr(jcfg, f.name) and f.name != "dtype":
            assert getattr(m.cfg, f.name) == getattr(jcfg, f.name), f.name
    from transception_tpu_torch.cli import train as ptrain
    for parser, extra in ((pcli._parser(), ["--weight_pth", "w.pth"]),
                          (ptrain._parser(), [])):
        args = parser.parse_args(["--model", name] + TINY + extra)
        cfg = pcommon.build_configs(args)[0]
        assert registry.model_config(args.model, cfg) == \
            registry.model_config(name, _tiny_cfg(dtype=cfg.dtype))


def test_registry_unknown_name_is_a_key_error():
    from transception_tpu.models.registry import create_model as jcreate
    for create in (registry.create_model, jcreate):
        with pytest.raises(KeyError, match="unknown model"):
            create("no_such_model")


# ---- flags and configs ----

def _parsers(adders):
    p, j = argparse.ArgumentParser(), argparse.ArgumentParser()
    for name in adders:
        getattr(pcommon, name)(p)
        getattr(jcommon, name)(j)
    return p, j


@pytest.mark.parametrize("adders", [("add_model_args",), ("add_data_args",),
                                    ("add_train_args",)])
def test_flags_and_defaults_equal_jax(adders):
    p, j = _parsers(adders)
    assert vars(p.parse_args([])) == vars(j.parse_args([]))
    assert [a.option_strings for a in p._actions] == \
        [a.option_strings for a in j._actions]


ARGVS = [
    "",
    "--dataset synthetic --img_size 64 --num_layers 1,2,1 --num_path 2,2,2 "
    "--stage1_layers 1 --dtype float32 --no_pallas --drop_path_rate 0.1",
    "--dataset ISIC --br_config 3 --num_classes 4 --test_path /x "
    "--volume_path /y --list_dir /z",
    "--batch_size 30 --base_lr 0.01 --max_epochs 5 --seed 7 "
    "--eval_interval 3 --eval_schedule reference --model_name m "
    "--grad_clipping --no_scheduler --accumulation_steps 2 --dp_size 2 "
    "--tp_size 1 --no_resume --eval_device_resample --output_dir /o",
    "--concat se --have_bridge sp --Stage_3or4 4 --use_sa_config 2 "
    "--sa_ker 5 --inter out --num_sp 2 --token_mlp mix",
]


@pytest.mark.parametrize("argv", ARGVS)
def test_build_configs_equal_jax_on_shared_fields(argv):
    adders = ("add_model_args", "add_data_args", "add_train_args")
    p, j = _parsers(adders)
    args = shlex.split(argv)
    pa, ja = p.parse_args(args), j.parse_args(args)
    ported = pcommon.build_configs(pa)
    ref = jcommon.build_configs(ja)
    for pc, jc in zip(ported, ref):
        jf = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
        shared = [f.name for f in dataclasses.fields(pc) if f.name in jf]
        assert shared
        for name in shared:
            assert getattr(pc, name) == jf[name], name
    assert ported[0].use_kernels == ref[0].use_pallas


@pytest.mark.parametrize("flag,field,value", [
    ("--use_sa_config 2", "use_sa_config", 2), ("--sa_ker 5", "sa_ker", 5),
    ("--inter out", "inter", "out"), ("--num_sp 2", "num_sp", 2),
    ("--head_count 4", "head_count", 4), ("--dil_conv 0", "dil_conv", 0),
    ("--remat", "remat", True),
    ("--no_vectorize_paths", "vectorize_paths", False),
    ("--debug_nans", None, True)])
def test_ablation_flags_are_accepted(flag, field, value):
    """The ablation knobs refused before the port had the variants, the
    legacy models' head_count and dil_conv refused before it had them,
    and --no_vectorize_paths and --debug_nans refused before it had the
    per-path layout and its NaN checks: build_configs takes them into
    TransceptionConfig, as the JAX package's does (--debug_nans is the
    CLIs' switch, cli.common.nan_checks, in no config: the JAX CLI turns
    jax_debug_nans on, put back here)."""
    import jax
    p, j = _parsers(("add_model_args", "add_data_args", "add_train_args"))
    assert not pcommon.UNSUPPORTED
    args = shlex.split(flag)
    got = pcommon.build_configs(p.parse_args(args))[0]
    try:
        want = jcommon.build_configs(j.parse_args(args))[0]
    finally:
        jax.config.update("jax_debug_nans", False)
    if field is None:
        assert getattr(p.parse_args(args), flag[2:]) is value
        assert got == pcommon.build_configs(p.parse_args([]))[0]
        return
    assert getattr(got, field) == value == getattr(want, field)


@pytest.mark.parametrize("flag,field,value", [
    ("--device_data", "device_data", True),
    ("--root_path /r", "root_path", "/r"),
    ("--num_workers 2", "num_workers", 2),
    ("--no_augment", "augment", False),
    ("--max_steps 3", None, 3),
    ("--profile", None, True)])
def test_train_flags_are_accepted(flag, field, value):
    """The train loaders' and the train CLI's flags, refused before the
    port had them: build_configs takes them, the data ones into
    DataConfig, as the JAX package's does."""
    p, j = _parsers(("add_model_args", "add_data_args", "add_train_args"))
    dest = flag.split()[0][2:]
    assert dest not in pcommon.UNSUPPORTED
    args = p.parse_args(shlex.split(flag))
    data = pcommon.build_configs(args)[1]
    jdata = jcommon.build_configs(j.parse_args(shlex.split(flag)))[1]
    if field is None:
        assert getattr(args, dest) == value
    else:
        assert getattr(data, field) == value == getattr(jdata, field)


# ---- cli.test.main on the CPU ----

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two tiny Synapse-layout volumes ({case}.npy.h5 and test_vol.txt)."""
    import h5py
    root = tmp_path_factory.mktemp("synapse")
    (root / "vol").mkdir()
    (root / "lists").mkdir()
    rng = np.random.default_rng(0)
    names = ["case0001", "case0002"]
    for n in names:
        with h5py.File(root / "vol" / f"{n}.npy.h5", "w") as f:
            f["image"] = rng.random((3, 40, 36)).astype(np.float32)
            f["label"] = rng.integers(0, 9, (3, 40, 36)).astype(np.float32)
    (root / "lists" / "test_vol.txt").write_text("\n".join(names) + "\n")
    return root


@pytest.fixture(scope="module")
def weights():
    """A port model's weights (seed 5)."""
    return MSTransception(_tiny_cfg(dtype="float32"), "cpu",
                          seed=5).state_dict()


def _argv(data, out, pth, *extra):
    return ["--dataset", "Synapse", "--test_path", str(data / "vol"),
            "--list_dir", str(data / "lists"), "--output_dir", str(out),
            "--weight_pth", str(pth), "--eval_batch", "4", *TINY, *extra]


def _expected(weights, data, dtype):
    from transception_tpu_torch.data.synapse import SynapseVolumeDataset
    m = MSTransception(_tiny_cfg(dtype=dtype), "cpu")
    m.load_state_dict(weights)
    ds = SynapseVolumeDataset(str(data / "vol"), str(data / "lists"))
    return run_inference(m, ds, 9, 32, 4, log=None, device="cpu")


def test_cli_port_pth_round_trip(tmp_path, data, weights, capsys):
    torch.save(weights, tmp_path / "w.pth")
    got = pcli.main(_argv(data, tmp_path / "out", tmp_path / "w.pth"),
                    device="cpu")
    assert got == _expected(weights, data, "float32")
    log = (tmp_path / "out" / "test_log" / "eval.txt").read_text()
    assert "2 test iterations per epoch" in log
    assert "idx 1 case case0002 mean_dice" in log
    assert f"mean_dice : {got[0]:.6f} mean_hd95 : {got[1]:.6f}" in log
    out = capsys.readouterr().out
    assert f"Testing performance in best val model: mean_dice : " \
        f"{got[0]:.6f}" in out


def _reference_layout(weights):
    """The port's weights as a reference checkpoint would hold them: under
    "state_dict", DataParallel's "module." prefix, EfficientAttention's
    projections as 1x1 convs, and dead parameters the port lacks."""
    sd = {}
    for k, t in weights.items():
        if k.split(".")[-2] in ("keys", "queries", "values",
                                "reprojection") and t.dim() == 2:
            t = t[:, :, None, None]
        sd[f"module.{k}"] = t.clone()
    for dead in ("backbone.conv1_1_s1.weight", "backbone.cpe.proj.weight",
                 "backbone.block1.0.mlp.norm2.weight",
                 "backbone.block1.0.mlp.norm3.bias",
                 "backbone.mhca_stage2.mhca_blks.0.MHCA_layers.0.cpe.proj."
                 "weight",
                 "backbone.mhca_stage2.mhca_blks.0.MHCA_layers.0.crpe."
                 "conv_list.0.weight",
                 "bridge.bridge_layer1.attn.scale_reduce.sr0.weight",
                 "bridge.bridge_layer2.fc1_back.weight",
                 "decoder_3.concat_linear.weight",
                 "decoder_3.layer_former_1.norm1.weight",
                 "backbone.block1.0.norm2.num_batches_tracked"):
        sd[f"module.{dead}"] = torch.zeros(2)
    return {"state_dict": sd, "epoch": 3}


def test_cli_reference_pth_with_dead_keys_and_nifti(tmp_path, data,
                                                    weights):
    torch.save(_reference_layout(weights), tmp_path / "ref.pth")
    out = tmp_path / "out"
    got = pcli.main(_argv(data, out, tmp_path / "ref.pth", "--dtype",
                          "bfloat16", "--is_savenii"), device="cpu")
    assert got == _expected(weights, data, "bfloat16")
    log = (out / "test_log" / "eval.txt").read_text()
    assert "10 dead reference parameters not instantiated" in log
    for case in ("case0001", "case0002"):
        for kind in ("img", "pred", "gt"):
            vol, sp = load_nifti(str(out / "predictions"
                                     / f"{case}_{kind}.nii.gz"))
            assert vol.shape == (3, 40, 36) and sp == (1.0, 1.0, 1.0)
        pred, _ = load_nifti(str(out / "predictions" / f"{case}_pred.nii.gz"))
        assert pred.max() < 9


def test_cli_port_checkpoint(tmp_path, data, weights):
    from transception_tpu_torch.train.state import TrainState
    m = MSTransception(_tiny_cfg(dtype="float32"), "cpu")
    m.load_state_dict(weights)
    st = TrainState(m, pcfg.TrainConfig(), steps_per_epoch=1)
    torch.save(st.state_dict(), tmp_path / "step_00000001.pt")
    got = pcli.main(_argv(data, tmp_path / "out",
                          tmp_path / "step_00000001.pt"), device="cpu")
    assert got == _expected(weights, data, "float32")


def test_load_weights_refusals(tmp_path, weights):
    m = MSTransception(_tiny_cfg(dtype="float32"), "cpu")
    short = dict(weights)
    del short["decoder_0.last_layer.weight"]
    torch.save(short, tmp_path / "short.pth")
    with pytest.raises(KeyError, match="decoder_0.last_layer.weight"):
        pcli.load_weights(str(tmp_path / "short.pth"), m)
    unknown = dict(weights, **{"decoder_0.extra_head.weight":
                               torch.zeros(1)})
    torch.save(unknown, tmp_path / "unknown.pth")
    with pytest.raises(KeyError, match="decoder_0.extra_head.weight"):
        pcli.load_weights(str(tmp_path / "unknown.pth"), m)
    bad = dict(weights)
    bad["decoder_0.last_layer.weight"] = torch.zeros(3, 3)
    torch.save(bad, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="shape"):
        pcli.load_weights(str(tmp_path / "bad.pth"), m)
    (tmp_path / "orbax").mkdir()
    with pytest.raises(NotImplementedError,
                       match="orbax.*scripts/orbax_to_torch.py"):
        pcli.load_weights(str(tmp_path / "orbax"), m)


def test_cli_refusals(tmp_path, data):
    pth = tmp_path / "w.pth"
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    dp = max(cards + 1, 2)
    with pytest.raises(RuntimeError, match=f"needs {dp} cards, "
                                           f"have {cards}"):
        pcli.main(_argv(data, tmp_path, pth, "--dp_size", str(dp)))
    from transception_tpu_torch.cli import train as ptrain
    # The model axis counts its ranks' cards too: tp ranks on a host of
    # fewer cards are refused before any work.
    tp = max(cards + 1, 2)
    with pytest.raises(RuntimeError, match=f"mesh 1x{tp} needs {tp} cards, "
                                           f"have {cards}"):
        ptrain.main(["--tp_size", str(tp), "--output_dir", str(tmp_path)])
    if not torch.cuda.is_available():
        torch.save({}, pth)
        with pytest.raises(RuntimeError, match="CUDA"):
            pcli.main(_argv(data, tmp_path, pth, "--no_pallas"))


@pytest.mark.parametrize("dtype", [[], ["--dtype", "float32"],
                                   ["--dtype", "float16"]])
def test_cli_non_bf16_kernels_on_the_card_raise(tmp_path, data, dtype):
    """The CUDA kernels take fp32 and bf16: on the card an fp16 eval with
    the kernels on raises, naming the ways out (--dtype float32 or
    bfloat16, --no_pallas); fp32 (the default) runs the fp32 kernels, so
    with no card it raises the RuntimeError naming CUDA and never falls
    back to the CPU. Both before anything is read or built."""
    argv = _argv(data, tmp_path, tmp_path / "none.pth", *dtype)
    if dtype[-1:] == ["float16"]:
        with pytest.raises(ValueError, match="--dtype float32.*--dtype "
                           "bfloat16.*--no_pallas"):
            pcli.main(argv, device="cuda")
    elif torch.cuda.is_available():  # the card runs it: the weights first
        with pytest.raises(FileNotFoundError):
            pcli.main(argv, device="cuda")
        return
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            pcli.main(argv, device="cuda")
    assert not (tmp_path / "test_log").exists()
