"""--debug_nans in the port (cli.common.nan_checks), the counterpart of
the JAX CLIs' jax_debug_nans, on the CPU: a NaN planted in a weight
raises FloatingPointError naming the first module whose output holds it,
in a forward and in a train-CLI step; the backward runs under autograd's
anomaly mode with its NaN check; without the flag nothing is installed
(no hook, no anomaly mode), and a NaN goes through as it does without
the switch.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)
from test_torch_tp_cli import volumes  # noqa: F401 (fixture)

from transception_tpu_torch.cli.common import nan_checks
from transception_tpu_torch.core.config import TransceptionConfig

TINY = dict(img_size=32, dtype="float32", stage1_layers=1,
            num_path=(1, 1, 1), num_layers=(1, 1, 1))
PLANTED = "backbone.patch_embed_stage2.patch_embeds.0.patch_conv.dwconv"


def _planted(model):
    """model with a NaN in the first tap of PLANTED's weight."""
    with torch.no_grad():
        model.get_submodule(PLANTED).weight.view(-1)[0] = float("nan")
    return model


def _hooks(model):
    return sum(len(m._forward_hooks) for m in model.modules())


def test_forward_names_the_first_module_with_a_nan():
    from transception_tpu_torch.models.transception import MSTransception
    model = _planted(MSTransception(TransceptionConfig(**TINY), "cpu"))
    x = torch.rand(2, 32, 32, 1, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.isnan(model(x)).any()  # no switch: the NaN goes through
        with nan_checks(model):
            with pytest.raises(FloatingPointError,
                               match=f"NaN in the output of {PLANTED} "
                                     f"\\(Conv2d\\)"):
                model(x)
    assert _hooks(model) == 0


def test_switch_installs_hooks_and_anomaly_mode_only_when_on():
    from transception_tpu_torch.models.transception import MSTransception
    model = MSTransception(TransceptionConfig(**TINY), "cpu")
    n = len(list(model.modules()))
    assert not torch.is_anomaly_enabled()
    with nan_checks(model, False):
        assert _hooks(model) == 0 and not torch.is_anomaly_enabled()
    with nan_checks(model):
        assert _hooks(model) == n
        assert torch.is_anomaly_enabled()
        assert torch.is_anomaly_check_nan_enabled()
    assert _hooks(model) == 0 and not torch.is_anomaly_enabled()


def test_backward_runs_under_anomaly_mode():
    """A NaN that first appears in the backward (0 · d sqrt(x)/dx at 0)
    raises there, naming the backward function."""
    lin = torch.nn.Linear(2, 2)
    x = torch.zeros(3, 2, requires_grad=True)
    with nan_checks(lin):
        y = (torch.sqrt(x) * 0.0).sum() + lin(x).sum()
        with pytest.raises(RuntimeError, match="returned nan values"):
            y.backward()
    y = (torch.sqrt(x) * 0.0).sum()
    y.backward()  # without the switch: no check
    assert torch.isnan(x.grad).all()


def _argv(volumes, out, *more):
    return ["--dataset", "Synapse", "--root_path", str(out / "no_slices"),
            "--test_path", str(volumes / "vol"), "--list_dir",
            str(volumes / "lists"), "--output_dir", str(out),
            "--batch_size", "2", "--max_steps", "1", "--num_workers", "1",
            "--img_size", "32", "--stage1_layers", "1", "--num_path",
            "1,1,1", "--num_layers", "1,1,1", "--dtype", "float32",
            "--dp_size", "1", *more]


@pytest.mark.parametrize("flag", [True, False])
def test_train_cli_step_raises_on_a_planted_nan(volumes, tmp_path,  # noqa: F811
                                                monkeypatch, flag):
    """cli.train with --debug_nans: the first step's forward raises
    FloatingPointError naming the planted module, before any update or
    checkpoint; without it the run takes its step (a NaN loss) and
    checkpoints."""
    from transception_tpu_torch.cli import train as ptrain_cli
    from transception_tpu_torch.models import registry
    build = registry.create_model
    monkeypatch.setattr(registry, "create_model",
                        lambda *a, **k: _planted(build(*a, **k)))
    argv = _argv(volumes, tmp_path, *(["--debug_nans"] if flag else []))
    if flag:
        with pytest.raises(FloatingPointError, match=PLANTED):
            ptrain_cli.main(argv, device="cpu")
        assert not (tmp_path / "ckpt").exists()
    else:
        ptrain_cli.main(argv, device="cpu")
        sd = torch.load(tmp_path / "ckpt" / "step_00000001.pt",
                        weights_only=True)
        assert sd["step"] == 1
        assert not np.isfinite(
            sd["model"][PLANTED + ".weight"].numpy()).all()
    assert not torch.is_anomaly_enabled()
