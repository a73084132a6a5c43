"""The port's serving export (serve/export.py, cli/export.py) on the CPU
against the JAX package's: the tiny model's eval-mode logits forward,
exported through torch.export with the kernels as torch.library
operators, saved, and loaded in a fresh process that never imports the
port's models (nor JAX): its logits against the eager port forward
(1e-5) and against JAX's export_model(..., platforms=["cpu"]) artifact
run on the same input (1e-4 of max|JAX|); --plain_xla's program without
the operators; the refusals (garbage, a JAX artifact, a platform
torch.export cannot honour)."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from conftest import tiny_config
from transception_tpu.models.transception import MSTransception as JModel
from transception_tpu.serve import export as jexport
from transception_tpu_torch.cli import export as pcli
from transception_tpu_torch.convert.from_jax import load_jax_variables
from transception_tpu_torch.core.config import TransceptionConfig
from transception_tpu_torch.models.transception import MSTransception
from transception_tpu_torch.ops import kernels
from transception_tpu_torch.serve import export as pexport

IMG, B = 32, 2
REPO = Path(__file__).resolve().parents[1]
# Loads an artifact in a fresh process and runs it on a saved input:
# prints which packages that process imported and the operators the
# program calls.
LOADER = """
import json, sys
import numpy as np
import torch
from transception_tpu_torch.serve.export import load_exported
fn = load_exported(sys.argv[1])
out = fn(np.load(sys.argv[2]))
np.save(sys.argv[3], out.numpy())
ops = sorted({str(n.target) for n in fn.program.graph.nodes
              if n.op == "call_function" and "transception" in str(n.target)})
print(json.dumps({"models": "transception_tpu_torch.models" in sys.modules,
                  "jax": "jax" in sys.modules,
                  "transception_tpu": "transception_tpu" in sys.modules,
                  "ops": ops, "device": str(fn.device),
                  "shape": list(out.shape), "dtype": str(out.dtype)}))
"""


@pytest.fixture(scope="module")
def setup():
    jc = tiny_config()
    jm = JModel(jc)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(
        jm.init, static_argnames=("train",))(
            jax.random.PRNGKey(2), jnp.zeros((1, IMG, IMG, 1)), train=False))
    names = {f.name for f in dataclasses.fields(TransceptionConfig)}
    pc = TransceptionConfig(**{f.name: getattr(jc, f.name)
                               for f in dataclasses.fields(jc)
                               if f.name in names})
    pm = MSTransception(pc, device="cpu")
    load_jax_variables(pm, v, device="cpu")
    x = np.random.default_rng(0).random((B, IMG, IMG, 1)).astype(np.float32)
    return jm, v, pm, x


def _load_in_subprocess(tmp_path, artifact, x):
    np.save(tmp_path / "x.npy", x)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-c", LOADER, str(artifact), str(tmp_path / "x.npy"),
         str(tmp_path / "y.npy")], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    info = json.loads(res.stdout.strip().splitlines()[-1])
    return np.load(tmp_path / "y.npy"), info


def _cli_argv(out, pth, *extra):
    return ["--img_size", str(IMG), "--stage1_layers", "1", "--num_path",
            "2,2,2", "--num_layers", "1,1,1", "--dtype", "float32",
            "--weight_pth", str(pth), "--out", str(out),
            "--export_batch", str(B), *extra]


@pytest.fixture(scope="module")
def artifacts(setup, tmp_path_factory):
    """The tiny model's weights as a .pth, exported by cli.export for the
    CPU with the kernels' operators ("kernels") and with --plain_xla
    ("plain")."""
    _, _, pm, _ = setup
    d = tmp_path_factory.mktemp("artifacts")
    pth = d / "w.pth"
    torch.save(pm.state_dict(), pth)
    out = {"pth": pth}
    out["kernels"] = pcli.main(_cli_argv(d / "kernels.pt2", pth,
                                         "--platforms", "cpu"))
    out["plain"] = pcli.main(_cli_argv(d / "plain.pt2", pth, "--plain_xla"),
                             device="cpu")
    return out


def _routed(model, x):
    kernels.reset_launches()
    with torch.no_grad():
        model(torch.from_numpy(x))
    return kernels.routed_counts()


def _eager(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def test_artifact_in_a_fresh_process_matches_eager_and_jax(setup, artifacts,
                                                          tmp_path):
    jm, v, pm, x = setup
    got, info = _load_in_subprocess(tmp_path, artifacts["kernels"], x)
    # Deployable without the model source (and without JAX).
    assert not info["models"] and not info["jax"] and \
        not info["transception_tpu"]
    # The kernels the eager forward routes to are operators of the
    # program (on the CPU their plain versions run).
    want_ops = {f"{kernels.NAMESPACE}.{k}.default"
                for k, n in _routed(pm, x).items() if n}
    assert set(info["ops"]) == want_ops and want_ops
    assert info["device"] == "cpu" and info["dtype"] == "torch.float32"
    assert info["shape"] == [B, IMG, IMG, pm.cfg.num_classes]
    eager = _eager(pm, x)
    assert np.abs(got - eager).max() <= 1e-5 * max(1.0, np.abs(eager).max())
    # JAX's own artifact of the same weights on the same input.
    jfn = jexport.load_model(jexport.export_model(jm, v, B, IMG,
                                                  platforms=["cpu"]))
    jout = np.asarray(jfn(jnp.asarray(x)))
    assert got.shape == jout.shape
    assert np.abs(got - jout).max() <= 1e-4 * np.abs(jout).max()


def test_plain_xla_program_holds_no_kernel_operator(setup, artifacts):
    """--plain_xla: the kernels switched off while tracing, so the program
    holds PyTorch's operators alone (the model's forward leaves the
    caller's switch off, ops.kernels.active) and gives the same logits."""
    _, _, pm, x = setup
    with kernels.enabled(False):
        assert _routed(pm, x) == {}
    fn = pexport.load_exported(artifacts["plain"])
    assert not any(kernels.NAMESPACE in str(n.target)
                   for n in fn.program.graph.nodes)
    eager = _eager(pm, x)
    got = fn(x).numpy()
    assert np.abs(got - eager).max() <= 1e-5 * max(1.0, np.abs(eager).max())


class _Tiny(torch.nn.Module):
    """A stand-in model: NHWC in, a 1x1 head and a train-mode switch."""

    def __init__(self):
        super().__init__()
        self.head = torch.nn.Linear(1, 3)
        self.drop = torch.nn.Dropout(0.5)

    def forward(self, x):
        return self.drop(self.head(x))


def test_export_is_eval_mode_and_leaves_the_model_in_its_mode():
    m = _Tiny().train()
    data = pexport.export_model(m, 2, 4)
    assert m.training
    fn = pexport.load_model(data)
    x = torch.randn(2, 4, 4, 1)
    m.eval()
    with torch.no_grad():
        torch.testing.assert_close(fn(x), m(x))


def test_load_exported_refuses_garbage_and_jax_artifacts(tmp_path):
    garbage = tmp_path / "garbage.bin"
    garbage.write_bytes(b"not an artifact at all")
    with pytest.raises(ValueError, match="not a transception_tpu_torch "
                                         "export artifact"):
        pexport.load_exported(str(garbage))
    jax_file = tmp_path / "model.stablehlo"
    jexport.save_exported(str(jax_file), b"\x00" * 64)
    with pytest.raises(ValueError, match="JAX package artifact"):
        pexport.load_exported(str(jax_file))


@pytest.mark.parametrize("platforms,match", [
    (["tpu"], "runs on one of"), (["cuda", "cpu"], "one device"),
    (["cuda"], "build the model on cuda")])
def test_platforms_torch_export_cannot_honour_raise(platforms, match):
    with pytest.raises(ValueError, match=match):
        pexport.export_model(_Tiny(), 1, 4, platforms=platforms)


def test_cli_exports_for_the_cpu(setup, artifacts, tmp_path):
    """cli.export with --platforms cpu: the weights of --weight_pth in the
    program (its logits those of the eager model), the kernels as
    operators; --platforms tpu and two platforms raise, naming why; cuda
    without a card raises, never falling back to the CPU."""
    _, _, pm, x = setup
    fn = pexport.load_exported(artifacts["kernels"])
    assert fn.device == torch.device("cpu")
    torch.testing.assert_close(fn(x), torch.from_numpy(_eager(pm, x)),
                               rtol=1e-5, atol=1e-5)
    assert any(kernels.NAMESPACE in str(n.target)
               for n in fn.program.graph.nodes)
    out, pth = tmp_path / "x.pt2", artifacts["pth"]
    for bad, match in (("tpu", "runs on one of"), ("cuda,cpu", "one device")):
        with pytest.raises(ValueError, match=match):
            pcli.main(_cli_argv(out, pth, "--platforms", bad))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pcli.main(_cli_argv(out, pth))
    assert not out.exists()
