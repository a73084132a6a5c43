"""Volume evaluation of the port against the JAX package: NIfTI bytes, the
volume datasets, run_inference's log lines and saved volumes (both
packages' predictors replaced by one numpy stub), and the tiny model end
to end on the three predictor paths (host spline, spline on the device,
everything on the device) in fp32, and the host path in bf16, with the
same weights (the port's, carried into the JAX tree by the JAX package's
converter) and the same synthetic volumes.

Tolerances (the port computes on the CPU here, with the kernels' plain
versions):
  * fp32: class maps equal on >= 99.9% of voxels on every path (fp32
    reassociation flips only near-ties); per-class mean dice within 0.01
    and mean hd95 within 0.5 voxels of JAX's (a flipped voxel moves them
    by about that much on these 48² volumes).
  * bf16: both packages round at their own points (tests/test_torch_model.py),
    so class maps equal on >= 97% of voxels, the bf16 limit there.
"""

import dataclasses
import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu.data import synapse as jsyn
from transception_tpu.eval import inference as jinf
from transception_tpu.eval import nifti as jnii
from transception_tpu.models.transception import MSTransception as JModel
from transception_tpu_torch.convert.from_jax import load_jax_variables
from transception_tpu_torch.core.config import DataConfig, TransceptionConfig
from transception_tpu_torch.data import synapse as psyn
from transception_tpu_torch.eval import inference as pinf
from transception_tpu_torch.eval import nifti as pnii
from transception_tpu_torch.eval.inference import (
    test_single_volume as port_single_volume,  # alias: not a pytest test
)
from transception_tpu_torch.models.transception import MSTransception

from conftest import tiny_config

P = 32        # tiny_config's img_size: the patch size
BATCH = 8
CLASSES = 9
FP32_AGREE = 0.999
BF16_AGREE = 0.97


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny model's ops are too small for intra-op threads; with
    several test workers on one host their spinning threads only take
    cores from the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_config(jc, **kw):
    names = {f.name for f in dataclasses.fields(TransceptionConfig)}
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)
              if f.name in names}
    fields.update(kw)
    return TransceptionConfig(**fields)


# ---- NIfTI ----

@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int16,
                                   np.float64])
def test_nifti_bytes_equal_jax(tmp_path, dtype):
    vol = (np.random.default_rng(0).random((5, 7, 9)) * 9).astype(dtype)
    for name, sp in (("a.nii.gz", (1.0, 1.0, 2.5)), ("b.nii", (0.7, 0.8,
                                                             3.0))):
        pnii.save_nifti(str(tmp_path / f"p{name}"), vol, sp)
        jnii.save_nifti(str(tmp_path / f"j{name}"), vol, sp)
        got = (tmp_path / f"p{name}").read_bytes()
        assert got == (tmp_path / f"j{name}").read_bytes()
        back, spacing = pnii.load_nifti(str(tmp_path / f"p{name}"))
        np.testing.assert_array_equal(back, vol)
        assert back.dtype == vol.dtype
        assert spacing == pytest.approx(sp)
    raw = gzip.decompress((tmp_path / "pa.nii.gz").read_bytes())
    assert raw[344:348] == b"n+1\x00"
    assert pnii._build_header(vol.shape, vol.dtype, (1, 1, 2)) == \
        jnii._build_header(vol.shape, vol.dtype, (1, 1, 2))


# ---- datasets ----

@pytest.mark.parametrize("idx", range(3))
def test_synthetic_volumes_equal_jax(idx):
    p = psyn.SyntheticVolumeDataset(length=3, hw=48).get(idx)
    j = jsyn.SyntheticVolumeDataset(length=3, hw=48).get(idx)
    assert p.keys() == j.keys() and p["case_name"] == j["case_name"]
    for k in ("image", "label"):
        assert p[k].dtype == j[k].dtype
        np.testing.assert_array_equal(p[k], j[k])
    assert len(psyn.SyntheticVolumeDataset()) == \
        len(jsyn.SyntheticVolumeDataset())


def _write_h5_cases(tmp_path, names=("case0001", "case0002")):
    import h5py
    vol_dir, list_dir = tmp_path / "vol", tmp_path / "lists"
    vol_dir.mkdir()
    list_dir.mkdir()
    rng = np.random.default_rng(3)
    for n in names:
        with h5py.File(vol_dir / f"{n}.npy.h5", "w") as f:
            f["image"] = rng.random((4, 40, 36)).astype(np.float32)
            f["label"] = rng.integers(0, CLASSES, (4, 40, 36)).astype(
                np.uint8)
    (list_dir / "test_vol.txt").write_text("\n".join(names) + "\n\n")
    return str(vol_dir), str(list_dir)


def test_synapse_volumes_read_like_jax(tmp_path):
    vol_dir, list_dir = _write_h5_cases(tmp_path)
    assert psyn.read_list(list_dir, "test_vol") == \
        jsyn.read_list(list_dir, "test_vol") == ["case0001", "case0002"]
    p = psyn.SynapseVolumeDataset(vol_dir, list_dir)
    j = jsyn.SynapseVolumeDataset(vol_dir, list_dir)
    assert len(p) == len(j) == 2
    for i in range(2):
        a, b = p.get(i), j.get(i)
        assert a["case_name"] == b["case_name"]
        for k in ("image", "label"):
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])


def test_make_test_dataset_picks_like_jax(tmp_path):
    from transception_tpu.core.config import DataConfig as JDataConfig
    vol_dir, list_dir = _write_h5_cases(tmp_path)
    for kw in (dict(dataset="synthetic"),
               dict(dataset="synapse", test_path=str(tmp_path / "absent")),
               dict(dataset="synapse", test_path=vol_dir, list_dir=list_dir),
               dict(dataset="synthetic", test_path=vol_dir,
                    list_dir=list_dir)):
        p = psyn.make_test_dataset(DataConfig(**kw))
        j = jsyn.make_test_dataset(JDataConfig(**kw))
        assert type(p).__name__ == type(j).__name__
        assert len(p) == len(j)
        assert p.get(0)["case_name"] == j.get(0)["case_name"]
    # ISIC: a missing test_path gives the synthetic lesions, as in JAX.
    kw = dict(dataset="isic", test_path=str(tmp_path / "absent"),
              img_size=32)
    p = psyn.make_test_dataset(DataConfig(**kw))
    j = jsyn.make_test_dataset(JDataConfig(**kw))
    assert type(p).__name__ == type(j).__name__ == "SyntheticISICDataset"
    assert len(p) == len(j)
    rng = np.random.default_rng(0)
    assert p.get(0, rng)["case_name"] == j.get(0, rng)["case_name"]


# ---- run_inference's protocol, with one numpy stub for both packages ----

def _stub_predictor(*args, **kwargs):
    """A predictor without a model: class ids from the first P x P pixels
    of each raw slice (deterministic, every class present)."""

    def predict(slices):
        return (np.clip(slices, 0, 1) * (CLASSES - 0.01)).astype(np.uint8)

    def predict_volume(vol):
        return predict(vol[:, :P, :P])

    predict_volume.seconds = {"resample": 0.0, "forward": 0.0}
    predict.predict_volume = predict_volume
    return predict


def test_run_inference_lines_and_volumes_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jinf, "make_predictor", _stub_predictor)
    monkeypatch.setattr(pinf, "make_predictor", _stub_predictor)
    ds = psyn.SyntheticVolumeDataset(length=3, hw=48)
    out = {}
    for name, run, kw in (
            ("jax", jinf.run_inference, dict(variables=None)),
            ("port", pinf.run_inference, dict(device="cpu"))):
        lines = []
        (tmp_path / name).mkdir()
        means = run(model=None, volume_dataset=ds, classes=CLASSES,
                    patch_size=P, batch=BATCH, log=lines.append,
                    save_path=str(tmp_path / name), z_spacing=2.5,
                    hd95_spacing=(2.5, 1.0, 1.0), **kw)
        out[name] = (lines, means)
    (jl, jm), (pl, pm) = out["jax"], out["port"]
    assert pl == jl and pm == jm
    assert pl[0] == "3 test iterations per epoch"
    assert [ln.split()[1] for ln in pl[1:4]] == ["0", "1", "2"]
    assert pl[-1].startswith("Testing performance in best val model: "
                             "mean_dice : ")
    assert sum(ln.startswith("Mean class") for ln in pl) == CLASSES - 1
    for i in range(3):
        case = ds.get(i)["case_name"]
        for kind in ("img", "pred", "gt"):
            f = f"{case}_{kind}.nii.gz"
            assert (tmp_path / "port" / f).read_bytes() == \
                (tmp_path / "jax" / f).read_bytes()


def test_run_inference_reports_the_split(monkeypatch):
    monkeypatch.setattr(pinf, "make_predictor", _stub_predictor)
    ds = psyn.SyntheticVolumeDataset(length=2, hw=40)
    stats = []
    pinf.run_inference(None, ds, CLASSES, P, BATCH, log=None, device="cpu",
                       stats=stats)
    assert len(stats) == 2
    for s in stats:
        assert set(s) == {"load", "resample", "forward", "back_resize",
                          "save", "metrics_wait", "metrics"}
        assert all(v >= 0 for v in s.values())


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    m = MSTransception(TransceptionConfig(img_size=32, stage1_layers=1,
                                          num_path=(1, 1, 1),
                                          num_layers=(1, 1, 1)), "cpu")
    for make in (pinf.make_predictor, pinf.make_device_predictor):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(m, P)
    with pytest.raises(RuntimeError, match="CUDA"):
        pinf.run_inference(m, psyn.SyntheticVolumeDataset(1, 40), CLASSES,
                           P, log=None)


# ---- the tiny model end to end against JAX ----

@pytest.fixture(scope="module")
def pair():
    """The JAX model at tiny_config (fp32) and the port's, with the same
    weights: the port's seeded init with random BatchNorm statistics,
    carried into the JAX tree by the JAX package's own converter (so no
    JAX init is compiled; tests/test_torch_convert.py holds the two
    directions bit-exact)."""
    from transception_tpu.convert.torch2flax import convert_state_dict
    jc = tiny_config()
    jm = JModel(jc)
    pm = MSTransception(_port_config(jc), device="cpu", seed=3)
    gen = torch.Generator().manual_seed(0)
    for name, buf in pm.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, P, P, 1)))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                   shapes)
    v, _ = convert_state_dict(
        {k: t.numpy() for k, t in pm.state_dict().items()}, zeros)
    v = jax.tree_util.tree_map(np.asarray, v)
    load_jax_variables(MSTransception(_port_config(jc), device="cpu"), v,
                       device="cpu")  # the tree is complete
    return jc, jm, v, pm


@pytest.fixture(scope="module")
def jax_host(pair):
    """JAX's host-path predictor, compiled once for the module."""
    jc, jm, v, _ = pair
    return jinf.make_predictor(jm, v, P, BATCH)


@pytest.fixture(scope="module")
def volumes():
    """Three synthetic 48² volumes, and one at 61 x 48, where the order-0
    map back has an edge-filled row (_zoom0_index(32, 61))."""
    ds = psyn.SyntheticVolumeDataset(length=3, hw=48)
    vols = [ds.get(i) for i in range(3)]
    rng = np.random.default_rng(7)
    vols.append({"image": rng.random((5, 61, 48), np.float32),
                 "label": rng.integers(0, CLASSES, (5, 61, 48)).astype(
                     np.float32), "case_name": "odd"})
    return ds, vols


def _agree(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return (a == b).mean()


def test_tiny_volume_eval_host_path_equals_jax(pair, jax_host, volumes,
                                               monkeypatch, tmp_path):
    """run_inference in both packages (JAX's on its host predictor), the
    class maps they save compared voxel by voxel; test_single_volume on
    the odd-shaped volume."""
    jc, jm, v, pm = pair
    ds, vols = volumes
    monkeypatch.setattr(jinf, "make_predictor", lambda *a, **k: jax_host)
    out = {}
    for name, run, args in (("jax", jinf.run_inference, (jm, v)),
                            ("port", pinf.run_inference, (pm,))):
        lines = []
        (tmp_path / name).mkdir()
        kw = {} if name == "jax" else {"device": "cpu"}
        means = run(*args, ds, CLASSES, patch_size=P, batch=BATCH,
                    log=lines.append, save_path=str(tmp_path / name), **kw)
        out[name] = lines, means
    (jl, (jd, jh)), (pl, (pd, ph)) = out["jax"], out["port"]
    assert len(pl) == len(jl) == 3 + 1 + CLASSES - 1 + 1 and pl[0] == jl[0]
    assert abs(pd - jd) <= 0.01 and abs(ph - jh) <= 0.5
    for s in vols[:3]:
        f = f"{s['case_name']}_pred.nii.gz"
        got, _ = pnii.load_nifti(str(tmp_path / "port" / f))
        want, _ = pnii.load_nifti(str(tmp_path / "jax" / f))
        assert got.shape == s["image"].shape
        assert (got == want).mean() >= FP32_AGREE
    s = vols[3]
    pp = pinf.make_predictor(pm, P, BATCH, device="cpu")
    jmets, jpred = jinf.test_single_volume(
        s["image"], s["label"], jax_host, CLASSES, P, return_prediction=True)
    pmets, ppred = port_single_volume(
        s["image"], s["label"], pp, CLASSES, P, return_prediction=True)
    assert ppred.shape == s["image"].shape
    assert _agree(ppred, jpred) >= FP32_AGREE
    np.testing.assert_allclose(np.asarray(pmets)[:, 0],
                               np.asarray(jmets)[:, 0], atol=0.01)
    np.testing.assert_allclose(np.asarray(pmets)[:, 1],
                               np.asarray(jmets)[:, 1], atol=0.5)


def test_tiny_device_resample_paths_equal_jax(pair, volumes):
    """make_predictor(device_resample=True) and make_device_predictor
    against JAX's (at 48², one program each), and on the port against its
    own host path (every volume)."""
    jc, jm, v, pm = pair
    _, vols = volumes
    jr = jinf.make_predictor(jm, v, P, BATCH, device_resample=True)
    jd = jinf.make_device_predictor(jm, v, P, BATCH)
    host = pinf.make_predictor(pm, P, BATCH, device="cpu")
    pr = pinf.make_predictor(pm, P, BATCH, device="cpu",
                             device_resample=True)
    pdev = pinf.make_device_predictor(pm, P, BATCH, device="cpu")
    img = np.concatenate([s["image"] for s in vols[:2]])
    want_r = jinf._resize_pred_back(jr.predict_volume(img), 48, 48)
    got_r = pinf._resize_pred_back(pr.predict_volume(img), 48, 48)
    assert _agree(got_r, want_r) >= FP32_AGREE
    assert _agree(pdev(img), jd(img)) >= FP32_AGREE
    for s in vols:
        img = s["image"]
        h, w = img.shape[1:]
        got_r = pinf._resize_pred_back(pr.predict_volume(img), h, w)
        # The device gather is the host back-resize, bit for bit; the
        # float64 spline is the host spline's.
        np.testing.assert_array_equal(pdev(img), got_r)
        got_h = pinf._resize_pred_back(host.predict_volume(img), h, w)
        assert _agree(got_r, got_h) >= FP32_AGREE


def test_tiny_device_resample_matches_host_spline(pair):
    """The float64 products round once to fp32: the resampled slices are
    the host spline's to one fp32 rounding."""
    vol = np.random.default_rng(11).random((3, 61, 48), np.float32)
    a_h, a_w = pinf._operators(61, 48, P, torch.device("cpu"))
    got = pinf._resample(torch.from_numpy(vol), a_h, a_w).numpy()
    want = pinf.resize_slices(vol, P)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -23)


def test_tiny_device_resample_passthrough(pair, volumes):
    """At the patch size the device-resample path is the host path: the
    slices go to the model as they are."""
    pm = pair[3]
    _, vols = volumes
    at_p = vols[0]["image"][:, :P, :P]
    host = pinf.make_predictor(pm, P, BATCH, device="cpu")
    np.testing.assert_array_equal(
        pinf.make_predictor(pm, P, BATCH, device="cpu",
                            device_resample=True).predict_volume(at_p),
        host.predict_volume(at_p))


def test_tiny_bf16_host_path_matches_jax_bf16_transfer(pair, volumes):
    """JAX ships bf16 slices to a bf16 model (default_transfer_dtype) and
    casts them back to fp32; the port ships fp32 and the model rounds to
    bf16 first thing: the same values reach the first layer."""
    jc, jm, v, pm = pair
    _, vols = volumes
    jb = JModel(dataclasses.replace(jc, dtype="bfloat16"))
    pb = MSTransception(_port_config(jc, dtype="bfloat16"), device="cpu")
    pb.load_state_dict(pm.state_dict())
    jp = jinf.make_predictor(jb, v, P, BATCH)
    pp = pinf.make_predictor(pb, P, BATCH, device="cpu")
    img = np.concatenate([s["image"] for s in vols[:2]])
    agree = _agree(pp.predict_volume(img), jp.predict_volume(img))
    assert agree >= BF16_AGREE, f"bf16 class maps agree on {agree:.4f}"
