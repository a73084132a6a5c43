"""The port's host-side eval numerics against the JAX package's: DSC/HD95
(eval/metrics.py), the spline operators and the order-0 back-resize
(eval/inference.py), and the native resampler (native/). All numpy/scipy
on the host in both packages, so every comparison is exact."""

import numpy as np
import pytest
from scipy import ndimage

from transception_tpu.eval import inference as jinf
from transception_tpu.eval import metrics as jmet
from transception_tpu_torch import native
from transception_tpu_torch.eval import inference as pinf
from transception_tpu_torch.eval import metrics as pmet


def _blobs(seed, shape=(10, 12, 11)):
    """Two overlapping random balls (tests/test_metric_goldens.py)."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.mgrid[: shape[0], : shape[1], : shape[2]]
    c1 = rng.integers(2, np.asarray(shape) - 2, 3)
    c2 = c1 + rng.integers(-2, 3, 3)
    r1, r2 = rng.integers(2, 5), rng.integers(2, 5)
    a = ((zz - c1[0]) ** 2 + (yy - c1[1]) ** 2 + (xx - c1[2]) ** 2) < r1 ** 2
    b = ((zz - c2[0]) ** 2 + (yy - c2[1]) ** 2 + (xx - c2[2]) ** 2) < r2 ** 2
    return a, b


def _labels(seed, shape=(6, 40, 36), classes=4):
    """Blocky random label volumes: class maps with real surfaces."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, classes, (shape[0], shape[1] // 4, shape[2] // 4))
    return np.repeat(np.repeat(small, 4, 1), 4, 2)


@pytest.mark.parametrize("spacing", [None, (2.5, 1.0, 1.0),
                                     (0.7, 1.3, 0.9)])
@pytest.mark.parametrize("seed", range(4))
def test_metrics_equal_jax_on_random_blobs(seed, spacing):
    a, b = _blobs(seed)
    assert pmet.dice_coefficient(a, b) == jmet.dice_coefficient(a, b)
    assert pmet.hd95(a, b, spacing) == jmet.hd95(a, b, spacing)
    assert pmet.metric_per_case(a, b, spacing) == \
        jmet.metric_per_case(a, b, spacing)


@pytest.mark.parametrize("seed", range(3))
def test_metric_per_case_equal_jax_on_label_volumes(seed):
    pred, gt = _labels(seed), _labels(seed + 10)
    for c in range(1, 4):
        for sp in (None, (3.0, 1.0, 1.0)):
            assert pmet.metric_per_case(pred == c, gt == c, sp) == \
                jmet.metric_per_case(pred == c, gt == c, sp)


def test_surface_and_bbox_equal_jax():
    for seed in range(3):
        a, b = _blobs(seed)
        np.testing.assert_array_equal(pmet._surface(a), jmet._surface(a))
        assert pmet._union_bbox(a | b) == jmet._union_bbox(a | b)


def test_empty_mask_conventions_match_jax():
    """utils.py:50-60: pred>0 & gt empty -> (1, 0); pred empty -> (0, 0)."""
    z = np.zeros((4, 5, 6), bool)
    one = z.copy()
    one[1, 2, 3] = True
    for pred, gt, want in ((one, z, (1.0, 0.0)), (z, one, (0.0, 0.0)),
                           (z, z, (0.0, 0.0)), (one, one, (1.0, 0.0))):
        assert pmet.metric_per_case(pred, gt) == want
        assert jmet.metric_per_case(pred, gt) == want
    assert pmet.dice_coefficient(z, z) == jmet.dice_coefficient(z, z) == 0.0
    assert pmet.hd95(one, z) == jmet.hd95(one, z) == 0.0


@pytest.mark.parametrize("n_in,n_out", [(37, 17), (48, 32), (17, 32),
                                        (64, 64), (512, 224), (61, 32)])
def test_zoom_operator_equals_jax(n_in, n_out):
    got = pinf._zoom_operator(n_in, n_out)
    assert got.dtype == np.float64 and got.shape == (n_out, n_in)
    np.testing.assert_array_equal(got, jinf._zoom_operator(n_in, n_out))


def test_zoom_operator_is_the_2d_spline():
    rng = np.random.default_rng(5)
    for h, w, oh, ow in [(37, 29, 17, 17), (48, 40, 32, 32)]:
        img = rng.random((h, w))
        want = ndimage.zoom(img, (oh / h, ow / w), order=3)
        got = pinf._zoom_operator(h, oh) @ img @ pinf._zoom_operator(w, ow).T
        np.testing.assert_allclose(got, want, atol=1e-10)


@pytest.mark.parametrize("ph,pw,h,w", [
    (32, 32, 48, 48), (32, 32, 512, 512), (224, 224, 147, 189),
    (224, 224, 512, 512), (17, 23, 61, 37),
    # Shape pairs where scipy's edge fill gives class 0 (a zero of the
    # validity mask): 32 -> 61 and 224 -> 147 on one axis.
    (32, 32, 61, 48), (224, 224, 147, 512)])
def test_resize_pred_back_bit_exact_to_jax_and_scipy(ph, pw, h, w):
    rng = np.random.default_rng(ph * h + w)
    pred = rng.integers(1, 9, (2, ph, pw)).astype(np.uint8)
    got = pinf._resize_pred_back(pred, h, w)
    np.testing.assert_array_equal(got, jinf._resize_pred_back(pred, h, w))
    want = np.stack([ndimage.zoom(pred[i], (h / ph, w / pw), order=0)
                     for i in range(2)])
    np.testing.assert_array_equal(got, want)
    for n_in, n_out in ((ph, h), (pw, w)):
        for a, b in zip(pinf._zoom0_index(n_in, n_out),
                        jinf._zoom0_index(n_in, n_out)):
            np.testing.assert_array_equal(a, b)


def test_edge_fill_gives_class_zero():
    """The mask's zero: every class id is >= 1 in the input, and scipy
    (so the port) writes class 0 on the filled row."""
    _, ok = pinf._zoom0_index(32, 61)
    assert not ok.all()
    pred = np.full((1, 32, 32), 5, np.uint8)
    back = pinf._resize_pred_back(pred, 61, 48)
    assert (back[0][~ok] == 0).all() and (back[0][ok] == 5).all()


@pytest.mark.parametrize("shape,out_hw,order", [
    ((3, 512, 512), (224, 224), 3),   # the Synapse eval downsample
    ((3, 224, 224), (512, 512), 0),   # the class map back
    ((2, 64, 64), (224, 224), 3),     # upsample
    ((2, 100, 120), (224, 224), 3),   # non-square
    ((2, 224, 224), (147, 189), 0),
    ((1, 224, 224), (224, 224), 3),   # identity ratio
    ((2, 31, 57), (13, 224), 3),      # odd ratios both directions
])
def test_native_zoom_bit_exact_to_scipy(shape, out_hw, order):
    vol = np.random.default_rng(0).random(shape).astype(np.float32)
    if order == 0:
        vol = np.round(vol * 8)
    got = native.zoom2d_batch(vol, *out_hw, order)
    want = np.stack([
        ndimage.zoom(vol[i], (out_hw[0] / shape[1], out_hw[1] / shape[2]),
                     order=order)
        for i in range(shape[0])])
    np.testing.assert_array_equal(got, want)


def test_native_threads_deterministic():
    vol = np.random.default_rng(1).random((8, 128, 128)).astype(np.float32)
    np.testing.assert_array_equal(native.zoom2d_batch(vol, 224, 224, 3, 1),
                                  native.zoom2d_batch(vol, 224, 224, 3, 8))


@pytest.mark.parametrize("shape,size", [((5, 100, 100), 64),
                                        ((4, 48, 40), 32),
                                        ((3, 512, 512), 224),
                                        ((2, 32, 32), 32)])
def test_resize_slices_equals_jax_and_scipy(shape, size):
    """The native path (default), the scipy path (native=False) and JAX's
    _resize_slices_scipy give the same bits."""
    vol = np.random.default_rng(2).random(shape).astype(np.float32)
    got = pinf.resize_slices(vol, size)
    assert got.dtype == np.float32 and got.shape == (shape[0], size, size)
    np.testing.assert_array_equal(got, pinf.resize_slices(vol, size,
                                                          native=False))
    np.testing.assert_array_equal(got, jinf._resize_slices_scipy(vol, size))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output;
    nothing falls back to scipy on its own."""
    bad = tmp_path / "resample.c"
    bad.write_text("int zoom2d_batch_f32( {\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed"):
        native.zoom2d_batch(np.zeros((1, 8, 8), np.float32), 4, 4, 3)
    with pytest.raises(RuntimeError, match="failed"):
        pinf.resize_slices(np.zeros((1, 8, 8), np.float32), 4)
    assert not list((tmp_path / "build").glob("*.so"))


def test_native_builds_outside_the_source_tree():
    native.get_lib()
    so = native._so_path()
    assert so.exists() and so.parent.name == "build"
    assert not list(native._HERE.glob("*.so"))
    with pytest.raises(ValueError, match="order"):
        native.zoom2d_batch(np.zeros((1, 8, 8), np.float32), 4, 4, 1)
