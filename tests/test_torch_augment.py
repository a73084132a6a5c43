"""The port's training augmentation (transception_tpu_torch/data/augment.py)
against the JAX package's (transception_tpu/data/augment.py): both are
numpy/scipy, so each of the ten ops, augment_slice,
random_generator_augment, zoom_to and normalize_image must give the same
bits on the same np.random.Generator, gray and RGB; and the analytic
properties of tests/test_augment_properties.py (imgaug is not installed
here) hold for the port's functions too, the same tests run with the
port's module in place of the JAX one."""

import numpy as np
import pytest

import test_augment_properties as props
from transception_tpu.data import augment as J
from transception_tpu_torch.data import augment as P

OPS = ("aug_flipud", "aug_fliplr", "aug_gaussian_noise", "aug_gaussian_blur",
       "aug_linear_contrast", "aug_affine_scale", "aug_affine_rotate",
       "aug_affine_shear", "aug_piecewise_affine", "aug_affine_translate")


def _pair(seed, shape=(40, 36)):
    rng = np.random.default_rng(seed)
    img = rng.random(shape).astype(np.float32)
    lbl = rng.integers(0, 9, shape[:2]).astype(np.float32)
    return img, lbl


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_pipeline_is_the_same_ten_ops():
    assert [f.__name__ for f in P._PIPELINE] == list(OPS)
    assert [f.__name__ for f in J._PIPELINE] == list(OPS)


@pytest.mark.parametrize("rgb", [False, True], ids=["gray", "rgb"])
@pytest.mark.parametrize("op", OPS)
def test_op_bit_for_bit(op, rgb):
    img, lbl = _pair(3, (40, 36, 3) if rgb else (40, 36))
    for seed in range(4):
        _same(getattr(P, op)(img, lbl, np.random.default_rng(seed)),
              getattr(J, op)(img, lbl, np.random.default_rng(seed)))


def test_augment_slice_bit_for_bit():
    img, lbl = _pair(5)
    rgb, _ = _pair(6, (40, 36, 3))
    for seed in range(24):
        _same(P.augment_slice(img, lbl, np.random.default_rng(seed)),
              J.augment_slice(img, lbl, np.random.default_rng(seed)))
        _same(P.augment_slice(rgb, lbl, np.random.default_rng(seed)),
              J.augment_slice(rgb, lbl, np.random.default_rng(seed)))


def test_random_generator_augment_bit_for_bit():
    img, lbl = _pair(7, (32, 32))
    for seed in range(16):
        _same(P.random_generator_augment(img, lbl,
                                         np.random.default_rng(seed)),
              J.random_generator_augment(img, lbl,
                                         np.random.default_rng(seed)))


@pytest.mark.parametrize("hw", [(512, 512), (40, 36), (24, 24)])
def test_zoom_to_and_normalize_bit_for_bit(hw):
    img, lbl = _pair(8, hw)
    _same(P.zoom_to(img, lbl, 24), J.zoom_to(img, lbl, 24))
    np.testing.assert_array_equal(P.normalize_image(img),
                                  J.normalize_image(img))


# The analytic properties, on the port's functions. test_imgaug_goldens
# asserts recorded imgaug outputs where present; tests/golden/imgaug/
# does not exist, so it has nothing to run here.
PROPERTIES = sorted(n for n in dir(props) if n.startswith("test_")
                    and n != "test_imgaug_goldens")


@pytest.mark.parametrize("name", PROPERTIES)
def test_augment_property_on_the_port(name, monkeypatch):
    monkeypatch.setattr(props, "A", P)
    fn = getattr(props, name)
    if "monkeypatch" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        fn(monkeypatch)
    else:
        fn()
