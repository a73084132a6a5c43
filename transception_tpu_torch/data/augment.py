"""Training augmentation, the port's copy of transception_tpu/data/augment.py
(numpy/scipy, no JAX): the reference's imgaug pipeline
(datasets/dataset_synapse.py:84-95),

  SomeOf((0,4), [Flipud(.5), Fliplr(.5), AdditiveGaussianNoise(0.005*255),
                 GaussianBlur(sigma=1), LinearContrast(0.5-1.5),
                 Affine(scale 0.5-2), Affine(rotate ±40), Affine(shear ±16),
                 PiecewiseAffine(0.008-0.03), Affine(translate ±20%)],
         random_order=True)

Geometric ops transform image (order-1) and label (order-0, via the same
one-hot->argmax semantics as dataset_synapse.py:27-36); photometric ops touch
the image only, matching imgaug's segmap behavior. Also provides the
rot90/±20° helpers from dataset_synapse.py:38-51 for the RandomGenerator
path. Runs on host numpy, train only: the host loader's threads overlap it
with the card's steps. The same calls on the same np.random.Generator give
the JAX package's results bit for bit (tests/test_torch_augment.py).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
from scipy import ndimage


def _affine_pair(img, lbl, matrix, offset):
    if img.ndim == 3:  # (H, W, C): same spatial transform on every channel
        out_img = np.stack(
            [ndimage.affine_transform(img[..., c], matrix, offset=offset,
                                      order=1, mode="constant", cval=0.0)
             for c in range(img.shape[-1])], axis=-1)
    else:
        out_img = ndimage.affine_transform(img, matrix, offset=offset,
                                           order=1, mode="constant", cval=0.0)
    out_lbl = ndimage.affine_transform(lbl, matrix, offset=offset, order=0,
                                       mode="constant", cval=0.0)
    return out_img, out_lbl


def _centered(matrix, shape):
    """Offset so the transform is about the image center (imgaug style)."""
    c = (np.asarray(shape[:2]) - 1) / 2.0
    offset = c - matrix @ c
    return matrix, offset


def aug_flipud(img, lbl, rng):
    if rng.random() < 0.5:
        return img[::-1].copy(), lbl[::-1].copy()
    return img, lbl


def aug_fliplr(img, lbl, rng):
    if rng.random() < 0.5:
        return img[:, ::-1].copy(), lbl[:, ::-1].copy()
    return img, lbl


def aug_gaussian_noise(img, lbl, rng, scale=0.005 * 255):
    return img + rng.normal(0.0, scale, img.shape).astype(img.dtype), lbl


def aug_gaussian_blur(img, lbl, rng, sigma=1.0):
    if img.ndim == 3:  # blur spatially only, never across channels
        return ndimage.gaussian_filter(img, sigma=(sigma, sigma, 0.0)), lbl
    return ndimage.gaussian_filter(img, sigma=sigma), lbl


def aug_linear_contrast(img, lbl, rng, lo=0.5, hi=1.5):
    center = 0.5  # float images in [0, 1]
    if img.ndim == 3 and rng.random() < 0.5:
        # imgaug per_channel=0.5 semantics: half the time an independent
        # alpha per channel.
        alpha = rng.uniform(lo, hi, size=(1, 1, img.shape[-1]))
    else:
        alpha = rng.uniform(lo, hi)
    return center + alpha * (img - center), lbl


def aug_affine_scale(img, lbl, rng, lo=0.5, hi=2.0):
    sx = rng.uniform(lo, hi)
    sy = rng.uniform(lo, hi)
    # output->input mapping: inverse scales.
    m, off = _centered(np.diag([1.0 / sy, 1.0 / sx]), img.shape)
    return _affine_pair(img, lbl, m, off)


def aug_affine_rotate(img, lbl, rng, deg=40.0):
    a = np.deg2rad(rng.uniform(-deg, deg))
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    m, off = _centered(rot, img.shape)
    return _affine_pair(img, lbl, m, off)


def aug_affine_shear(img, lbl, rng, deg=16.0):
    """imgaug Affine(shear=deg) = skimage x-shear about the center:
    forward x' = x - sin(sh)*y, y' = cos(sh)*y. Output->input matrix in
    (row, col) coords is [[1/cos, 0], [tan, 1]]."""
    sh = np.deg2rad(rng.uniform(-deg, deg))
    m = np.array([[1.0 / np.cos(sh), 0.0], [np.tan(sh), 1.0]])
    m, off = _centered(m, img.shape)
    return _affine_pair(img, lbl, m, off)


def aug_affine_translate(img, lbl, rng, frac=0.2):
    ty = rng.uniform(-frac, frac) * img.shape[0]
    tx = rng.uniform(-frac, frac) * img.shape[1]
    m = np.eye(2)
    return _affine_pair(img, lbl, m, np.array([-ty, -tx]))


def aug_piecewise_affine(img, lbl, rng, scale_lo=0.008, scale_hi=0.03,
                         nb_rows=4, nb_cols=4):
    """imgaug PiecewiseAffine semantics (its documented default is a
    4x4 grid of control points): each grid node is independently jittered
    by a normal displacement with sigma = scale * image_size (dy by
    scale*h, dx by scale*w), and the displacement field between nodes is
    piecewise-interpolated; the warp is applied as an inverse coordinate
    map (order-1 image / order-0 label, like the segmap path).

    Documented divergences from imgaug's exact implementation (which fits
    a skimage PiecewiseAffineTransform on the jittered points): (a) the
    field between nodes is interpolated bilinearly per cell rather than
    affinely per Delaunay triangle, and (b) the inverse map is
    approximated by negating the forward node displacements instead of
    fitting the inverse transform — both are O(scale)-small at the
    pipeline's scale range (<=0.03) and train-only (no eval-parity
    impact). The node displacement DISTRIBUTION itself (per-node normal,
    4x4 grid, sigma=scale*size) matches imgaug exactly by construction."""
    from scipy.interpolate import RegularGridInterpolator
    h, w = img.shape[:2]
    scale = rng.uniform(scale_lo, scale_hi)
    node_y = np.linspace(0, h - 1, nb_rows)
    node_x = np.linspace(0, w - 1, nb_cols)
    dy_nodes = rng.normal(0, scale * h, (nb_rows, nb_cols))
    dx_nodes = rng.normal(0, scale * w, (nb_rows, nb_cols))
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pts = np.stack([yy.ravel(), xx.ravel()], axis=-1)
    dy = RegularGridInterpolator((node_y, node_x), dy_nodes,
                                 method="linear")(pts).reshape(h, w)
    dx = RegularGridInterpolator((node_y, node_x), dx_nodes,
                                 method="linear")(pts).reshape(h, w)
    coords = np.stack([yy + dy, xx + dx])
    if img.ndim == 3:
        out_img = np.stack(
            [ndimage.map_coordinates(img[..., c], coords, order=1,
                                     mode="constant")
             for c in range(img.shape[-1])], axis=-1)
    else:
        out_img = ndimage.map_coordinates(img, coords, order=1,
                                          mode="constant")
    out_lbl = ndimage.map_coordinates(lbl, coords, order=0, mode="constant")
    return out_img, out_lbl


_PIPELINE: List[Callable] = [
    aug_flipud,
    aug_fliplr,
    aug_gaussian_noise,
    aug_gaussian_blur,
    aug_linear_contrast,
    aug_affine_scale,
    aug_affine_rotate,
    aug_affine_shear,
    aug_piecewise_affine,
    aug_affine_translate,
]


def augment_slice(img: np.ndarray, lbl: np.ndarray,
                  rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """SomeOf((0,4)) of the 10 ops, random order (dataset_synapse.py:84-95).

    img may be (H, W) grayscale or (H, W, C) channels-last RGB; geometric
    ops share one transform across channels, photometric ops draw
    per-channel randomness (LinearContrast per_channel=0.5 imgaug-style)."""
    k = rng.integers(0, 5)
    if k == 0:
        return img, lbl
    idx = rng.choice(len(_PIPELINE), size=k, replace=False)
    rng.shuffle(idx)
    img = np.asarray(img, np.float32)
    lbl = np.asarray(lbl, np.float32)
    for i in idx:
        img, lbl = _PIPELINE[i](img, lbl, rng)
    return img, lbl


# --- RandomGenerator-path helpers (dataset_synapse.py:38-72) ---

def random_rot_flip(img, lbl, rng):
    k = int(rng.integers(0, 4))
    img = np.rot90(img, k)
    lbl = np.rot90(lbl, k)
    axis = int(rng.integers(0, 2))
    return np.flip(img, axis=axis).copy(), np.flip(lbl, axis=axis).copy()


def random_rotate(img, lbl, rng):
    angle = float(rng.integers(-20, 20))
    img = ndimage.rotate(img, angle, order=0, reshape=False)
    lbl = ndimage.rotate(lbl, angle, order=0, reshape=False)
    return img, lbl


def random_generator_augment(img, lbl, rng):
    """The alternative torch-side aug (constructed but unused in the
    reference trainer, trainer.py:89-96; provided for completeness)."""
    if rng.random() > 0.5:
        img, lbl = random_rot_flip(img, lbl, rng)
    elif rng.random() > 0.5:
        img, lbl = random_rotate(img, lbl, rng)
    return img, lbl


def zoom_to(img: np.ndarray, lbl: np.ndarray, size: int):
    """Bicubic image / nearest label resize (dataset_synapse.py:109-112)."""
    x, y = img.shape
    if x != size or y != size:
        img = ndimage.zoom(img, (size / x, size / y), order=3)
        lbl = ndimage.zoom(lbl, (size / x, size / y), order=0)
    return img, lbl


def normalize_image(img: np.ndarray) -> np.ndarray:
    """ToTensor + Normalize([0.5],[0.5]) equivalent (trainer.py:89-93)."""
    return (np.asarray(img, np.float32) - 0.5) / 0.5
