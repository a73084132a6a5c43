"""Volume evaluation metrics: binary Dice (DSC) and 95% Hausdorff (HD95).

A copy of transception_tpu/eval/metrics.py for the PyTorch port (numpy and
scipy on the host, as there); tests/test_torch_eval_metrics.py holds the
two equal.

medpy is not a dependency, so HD95 is implemented directly with
scipy distance transforms using medpy's definition (95th percentile of the
pooled directed surface distances, surfaces via connectivity-1 erosion).
The (1,0)/(0,0) empty-mask conventions follow utils.py:50-60.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage


def dice_coefficient(pred: np.ndarray, gt: np.ndarray) -> float:
    """Binary Dice: 2|A∩B| / (|A| + |B|)."""
    pred = np.asarray(pred, bool)
    gt = np.asarray(gt, bool)
    denom = pred.sum() + gt.sum()
    if denom == 0:
        return 0.0
    return float(2.0 * np.logical_and(pred, gt).sum() / denom)


def _surface(mask: np.ndarray) -> np.ndarray:
    """Border voxels: mask minus its connectivity-1 erosion."""
    struct = ndimage.generate_binary_structure(mask.ndim, 1)
    eroded = ndimage.binary_erosion(mask, structure=struct, iterations=1)
    return mask & ~eroded


def _union_bbox(mask: np.ndarray):
    """Tight bounding-box slices of a non-empty mask (per-axis any-reduce)."""
    out = []
    for ax in range(mask.ndim):
        axes = tuple(i for i in range(mask.ndim) if i != ax)
        nz = np.flatnonzero(mask.any(axis=axes))
        out.append(slice(int(nz[0]), int(nz[-1]) + 1))
    return tuple(out)


def hd95(pred: np.ndarray, gt: np.ndarray, spacing=None) -> float:
    """95th percentile of the pooled symmetric surface distances.

    Computed inside the union bounding box of the two masks — EXACT, not
    an approximation: every surface voxel (EDT source and query alike)
    lies inside the crop, a tight bbox leaves all-background just outside
    each face exactly as the full volume does (so connectivity-1 erosion
    with border_value=0 yields identical surfaces), and cropping changes
    no geometry. distance_transform_edt is O(volume), so this turns two
    full-volume EDTs per class into ~the organ's subvolume
    (the brute-force oracle in tests/test_metric_goldens.py pins
    equality for the JAX package's copy). Surfaces are computed once and
    shared by both directions."""
    pred = np.asarray(pred, bool)
    gt = np.asarray(gt, bool)
    if not pred.any() or not gt.any():
        return 0.0
    box = _union_bbox(pred | gt)
    pred, gt = pred[box], gt[box]
    sp, sg = _surface(pred), _surface(gt)
    d1 = ndimage.distance_transform_edt(~sg, sampling=spacing)[sp]
    d2 = ndimage.distance_transform_edt(~sp, sampling=spacing)[sg]
    return float(np.percentile(np.hstack((d1, d2)), 95))


def metric_per_case(pred: np.ndarray, gt: np.ndarray,
                    spacing=None) -> Tuple[float, float]:
    """(dice, hd95) with the reference's empty-mask conventions
    (utils.py:50-60): pred>0 & gt==0 -> (1, 0); both empty/pred empty -> (0,0).

    spacing: optional per-axis voxel spacing for hd95 in physical units,
    e.g. (z_spacing, 1, 1) for a (D, H, W) volume. The reference's
    published protocol calls medpy hd95 with NO spacing (utils.py:54) —
    pass None for protocol parity."""
    pred = np.asarray(pred) > 0
    gt = np.asarray(gt) > 0
    if pred.sum() > 0 and gt.sum() > 0:
        return dice_coefficient(pred, gt), hd95(pred, gt, spacing)
    if pred.sum() > 0 and gt.sum() == 0:
        return 1.0, 0.0
    return 0.0, 0.0
