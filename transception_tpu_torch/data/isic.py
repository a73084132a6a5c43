"""ISIC 2018 skin-lesion binary segmentation, the port's copy of
transception_tpu/data/isic.py (numpy and scipy on the host; no JAX).

Two layouts:
  * raw: paired image (jpg/png) and mask ('*_segmentation.png') dirs, the
    official ISIC 2018 Task-1 layout (read with PIL);
  * preprocessed: one .npy/.npz per split with 'image' (N, H, W, 3 float in
    [0, 1], or (N, H, W) gray, repeated to 3 channels) and 'label'
    (N, H, W) arrays.
Binary labels {0, 1}; images zoomed order-1 and masks nearest to img_size.
The items are the JAX package's bit for bit (tests/test_torch_isic.py).
`dice_eval` scores a model's argmax over its logits per image.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np
import torch
from scipy import ndimage

from transception_tpu_torch.core.device import DeviceLike, resolve_device
from transception_tpu_torch.data.augment import augment_slice, normalize_image
from transception_tpu_torch.eval.metrics import dice_coefficient


def _resize_rgb(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    if h == size and w == size:
        return img
    return ndimage.zoom(img, (size / h, size / w, 1), order=1)


def _resize_mask(mask: np.ndarray, size: int) -> np.ndarray:
    if mask.shape[0] == size and mask.shape[1] == size:
        return mask
    return ndimage.zoom(mask, (size / mask.shape[0], size / mask.shape[1]),
                        order=0)


class ISICDataset:
    """Raw-layout ISIC dataset (a split by file list: every image of
    image_dir by default), paired by name with mask_dir's
    '{name}_segmentation.png'."""

    def __init__(self, image_dir: str, mask_dir: str, img_size: int = 224,
                 augment: bool = True, file_list: Optional[List[str]] = None):
        self.image_dir = image_dir
        self.mask_dir = mask_dir
        self.img_size = img_size
        self.augment = augment
        if file_list is None:
            file_list = sorted(
                os.path.splitext(os.path.basename(p))[0]
                for p in glob.glob(os.path.join(image_dir, "*.jpg"))
                + glob.glob(os.path.join(image_dir, "*.png")))
        self.names = file_list

    def __len__(self):
        return len(self.names)

    def _load_pair(self, name: str):
        from PIL import Image
        img_path = None
        for ext in (".jpg", ".png"):
            p = os.path.join(self.image_dir, name + ext)
            if os.path.exists(p):
                img_path = p
                break
        mask_path = os.path.join(self.mask_dir, name + "_segmentation.png")
        img = np.asarray(Image.open(img_path).convert("RGB"),
                         np.float32) / 255.0
        mask = (np.asarray(Image.open(mask_path).convert("L"),
                           np.float32) > 127.5).astype(np.float32)
        return img, mask

    def get(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        name = self.names[idx]
        img, mask = self._load_pair(name)
        img = _resize_rgb(img, self.img_size)
        mask = _resize_mask(mask, self.img_size)
        if self.augment:
            # One pass on the stacked (H, W, 3) image: the geometric ops
            # share one transform over the channels and the mask.
            img, mask = augment_slice(img, mask, rng)
        return {
            "image": normalize_image(img),  # (H, W, 3)
            "label": np.round(mask).astype(np.int32),
            "case_name": name,
        }


class ISICPreprocessedDataset:
    """Single-file preprocessed layout."""

    def __init__(self, path: str, img_size: int = 224, augment: bool = True):
        data = np.load(path, allow_pickle=False)
        self.images = np.asarray(data["image"], np.float32)
        self.labels = np.asarray(data["label"], np.float32)
        self.img_size = img_size
        self.augment = augment

    def __len__(self):
        return len(self.images)

    def get(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        img = self.images[idx]
        mask = self.labels[idx]
        if img.ndim == 2:
            img = img[..., None].repeat(3, -1)
        img = _resize_rgb(img, self.img_size)
        if mask.shape != (self.img_size, self.img_size):
            mask = _resize_mask(mask, self.img_size)
        if self.augment:
            img, mask = augment_slice(img, mask, rng)
        return {
            "image": normalize_image(img),
            "label": np.round(mask).astype(np.int32),
            "case_name": f"isic_{idx:05d}",
        }


class SyntheticISICDataset:
    """Deterministic random RGB lesions (item idx draws from numpy's
    default_rng(5000 + idx), as the JAX package's do) for machines without
    the dataset."""

    def __init__(self, length: int = 256, img_size: int = 224,
                 augment: bool = False):
        self.length = length
        self.img_size = img_size
        self.augment = augment

    def __len__(self):
        return self.length

    def get(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        g = np.random.default_rng(5000 + idx)
        s = self.img_size
        img = g.random((s, s, 3), np.float32)
        yy, xx = np.mgrid[0:s, 0:s]
        cy, cx = g.integers(s // 4, 3 * s // 4, 2)
        r = g.integers(s // 8, s // 4)
        mask = (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r).astype(np.int32)
        return {"image": normalize_image(img), "label": mask,
                "case_name": f"synthetic_isic_{idx}"}


def _save_prediction(save_path: str, name: str, pb: np.ndarray) -> None:
    """{name}_pred.png (uint8 0/255, PIL), or {name}_pred.npy (0/1) where
    PIL is missing, as the JAX package writes them."""
    try:
        from PIL import Image
        Image.fromarray(pb.astype(np.uint8) * 255).save(
            os.path.join(save_path, f"{name}_pred.png"))
    except Exception:  # PIL is optional
        np.save(os.path.join(save_path, f"{name}_pred.npy"),
                pb.astype(np.uint8))


def dice_eval(model, dataset, img_size: int = 224, batch: int = 32,
              log=print, save_path: Optional[str] = None,
              per_case_log: bool = True,
              device: DeviceLike = "cuda") -> float:
    """Binary segmentation eval over an ISIC split (JAX isic.py:144-203):
    per-case dice/IoU lines, the mean, optional prediction export.

    * inputs are normalised (x - 0.5) / 0.5 by the dataset and resized to
      img_size (order-1 RGB, nearest masks);
    * the prediction is the argmax over the model's logits forward (not
      the fused argmax head), ties to class 0: for a 2-class head exactly
      the p(lesion) > 0.5 threshold;
    * dice/IoU at img_size on {0, 1} masks; the last batch is padded with
      zeros to `batch`, so every forward has one shape;
    * the forward runs in eval mode (JAX's train=False: BatchNorm on its
      running statistics, which the eval leaves untouched, and no
      drop-path), and the model's mode is restored after it.
    `model` lives on `device` (the card unless the caller asks for the
    CPU); save_path: {case}_pred.png per case (.npy without PIL)."""
    was_training = model.training
    model.eval()
    try:
        return _dice_eval(model, dataset, batch, log, save_path,
                          per_case_log, resolve_device(device))
    finally:
        model.train(was_training)


def _dice_eval(model, dataset, batch, log, save_path, per_case_log,
               dev) -> float:
    dices, ious = [], []
    n = len(dataset)
    rng = np.random.default_rng(0)
    if save_path is not None:
        os.makedirs(save_path, exist_ok=True)
    for start in range(0, n, batch):
        idxs = range(start, min(start + batch, n))
        items = [dataset.get(i, rng) for i in idxs]
        x = np.stack([it["image"] for it in items])
        if x.shape[0] < batch:
            x = np.pad(x, ((0, batch - x.shape[0]), (0, 0), (0, 0), (0, 0)))
        with torch.inference_mode():
            logits = model(torch.from_numpy(x).to(dev))
            pred = logits.argmax(-1).cpu().numpy()[:len(items)]
        for p, it in zip(pred, items):
            pb, gb = p > 0, it["label"] > 0
            d = dice_coefficient(pb, gb)
            inter = float(np.logical_and(pb, gb).sum())
            union = float(np.logical_or(pb, gb).sum())
            iou = inter / union if union > 0 else 1.0
            dices.append(d)
            ious.append(iou)
            if per_case_log and log:
                log(f"case {it['case_name']} dice {d:.6f} iou {iou:.6f}")
            if save_path is not None:
                _save_prediction(save_path, it["case_name"], pb)
    mean = float(np.mean(dices)) if dices else 0.0
    mean_iou = float(np.mean(ious)) if ious else 0.0
    if log:
        log(f"ISIC eval: mean_dice {mean:.6f} mean_iou {mean_iou:.6f} "
            f"over {len(dices)} images")
    return mean
