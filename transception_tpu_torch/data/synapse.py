"""Synapse multi-organ CT datasets (datasets/dataset_synapse.py:75-128 of
the reference), the port's copy of transception_tpu/data/synapse.py.

Train split: {case}_sliceNNN.npz files with 'image'/'label' (H, W) arrays,
augmented (data.augment) and zoomed to img_size on the host. Test split:
{case}.npy.h5 whole volumes with 'image'/'label' (D, H, W). The synthetic
variants give deterministic random slices and volumes of the same layout,
bit-identical to the JAX package's (same seeds), for machines without the
dataset. ISIC is not ported (ROADMAP.md §1 item 5).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from transception_tpu_torch.data.augment import (
    augment_slice,
    normalize_image,
    zoom_to,
)


def read_list(list_dir: str, split: str) -> List[str]:
    """The case names of {list_dir}/{split}.txt, one per non-empty line."""
    path = os.path.join(list_dir, f"{split}.txt")
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


class SynapseSliceDataset:
    """Training slices (dataset_synapse.py:102-112): {case}.npz with
    'image'/'label' (H, W), augmented with the item's generator (the
    loader's per-item rng) and zoomed to img_size (bicubic image, nearest
    label). Items: image (img_size, img_size, 1) fp32 normalised to
    [-1, 1], label (img_size, img_size) int32, case_name."""

    def __init__(self, base_dir: str, list_dir: str, img_size: int = 224,
                 augment: bool = True, split: str = "train"):
        self.base_dir = base_dir
        self.img_size = img_size
        self.augment = augment
        self.samples = read_list(list_dir, split)

    def __len__(self):
        return len(self.samples)

    def get(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        name = self.samples[idx]
        data = np.load(os.path.join(self.base_dir, name + ".npz"))
        image = np.asarray(data["image"], np.float32)
        label = np.asarray(data["label"], np.float32)
        if self.augment:
            image, label = augment_slice(image, label, rng)
        image, label = zoom_to(image, label, self.img_size)
        return {
            "image": normalize_image(image)[..., None],  # (H, W, 1)
            "label": label.astype(np.int32),
            "case_name": name,
        }


class SyntheticSliceDataset:
    """Deterministic random slices (item idx draws from numpy's
    default_rng(idx), as the JAX package's do) for machines without the
    dataset; augmented like the Synapse slices when `augment`."""

    def __init__(self, length: int = 2211, img_size: int = 224,
                 num_classes: int = 9, raw_size: int = 512,
                 augment: bool = False):
        self.length = length
        self.img_size = img_size
        self.num_classes = num_classes
        self.raw_size = raw_size
        self.augment = augment

    def __len__(self):
        return self.length

    def get(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        g = np.random.default_rng(idx)
        image = g.random((self.img_size, self.img_size), np.float32)
        label = g.integers(0, self.num_classes,
                           (self.img_size, self.img_size)).astype(np.float32)
        if self.augment:
            image, label = augment_slice(image, label, rng)
            image, label = zoom_to(image, label, self.img_size)
        return {
            "image": normalize_image(image)[..., None],
            "label": label.astype(np.int32),
            "case_name": f"synthetic_{idx:05d}",
        }


class SynapseVolumeDataset:
    """Test volumes (dataset_synapse.py:114-118): {case}.npy.h5 with
    'image'/'label' (D, H, W). h5py is imported when a volume is read, so
    a machine without it fails there, not at import."""

    def __init__(self, base_dir: str, list_dir: str, split: str = "test_vol"):
        self.base_dir = base_dir
        self.samples = read_list(list_dir, split)

    def __len__(self):
        return len(self.samples)

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        import h5py
        name = self.samples[idx]
        path = os.path.join(self.base_dir, f"{name}.npy.h5")
        with h5py.File(path, "r") as f:
            image = np.asarray(f["image"][:], np.float32)
            label = np.asarray(f["label"][:], np.float32)
        return {"image": image, "label": label, "case_name": name}


class SyntheticVolumeDataset:
    """Deterministic random volumes (D varies per case like real Synapse):
    case idx draws from numpy's default_rng(1000 + idx), as the JAX
    package's does."""

    def __init__(self, length: int = 2, hw: int = 512, num_classes: int = 9):
        self.length = length
        self.hw = hw
        self.num_classes = num_classes

    def __len__(self):
        return self.length

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        g = np.random.default_rng(1000 + idx)
        d = int(g.integers(16, 24))
        image = g.random((d, self.hw, self.hw), np.float32)
        label = g.integers(0, self.num_classes,
                           (d, self.hw, self.hw)).astype(np.float32)
        return {"image": image, "label": label,
                "case_name": f"synthetic_vol_{idx}"}


def _refuse_isic(cfg) -> None:
    if cfg.dataset == "isic":
        raise NotImplementedError(
            "the ISIC dataset and its dice_eval are not ported yet "
            "(ROADMAP.md §1 item 5)")


def make_train_dataset(cfg):
    """DataConfig -> train slices: the synthetic slices for
    dataset="synthetic" or when cfg.root_path is not a directory (as the
    JAX package does), else the Synapse .npz slices of
    {cfg.list_dir}/train.txt under root_path. ISIC is not ported yet."""
    _refuse_isic(cfg)
    if cfg.dataset == "synthetic" or not os.path.isdir(cfg.root_path):
        return SyntheticSliceDataset(length=cfg.synthetic_len,
                                     img_size=cfg.img_size,
                                     num_classes=cfg.num_classes,
                                     augment=cfg.augment)
    return SynapseSliceDataset(cfg.root_path, cfg.list_dir,
                               img_size=cfg.img_size, augment=cfg.augment)


def make_test_dataset(cfg):
    """DataConfig -> test volumes: the synthetic set for
    dataset="synthetic" or when cfg.test_path is not a directory (as the
    JAX package does), else the Synapse .npy.h5 volumes of
    {cfg.list_dir}/test_vol.txt. ISIC is not ported yet."""
    _refuse_isic(cfg)
    if cfg.dataset == "synthetic" or not os.path.isdir(cfg.test_path):
        return SyntheticVolumeDataset(num_classes=cfg.num_classes)
    return SynapseVolumeDataset(cfg.test_path, cfg.list_dir)
