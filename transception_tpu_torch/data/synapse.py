"""Synapse test volumes (datasets/dataset_synapse.py:114-118 of the
reference), the volume half of transception_tpu/data/synapse.py.

Test split: {case}.npy.h5 whole volumes with 'image'/'label' (D, H, W).
SyntheticVolumeDataset gives deterministic random volumes of the same
layout, bit-identical to the JAX package's (same seeds), for machines
without the dataset. The slice datasets and make_train_dataset are not
ported yet (ROADMAP.md §1 item 3).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np


def read_list(list_dir: str, split: str) -> List[str]:
    """The case names of {list_dir}/{split}.txt, one per non-empty line."""
    path = os.path.join(list_dir, f"{split}.txt")
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


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


def make_test_dataset(cfg):
    """DataConfig -> test volumes: the synthetic set for
    dataset="synthetic" or when cfg.test_path is not a directory (as the
    JAX package does), else the Synapse .npy.h5 volumes of
    {cfg.list_dir}/test_vol.txt. ISIC is not ported yet."""
    if cfg.dataset == "isic":
        raise NotImplementedError(
            "the ISIC dataset and its dice_eval are not ported yet "
            "(ROADMAP.md §1 item 5)")
    if cfg.dataset == "synthetic" or not os.path.isdir(cfg.test_path):
        return SyntheticVolumeDataset(num_classes=cfg.num_classes)
    return SynapseVolumeDataset(cfg.test_path, cfg.list_dir)
