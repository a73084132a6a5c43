"""Segmentation losses: 0.4·CE + 0.6·soft-Dice, PyTorch port of
transception_tpu/train/losses.py (reference trainer.py:141-143,
utils.py:24-47). All accumulation in fp32; Dice is per class over the
whole batch, classes include the background, smooth 1e-5.

Under data parallelism (parallel.mesh.data_parallel) segmentation_loss
takes the Dice over the global batch: the per-class sums are summed over
the ranks before the ratio (global_sum, differentiable). The CE stays
each rank's mean over its own pixels: the ranks' shards are equal, so
DistributedDataParallel's gradient mean of those is the global CE's
gradient, and each rank's Dice gradient, the sum of the R ranks' copies,
comes back to one copy in the same mean.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from transception_tpu_torch.parallel.mesh import global_sum


def _one_hot(labels: torch.Tensor, k: int) -> torch.Tensor:
    return F.one_hot(labels.long(), k).float()


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over all pixels; logits (..., K), labels (...) int, as
    −Σ one_hot · log_softmax."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(_one_hot(labels, logp.shape[-1]) * logp).sum(-1).mean()


def dice_loss(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
              weight: Optional[Sequence[float]] = None,
              apply_softmax: bool = True,
              smooth: float = 1e-5) -> torch.Tensor:
    """Soft Dice per class over the whole batch, averaged over classes."""
    p = logits.float()
    if apply_softmax:
        p = torch.softmax(p, dim=-1)
    onehot = _one_hot(labels, num_classes)
    axes = tuple(range(p.dim() - 1))
    intersect = (p * onehot).sum(axes)
    z = (p * p).sum(axes)
    y = onehot.sum(axes)
    per_class = 1.0 - (2.0 * intersect + smooth) / (z + y + smooth)
    if weight is not None:
        per_class = per_class * torch.as_tensor(weight, dtype=torch.float32,
                                                device=p.device)
    return per_class.mean()


def shuffle_labels_wide(labels: torch.Tensor, p: int = 4) -> torch.Tensor:
    """(B, H, W) labels into the wide-head token order (B, (H/p)·(W/p),
    p²): wide entry (n, q), n = h·(W/p) + w, q = p1·p + p2, is pixel
    (h·p + p1, w·p + p2), the inverse of the final pixel shuffle."""
    B, H, W = labels.shape
    h, w = H // p, W // p
    return labels.reshape(B, h, p, w, p).permute(0, 1, 3, 2, 4) \
        .reshape(B, h * w, p * p)


def segmentation_loss(logits: torch.Tensor, labels: torch.Tensor,
                      num_classes: int, ce_weight: float = 0.4,
                      dice_weight: float = 0.6):
    """(total, ce, dice), one fp32 log-softmax and one one-hot shared by
    both terms (softmax = exp(log_softmax)); the Dice over the global
    batch under data parallelism, the CE this rank's mean."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    onehot = _one_hot(labels, num_classes)
    ce = -(onehot * logp).sum(-1).mean()
    p = torch.exp(logp)
    axes = tuple(range(p.dim() - 1))
    intersect, z, y = global_sum(torch.cat([
        (p * onehot).sum(axes), (p * p).sum(axes), onehot.sum(axes)])
    ).split(num_classes)
    dc = (1.0 - (2.0 * intersect + 1e-5) / (z + y + 1e-5)).mean()
    return ce_weight * ce + dice_weight * dc, ce, dc
