"""Synthetic training batches made on the device, PyTorch port of
transception_tpu/data/device_synthetic.py.

No host-to-device traffic per step: each batch is drawn on the device from
a torch.Generator seeded by (seed, epoch · len + step), so the stream is a
pure function of those and a run resumed at an epoch boundary replays it.
Images are U[0, 1) of shape (B, S, S, 1) fp32 and labels uniform over the
classes, (B, S, S) int64. The bits differ from jax.random's; shapes, dtypes
and determinism are the contract. The loader protocol (len, set_epoch,
iteration over dict batches) is the host loader's. Under data parallelism
each rank draws the global batch from the shared seed and keeps its
contiguous rows, so the ranks together see the one-process stream.
"""

from __future__ import annotations

from typing import Dict, Iterator

import torch

from transception_tpu_torch.core.device import DeviceLike, resolve_device


class DeviceSyntheticStream:
    def __init__(self, batch_size: int, img_size: int, num_classes: int,
                 length: int = 2211, seed: int = 1234,
                 device: DeviceLike = "cuda", process_index: int = 0,
                 process_count: int = 1):
        assert batch_size % process_count == 0, (
            "global batch must divide across hosts")
        self.batch_size, self.img_size = batch_size, img_size
        b = batch_size // process_count
        self.rows = slice(process_index * b, (process_index + 1) * b)
        self.num_classes, self.length, self.seed = num_classes, length, seed
        self.device = resolve_device(device)
        self.epoch = 0

    def __len__(self) -> int:
        return self.length // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """This process's rows of the global batch at stream position
        `step`."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed << 32) + step)
        B, S = self.batch_size, self.img_size
        image = torch.rand((B, S, S, 1), generator=gen, device=self.device)
        label = torch.randint(0, self.num_classes, (B, S, S), generator=gen,
                              device=self.device)
        return {"image": image[self.rows], "label": label[self.rows]}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        base = self.epoch * len(self)
        for b in range(len(self)):
            yield self.batch(base + b)
