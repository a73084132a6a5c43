"""Host-side data loader: threaded decode and augment with a bounded
prefetch queue, the port's copy of transception_tpu/data/loader.py, and the
move of its batches to the model's device.

It replaces the reference's torch DataLoader (trainer.py:104-105, 4 forked
workers) with a thread pool that overlaps numpy augmentation with the
card's steps. The per-epoch order and each item's generator are the JAX
package's formulas, so the same dataset, seed and epoch give the same
batches bit for bit (tests/test_torch_loader.py). Under data parallelism
(parallel.mesh) each rank loads its contiguous 1/process_count of every
global batch, each item with the generator of its global position, so
the ranks' shards, concatenated, are the one-process batch.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Tuple

import numpy as np
import torch


class HostDataLoader:
    """Deterministic, seeded batch iterator.

    Each epoch re-shuffles with seed+epoch (the reference seeds workers with
    seed+worker_id, train_MSTransception.py:101-102; here determinism is
    exact across restarts). Item i of the epoch's order draws its
    augmentation from default_rng((seed·1000003 + epoch·131 + i) &
    0x7FFFFFFF). Process process_index of process_count loads rows
    [index·b/count, (index + 1)·b/count) of each global batch of b
    (loader.py:26-43, 94-97 of the JAX package). A producer thread fills a
    queue of at most `prefetch` batches from a pool of `num_workers`
    threads; breaking out of the iteration stops it.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 1234, num_workers: int = 4,
                 drop_last: bool = True, process_index: int = 0,
                 process_count: int = 1, prefetch: int = 2):
        assert batch_size % process_count == 0, (
            "global batch must divide across hosts")
        self.dataset = dataset
        self.global_batch = batch_size
        self.local_batch = batch_size // process_count
        self.process_index = process_index
        self.process_count = process_count
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.global_batch
        if not self.drop_last and len(self.dataset) % self.global_batch:
            n += 1
        return n

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        return order

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._epoch_order()
        n_batches = len(self)
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def load_item(global_idx: int, within: int):
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + self.epoch * 131 + global_idx)
                & 0x7FFFFFFF)
            return self.dataset.get(int(within), rng)

        def put_or_stop(item) -> bool:
            """Bounded put that gives up when the consumer went away: an
            early break (max_steps mid-epoch) would otherwise leave the
            producer blocked on a full queue forever."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in range(n_batches):
                    if stop.is_set():
                        return
                    start = b * self.global_batch
                    idxs = order[start:start + self.global_batch]
                    # This process's contiguous shard of the global batch.
                    lo = self.process_index * self.local_batch
                    idxs = idxs[lo:lo + self.local_batch]
                    futs = [pool.submit(load_item, start + lo + j, i)
                            for j, i in enumerate(idxs)]
                    items = [f.result() for f in futs]
                    batch = {
                        "image": np.stack([it["image"] for it in items]),
                        "label": np.stack([it["label"] for it in items]),
                        "case_name": [it["case_name"] for it in items],
                    }
                    if not put_or_stop(batch):
                        return
            finally:
                put_or_stop(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    break
                yield batch
        finally:
            stop.set()
            pool.shutdown(wait=False)


def to_device(batch: dict, device: torch.device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One loader batch as (images, labels) on `device`: the one-process
    counterpart of the JAX Trainer's assemble_global_batch
    (transception_tpu/train/trainer.py:63). Host arrays go through pinned
    memory with a non_blocking copy on the card (the host may then prepare
    the next batch while the copy runs); images (B, S, S, 1) fp32, labels
    (B, S, S) int64 as the loss takes them. Tensors already on the device
    (DeviceSyntheticStream's) pass through."""
    image, label = batch["image"], batch["label"]
    if isinstance(image, torch.Tensor):
        return image, label
    image, label = torch.from_numpy(image), torch.from_numpy(label)
    if device.type == "cuda":
        image = image.pin_memory().to(device, non_blocking=True)
        label = label.pin_memory().to(device, non_blocking=True)
    return image.to(device), label.to(device).long()
