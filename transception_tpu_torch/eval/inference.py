"""Slice-batched 3-D volume inference, PyTorch port of
transception_tpu/eval/inference.py:29-48,108-312 (host spline path).

Eval protocol (utils.py:70-98 of the reference): order-3 spline zoom of
each slice to the patch size, (x − 0.5)/0.5, argmax per pixel. Slices go
to the card in fixed batch buckets (the last chunk padded) and class maps
come back as uint8, once per volume; the card runs chunk i while the host
resamples chunk i+1 (CUDA launches are asynchronous).
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from scipy import ndimage

from transception_tpu_torch.core.device import DeviceLike, resolve_device


def resize_slices(vol: np.ndarray, size: int) -> np.ndarray:
    """Per-slice order-3 spline zoom of a (D, h, w) volume to (D, size,
    size) float32 (scipy.ndimage.zoom, the reference numerics), one thread
    per CPU core."""
    d, h, w = vol.shape
    if h == size and w == size:
        return vol.astype(np.float32)

    def one(i):
        return ndimage.zoom(vol[i], (size / h, size / w), order=3)

    with ThreadPoolExecutor(max_workers=os.cpu_count()) as ex:
        out = list(ex.map(one, range(d)))
    return np.stack(out).astype(np.float32)


def make_predictor(model, patch_size: int = 224, batch: int = 32,
                   device: DeviceLike = "cuda"):
    """Returns predict((D, patch, patch) normalised float32) -> (D, patch,
    patch) uint8, with predict.predict_volume((D, h, w) raw volume in
    [0, 1]) -> (D, patch, patch) uint8 running the protocol resample on the
    host. The model runs with argmax=True in chunks of `batch` slices."""
    dev = resolve_device(device)
    model = model.to(dev).eval()

    def fwd(sl: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(sl, np.float32))
        with torch.inference_mode():
            return model(x.to(dev)[..., None],
                         argmax=True)

    def _pad(sl: np.ndarray) -> np.ndarray:
        pad = batch - sl.shape[0]
        return np.pad(sl, ((0, pad), (0, 0), (0, 0))) if pad else sl

    def _gather(outs, d: int) -> np.ndarray:
        return torch.cat(outs).cpu().numpy()[:d]

    def predict(slices: np.ndarray) -> np.ndarray:
        d = slices.shape[0]
        outs = [fwd(_pad(slices[c * batch:(c + 1) * batch]))
                for c in range(math.ceil(d / batch))]
        return _gather(outs, d)

    def predict_volume(vol: np.ndarray) -> np.ndarray:
        d = vol.shape[0]
        outs = []
        for c in range(math.ceil(d / batch)):
            sl = resize_slices(vol[c * batch:(c + 1) * batch], patch_size)
            outs.append(fwd(_pad((sl - 0.5) / 0.5)))
        return _gather(outs, d)

    predict.predict_volume = predict_volume
    return predict
