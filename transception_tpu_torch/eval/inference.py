"""Slice-batched 3-D volume inference and per-class DSC/HD95, PyTorch port
of transception_tpu/eval/inference.py.

Eval protocol (utils.py:63-98 of the reference): order-3 spline zoom of
each slice to the patch size, (x − 0.5)/0.5, argmax per pixel, order-0
zoom of the class map back to native resolution, metrics over classes
1..K-1. Slices go to the card in fixed batch buckets (the last chunk
padded) and class maps come back as uint8; the card runs chunk i while
the host resamples chunk i+1 (CUDA launches are asynchronous).

Three predictor paths: the host spline (make_predictor, the protocol
default), the spline on the card as two products against exact operators
(make_predictor(device_resample=True)), and everything on the card but
the metrics (make_device_predictor). run_inference loops a volume dataset
with the next volume's load and the last volume's metrics on host threads.

Each takes mesh= (parallel.mesh.DataMesh, JAX's make_predictor(mesh=)):
every chunk of `batch` slices splits over the ranks, each rank forwards
its contiguous rows on its card, and the class maps are all-gathered, so
every rank holds the chunk's maps; run_inference leaves the back-resize,
the metrics, the NIfTI export and the logs to rank 0 and gives every rank
rank 0's means. Eval BatchNorm applies running statistics, so a slice's
map does not depend on which rank ran it.
"""

from __future__ import annotations

import inspect
import math
import time
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from scipy import ndimage

from transception_tpu_torch.core.device import DeviceLike, resolve_device
from transception_tpu_torch.eval.metrics import metric_per_case
from transception_tpu_torch.parallel.mesh import (
    DataMesh,
    broadcast_floats,
    gather_rows,
)


def resize_slices(vol: np.ndarray, size: int,
                  native: bool = True) -> np.ndarray:
    """Per-slice order-3 spline zoom of a (D, h, w) volume to (D, size,
    size) float32, scipy.ndimage.zoom's numerics: by the threaded native
    resampler (transception_tpu_torch/native, bit-identical to scipy; it
    raises if it cannot be built), or with native=False by scipy itself,
    one slice at a time."""
    d, h, w = vol.shape
    if h == size and w == size:
        return vol.astype(np.float32)
    if native:
        from transception_tpu_torch.native import zoom2d_batch
        return zoom2d_batch(vol, size, size, 3)
    return np.stack([ndimage.zoom(vol[i], (size / h, size / w), order=3)
                     for i in range(d)]).astype(np.float32)


@lru_cache(maxsize=16)
def _zoom_operator(n_in: int, n_out: int, order: int = 3) -> np.ndarray:
    """(n_out, n_in) float64 matrix P with P @ x == ndimage.zoom(x,
    n_out/n_in, order=order) for 1-D x (inference.py:52 of the JAX
    package).

    ndimage.zoom is linear in its input (B-spline prefilter and fixed
    per-coordinate interpolation weights) and 2-D zoom is separable, so
    the protocol's per-slice resample is exactly A_h @ img @ A_w.T. The
    operator is recovered from scipy itself by zooming the identity along
    one axis, so scipy's coordinate convention and constant-mode edges
    are captured exactly. Callers must not modify the cached array."""
    eye = np.eye(n_in, dtype=np.float64)
    op = ndimage.zoom(eye, (n_out / n_in, 1.0), order=order)
    assert op.shape == (n_out, n_in)
    return op


def _zoom0_index(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """The per-axis source-index map of scipy ndimage.zoom(order=0)
    (inference.py:75 of the JAX package): (index_map, valid_mask).

    Order-0 zoom is separable index selection; zooming a 1-based arange
    gives the indices it gathers. The 1-based offset tells scipy's edge
    artifact (coordinates epsilon outside the input are filled with
    cval=0 under mode='constant'; the reference's utils.py:84-87 inherits
    it) from a genuine index 0: where the zoomed arange is 0 the output is
    class 0, not a gathered value."""
    m = ndimage.zoom(np.arange(1, n_in + 1, dtype=np.int64), n_out / n_in,
                     order=0)
    return np.maximum(m - 1, 0), m > 0


def _resize_pred_back(pred: np.ndarray, h: int, w: int) -> np.ndarray:
    """Order-0 zoom of (D, ph, pw) class maps back to (D, h, w)
    (utils.py:84-87), bit-exact to scipy including its constant-fill edge
    artifact."""
    d, ph, pw = pred.shape
    if ph == h and pw == w:
        return pred
    ridx, rok = _zoom0_index(ph, h)
    cidx, cok = _zoom0_index(pw, w)
    out = pred[:, ridx[:, None], cidx[None, :]]
    if not (rok.all() and cok.all()):
        out = out * (rok[:, None] & cok[None, :])
    return out


def _operators(h: int, w: int, patch_size: int, dev: torch.device):
    """The spline operators (A_h, A_w) of native size (h, w) as float64
    tensors on `dev`."""
    return (torch.from_numpy(_zoom_operator(h, patch_size)).to(dev),
            torch.from_numpy(_zoom_operator(w, patch_size)).to(dev))


def _resample(x: torch.Tensor, a_h: torch.Tensor,
              a_w: torch.Tensor) -> torch.Tensor:
    """(b, h, w) raw slices -> (b, p, p) fp32 protocol resample, A_h @ x @
    A_w^T. The products run in float64 and round once to fp32: the global
    TF32 switches (torch.backends.cuda.matmul.allow_tf32,
    set_float32_matmul_precision) do not reach them, and the result is the
    host spline's to about one fp32 rounding (scipy also computes in
    float64)."""
    t = torch.matmul(a_h, x.double())
    return torch.matmul(t, a_w.T).float()


def _normalise(t: torch.Tensor) -> torch.Tensor:
    return (t - 0.5) / 0.5


def _shards(batch: int, device: DeviceLike, mesh: Optional[DataMesh]):
    """(device, this rank's rows of a chunk of `batch` slices, the
    all-gather of the ranks' outputs) for an optional mesh; the chunk must
    split evenly (the JAX package's error, inference.py:169-173)."""
    if mesh is None:
        return resolve_device(device), slice(0, batch), lambda t: t
    if batch % mesh.world:
        raise ValueError(
            f"eval batch {batch} not divisible by the mesh 'data' axis "
            f"({mesh.world}); pick a multiple so chunks shard evenly")
    return (mesh.device, mesh.rows(batch),
            lambda t: gather_rows(t, mesh))


class _Clock:
    """Wall seconds per part of predict_volume, for run_inference's
    per-volume split."""

    def __init__(self):
        self.seconds = {"resample": 0.0, "forward": 0.0}
        self._t = time.perf_counter()

    def lap(self, part: str) -> None:
        now = time.perf_counter()
        self.seconds[part] += now - self._t
        self._t = now


def class_ids(model, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 class ids of the (B, H, W, 1) slices x: the model's
    fused argmax where it has one (MSTransception's argmax=True), else the
    argmax of its fp32 logits (the legacy models), as the JAX predictors
    (inference.py:178-189, 326-354)."""
    if "argmax" in inspect.signature(model.forward).parameters:
        return model(x, argmax=True)
    return model(x).argmax(-1).to(torch.uint8)


def make_predictor(model, patch_size: int = 224, batch: int = 32,
                   device: DeviceLike = "cuda",
                   device_resample: bool = False,
                   mesh: Optional[DataMesh] = None):
    """Returns predict((D, patch, patch) normalised float32) -> (D, patch,
    patch) uint8, with predict.predict_volume((D, h, w) raw volume in
    [0, 1]) -> (D, patch, patch) uint8. The model runs with argmax=True
    in chunks of `batch` slices (JAX make_predictor, inference.py:119).

    predict_volume resamples on the host (resize_slices, the protocol's
    numerics) by default. device_resample=True ships the raw fp32 slices
    and resamples on the card (inference.py:230-262 of the JAX package):
    the two products against _zoom_operator in float64 (_resample), the
    operators cached per native (h, w). Slices already at the patch size
    skip the resample on either path.
    predict_volume.seconds holds the wall seconds of its last call spent
    resampling on the host and in the forwards (enqueue and the wait for
    the card). mesh: each rank resamples and forwards its rows of every
    chunk (the module docstring); the results are the whole volume's on
    every rank."""
    dev, rows, gather = _shards(batch, device, mesh)
    model = model.to(dev).eval()
    ops = {}
    nb = rows.stop - rows.start

    def fwd(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return gather(class_ids(model, x[..., None]))

    def _pad(sl: np.ndarray, n: int = batch) -> np.ndarray:
        pad = n - sl.shape[0]
        return np.pad(sl, ((0, pad), (0, 0), (0, 0))) if pad else sl

    def _to_dev(sl: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(sl)).to(dev)

    def _gather(outs, d: int) -> np.ndarray:
        return torch.cat(outs).cpu().numpy()[:d]

    def predict(slices: np.ndarray) -> np.ndarray:
        d = slices.shape[0]
        outs = [fwd(_to_dev(_pad(slices[c * batch:(c + 1) * batch]
                                 .astype(np.float32))[rows]))
                for c in range(math.ceil(d / batch))]
        return _gather(outs, d)

    def _host_rows(chunk: np.ndarray) -> np.ndarray:
        """This rank's rows of the padded, resampled, normalised chunk:
        only its own slices are resampled (the spline is per slice)."""
        mine = chunk[rows]
        if not mine.shape[0]:
            return np.zeros((nb, patch_size, patch_size), np.float32)
        return _pad(_normalise(resize_slices(mine, patch_size)), nb)

    def _raw_forward(chunk: np.ndarray, h: int, w: int) -> torch.Tensor:
        if (h, w) not in ops:
            ops[(h, w)] = _operators(h, w, patch_size, dev)
        x = _to_dev(chunk.astype(np.float32))
        with torch.inference_mode():
            return fwd(_normalise(_resample(x, *ops[(h, w)])))

    def predict_volume(vol: np.ndarray) -> np.ndarray:
        d, h, w = vol.shape
        clock = _Clock()
        outs = []
        raw = device_resample and (h, w) != (patch_size, patch_size)
        for c in range(math.ceil(d / batch)):
            chunk = vol[c * batch:(c + 1) * batch]
            if raw:
                outs.append(_raw_forward(_pad(chunk)[rows], h, w))
            else:
                sl = _host_rows(chunk)
                clock.lap("resample")
                outs.append(fwd(_to_dev(sl)))
            clock.lap("forward")
        out = _gather(outs, d)
        clock.lap("forward")
        predict_volume.seconds = clock.seconds
        return out

    predict_volume.seconds = {}
    predict.predict_volume = predict_volume
    return predict


def make_device_predictor(model, patch_size: int = 224, batch: int = 32,
                          device: DeviceLike = "cuda",
                          mesh: Optional[DataMesh] = None):
    """Serving-path predictor (JAX make_device_predictor,
    inference.py:315-374): resize, normalise, forward, argmax and the
    order-0 back-resize all on the card. The spline in is _resample (float64
    products against _zoom_operator), the class maps back are gathered
    through _zoom0_index's row and column indices with its validity mask
    multiplied in (bit-exact to the host's _resize_pred_back). One
    operator set is cached per native (h, w). Returns predict((D, h, w)
    raw volume in [0, 1]) -> (D, h, w) uint8; the host sees raw slices in
    and class maps out. mesh: each rank runs its rows of every chunk, the
    maps are all-gathered."""
    dev, rows, gather = _shards(batch, device, mesh)
    model = model.to(dev).eval()
    cache = {}

    def _ops_for(h: int, w: int):
        if (h, w) not in cache:
            ridx, rok = _zoom0_index(patch_size, h)
            cidx, cok = _zoom0_index(patch_size, w)
            ok = None
            if not (rok.all() and cok.all()):
                ok = torch.from_numpy(
                    (rok[:, None] & cok[None, :]).astype(np.uint8)).to(dev)
            cache[(h, w)] = (_operators(h, w, patch_size, dev),
                             torch.from_numpy(ridx).to(dev),
                             torch.from_numpy(cidx).to(dev), ok)
        return cache[(h, w)]

    def fwd(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        (a_h, a_w), ridx, cidx, ok = _ops_for(h, w)
        with torch.inference_mode():
            if (h, w) == (patch_size, patch_size):
                return class_ids(model, _normalise(x)[..., None])
            pred = class_ids(model,
                             _normalise(_resample(x, a_h, a_w))[..., None])
            pred = pred.index_select(1, ridx).index_select(2, cidx)
            return pred * ok if ok is not None else pred

    def predict(vol: np.ndarray) -> np.ndarray:
        d, h, w = vol.shape
        n_chunks = math.ceil(d / batch)
        x = np.pad(np.asarray(vol, np.float32),
                   ((0, n_chunks * batch - d), (0, 0), (0, 0)))
        outs = [gather(fwd(torch.from_numpy(
                    x[c * batch:(c + 1) * batch][rows]).to(dev), h, w))
                for c in range(n_chunks)]
        return torch.cat(outs).cpu().numpy()[:d]

    return predict


def test_single_volume(image: np.ndarray, label: np.ndarray, predict,
                       classes: int, patch_size: int = 224,
                       spacing=None, return_prediction: bool = False):
    """Volume eval matching utils.py:63-98, slice-batched (JAX
    test_single_volume, inference.py:377): [(dice, hd95)] for classes
    1..classes-1, and with return_prediction the full-resolution class
    maps too. spacing: optional (z, 1, 1)-style voxel spacing for hd95
    (the published protocol uses None)."""
    image = np.asarray(image, np.float32)
    label = np.asarray(label)
    d, h, w = image.shape
    pv = getattr(predict, "predict_volume", None)
    if pv is not None:
        pred_patch = pv(image)
    else:
        pred_patch = predict(_normalise(resize_slices(image, patch_size)))
    prediction = _resize_pred_back(pred_patch, h, w)
    metrics = [metric_per_case(prediction == i, label == i, spacing)
               for i in range(1, classes)]
    if return_prediction:
        return metrics, prediction
    return metrics


def run_inference(model, volume_dataset, classes: int,
                  patch_size: int = 224, batch: int = 32,
                  log: Optional[Callable[[str], None]] = print,
                  save_path: Optional[str] = None, z_spacing: float = 1.0,
                  hd95_spacing=None, device_resample: bool = False,
                  device: DeviceLike = "cuda",
                  stats: Optional[List[dict]] = None,
                  mesh: Optional[DataMesh] = None):
    """Loop the test volumes, accumulate the per-case metric matrix and
    log per-class means (JAX run_inference, inference.py:404-499; the
    reference's test.py:104-123). Returns (mean dice, mean hd95).

    save_path: when set, writes {case}_img/_pred/_gt.nii.gz per case with
    spacing (1, 1, z_spacing) like the reference (utils.py:100-109).
    hd95_spacing: optional (z, 1, 1) voxel spacing for hd95 in mm (the
    published protocol uses None). device_resample: the spline on the card
    (make_predictor). stats: when given, one dict per volume is appended
    with its wall seconds on the calling thread (waiting for its load, the
    host resample, the forwards: enqueue and the wait for the card, the
    back-resize, the NIfTI export, the wait for earlier volumes' metrics)
    and the seconds its metrics took on the metric thread.

    The next volume's load runs on a one-thread pool while the card runs
    the current one, and volume i's metrics (per-class EDTs on the host)
    run on a one-thread metric pool while the card predicts volume i+1.
    Neither thread touches a CUDA tensor: the metrics get numpy class maps
    and every launch stays on the calling thread. The per-case log lines
    stay in case order.

    mesh: every rank loads each volume and forwards its rows of each chunk
    (make_predictor); the data axis's rank 0 alone resizes back and
    scores, and every rank of its data group returns its means. Of those,
    rank (0, 0) of the (data, model) mesh alone exports, logs and fills
    `stats` (under tensor parallelism each model rank's data group scores
    the same volumes)."""
    predict = make_predictor(model, patch_size, batch, device=device,
                             device_resample=device_resample, mesh=mesh)
    main = mesh is None or mesh.rank == 0
    if not (main and (mesh is None or mesh.is_main)):
        log, save_path, stats = None, None, None
    metric_sum = np.zeros((classes - 1, 2), np.float64)
    n = len(volume_dataset)
    if log:  # test.py:107
        log(f"{n} test iterations per epoch")

    def metrics_of(prediction, label):
        t0 = time.perf_counter()
        m = np.asarray([metric_per_case(prediction == c, label == c,
                                        hd95_spacing)
                        for c in range(1, classes)])
        return m, time.perf_counter() - t0

    pending: List[Tuple[int, str, object]] = []
    split: List[dict] = []  # per volume, for `stats`

    def drain(upto: int):
        nonlocal metric_sum
        while len(pending) > upto:
            i, case, fut = pending.pop(0)
            m, split[i]["metrics"] = fut.result()
            metric_sum += m
            if log:
                log(f"idx {i} case {case} mean_dice {m[:, 0].mean():.6f} "
                    f"mean_hd95 {m[:, 1].mean():.6f}")

    with ThreadPoolExecutor(max_workers=1) as pool, \
            ThreadPoolExecutor(max_workers=1) as metric_pool:
        next_fut = pool.submit(volume_dataset.get, 0) if n else None
        for i in range(n):
            t0 = time.perf_counter()
            sample = next_fut.result()
            next_fut = (pool.submit(volume_dataset.get, i + 1)
                        if i + 1 < n else None)
            image = np.asarray(sample["image"], np.float32)
            label = np.asarray(sample["label"])
            h, w = image.shape[1:]
            t1 = time.perf_counter()
            pred_patch = predict.predict_volume(image)
            if not main:
                continue
            t2 = time.perf_counter()
            prediction = _resize_pred_back(pred_patch, h, w)
            t3 = time.perf_counter()
            if save_path is not None:
                from transception_tpu_torch.eval.nifti import save_nifti
                case = sample["case_name"]
                sp = (1.0, 1.0, float(z_spacing))
                save_nifti(f"{save_path}/{case}_pred.nii.gz",
                           np.asarray(prediction, np.float32), sp)
                save_nifti(f"{save_path}/{case}_img.nii.gz", image, sp)
                save_nifti(f"{save_path}/{case}_gt.nii.gz",
                           np.asarray(label, np.float32), sp)
            t4 = time.perf_counter()
            sec = predict.predict_volume.seconds
            split.append({"load": t1 - t0, "resample": sec["resample"],
                          "forward": t2 - t1 - sec["resample"],
                          "back_resize": t3 - t2, "save": t4 - t3})
            pending.append((i, sample["case_name"],
                            metric_pool.submit(metrics_of, prediction,
                                               label)))
            drain(1)  # resolve all but the in-flight case, in order
            split[i]["metrics_wait"] = time.perf_counter() - t4
        t0 = time.perf_counter()
        drain(0)
        if split:
            split[-1]["metrics_wait"] += time.perf_counter() - t0
    if stats is not None:
        stats.extend(split)
    metric_mean = metric_sum / max(n, 1)
    if log:
        for c in range(1, classes):
            log(f"Mean class {c} mean_dice {metric_mean[c - 1, 0]:.6f} "
                f"mean_hd95 {metric_mean[c - 1, 1]:.6f}")
    performance, mean_hd95 = broadcast_floats(
        [metric_mean[:, 0].mean(), metric_mean[:, 1].mean()], mesh)
    if log:
        # Byte-identical to test.py:122 ('%f' == ':.6f') and to the JAX
        # package's line.
        log(f"Testing performance in best val model: mean_dice : "
            f"{performance:.6f} mean_hd95 : {mean_hd95:.6f}")
    return float(performance), float(mean_hd95)
