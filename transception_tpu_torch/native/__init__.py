"""Native (C) host resampler of the port, loaded via ctypes.

A copy of transception_tpu/native (resample.c and its loader): a threaded
order-0/order-3 spline zoom of a stack of slices, bit-identical to
scipy.ndimage.zoom. Built with the system C compiler at first use into
transception_tpu_torch/build/ (git-ignored), keyed by a hash of the source
and flags, never next to the source. A failed build or load raises with
the compiler's or the loader's message; the scipy path is a separate,
explicit choice of the caller (eval.inference.resize_slices(native=False)).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "resample.c"
_BUILD = _HERE.parent / "build"
_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-pthread")
_lock = threading.Lock()
_lib = None


def _so_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD / f"libresample-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cc = next((c for c in ("cc", "gcc", "clang") if shutil.which(c)), None)
    if cc is None:
        raise RuntimeError("no C compiler (cc, gcc, clang) on PATH to build "
                           f"{_SRC}")
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([cc, *_FLAGS, str(_SRC), "-o", str(tmp), "-lm"],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"building {_SRC} with {cc} failed "
                           f"(rc {r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The native library, built at first use; raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            so = _so_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            lib.zoom2d_batch_f32.restype = ctypes.c_int
            lib.zoom2d_batch_f32.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ]
            _lib = lib
        return _lib


def zoom2d_batch(vol: np.ndarray, out_h: int, out_w: int, order: int,
                 threads: int = 0) -> np.ndarray:
    """(D, H, W) float32 -> (D, out_h, out_w) float32 with scipy zoom
    semantics (order 0 or 3), one thread per slice group (threads=0: one
    per CPU core, at most 16)."""
    if order not in (0, 3):
        raise ValueError(f"order {order}: the native zoom has orders 0 and 3")
    lib = get_lib()
    vol = np.ascontiguousarray(vol, np.float32)
    d, h, w = vol.shape
    out = np.empty((d, out_h, out_w), np.float32)
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    rc = lib.zoom2d_batch_f32(
        vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), d, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_h, out_w,
        order, threads)
    if rc != 0:
        raise RuntimeError(f"zoom2d_batch_f32 failed (rc {rc}) on "
                           f"{vol.shape} -> ({out_h}, {out_w})")
    return out
