"""Minimal pure-numpy NIfTI-1 (.nii / .nii.gz) writer + reader.

A copy of transception_tpu/eval/nifti.py for the PyTorch port: the same
bytes for the same volume and spacing (the header's description field
included), held equal by tests/test_torch_volume_eval.py.

The reference exports eval volumes with SimpleITK (utils.py:100-109:
GetImageFromArray on the (D, H, W) numpy volume, SetSpacing((1, 1,
z_spacing)), WriteImage as .nii.gz). SimpleITK is not a dependency, and
NIfTI-1 is a fixed 348-byte little-endian header + raw voxels, so this
module writes the format directly — no dependency needed. Output is
byte-level standard NIfTI-1 ('n+1' magic, sform affine carrying the
spacing) and loads in nibabel / ITK / 3D Slicer.

Array convention matches SimpleITK's GetImageFromArray: a (D, H, W) numpy
volume maps to NIfTI dims (nx=W, ny=H, nz=D) with the C-order bytes of the
array being exactly the x-fastest Fortran order NIfTI stores.
"""

from __future__ import annotations

import gzip
import struct
from typing import Tuple

import numpy as np

_DTYPES = {
    np.dtype(np.uint8): (2, 8),
    np.dtype(np.int16): (4, 16),
    np.dtype(np.int32): (8, 32),
    np.dtype(np.float32): (16, 32),
    np.dtype(np.float64): (64, 64),
}
_CODE_TO_DTYPE = {code: dt for dt, (code, _) in _DTYPES.items()}


def _build_header(shape_dhw: Tuple[int, ...], dtype: np.dtype,
                  spacing: Tuple[float, float, float]) -> bytes:
    """348-byte NIfTI-1 header for a (D, H, W) volume; spacing is
    (sx, sy, sz) like SimpleITK SetSpacing."""
    d, h, w = shape_dhw
    code, bitpix = _DTYPES[np.dtype(dtype)]
    sx, sy, sz = (float(s) for s in spacing)

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)                     # sizeof_hdr
    struct.pack_into("<8h", hdr, 40, 3, w, h, d, 1, 1, 1, 1)  # dim
    struct.pack_into("<h", hdr, 70, code)                   # datatype
    struct.pack_into("<h", hdr, 72, bitpix)                 # bitpix
    struct.pack_into("<8f", hdr, 76, 1.0, sx, sy, sz, 0, 0, 0, 0)  # pixdim
    struct.pack_into("<f", hdr, 108, 352.0)                 # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)                   # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)                   # scl_inter
    hdr[123] = 2                                            # xyzt_units: mm
    descrip = b"transception_tpu"
    hdr[148:148 + len(descrip)] = descrip
    struct.pack_into("<h", hdr, 252, 0)                     # qform_code
    struct.pack_into("<h", hdr, 254, 1)                     # sform_code
    struct.pack_into("<4f", hdr, 280, sx, 0, 0, 0)          # srow_x
    struct.pack_into("<4f", hdr, 296, 0, sy, 0, 0)          # srow_y
    struct.pack_into("<4f", hdr, 312, 0, 0, sz, 0)          # srow_z
    hdr[344:348] = b"n+1\x00"                               # magic
    return bytes(hdr)


def save_nifti(path: str, volume: np.ndarray,
               spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)) -> None:
    """Write a (D, H, W) volume as .nii or .nii.gz (by extension).

    Mirrors the reference export (utils.py:100-109): spacing is the
    SimpleITK (sx, sy, sz) triple — pass (1, 1, z_spacing)."""
    volume = np.ascontiguousarray(volume)
    if volume.dtype not in _DTYPES:
        volume = volume.astype(np.float32)
    if volume.ndim != 3:
        raise ValueError(f"expected a (D, H, W) volume, got {volume.shape}")
    payload = (_build_header(volume.shape, volume.dtype, spacing)
               + b"\x00\x00\x00\x00"  # no header extensions
               + volume.tobytes())
    if path.endswith(".gz"):
        # mtime=0 + empty embedded filename keep output byte-reproducible.
        with open(path, "wb") as f:
            with gzip.GzipFile(filename="", fileobj=f, mode="wb",
                               mtime=0) as gz:
                gz.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)


def load_nifti(path: str) -> Tuple[np.ndarray, Tuple[float, float, float]]:
    """Read a (single-file, little-endian) NIfTI-1 volume written by
    save_nifti or any standard tool; returns ((D, H, W) array,
    (sx, sy, sz) spacing)."""
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            blob = f.read()
    else:
        with open(path, "rb") as f:
            blob = f.read()
    if struct.unpack_from("<i", blob, 0)[0] != 348:
        raise ValueError("not a little-endian NIfTI-1 file")
    dim = struct.unpack_from("<8h", blob, 40)
    ndim, w, h, d = dim[0], dim[1], dim[2], dim[3]
    if ndim != 3:
        raise ValueError(f"expected a 3-D volume, got ndim={ndim}")
    code = struct.unpack_from("<h", blob, 70)[0]
    if code not in _CODE_TO_DTYPE:
        raise ValueError(f"unsupported NIfTI datatype code {code}")
    dtype = _CODE_TO_DTYPE[code]
    pixdim = struct.unpack_from("<8f", blob, 76)
    vox_offset = int(struct.unpack_from("<f", blob, 108)[0])
    n = d * h * w
    arr = np.frombuffer(blob, dtype, count=n, offset=vox_offset)
    return arr.reshape(d, h, w).copy(), (pixdim[1], pixdim[2], pixdim[3])
