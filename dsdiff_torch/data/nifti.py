"""Minimal NIfTI-1 reader/writer (pure numpy, .nii / .nii.gz).

The port's own copy of the JAX package's ``data/nifti.py``.

The reference does all volume I/O through SimpleITK
(preprocess/resample.py, trainers/trainer_ds_diff.py:825-875 slice->volume
assembly, inference/get_metric.py). SimpleITK is not available in this
environment, and the framework only needs the NIfTI-1 subset the pipeline
actually touches: 3D scalar volumes, pixdim spacing, the sform/qform affine,
scl slope/inter scaling. This module implements exactly that against the
nifti1.h layout (348-byte header + vox_offset data).

``Nifti.like`` reproduces the CopyInformation contract: write a prediction
volume on a template's grid (trainer_use_gaussian_diff.py:632-655).
"""
from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Nifti", "read_nifti", "write_nifti"]

_HDR_SIZE = 348
_MAGIC = (b"n+1\x00", b"ni1\x00")

# nifti datatype codes -> numpy dtypes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class Nifti:
    """A loaded NIfTI volume: ``data`` is [x, y, z] (fortran axis order kept),
    ``affine`` maps voxel indices to world mm."""

    data: np.ndarray
    affine: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float64)
    )

    @property
    def spacing(self) -> tuple:
        return tuple(np.linalg.norm(self.affine[:3, i]) for i in range(3))

    @property
    def shape(self) -> tuple:
        return self.data.shape

    @classmethod
    def like(cls, data: np.ndarray, template: "Nifti") -> "Nifti":
        """New volume on the template's grid (SimpleITK CopyInformation)."""
        assert data.shape == template.data.shape, (
            f"{data.shape} vs template {template.data.shape}"
        )
        return cls(data, template.affine.copy())

    def save(self, path):
        write_nifti(path, self)


def _open(path, mode="rb"):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path) -> Nifti:
    with _open(path) as f:
        hdr = f.read(_HDR_SIZE)
        if len(hdr) < _HDR_SIZE:
            raise ValueError(f"{path}: truncated NIfTI header")
        sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
        endian = "<"
        if sizeof_hdr != _HDR_SIZE:
            endian = ">"
            if struct.unpack(">i", hdr[0:4])[0] != _HDR_SIZE:
                raise ValueError(f"{path}: not a NIfTI-1 file")
        magic = hdr[344:348]
        if magic not in _MAGIC:
            raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

        dim = struct.unpack(endian + "8h", hdr[40:56])
        ndim = dim[0]
        shape = tuple(int(d) for d in dim[1 : 1 + max(ndim, 1)])
        datatype = struct.unpack(endian + "h", hdr[70:72])[0]
        if datatype not in _DTYPES:
            raise ValueError(f"{path}: unsupported datatype {datatype}")
        dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
        pixdim = struct.unpack(endian + "8f", hdr[76:108])
        vox_offset = struct.unpack(endian + "f", hdr[108:112])[0]
        scl_slope = struct.unpack(endian + "f", hdr[112:116])[0]
        scl_inter = struct.unpack(endian + "f", hdr[116:120])[0]
        sform_code = struct.unpack(endian + "h", hdr[254:256])[0]
        srow = np.array(
            struct.unpack(endian + "12f", hdr[280:328]), dtype=np.float64
        ).reshape(3, 4)

        f.seek(int(vox_offset))
        count = int(np.prod(shape))
        raw = f.read(count * dtype.itemsize)
        data = np.frombuffer(raw, dtype=dtype, count=count)
        # NIfTI data is fortran-ordered (x fastest)
        data = data.reshape(shape[::-1]).transpose(range(len(shape))[::-1])

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter

    affine = np.eye(4, dtype=np.float64)
    if sform_code > 0:
        affine[:3, :] = srow
    else:
        # fall back to pixdim spacing on the identity orientation
        for i in range(min(3, len(shape))):
            affine[i, i] = pixdim[i + 1] if pixdim[i + 1] != 0 else 1.0
    return Nifti(np.ascontiguousarray(data), affine)


def write_nifti(path, vol: Nifti):
    data = np.asarray(vol.data)
    if data.dtype not in _CODES:
        data = data.astype(np.float32)
    code = _CODES[np.dtype(data.dtype)]
    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    spacing = list(vol.spacing) + [1.0] * (3 - min(3, ndim))
    pixdim = [1.0] + spacing[:3] + [0.0, 0.0, 0.0, 0.0]

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    hdr[39] = ord("r")  # dim_info unused; regular
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 1)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<12f", hdr, 280, *vol.affine[:3, :].reshape(-1))
    hdr[344:348] = b"n+1\x00"

    # fortran byte order on disk
    body = np.asfortranarray(data).tobytes(order="F")
    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # extension flag
        f.write(body)
