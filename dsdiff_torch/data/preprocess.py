"""Offline NIfTI preprocessing: resample, normalize, crop, split, H5 export.

Port of the JAX package's ``data/preprocess.py``, a copy over the port's
``h5store``, ``nifti`` and ``transforms``: the reference's preprocess/ chain
without SimpleITK (scipy + the ``data.nifti`` codec). ``h5py`` is imported
by ``h5store.write_slice`` only, when a slice is written.

- ``resample_inplane``  == preprocess/resample.py:10-83 — per-patient
  256x256 in-plane physical-grid resample, linear for images / nearest for
  masks, slice count unchanged.
- ``normalize_volume``  == preprocess/normalization.py:27-86 — clip at
  0.75*max then min-max to [-1,1], or z-score.
- ``crop_brats``        == preprocess/preprocess_nii.py:36-139 — crop to
  the segmentation's nonzero z-range and a centered in-plane square, then
  min-max to [-1,1].
- ``volume_to_h5``      == preprocess/to_h5.py:17-51 — per-slice
  layer_<i>.h5 export with one dataset per sequence key.
- ``preprocess_dataset`` wires them per case and records the 70/30 split
  (spilt_train_test.py:79-135).
"""
from __future__ import annotations

from pathlib import Path
from typing import Mapping, Sequence

import numpy as np
from scipy import ndimage

from . import h5store
from .nifti import Nifti, read_nifti
from .transforms import normalize_minmax, normalize_zscore

__all__ = [
    "resample_inplane",
    "normalize_volume",
    "crop_brats",
    "volume_to_h5",
    "preprocess_dataset",
]


def resample_inplane(
    vol: Nifti, target: int = 256, is_mask: bool = False
) -> Nifti:
    """Resample each axial slice onto a target x target in-plane grid that
    spans the same physical extent; z is untouched."""
    data = vol.data
    x, y = data.shape[0], data.shape[1]
    zoom = (target / x, target / y) + (1.0,) * (data.ndim - 2)
    order = 0 if is_mask else 1
    out = ndimage.zoom(data.astype(np.float32), zoom, order=order,
                       mode="nearest", grid_mode=True)
    # fix rounding: force exact target shape
    out = out[:target, :target]
    affine = vol.affine.copy()
    affine[:3, 0] *= x / target
    affine[:3, 1] *= y / target
    return Nifti(out.astype(data.dtype if is_mask else np.float32), affine)


def normalize_volume(vol: np.ndarray, mode: str = "minmax") -> np.ndarray:
    if mode == "minmax":
        return normalize_minmax(vol)
    if mode == "zscore":
        return normalize_zscore(vol)
    raise ValueError(f"unknown normalization '{mode}'")


def crop_brats(
    sequences: Mapping[str, Nifti],
    seg_key: str = "seg",
    inplane: int = 192,
) -> dict:
    """Crop all sequences to the segmentation's nonzero z-range and a centered
    inplane x inplane square; min-max each to [-1,1] (seg left as labels)."""
    seg = sequences[seg_key].data
    nz = np.where(np.any(seg != 0, axis=(0, 1)))[0]
    z0, z1 = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, seg.shape[2])
    X, Y = seg.shape[0], seg.shape[1]
    x0 = max((X - inplane) // 2, 0)
    y0 = max((Y - inplane) // 2, 0)
    out = {}
    for key, vol in sequences.items():
        c = vol.data[x0 : x0 + inplane, y0 : y0 + inplane, z0:z1]
        if key != seg_key:
            c = normalize_minmax(c, clip_quantile_of_max=1.0)
        out[key] = Nifti(c, vol.affine.copy())
    return out


def volume_to_h5(
    case_dir,
    volumes: Mapping[str, np.ndarray],
    axis: int = 2,
):
    """Export aligned volumes as per-slice layer_<i>.h5 files."""
    case_dir = Path(case_dir)
    shapes = {np.asarray(v).shape for v in volumes.values()}
    assert len(shapes) == 1, f"misaligned volumes: {shapes}"
    n = next(iter(shapes))[axis]
    for i in range(n):
        arrays = {
            k: np.take(np.asarray(v), i, axis=axis) for k, v in volumes.items()
        }
        h5store.write_slice(case_dir / f"layer_{i}.h5", arrays)
    return n


def preprocess_dataset(
    src_root,
    dst_root,
    keys: Sequence[str] = ("F_Data1", "F_Data2", "S_Data1", "S_Data2"),
    target: int = 256,
    norm: str = "minmax",
    test_frac: float = 0.3,
    seed: int = 42,
):
    """Full offline chain: per case read <case>/<key>.nii.gz, resample to the
    target in-plane grid, normalize, split patients, export H5 slices into
    images_tr_{target}/ and images_ts_{target}/."""
    src_root, dst_root = Path(src_root), Path(dst_root)
    cases = sorted(d.name for d in src_root.iterdir() if d.is_dir())
    train, test = h5store.train_test_split_cases(
        cases, test_frac, seed, record_path=dst_root / "train_test.csv"
    )
    for case in cases:
        split = "tr" if case in train else "ts"
        vols = {}
        for key in keys:
            f = src_root / case / f"{key}.nii.gz"
            if not f.exists():
                f = src_root / case / f"{key}.nii"
            vol = resample_inplane(read_nifti(f), target)
            vols[key] = normalize_volume(vol.data, norm)
        volume_to_h5(dst_root / f"images_{split}_{target}" / case, vols)
    return train, test
