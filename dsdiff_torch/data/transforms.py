"""Host-side slice transforms: pad, augment, edge maps.

The port's own copy of the JAX package's ``data/transforms.py``. ``cv2`` and
``scipy.ndimage`` are imported inside the functions that use them, so the
rest of the port imports where they are not installed.

- ``divisible_pad``: DivisiblePadd(k=32, mode='reflect')
  (training_transform.py:260).
- ``random_rotate`` / ``random_flip``: RandRotated(±30°, bilinear,
  reflection) + RandFlipd on both spatial axes
  (training_transform.py:266-284), driven by an explicit np.random.Generator
  for determinism.
- ``edge_map``: GetEdgeMap (my_transform.py:29-139) — bilateral filter with
  random sigma in [40,50], Sobel/Laplacian/Canny/sobel&laplacian, random
  threshold in [10,20], min-max normalize, max over input channels.
- ``random_rotate_3d`` and the preset compositions of
  training_transform.py: ``get_3d_train_transform`` /
  ``get_3d_val_transform`` (k=16 padding, 3-axis rotation, 3-axis flips),
  ``get_2d_rgb_train_transform`` / ``get_2d_rgb_val_transform`` (each
  sequence repeated to three channels) and ``get_wholebody_test_transform``
  (concat only). Each draws from the given ``np.random.Generator`` exactly
  as the JAX package's does.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = [
    "divisible_pad",
    "random_rotate",
    "random_flip",
    "random_rotate_3d",
    "edge_map",
    "normalize_minmax",
    "normalize_zscore",
    "get_3d_train_transform",
    "get_3d_val_transform",
    "get_2d_rgb_train_transform",
    "get_2d_rgb_val_transform",
    "get_wholebody_test_transform",
]


def divisible_pad(x: np.ndarray, k: int = 32, mode: str = "reflect",
                  spatial_dims: int = 2):
    """Pad the trailing ``spatial_dims`` dims to multiples of k, split
    evenly front/back (MONAI DivisiblePadd semantics; k=32 for 2D slices,
    k=16 for 3D volumes — training_transform.py:112,260)."""
    pads = []
    for d in range(-spatial_dims, 0):
        p = (-x.shape[d]) % k
        pads.append((p // 2, p - p // 2))
    if all(p == (0, 0) for p in pads):
        return x
    pad = [(0, 0)] * (x.ndim - spatial_dims) + pads
    return np.pad(x, pad, mode=mode)


def random_rotate(
    arrays: Sequence[np.ndarray],
    rng: np.random.Generator,
    max_deg: float = 30.0,
    prob: float = 0.5,
):
    """Jointly rotate [C, H, W] arrays by a shared random angle (bilinear,
    reflection border)."""
    if rng.random() >= prob:
        return list(arrays)
    import cv2

    angle = rng.uniform(-max_deg, max_deg)
    out = []
    for a in arrays:
        h, w = a.shape[-2], a.shape[-1]
        M = cv2.getRotationMatrix2D((w / 2 - 0.5, h / 2 - 0.5), angle, 1.0)
        chans = a if a.ndim == 3 else a[None]
        rot = np.stack(
            [
                cv2.warpAffine(
                    c.astype(np.float32), M, (w, h),
                    flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT,
                )
                for c in chans
            ]
        )
        out.append(rot if a.ndim == 3 else rot[0])
    return out


def random_flip(
    arrays: Sequence[np.ndarray],
    rng: np.random.Generator,
    prob: float = 0.5,
):
    """Jointly flip along each spatial axis with independent probability."""
    arrays = list(arrays)
    for axis in (-2, -1):
        if rng.random() < prob:
            arrays = [np.flip(a, axis=axis).copy() for a in arrays]
    return arrays


def _bilateral_uint8(img01: np.ndarray, sigma: float) -> np.ndarray:
    import cv2

    u8 = np.uint8(np.clip((img01 + 1) * 255 / 2, 0, 255))
    return cv2.bilateralFilter(u8, 10, sigma, sigma)


def _minmax(e: np.ndarray) -> np.ndarray:
    return (e - e.min() + 1e-12) / (e.max() - e.min() + 1e-8)


def edge_map(
    img: np.ndarray,
    kind: str = "sobel",
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Edge channel from [C, H, W] in [-1, 1]; returns [1, H, W] float32.

    Faithful to GetEdgeMap (my_transform.py:29-139): per-call random bilateral
    sigma (40..50) and threshold (10..20), per-channel edges max-combined.
    """
    import cv2

    rng = rng or np.random.default_rng()
    thresh = int(rng.integers(10, 21))
    sigma = float(rng.integers(40, 51))
    chans = img if img.ndim == 3 else img[None]
    edges = []
    for c in chans:
        if kind == "sobel":
            u8 = _bilateral_uint8(c, sigma)
            gx = cv2.Sobel(u8, cv2.CV_16S, 1, 0)
            gy = cv2.Sobel(u8, cv2.CV_16S, 0, 1)
            e = cv2.addWeighted(
                cv2.convertScaleAbs(gx), 0.5, cv2.convertScaleAbs(gy), 0.5, 0
            )
            e[e < thresh] = 0
        elif kind == "laplacian":
            u8 = _bilateral_uint8(c, sigma)
            e = cv2.convertScaleAbs(cv2.Laplacian(u8, cv2.CV_16S, ksize=3))
            e[e < thresh] = 0
        elif kind == "sobel&laplacian":
            u8 = _bilateral_uint8(c, sigma)
            gx = cv2.Sobel(u8, cv2.CV_16S, 1, 0)
            gy = cv2.Sobel(u8, cv2.CV_16S, 0, 1)
            sob = cv2.addWeighted(
                cv2.convertScaleAbs(gx), 0.5, cv2.convertScaleAbs(gy), 0.5, 0
            )
            lap = cv2.convertScaleAbs(cv2.Laplacian(sob, cv2.CV_16S, ksize=3))
            lap[sob < thresh] = 0
            e = cv2.addWeighted(sob, 0.7, lap, 0.3, 0)
            e[e < thresh] = 0
        elif kind == "canny":
            u8 = np.uint8(np.clip((c + 1) * 255 / 2, 0, 255))
            e = cv2.Canny(u8, 100, 200)
        else:
            raise ValueError(f"unknown edge type '{kind}'")
        edges.append(_minmax(e.astype(np.float32)))
    return np.max(np.stack(edges), axis=0)[None].astype(np.float32)


def normalize_minmax(vol: np.ndarray, clip_quantile_of_max: float = 0.75):
    """Clip at q*max then min-max to [-1, 1]
    (preprocess/normalization.py:64-71)."""
    v = vol.astype(np.float32)
    v = np.clip(v, None, clip_quantile_of_max * float(v.max()))
    lo, hi = float(v.min()), float(v.max())
    if hi - lo < 1e-12:
        return np.zeros_like(v)
    return (v - lo) / (hi - lo) * 2.0 - 1.0


def normalize_zscore(vol: np.ndarray):
    v = vol.astype(np.float32)
    return (v - v.mean()) / (v.std() + 1e-8)


# --------------------------------------------------------------- 3D augments
def random_rotate_3d(
    arrays: Sequence[np.ndarray],
    rng: np.random.Generator,
    max_deg: float = 30.0,
    prob: float = 0.5,
):
    """Jointly rotate [D, H, W] (or [C, D, H, W]) volumes by shared random
    Euler angles about all three axes (trilinear, reflection border) —
    RandRotated(range_x/y/z=30°) parity, training_transform.py:116-121."""
    if rng.random() >= prob:
        return list(arrays)
    import scipy.ndimage as ndi

    ax, ay, az = np.deg2rad(rng.uniform(-max_deg, max_deg, 3))

    def rot(a, theta, axes):
        ca, sa = np.cos(theta), np.sin(theta)
        r = np.eye(3)
        i, j = axes
        r[i, i] = ca
        r[i, j] = -sa
        r[j, i] = sa
        r[j, j] = ca
        return a @ r

    R = rot(rot(rot(np.eye(3), ax, (1, 2)), ay, (0, 2)), az, (0, 1))
    out = []
    for a in arrays:
        vols = a if a.ndim == 4 else a[None]
        shp = np.asarray(vols.shape[1:], np.float64)
        center = (shp - 1) / 2.0
        offset = center - R @ center
        rotd = np.stack([
            ndi.affine_transform(
                v.astype(np.float32), R, offset=offset, order=1,
                mode="reflect",
            )
            for v in vols
        ])
        out.append(rotd if a.ndim == 4 else rotd[0])
    return out


def _random_flip_nd(arrays, rng, prob, axes):
    arrays = list(arrays)
    for axis in axes:
        if rng.random() < prob:
            arrays = [np.flip(a, axis=axis).copy() for a in arrays]
    return arrays


# ----------------------------------------------------- preset compositions
# Functional equivalents of the reference's MONAI Compose presets
# (training_project/training_transform.py). Each returns
# ``apply(sample: dict[str, ndarray], rng) -> dict`` producing the
# reference's output contract: ``image`` = channel-first concat of ``keys``,
# with any extra entries ('t1ce' target, 'mask', ...) carried through the
# same geometric augmentations.
def _concat_first(sample, keys, extra_spatial=3):
    vols = {k: np.asarray(v, np.float32) for k, v in sample.items()}
    image = np.stack([vols[k] for k in keys], axis=0)
    extras = {k: v for k, v in vols.items() if k not in keys}
    return image, extras


def get_3d_train_transform(keys, random_prob: float = 0.5):
    """DivisiblePad(k=16) + 3-axis RandRotate(±30°) + RandFlip on all three
    spatial axes, jointly over image/t1ce/mask
    (training_transform.py:106-176)."""

    def apply(sample: dict, rng: np.random.Generator) -> dict:
        image, extras = _concat_first(sample, keys)
        image = divisible_pad(image, k=16, spatial_dims=3)
        extras = {k: divisible_pad(v, k=16, spatial_dims=3)
                  for k, v in extras.items()}
        names = list(extras)
        arrays = random_rotate_3d([image] + [extras[n] for n in names],
                                  rng, prob=random_prob)
        arrays = _random_flip_nd(arrays, rng, random_prob, (-3, -2, -1))
        out = {"image": arrays[0]}
        out.update(dict(zip(names, arrays[1:])))
        return out

    return apply


def get_3d_val_transform(keys):
    """Pad + concat only (training_transform.py:358-372)."""

    def apply(sample: dict, rng=None) -> dict:
        image, extras = _concat_first(sample, keys)
        out = {"image": divisible_pad(image, k=16, spatial_dims=3)}
        out.update({k: divisible_pad(v, k=16, spatial_dims=3)
                    for k, v in extras.items()})
        return out

    return apply


def get_2d_rgb_train_transform(keys, random_prob: float = 0.5):
    """RepeatChannel(3) + DivisiblePad(k=32) + in-plane rotate + 2-axis flip
    (training_transform.py:298-339)."""

    def apply(sample: dict, rng: np.random.Generator) -> dict:
        rgb = {k: np.repeat(np.asarray(v, np.float32)[None], 3, axis=0)
               for k, v in sample.items()}
        image = np.concatenate([rgb[k] for k in keys], axis=0)
        extras = {k: v for k, v in rgb.items() if k not in keys}
        image = divisible_pad(image, k=32)
        extras = {k: divisible_pad(v, k=32) for k, v in extras.items()}
        names = list(extras)
        arrays = random_rotate([image] + [extras[n] for n in names],
                               rng, prob=random_prob)
        arrays = _random_flip_nd(arrays, rng, random_prob, (-2, -1))
        out = {"image": arrays[0]}
        out.update(dict(zip(names, arrays[1:])))
        return out

    return apply


def get_2d_rgb_val_transform(keys):
    def apply(sample: dict, rng=None) -> dict:
        rgb = {k: np.repeat(np.asarray(v, np.float32)[None], 3, axis=0)
               for k, v in sample.items()}
        image = np.concatenate([rgb[k] for k in keys], axis=0)
        out = {"image": divisible_pad(image, k=32)}
        out.update({k: divisible_pad(v, k=32)
                    for k, v in rgb.items() if k not in keys})
        return out

    return apply


def get_wholebody_test_transform(keys):
    """Concat only, NO padding — whole-body volumes are assembled at native
    size (training_transform.py:487-509)."""

    def apply(sample: dict, rng=None) -> dict:
        image, extras = _concat_first(sample, keys)
        return {"image": image, **extras}

    return apply
