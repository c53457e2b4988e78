"""Host-side slice transforms: pad, augment, edge maps.

The port's own copy of the JAX package's ``data/transforms.py:40-167``; its
3-D and RGB presets are not ported yet (ROADMAP A18). ``cv2`` is imported
inside the functions that use it, so the rest of the port imports where it
is not installed.

- ``divisible_pad``: DivisiblePadd(k=32, mode='reflect')
  (training_transform.py:260).
- ``random_rotate`` / ``random_flip``: RandRotated(±30°, bilinear,
  reflection) + RandFlipd on both spatial axes
  (training_transform.py:266-284), driven by an explicit np.random.Generator
  for determinism.
- ``edge_map``: GetEdgeMap (my_transform.py:29-139) — bilateral filter with
  random sigma in [40,50], Sobel/Laplacian/Canny/sobel&laplacian, random
  threshold in [10,20], min-max normalize, max over input channels.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = [
    "divisible_pad",
    "random_rotate",
    "random_flip",
    "edge_map",
    "normalize_minmax",
    "normalize_zscore",
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
