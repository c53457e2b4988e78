"""Small utilities: image conversion, GAN image pool, heatmaps, progress.

The port's own copy of the JAX package's ``utils/misc.py``; ``count_params``
counts a module's parameters.

Parity targets in training_project/utils/: ``tensor2im``
(save_tensor_img.py:6-32), ``ImagePool`` (image_pool.py), ``get_heatmap``
(util.py:144-155), ``printProgressBar`` (progress_bar.py).
"""
from __future__ import annotations

import sys

import numpy as np

__all__ = ["tensor2im", "ImagePool", "heatmap_to_rgb",
           "print_progress_bar", "count_params"]


def tensor2im(arr: np.ndarray, imtype=np.uint8) -> np.ndarray:
    """[-1,1] float image -> uint8 [H, W, C] (save_tensor_img.py:6-32)."""
    a = np.asarray(arr, np.float32)
    if a.ndim == 4:
        a = a[0]
    if a.ndim == 2:
        a = a[:, :, None]
    if a.shape[-1] == 1:
        a = np.repeat(a, 3, axis=-1)
    a = (a + 1.0) / 2.0 * 255.0
    # clip passes NaN through, which then warns (and wraps) on the uint8
    # cast — early-training samples can contain NaN/Inf pixels
    a = np.nan_to_num(a, nan=0.0, posinf=255.0, neginf=0.0)
    return np.clip(a, 0, 255).astype(imtype)


class ImagePool:
    """History buffer of generated images for discriminator training
    (image_pool.py): with probability 0.5 swap the incoming image with a
    stored one."""

    def __init__(self, pool_size: int = 50, seed: int = 0):
        self.pool_size = pool_size
        self.images: list = []
        self.rng = np.random.default_rng(seed)

    def query(self, images: np.ndarray) -> np.ndarray:
        if self.pool_size == 0:
            return images
        out = []
        for img in np.asarray(images):
            if len(self.images) < self.pool_size:
                self.images.append(img.copy())
                out.append(img)
            elif self.rng.random() > 0.5:
                idx = int(self.rng.integers(0, self.pool_size))
                out.append(self.images[idx].copy())
                self.images[idx] = img.copy()
            else:
                out.append(img)
        return np.stack(out)


def heatmap_to_rgb(mat: np.ndarray) -> np.ndarray:
    """[-1,1] similarity matrix -> RGB heatmap uint8 (util.py:144-155
    get_heatmap; coolwarm-style two-ramp colormap without matplotlib)."""
    # nan_to_num BEFORE clip: np.clip propagates NaN (zero-variance
    # features early in training yield 0/0 cosine similarities), which
    # would reach the uint8 cast as a RuntimeWarning + garbage pixel
    m = np.clip(np.nan_to_num(np.asarray(mat, np.float32)), -1.0, 1.0)
    t = (m + 1.0) / 2.0  # 0..1
    r = np.clip(2.0 * t, 0, 1)
    b = np.clip(2.0 * (1.0 - t), 0, 1)
    g = 1.0 - np.abs(2.0 * t - 1.0)
    rgb = np.stack([r, g, b], axis=-1)
    return (rgb * 255).astype(np.uint8)


def print_progress_bar(iteration: int, total: int, content: str = "",
                       length: int = 30, stream=None):
    """Console progress bar (progress_bar.py parity)."""
    stream = stream or sys.stdout
    frac = iteration / max(total, 1)
    filled = int(length * frac)
    bar = "#" * filled + "-" * (length - filled)
    stream.write(f"\r|{bar}| {100*frac:5.1f}% {content}")
    if iteration >= total:
        stream.write("\n")
    stream.flush()


def count_params(model, verbose: bool = False) -> int:
    """Total parameter count of a module (ldm/util.py:75-80 count_params)."""
    n = sum(p.numel() for p in model.parameters())
    if verbose:
        print(f"{n / 1e6:.2f}M parameters")
    return n
