"""Fold/unfold patched model application (split-input sampling).

Port of the JAX package's ``core/patching.py``: the input is cut into
overlapping ``kernel_size``/``stride`` tiles, the denoiser runs ONCE over
every tile folded into the batch axis, and the outputs are re-assembled
with the border-distance weighting and divided by the folded weighting.
Maps are NHWC; tile offsets are Python ints, y-major (torch ``Unfold``
order). The weighting is computed on the host in float64, as the JAX
package's numpy does, and enters the fold in the patches' dtype.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["delta_border", "get_weighting", "extract_patches",
           "fold_patches", "patched_apply"]


def delta_border(h: int, w: int) -> np.ndarray:
    """Normalised distance to the nearest image border, 0 at the border and
    0.5 at the centre, [h, w]."""
    y = np.arange(h, dtype=np.float64) / max(h - 1, 1)
    x = np.arange(w, dtype=np.float64) / max(w - 1, 1)
    arr = np.stack(np.meshgrid(y, x, indexing="ij"), axis=-1)
    dist_lu = arr.min(axis=-1)
    dist_rd = (1.0 - arr).min(axis=-1)
    return np.minimum(dist_lu, dist_rd)


def get_weighting(
    kh: int, kw: int, Ly: int, Lx: int,
    clip_min_weight: float = 0.01, clip_max_weight: float = 0.5,
    tie_braker: bool = True,
    clip_min_tie_weight: float = 0.01, clip_max_tie_weight: float = 0.5,
) -> np.ndarray:
    """Per-pixel tile weighting [Ly*Lx, kh, kw]: each tile's clipped border
    distance, times (``tie_braker``) its tile's clipped distance to the
    border of the Ly x Lx tile grid."""
    w = np.clip(delta_border(kh, kw), clip_min_weight, clip_max_weight)
    w = np.tile(w[None], (Ly * Lx, 1, 1))
    if tie_braker:
        lw = np.clip(delta_border(Ly, Lx), clip_min_tie_weight,
                     clip_max_tie_weight)
        w = w * lw.reshape(Ly * Lx, 1, 1)
    return w


def _offsets(size: int, k: int, s: int) -> list[int]:
    return list(range(0, size - k + 1, s))


def _check_coverage(size: int, k: int, s: int, axis: str) -> None:
    offs = _offsets(size, k, s)
    if not offs or offs[-1] + k != size:
        raise ValueError(
            f"kernel/stride do not tile the {axis} extent: size={size}, "
            f"kernel={k}, stride={s} leaves pixels "
            f"[{(offs[-1] + k) if offs else 0}, {size}) uncovered, which "
            f"would divide by a zero fold-norm (NaN output). Require "
            f"(size - kernel) % stride == 0."
        )


def extract_patches(x: torch.Tensor, kernel_size, stride) -> torch.Tensor:
    """[B, H, W, C] -> [B, L, kh, kw, C] overlapping tiles, L = Ly*Lx,
    y-major."""
    kh, kw = kernel_size
    sh, sw = stride
    tiles = [
        x[:, oy : oy + kh, ox : ox + kw, :]
        for oy in _offsets(x.shape[1], kh, sh)
        for ox in _offsets(x.shape[2], kw, sw)
    ]
    return torch.stack(tiles, dim=1)


def fold_patches(patches: torch.Tensor, out_hw, kernel_size, stride,
                 weighting: np.ndarray) -> torch.Tensor:
    """[B, L, kh, kw, C] -> [B, H, W, C], overlap-summed with ``weighting``
    [L, kh, kw] and divided by the folded weighting. Raises where the tiles
    leave a pixel uncovered."""
    kh, kw = kernel_size
    sh, sw = stride
    H, W = out_hw
    _check_coverage(H, kh, sh, "H")
    _check_coverage(W, kw, sw, "W")
    B, L, _, _, C = patches.shape
    w = torch.as_tensor(np.asarray(weighting), dtype=patches.dtype,
                        device=patches.device)[..., None]  # [L, kh, kw, 1]
    canvas = torch.zeros((B, H, W, C), dtype=patches.dtype,
                         device=patches.device)
    norm = torch.zeros((1, H, W, 1), dtype=patches.dtype,
                       device=patches.device)
    i = 0
    for oy in _offsets(H, kh, sh):
        for ox in _offsets(W, kw, sw):
            canvas[:, oy : oy + kh, ox : ox + kw, :] += patches[:, i] * w[i]
            norm[:, oy : oy + kh, ox : ox + kw, :] += w[i]
            i += 1
    return canvas / norm


def patched_apply(fn, x: torch.Tensor, t: torch.Tensor, kernel_size, stride,
                  cond: torch.Tensor | None = None,
                  **weight_params) -> torch.Tensor:
    """``fn(x_tiles, t_tiles)`` over the overlapping tiles of ``x``, refolded.

    ``fn`` maps [N, kh, kw, Cin] -> [N, kh, kw, Cout]; one call covers every
    tile of every batch element (N = B*L). ``cond`` (channel conditioning)
    is tiled with x and concatenated to each tile.
    """
    kh, kw = kernel_size
    Ly = len(_offsets(x.shape[1], kh, stride[0]))
    Lx = len(_offsets(x.shape[2], kw, stride[1]))
    tiles = extract_patches(x, kernel_size, stride)  # [B, L, kh, kw, C]
    if cond is not None:
        ctiles = extract_patches(cond, kernel_size, stride)
        tiles = torch.cat([tiles, ctiles.to(tiles.dtype)], dim=-1)
    B, L = tiles.shape[:2]
    flat = tiles.reshape(B * L, kh, kw, tiles.shape[-1])
    out = fn(flat, torch.repeat_interleave(t, L, dim=0))
    out = out.reshape(B, L, kh, kw, out.shape[-1])
    weighting = get_weighting(kh, kw, Ly, Lx, **weight_params)
    return fold_patches(out, x.shape[1:3], kernel_size, stride, weighting)
