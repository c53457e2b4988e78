"""Composite weighted distance loss mixer.

Port of the JAX package's ``core/composite_loss.py``: a weighted sum of
L1 / L2 / SSIM / MS-SSIM / perceptual distances between prediction and
target, assembled once from a weights dict, over ``eval.metrics``' SSIM
and MS-SSIM.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..eval import metrics as M

__all__ = ["composite_distance"]


def composite_distance(weights: dict, perceptual_fn: Callable | None = None,
                       data_range: float = 2.0) -> Callable:
    """weights keys: l1, l2, ssim, ms_ssim, perceptual. Returns
    ``fn(pred, target) -> scalar`` on [B, H, W, 1] maps; the SSIM terms enter
    as (1 - ssim), ``perceptual`` only with a ``perceptual_fn``."""

    def fn(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        total = torch.zeros((), dtype=torch.float32, device=pred.device)
        if weights.get("l1"):
            total = total + weights["l1"] * (pred - target).abs().mean()
        if weights.get("l2"):
            total = total + weights["l2"] * ((pred - target) ** 2).mean()
        if weights.get("ssim"):
            s = M.ssim(target[..., 0], pred[..., 0], data_range)
            total = total + weights["ssim"] * (1.0 - s).mean()
        if weights.get("ms_ssim"):
            s = M.ms_ssim(target[..., 0], pred[..., 0], data_range)
            total = total + weights["ms_ssim"] * (1.0 - s).mean()
        if weights.get("perceptual") and perceptual_fn is not None:
            total = total + weights["perceptual"] * perceptual_fn(
                pred, target).mean()
        return total

    return fn
