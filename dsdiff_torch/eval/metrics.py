"""On-device image metrics: SSIM.

Port of the JAX package's ``eval/metrics.py:160-216`` (``_gaussian_kernel``,
``_filter2d``, ``ssim``). The host-side volume metrics come with ROADMAP
A18. The Gaussian filter runs in full f32 with TF32 off, the port's version
of the JAX package's ``precision=HIGHEST``: with TF32 (about three decimal
digits) the moment cancellation ``E[x²] - E[x]²`` goes negative on
near-constant regions with ``|mean| ~ 1`` and SSIM can exceed 1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.device import full_f32

__all__ = ["ssim"]


def _gaussian_kernel(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


def _filter2d(img: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Valid-mode 2D correlation of img [B, H, W] with kern [k, k], f32."""
    with full_f32():
        return F.conv2d(img[:, None], kern[None, None])[:, 0]


def ssim(true: torch.Tensor, pred: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM per batch element; inputs [B, H, W] (or [H, W])."""
    t = true.float()
    p = pred.float()
    if t.ndim == 2:
        t, p = t[None], p[None]
    k = _gaussian_kernel(kernel_size, sigma, device=t.device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_t = _filter2d(t, k)
    mu_p = _filter2d(p, k)
    mu_tt = _filter2d(t * t, k)
    mu_pp = _filter2d(p * p, k)
    mu_tp = _filter2d(t * p, k)
    # true variances are >= 0; negative values are cancellation noise
    var_t = torch.clamp(mu_tt - mu_t**2, min=0.0)
    var_p = torch.clamp(mu_pp - mu_p**2, min=0.0)
    cov = mu_tp - mu_t * mu_p
    num = (2 * mu_t * mu_p + c1) * (2 * cov + c2)
    den = (mu_t**2 + mu_p**2 + c1) * (var_t + var_p + c2)
    return (num / den).mean(dim=(1, 2))
