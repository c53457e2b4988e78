"""Hot-path ops: hand-written CUDA kernels for Hopper and their plain versions.

Port of the JAX package's ``ops``. A CPU tensor runs the op's plain PyTorch
version; a CUDA tensor launches the kernel or raises. There is no fallback
from the kernel and no switch between implementations.
"""
from __future__ import annotations

import torch

from . import flash_attention as _fa
from . import fused_norm as _fn

__all__ = ["scaled_attention", "fused_group_norm_silu", "group_norm_film_silu"]


def scaled_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Multi-head attention, layout [B, N, heads, head_dim]; differentiable
    (the kernel's gradient is the VJP of the plain math)."""
    if q.device.type == "cpu":
        return _fa.reference_attention(q, k, v)
    return _fa.flash_attention(q, k, v)


def fused_group_norm_silu(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, num_groups: int = 32):
    """SiLU(GroupNorm(x)) with eps 1e-5; x [B, H, W, C], scale/bias [C].

    On a CUDA tensor it raises when an input requires grad: the kernel has
    no backward. No model calls it (``GroupNorm32``'s eps is 1e-6; the
    models' norm sites take ``group_norm_film_silu``).
    """
    if x.device.type == "cpu":
        return _fn.group_norm_silu_plain(x, scale, bias, num_groups)
    return _fn.group_norm_silu(x, scale, bias, num_groups)


def group_norm_film_silu(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, num_groups: int,
                         scale: torch.Tensor | None = None,
                         shift: torch.Tensor | None = None,
                         eps: float = 1e-6):
    """SiLU(GroupNorm(x) * (1 + scale) + shift), or SiLU(GroupNorm(x))
    without scale and shift: x [B, C, H, W] (NCHW-contiguous or channels
    last; y keeps its format), gamma/beta f32 [C], scale/shift [B, C, 1, 1].

    On a CUDA tensor it raises when an input requires grad: the kernels
    have no backward (``models.layers.GroupNorm32.silu`` calls it only when
    no gradient is recorded).
    """
    if x.device.type == "cpu":
        return _fn.group_norm_film_silu_plain(x, gamma, beta, num_groups,
                                              scale, shift, eps)
    return _fn.group_norm_film_silu(x, gamma, beta, num_groups, scale, shift,
                                    eps)
