"""Hot-path ops: hand-written CUDA kernels for Hopper and their plain versions.

Port of the JAX package's ``ops``. A CPU tensor runs the op's plain PyTorch
version; a CUDA tensor launches the kernel or raises. There is no fallback
from the kernel and no switch between implementations.
"""
from __future__ import annotations

import torch

from . import flash_attention as _fa
from . import fused_norm as _fn

__all__ = ["scaled_attention", "fused_group_norm_silu"]


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
    no backward. No model calls it (``GroupNorm32``'s eps is 1e-6).
    """
    if x.device.type == "cpu":
        return _fn.group_norm_silu_plain(x, scale, bias, num_groups)
    return _fn.group_norm_silu(x, scale, bias, num_groups)
