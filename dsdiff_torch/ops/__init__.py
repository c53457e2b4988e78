"""Hot-path ops: hand-written CUDA kernels for Hopper and their plain versions.

Port of the JAX package's ``ops``. A CPU tensor runs the op's plain PyTorch
version; a CUDA tensor launches the kernel or raises. There is no fallback
from the kernel and no switch between implementations.
"""
from __future__ import annotations

import torch

from . import flash_attention as _fa

__all__ = ["scaled_attention"]


def scaled_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Multi-head attention, layout [B, N, heads, head_dim]."""
    if q.device.type == "cpu":
        return _fa.reference_attention(q, k, v)
    return _fa.flash_attention(q, k, v)
