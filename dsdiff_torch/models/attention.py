"""OpenAI-style self-attention over a spatial map.

Port of the JAX package's ``models/attention.py:211-239 AttentionBlock``. The
other attention modules (``CrossAttention``, ``FFTAttention``,
``SpatialTransformer``) come with a later slice (ROADMAP A17b).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import scaled_attention
from .layers import Dense, GroupNorm32, zero_init

__all__ = ["AttentionBlock"]


class AttentionBlock(nn.Module):
    """GroupNorm -> fused qkv projection -> heads -> attention -> zero-init
    projection -> residual, on an NCHW map.

    The qkv Dense(3C) output splits into contiguous q|k|v thirds (not the
    OpenAI per-head interleave); the thirds go to ``scaled_attention`` as
    strided [B, N, heads, D] views, with no copy.
    """

    def __init__(self, channels: int, num_heads: int = 1,
                 num_head_channels: int = -1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_head_channels == -1:
            self.heads = num_heads
        else:
            if channels % num_head_channels:
                raise ValueError(
                    f"{channels} channels do not split into heads of "
                    f"{num_head_channels}"
                )
            self.heads = channels // num_head_channels
        self.norm = GroupNorm32(channels)
        self.qkv = Dense(channels, 3 * channels, dtype=dtype)
        self.proj_out = zero_init(Dense(channels, channels, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        N = H * W
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, N, C)
        qkv = self.qkv(h).view(B, N, 3, self.heads, C // self.heads)
        q, k, v = qkv.unbind(dim=2)
        out = scaled_attention(q, k, v).reshape(B, N, C)
        out = self.proj_out(out)
        return x + out.view(B, H, W, C).permute(0, 3, 1, 2)
