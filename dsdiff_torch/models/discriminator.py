"""PatchGAN discriminator for the VAE GAN loss.

Port of the JAX package's ``models/discriminator.py``: the taming
NLayerDiscriminator with GroupNorm in place of BatchNorm (no batch
statistics, so the discriminator step stays a plain function of its
inputs). 4x4 convolutions with padding 1: a stride-2 ``conv_in`` with a
bias, ``n_layers`` bias-free convolutions (stride 2 but the last), each
followed by GroupNorm (``min(32, ch)`` groups, eps 1e-6, the Flax default,
statistics in f32) and LeakyReLU 0.2, then ``conv_out`` to a one-channel
logit map, returned in f32. NHWC in and out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv

__all__ = ["PatchDiscriminator", "hinge_d_loss", "vanilla_d_loss"]


class PatchDiscriminator(nn.Module):
    def __init__(self, base_channels: int = 64, n_layers: int = 3,
                 in_channels: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers = n_layers
        self.compute_dtype = dtype
        self.conv_in = Conv(in_channels, base_channels, 4, stride=2, padding=1,
                            dtype=dtype)
        ch = base_channels
        for i in range(1, n_layers + 1):
            out = base_channels * min(2**i, 8)
            stride = 2 if i < n_layers else 1
            setattr(self, f"conv_{i}", Conv(ch, out, 4, stride=stride,
                                            padding=1, bias=False, dtype=dtype))
            setattr(self, f"norm_{i}", nn.GroupNorm(min(32, out), out, eps=1e-6))
            ch = out
        self.conv_out = Conv(ch, 1, 4, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, in_channels] -> logits [B, h, w, 1], f32."""
        h = F.leaky_relu(self.conv_in(x.permute(0, 3, 1, 2)), 0.2)
        for i in range(1, self.n_layers + 1):
            h = getattr(self, f"conv_{i}")(h)
            h = getattr(self, f"norm_{i}")(h.float()).to(self.compute_dtype)
            h = F.leaky_relu(h, 0.2)
        return self.conv_out(h).float().permute(0, 2, 3, 1)


def hinge_d_loss(logits_real: torch.Tensor,
                 logits_fake: torch.Tensor) -> torch.Tensor:
    """0.5 * (mean relu(1 - real) + mean relu(1 + fake))."""
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real))
                  + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real: torch.Tensor,
                   logits_fake: torch.Tensor) -> torch.Tensor:
    """0.5 * (mean softplus(-real) + mean softplus(fake))."""
    return 0.5 * (torch.mean(F.softplus(-logits_real))
                  + torch.mean(F.softplus(logits_fake)))
