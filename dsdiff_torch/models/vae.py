"""KL-VAE first stage for latent diffusion.

Port of the JAX package's ``models/vae.py``: the SD conv autoencoder
(``Encoder``, ``Decoder``, the time-free ResnetBlock and the single-head
bottleneck attention) and ``DiagonalGaussian``, wrapped as
``AutoencoderKL`` with the 1-channel medical override. Training (the GAN
and perceptual loss, two optimizers) lives in ``train.vae_trainer``.

``AutoencoderKL`` takes and returns NHWC (its posterior's moments too);
``Encoder`` and ``Decoder`` run NCHW inside, as the port's other blocks.
Submodule names are the Flax module names, so ``utils.flax_bridge`` maps
weights one to one. Compute dtype as in ``models.layers``: f32 parameters,
convolutions and projections in ``dtype``, GroupNorm statistics in f32; the
encoder's and decoder's ``conv_out`` return f32. The bottleneck attention is
one head over all the channels (512 at ``ch`` 128, ``ch_mult`` (1, 2, 4, 4)),
through ``ops.scaled_attention``. The latent scale factor (0.18215 for SD
weights) is applied by the latent-diffusion pipeline, not here.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import scaled_attention
from .layers import Conv, Dense, GroupNorm32

__all__ = ["AutoencoderKL", "DiagonalGaussian", "Encoder", "Decoder"]


class DiagonalGaussian:
    """The posterior over latents: ``mean`` and ``logvar`` [B, h, w, z]
    (any layout: ``kl`` and ``nll`` sum over the three non-batch axes)."""

    def __init__(self, mean: torch.Tensor, logvar: torch.Tensor):
        self.mean = mean
        self.logvar = logvar

    @classmethod
    def from_moments(cls, moments: torch.Tensor) -> "DiagonalGaussian":
        """Moments [B, h, w, 2z] -> the first z channels' mean and the
        last z channels' log-variance, clipped to [-30, 20]."""
        mean, logvar = moments.chunk(2, dim=-1)
        return cls(mean, logvar.clamp(-30.0, 20.0))

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        """mean + std * noise, the noise given (a standard normal of the
        mean's shape), cast to the mean's dtype."""
        std = torch.exp(0.5 * self.logvar)
        return self.mean + std * noise.to(self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        return 0.5 * torch.sum(
            self.mean**2 + torch.exp(self.logvar) - 1.0 - self.logvar,
            dim=(1, 2, 3))

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        return 0.5 * torch.sum(
            math.log(2.0 * math.pi) + self.logvar
            + (sample - self.mean) ** 2 / torch.exp(self.logvar),
            dim=(1, 2, 3))


class _VaeResBlock(nn.Module):
    """Time-free ResnetBlock: GN-SiLU-conv twice, a 1x1 shortcut on a
    channel change."""

    def __init__(self, channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = GroupNorm32(channels)
        self.conv1 = Conv(channels, out_channels, 3, padding=1, dtype=dtype)
        self.norm2 = GroupNorm32(out_channels)
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1, dtype=dtype)
        self.nin_shortcut = (Conv(channels, out_channels, 1, dtype=dtype)
                             if channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class _VaeAttnBlock(nn.Module):
    """Single-head spatial attention over all ``channels`` at the
    bottleneck: separate q, k, v projections, each a contiguous
    [B, N, 1, C] view for the kernel."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.q = Dense(channels, channels, dtype=dtype)
        self.k = Dense(channels, channels, dtype=dtype)
        self.v = Dense(channels, channels, dtype=dtype)
        self.proj_out = Dense(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        out = scaled_attention(self.q(h)[:, :, None], self.k(h)[:, :, None],
                               self.v(h)[:, :, None])[:, :, 0]
        out = self.proj_out(out)
        return x + out.view(B, H, W, C).permute(0, 3, 1, 2)


class Encoder(nn.Module):
    """Conv encoder, NCHW in, ``2 * z_channels`` moments out (f32): a level
    of res blocks per ``ch_mult`` entry, each but the last closed by an
    asymmetric pad (bottom/right by one) and a stride-2 VALID conv, then
    res-attention-res at the bottleneck."""

    def __init__(self, in_channels: int = 1, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4,
                 double_z: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.levels = len(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.conv_in = Conv(in_channels, ch, 3, padding=1, dtype=dtype)
        c = ch
        for level, mult in enumerate(ch_mult):
            for i in range(num_res_blocks):
                setattr(self, f"down_{level}_{i}",
                        _VaeResBlock(c, ch * mult, dtype=dtype))
                c = ch * mult
            if level != self.levels - 1:
                setattr(self, f"down_{level}_ds",
                        Conv(c, c, 3, stride=2, dtype=dtype))
        self.mid_res1 = _VaeResBlock(c, c, dtype=dtype)
        self.mid_attn = _VaeAttnBlock(c, dtype=dtype)
        self.mid_res2 = _VaeResBlock(c, c, dtype=dtype)
        self.norm_out = GroupNorm32(c)
        self.conv_out = Conv(c, 2 * z_channels if double_z else z_channels, 3,
                             padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in range(self.levels):
            for i in range(self.num_res_blocks):
                h = getattr(self, f"down_{level}_{i}")(h)
            if level != self.levels - 1:
                h = getattr(self, f"down_{level}_ds")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_res2(self.mid_attn(self.mid_res1(h)))
        return self.conv_out(F.silu(self.norm_out(h))).float()


class Decoder(nn.Module):
    """Latent -> image conv decoder, NCHW (f32 out): res-attention-res at
    the bottleneck, then per level from the deepest ``num_res_blocks + 1``
    res blocks and, but at the top, a nearest 2x upsample and a conv."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4,
                 out_channels: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.levels = len(ch_mult)
        self.num_res_blocks = num_res_blocks
        c = ch * ch_mult[-1]
        self.conv_in = Conv(z_channels, c, 3, padding=1, dtype=dtype)
        self.mid_res1 = _VaeResBlock(c, c, dtype=dtype)
        self.mid_attn = _VaeAttnBlock(c, dtype=dtype)
        self.mid_res2 = _VaeResBlock(c, c, dtype=dtype)
        for level in reversed(range(self.levels)):
            for i in range(num_res_blocks + 1):
                setattr(self, f"up_{level}_{i}",
                        _VaeResBlock(c, ch * ch_mult[level], dtype=dtype))
                c = ch * ch_mult[level]
            if level != 0:
                setattr(self, f"up_{level}_us",
                        Conv(c, c, 3, padding=1, dtype=dtype))
        self.norm_out = GroupNorm32(c)
        self.conv_out = Conv(c, out_channels, 3, padding=1, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid_res2(self.mid_attn(self.mid_res1(h)))
        for level in reversed(range(self.levels)):
            for i in range(self.num_res_blocks + 1):
                h = getattr(self, f"up_{level}_{i}")(h)
            if level != 0:
                h = getattr(self, f"up_{level}_us")(
                    F.interpolate(h, scale_factor=2, mode="nearest"))
        return self.conv_out(F.silu(self.norm_out(h))).float()


class AutoencoderKL(nn.Module):
    """Encoder + 1x1 quant convs + Decoder; ``embed_dim`` is the latent
    channel count after ``quant_conv``. NHWC at ``encode``, ``decode`` and
    ``forward``."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4,
                 embed_dim: int = 4, in_channels: int = 1,
                 out_channels: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.ch_mult = tuple(ch_mult)
        self.compute_dtype = dtype
        self.encoder = Encoder(in_channels, ch, ch_mult, num_res_blocks,
                               z_channels, dtype=dtype)
        self.decoder = Decoder(ch, ch_mult, num_res_blocks, z_channels,
                               out_channels, dtype=dtype)
        self.quant_conv = Conv(2 * z_channels, 2 * embed_dim, 1, dtype=dtype)
        self.post_quant_conv = Conv(embed_dim, z_channels, 1, dtype=dtype)

    @property
    def downsample(self) -> int:
        """The latent's spatial reduction: 2 per level past the first."""
        return 2 ** (len(self.ch_mult) - 1)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        """[B, H, W, in_channels] -> the posterior over [B, h, w, embed_dim]
        latents (moments in the compute dtype)."""
        moments = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        return DiagonalGaussian.from_moments(moments.permute(0, 2, 3, 1))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """[B, h, w, embed_dim] -> [B, H, W, out_channels], f32."""
        h = self.decoder(self.post_quant_conv(z.permute(0, 3, 1, 2)))
        return h.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, noise: torch.Tensor | None = None,
                sample_posterior: bool = True,
                generator: torch.Generator | None = None):
        """(reconstruction, posterior). A sampled latent takes ``noise``
        (standard normal, the latent's shape), drawn from ``generator`` if
        not given; ``sample_posterior=False`` decodes the mean."""
        post = self.encode(x)
        if not sample_posterior:
            return self.decode(post.mode()), post
        if noise is None:
            noise = torch.randn(post.mean.shape, generator=generator,
                                device=post.mean.device)
        return self.decode(post.sample(noise)), post
