"""Latent-diffusion adapter: a frozen KL-VAE around the diffusion pipeline.

Port of the JAX package's ``train/latent.py`` (trainer_latent_diffusion and
ldm's LatentDiffusion):

- the first stage is frozen: its weights are held in the compute dtype
  (``models.layers.hold_in_compute_dtype``) and it runs under
  ``torch.inference_mode``;
- each condition sequence is encoded alone, with a posterior sample, and
  the latents are concatenated in channels (conditions in order), the
  target encoded last;
- encodings are multiplied by ``scale_factor`` (0.18215, SD's); with
  ``scale_by_std`` it is set once to ``1 / (std(z) + 1e-8)`` of the first
  batch's encoded target;
- sampling runs in latent space and ``decode_batch`` decodes at the end.

Every posterior draw is an argument (``noise``: one standard normal tensor
per encoded sequence, conditions then target), or drawn from
``generator`` in that order, so a test can replay the JAX package's. The
trainer sees ordinary ``{"image", "target"}`` batches whose arrays are
latents [B, H/8, W/8, z] (``image``: z channels per condition).
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.layers import hold_in_compute_dtype
from ..models.vae import AutoencoderKL

__all__ = ["LatentAdapter"]


class LatentAdapter:
    def __init__(self, vae: AutoencoderKL, scale_factor: float = 0.18215,
                 scale_by_std: bool = False):
        self.vae = hold_in_compute_dtype(vae.requires_grad_(False)).eval()
        self.scale_factor = float(np.float32(scale_factor))
        self.scale_by_std = scale_by_std
        self._calibrated = not scale_by_std
        self.z_channels = vae.embed_dim
        self.downsample = vae.downsample

    def _noise(self, x: torch.Tensor, generator) -> torch.Tensor:
        B, H, W, _ = x.shape
        ds = self.downsample
        return torch.randn((B, H // ds, W // ds, self.z_channels),
                           generator=generator, device=x.device)

    def _encode_one(self, x: torch.Tensor, noise, generator) -> torch.Tensor:
        """One sequence [B, H, W, 1] -> its posterior sample (unscaled),
        a plain tensor that autograd may take as an input."""
        if noise is None:
            noise = self._noise(x, generator)
        with torch.inference_mode():
            z = self.vae.encode(x).sample(noise)
        return z.float().clone()

    def calibrate(self, batch: dict, generator=None, noise=None) -> None:
        """``scale_by_std``: scale = 1 / (std(z) + 1e-8) of the batch's
        encoded target (population std); once, and only with
        ``scale_by_std``."""
        if self._calibrated:
            return
        z = self._encode_one(batch["target"], noise, generator)
        self.scale_factor = float(1.0 / (z.std(correction=0) + 1e-8))
        self._calibrated = True

    def encode_batch(self, batch: dict, generator=None, noise=None) -> dict:
        """``{"image": [B,H,W,Cc], "target": [B,H,W,1]}`` -> the same keys
        as scaled latents (``image`` [B,h,w,Cc*z]); other keys pass."""
        self.calibrate(batch, generator)
        image = batch["image"]
        n = image.shape[-1]
        noise = list(noise) if noise is not None else [None] * (n + 1)
        z_cond = [self._encode_one(image[..., c:c + 1], noise[c], generator)
                  * self.scale_factor for c in range(n)]
        out = dict(batch)
        out["image"] = torch.cat(z_cond, dim=-1)
        out["target"] = (self._encode_one(batch["target"], noise[n], generator)
                         * self.scale_factor)
        return out

    def encode_cond(self, image: torch.Tensor, generator=None,
                    noise=None) -> torch.Tensor:
        """Conditions only (sampling): [B,H,W,Cc] -> [B,h,w,Cc*z]."""
        n = image.shape[-1]
        noise = list(noise) if noise is not None else [None] * n
        return torch.cat([self._encode_one(image[..., c:c + 1], noise[c],
                                           generator) * self.scale_factor
                          for c in range(n)], dim=-1)

    @torch.inference_mode()
    def decode_batch(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents [B,h,w,z] -> images [B,H,W,1], f32."""
        return self.vae.decode(z / self.scale_factor)
