"""Conditioning encoders: class embeddings and embedding noise augmentation.

Port of the JAX package's ``models/encoders.py`` without its CLIP wrappers
(they need the ``transformers`` package and pretrained CLIP weights, which
this repository does not hold; ROADMAP lists them):

- ``ClassEmbedder``: label -> embedding, with train-time unconditional-class
  dropout (to the last class) for classifier-free guidance; the dropout
  mask is given, or drawn from a given generator.
- ``EmbeddingNoiseAugmentation``: q-sample diffusion noise on embedding
  vectors (unCLIP style), returning the noise level for 'adm' conditioning;
  the noise and the level are given, or drawn from a given generator.
- ``unclip_adm_cond``: an embedding -> 'adm' vector conditioning.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core import process
from ..core.schedules import DiffusionSchedule
from .layers import timestep_embedding

__all__ = ["ClassEmbedder", "EmbeddingNoiseAugmentation", "unclip_adm_cond"]


class ClassEmbedder(nn.Module):
    """Label embedding (``embedding``) with dropout to the null class, the
    last one."""

    def __init__(self, n_classes: int, embed_dim: int = 512,
                 ucg_rate: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_classes = n_classes
        self.ucg_rate = ucg_rate
        self.dtype = dtype
        self.embedding = nn.Embedding(n_classes, embed_dim)

    def forward(self, y: torch.Tensor, *, deterministic: bool = True,
                drop: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """y [B] int -> [B, embed_dim]. Unless ``deterministic``, labels
        where ``drop`` (bool [B]; else drawn from ``generator``, each with
        probability ``ucg_rate``) become the null class."""
        if not deterministic and self.ucg_rate > 0:
            if drop is None:
                if generator is None:
                    raise ValueError("label dropout needs a mask or a "
                                     "generator")
                drop = torch.rand(y.shape, generator=generator,
                                  device=y.device) < self.ucg_rate
            y = torch.where(drop, torch.full_like(y, self.n_classes - 1), y)
        return self.embedding(y).to(self.dtype)


class EmbeddingNoiseAugmentation:
    """Normalise embeddings by the dataset's mean and std, q-sample them at a
    noise level, un-normalise; returns (noisy embedding, level)."""

    def __init__(self, sched: DiffusionSchedule,
                 max_noise_level: int | None = None,
                 mean: torch.Tensor | float = 0.0,
                 std: torch.Tensor | float = 1.0):
        self.sched = sched
        self.max_noise_level = max_noise_level or sched.num_timesteps
        self.mean = mean
        self.std = std

    def __call__(self, emb: torch.Tensor,
                 noise: torch.Tensor | None = None,
                 noise_level: torch.Tensor | None = None,
                 generator: torch.Generator | None = None):
        """emb [B, D]; ``noise_level`` [B] int in [0, max_noise_level) and
        ``noise`` [B, D], each drawn from ``generator`` where not given."""
        if (noise is None or noise_level is None) and generator is None:
            raise ValueError("noise augmentation needs its noise and level, "
                             "or a generator")
        B = emb.shape[0]
        if noise_level is None:
            noise_level = torch.randint(0, self.max_noise_level, (B,),
                                        generator=generator,
                                        device=emb.device)
        z = (emb - self.mean) / self.std
        if noise is None:
            noise = torch.randn(z.shape, generator=generator, dtype=z.dtype,
                                device=z.device)
        z = process.q_sample(self.sched, z, noise_level, noise)
        return z * self.std + self.mean, noise_level


def unclip_adm_cond(emb: torch.Tensor, aug: EmbeddingNoiseAugmentation,
                    level_emb_dim: int = 0, embedding_dropout: float = 0.0,
                    deterministic: bool = True,
                    noise: torch.Tensor | None = None,
                    noise_level: torch.Tensor | None = None,
                    keep: torch.Tensor | None = None,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """An embedding -> 'adm' vector conditioning: noise-augment it, append a
    sinusoidal embedding of the noise level when ``level_emb_dim`` > 0, and
    (unless ``deterministic``) drop whole rows with probability
    ``embedding_dropout``: ``keep`` (bool [B]) or drawn from
    ``generator``."""
    noisy, level = aug(emb, noise, noise_level, generator)
    if level_emb_dim > 0:
        lvl = timestep_embedding(level.float(), level_emb_dim)
        noisy = torch.cat([noisy, lvl.to(noisy.dtype)], dim=1)
    if not deterministic and embedding_dropout > 0:
        if keep is None:
            if generator is None:
                raise ValueError("embedding dropout needs a keep mask or a "
                                 "generator")
            keep = torch.rand((noisy.shape[0],), generator=generator,
                              device=noisy.device) >= embedding_dropout
        noisy = noisy * keep.to(noisy.dtype)[:, None]
    return noisy
