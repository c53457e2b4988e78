"""Conditioning encoders: class embeddings, CLIP wrappers, noise
augmentation.

Port of the JAX package's ``models/encoders.py``:

- ``ClassEmbedder``: label -> embedding, with train-time unconditional-class
  dropout (to the last class) for classifier-free guidance; the dropout
  mask is given, or drawn from a given generator.
- ``CLIPTextEmbedder`` / ``CLIPImageEmbedder``: the FrozenCLIP /
  FrozenOpenCLIPImageEmbedder capability from a local snapshot (no
  download: a missing ``weights_path`` raises), through the port's own CLIP
  towers and tokenizer (``models.clip``); on ``device``, the card by
  default.
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
from ..utils.device import resolve_device
from .clip import CLIPTokenizer, load_clip_tower
from .layers import timestep_embedding

__all__ = ["ClassEmbedder", "EmbeddingNoiseAugmentation", "CLIPTextEmbedder",
           "CLIPImageEmbedder", "unclip_adm_cond"]


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


def _require_snapshot(weights_path):
    if not weights_path:
        raise ValueError(
            "CLIP encoders need a local weights snapshot (nothing is "
            "downloaded); pass weights_path=<local dir>")
    return weights_path


class CLIPTextEmbedder:
    """Frozen CLIP text encoder (FrozenCLIPEmbedder capability,
    modules.py:92-140) from a local snapshot on ``device`` (default
    ``"cuda"``). Returns the last hidden states [B, max_length, D] for
    cross-attention conditioning."""

    def __init__(self, weights_path: str, max_length: int = 77, device=None):
        self.device = resolve_device(device)
        path = _require_snapshot(weights_path)
        self.tokenizer = CLIPTokenizer.from_pretrained(path)
        self.model = load_clip_tower(path, "text", self.device)
        self.max_length = max_length

    def __call__(self, texts: list[str]) -> torch.Tensor:
        ids = self.tokenizer(texts, self.max_length).to(self.device)
        with torch.inference_mode():
            return self.model(ids)


class CLIPImageEmbedder:
    """Frozen CLIP image encoder (FrozenOpenCLIPImageEmbedder capability,
    modules.py:240-320) from a local snapshot on ``device`` (default
    ``"cuda"``). Returns pooled image embeddings [B, D] for 'adm'
    conditioning."""

    def __init__(self, weights_path: str, device=None):
        self.device = resolve_device(device)
        self.model = load_clip_tower(_require_snapshot(weights_path), "vision",
                                     self.device)

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] in [-1, 1], handed to the tower as NCHW
        pixels without CLIP's normalisation, as the JAX wrapper does."""
        pixels = images.to(self.device, torch.float32).permute(0, 3, 1, 2)
        with torch.inference_mode():
            return self.model(pixels)
