"""DiT diffusion transformer with conditional channel-concat.

Port of the JAX package's ``models/dit.py:36-195``: ``DiT``, ``DIT_CONFIGS``
and ``make_dit``.

- Patchify by a strided conv, a fixed 2D sin-cos positional embedding (this
  package's own copy of ``_sincos_2d_pos_embed``), tokens in (row, column)
  order of the patch grid.
- adaLN-Zero blocks: a 6-way modulation (shift, scale, gate twice) from
  SiLU of the conditioning embedding, zero-initialised, so each block
  starts as the identity; ``LayerNorm`` without scale or bias and eps 1e-6
  (Flax's default, not torch's 1e-5), statistics in f32; tanh GELU.
- The conditioning is the timestep embedding (256 wide, two Dense layers),
  plus a label embedding with ``num_classes`` (the null class is index
  ``num_classes``). While training, labels are dropped with probability
  ``class_dropout_prob`` for classifier-free guidance: by the mask given to
  ``forward``, or drawn from the generator that
  ``layers.dropout_generator`` binds.
- The final adaLN + zero-initialised linear head, unpatchified in the JAX
  order ([B, g, g, p, p, C] -> rows (g, p), columns (g, p)); f32 out.
- With ``remat``, each block runs under activation checkpointing while the
  module trains with grad enabled (in a ``model.remat`` span, as the
  U-Nets' ResBlocks); the arithmetic is the same either way.

Attention goes through ``ops.scaled_attention`` ([B, N, heads, D]: the qkv
projection's thirds as strided views).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import scaled_attention
from .backbone import _remat
from .layers import Conv, Dense, timestep_embedding, zero_init

__all__ = ["DiT", "DIT_CONFIGS", "make_dit"]

LN_EPS = 1e-6  # Flax LayerNorm's default


def _sincos_2d_pos_embed(dim: int, grid: int) -> np.ndarray:
    """Fixed 2D sin-cos positional embedding [grid*grid, dim]: the first
    half of the channels encodes the column, the second the row."""
    def _1d(d, pos):
        omega = np.arange(d // 2, dtype=np.float64) / (d / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    g = np.arange(grid, dtype=np.float32)
    gy, gx = np.meshgrid(g, g, indexing="ij")
    emb = np.concatenate([_1d(dim // 2, gx), _1d(dim // 2, gy)], axis=1)
    return emb.astype(np.float32)


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis without scale or bias, f32 statistics,
    back in x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=LN_EPS).to(x.dtype)


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class _DiTBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden, self.heads = hidden, heads
        inner = int(hidden * mlp_ratio)
        self.adaLN = zero_init(Dense(hidden, 6 * hidden, dtype=dtype))
        self.qkv = Dense(hidden, 3 * hidden, dtype=dtype)
        self.proj = Dense(hidden, hidden, dtype=dtype)
        self.mlp_fc1 = Dense(hidden, inner, dtype=dtype)
        self.mlp_fc2 = Dense(inner, hidden, dtype=dtype)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        sh1, sc1, g1, sh2, sc2, g2 = self.adaLN(F.silu(c)).chunk(6, dim=-1)
        h = _modulate(_layer_norm(x), sh1, sc1)
        B, N, _ = h.shape
        qkv = self.qkv(h).view(B, N, 3, self.heads, self.hidden // self.heads)
        attn = scaled_attention(*qkv.unbind(dim=2)).reshape(B, N, self.hidden)
        x = x + g1[:, None, :] * self.proj(attn)
        h = _modulate(_layer_norm(x), sh2, sc2)
        h = self.mlp_fc2(F.gelu(self.mlp_fc1(h), approximate="tanh"))
        return x + g2[:, None, :] * h


class DiT(nn.Module):
    def __init__(
        self,
        input_size: int = 32,
        patch_size: int = 8,
        in_channels: int = 1,
        out_channels: int = 1,
        hidden_size: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        num_classes: int | None = None,
        class_dropout_prob: float = 0.1,
        remat: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if input_size % patch_size:
            raise ValueError(f"input {input_size} is not a multiple of "
                             f"patch {patch_size}")
        self.input_size, self.patch_size = input_size, patch_size
        self.out_channels = out_channels
        self.num_classes = num_classes
        self.class_dropout_prob = class_dropout_prob
        self.remat = remat
        self.dtype = dtype
        # bound by ``dropout_generator`` for a train step
        self.generator: torch.Generator | None = None
        grid = input_size // patch_size
        self.patch_embed = Conv(in_channels, hidden_size, patch_size,
                                stride=patch_size, dtype=dtype)
        self.register_buffer(
            "pos_embed",
            torch.from_numpy(_sincos_2d_pos_embed(hidden_size, grid)),
            persistent=False,
        )
        self.t_fc1 = Dense(256, hidden_size, dtype=dtype)
        self.t_fc2 = Dense(hidden_size, hidden_size, dtype=dtype)
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes + 1, hidden_size)
        for i in range(depth):
            self.add_module(f"block_{i}", _DiTBlock(hidden_size, num_heads,
                                                    mlp_ratio, dtype))
        self.depth = depth
        self.final_adaLN = zero_init(Dense(hidden_size, 2 * hidden_size,
                                           dtype=dtype))
        self.final_proj = zero_init(Dense(
            hidden_size, patch_size * patch_size * out_channels, dtype=dtype))

    def label_drop_mask(self, y: torch.Tensor) -> torch.Tensor:
        """The labels a training forward drops [B] (True: the null class),
        each with probability ``class_dropout_prob``, from the bound
        generator."""
        if self.generator is None:
            raise RuntimeError("DiT label dropout needs a mask or a generator "
                               "bound by dropout_generator")
        return torch.rand(y.shape, generator=self.generator,
                          device=y.device) < self.class_dropout_prob

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: torch.Tensor | None = None,
                drop: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, H, W, C] NHWC with H = W = input_size, t [B], y class
        indices [B] (with ``num_classes``); ``drop`` [B] bool, the labels to
        drop while training (drawn when None) -> [B, H, W, out] f32."""
        B, H, W, _ = x.shape
        p = self.patch_size
        if not H == W == self.input_size:
            raise ValueError(f"DiT({self.input_size}²) got {H}x{W}")
        g = H // p
        cd = self.dtype
        h = self.patch_embed(x.permute(0, 3, 1, 2))
        h = h.flatten(2).transpose(1, 2) + self.pos_embed.to(cd)[None]

        c = self.t_fc2(F.silu(self.t_fc1(timestep_embedding(t, 256))))
        if self.num_classes is not None:
            if y is None:
                raise ValueError("class-conditional DiT needs y")
            if self.training and self.class_dropout_prob > 0:
                if drop is None:
                    drop = self.label_drop_mask(y)
                y = torch.where(drop, torch.full_like(y, self.num_classes), y)
            c = c + self.label_emb(y).to(cd)

        remat = self.remat and self.training and torch.is_grad_enabled()
        for i in range(self.depth):
            block = getattr(self, f"block_{i}")
            h = (checkpoint(_remat, block, h, c, use_reentrant=False)
                 if remat else block(h, c))

        sh, sc = self.final_adaLN(F.silu(c)).chunk(2, dim=-1)
        h = self.final_proj(_modulate(_layer_norm(h), sh, sc))
        C = self.out_channels
        h = h.reshape(B, g, g, p, p, C).permute(0, 1, 3, 2, 4, 5)
        return h.reshape(B, H, W, C).float()


# the size registry of the reference's DiT_models
DIT_CONFIGS = {
    "DiT_XL_2": dict(depth=28, hidden_size=1152, patch_size=2, num_heads=16),
    "DiT_XL_4": dict(depth=28, hidden_size=1152, patch_size=4, num_heads=16),
    "DiT_XL_8": dict(depth=28, hidden_size=1152, patch_size=8, num_heads=16),
    "DiT_L_2": dict(depth=24, hidden_size=1024, patch_size=2, num_heads=16),
    "DiT_L_4": dict(depth=24, hidden_size=1024, patch_size=4, num_heads=16),
    "DiT_L_8": dict(depth=24, hidden_size=1024, patch_size=8, num_heads=16),
    "DiT_B_2": dict(depth=12, hidden_size=768, patch_size=2, num_heads=12),
    "DiT_B_4": dict(depth=12, hidden_size=768, patch_size=4, num_heads=12),
    "DiT_B_8": dict(depth=12, hidden_size=768, patch_size=8, num_heads=12),
    "DiT_S_2": dict(depth=12, hidden_size=384, patch_size=2, num_heads=6),
    "DiT_S_4": dict(depth=12, hidden_size=384, patch_size=4, num_heads=6),
    "DiT_S_8": dict(depth=12, hidden_size=384, patch_size=8, num_heads=6),
}


def make_dit(name: str, **kw) -> DiT:
    return DiT(**{**DIT_CONFIGS[name], **kw})
