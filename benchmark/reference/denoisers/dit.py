"""DiT (``model: dit``) in plain f32 PyTorch: Peebles & Xie, *Scalable
Diffusion Models with Transformers* (ICCV 2023), ``facebookresearch/DiT``
``models.py`` (``DiT_XL_8`` and its siblings), sized by the trainer block's
``ViT_config.params``.

- Patchify by a strided convolution, plus a fixed 2-D sin-cos position
  embedding (the first half of the channels encodes the patch's column, the
  second its row); tokens in row-major order of the patch grid.
- The condition c: a 256-wide frequency embedding of t through two linear
  layers with SiLU between.
- ``depth`` adaLN-Zero blocks: a 6-way shift / scale / gate from SiLU(c);
  LayerNorm with no affine and eps 1e-6; a fused qkv projection, softmax
  attention in ``num_heads`` heads, the output projection; an MLP of ratio 4
  with tanh GELU; each branch gated into the residual.
- A final adaLN layer and a linear head of patch² · C_out, unpatchified as
  published ([B, g, g, p, p, C] -> rows (g, p), columns (g, p)).

Where it departs from the published model, as the repository it ports runs
DiT: the conditions are joined to the chain on the channel axis (1 +
``n_cond`` input channels) and there are no class labels; the objective is
the repository's (v-parameterisation, Charbonnier + VB under
``learn_sigma``); the benchmark fills every parameter with seeded random
values, where the published adaLN-Zero layers and head start at zero.
Parameter names are the port's (``models/dit.py``). Every product goes
through ``benchmark/reference/layers.py`` (``Dense``, ``Conv``,
``plain_attention``), so the fp8 control rounds each one; under
``layers.PRECISION["remat"]`` each block is checkpointed while gradients are
on.
"""
from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from benchmark.reference.layers import (PRECISION, Conv, Dense,
                                        plain_attention, timestep_embedding)
from benchmark.reference.models import in_channels, out_channels

LN_EPS = 1e-6
FREQ_DIM = 256
MLP_RATIO = 4


def build(config: dict) -> nn.Module:
    vit = config["trainer"]["ViT_config"]["params"]
    return DiT(input_size=int(vit["input_size"]),
               patch_size=int(vit["patch_size"]),
               in_channels=in_channels(config),
               out_channels=out_channels(config),
               hidden=int(vit["hidden_size"]), depth=int(vit["depth"]),
               heads=int(vit["num_heads"]))


def tiny(config: dict) -> dict:
    """Two blocks of 144 in 2 heads of 72 (the published head width), patch
    8 over 32² images: 16 tokens."""
    cfg = copy.deepcopy(config)
    cfg["trainer"]["ViT_config"]["params"].update(
        input_size=32, patch_size=8, hidden_size=144, depth=2, num_heads=2)
    cfg["trainer"]["image_size"] = 32
    cfg["attention_calls"] = [[16, 2, 72, 2]]
    return cfg


def sincos_2d(dim: int, grid: int) -> torch.Tensor:
    """[grid², dim]: sin | cos of the column over the first half of the
    channels, of the row over the second, periods 10000^(k / (dim / 4))."""
    quarter = dim // 4
    omega = 1.0 / 10000 ** (torch.arange(quarter, dtype=torch.float64)
                            / quarter)
    pos = torch.arange(grid, dtype=torch.float64)
    row = pos.repeat_interleave(grid)
    col = pos.repeat(grid)

    def one(p):
        a = p[:, None] * omega[None, :]
        return torch.cat([torch.sin(a), torch.cos(a)], dim=1)

    return torch.cat([one(col), one(row)], dim=1).float()


def layer_norm(x):
    return F.layer_norm(x, x.shape[-1:], eps=LN_EPS)


def modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class DiTBlock(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.adaLN = Dense(hidden, 6 * hidden)
        self.qkv = Dense(hidden, 3 * hidden)
        self.proj = Dense(hidden, hidden)
        self.mlp_fc1 = Dense(hidden, MLP_RATIO * hidden)
        self.mlp_fc2 = Dense(MLP_RATIO * hidden, hidden)

    def forward(self, x, c):
        sh1, sc1, g1, sh2, sc2, g2 = self.adaLN(F.silu(c)).chunk(6, dim=-1)
        B, N, C = x.shape
        h = modulate(layer_norm(x), sh1, sc1)
        q, k, v = self.qkv(h).view(B, N, 3, self.heads,
                                   C // self.heads).unbind(2)
        x = x + g1[:, None, :] * self.proj(plain_attention(q, k, v)
                                           .reshape(B, N, C))
        h = modulate(layer_norm(x), sh2, sc2)
        h = self.mlp_fc2(F.gelu(self.mlp_fc1(h), approximate="tanh"))
        return x + g2[:, None, :] * h


class DiT(nn.Module):
    def __init__(self, input_size: int, patch_size: int, in_channels: int,
                 out_channels: int, hidden: int, depth: int, heads: int):
        super().__init__()
        self.patch, self.out_ch, self.depth = patch_size, out_channels, depth
        self.patch_embed = Conv(in_channels, hidden, patch_size,
                                stride=patch_size)
        self.register_buffer("pos_embed",
                             sincos_2d(hidden, input_size // patch_size),
                             persistent=False)
        self.t_fc1 = Dense(FREQ_DIM, hidden)
        self.t_fc2 = Dense(hidden, hidden)
        for i in range(depth):
            self.add_module(f"block_{i}", DiTBlock(hidden, heads))
        self.final_adaLN = Dense(hidden, 2 * hidden)
        self.final_proj = Dense(hidden, patch_size * patch_size * out_channels)

    def forward(self, x, t):
        B, H, W, _ = x.shape
        p, g = self.patch, H // self.patch
        h = self.patch_embed(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        h = h + self.pos_embed[None]
        c = self.t_fc2(F.silu(self.t_fc1(timestep_embedding(t, FREQ_DIM))))
        remat = PRECISION["remat"] and torch.is_grad_enabled()
        for i in range(self.depth):
            block = getattr(self, f"block_{i}")
            h = (checkpoint(block, h, c, use_reentrant=False) if remat
                 else block(h, c))
        sh, sc = self.final_adaLN(F.silu(c)).chunk(2, dim=-1)
        h = self.final_proj(modulate(layer_norm(h), sh, sc))
        h = h.reshape(B, g, g, p, p, self.out_ch).permute(0, 1, 3, 2, 4, 5)
        return h.reshape(B, H, W, self.out_ch), None
