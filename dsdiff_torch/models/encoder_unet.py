"""Encoder-half U-Net classifier for classifier guidance.

Port of the JAX package's ``models/encoder_unet.py``: the diffusion U-Net's
encoder and middle block, then GroupNorm + SiLU and a pooled
classification head. Pools: ``adaptive`` (global mean), ``attention``
(softmax over the tokens against a learned ``pool_query``) and ``spatial``
(flatten + ``spatial_fc`` to 2048 + ReLU; a Flax Dense infers its input
width, so this one needs ``image_size``). Its attention blocks run the
attention kernel on a card, and ``classifier_gradient`` differentiates the
classifier through the kernel's ``autograd.Function``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .backbone import UNetEncoder, UNetMiddle
from .layers import Dense, GroupNorm32, TimeEmbed

__all__ = ["EncoderUNet", "classifier_gradient", "POOLS"]

POOLS = ("adaptive", "attention", "spatial")


class EncoderUNet(nn.Module):
    def __init__(
        self,
        in_channels: int = 1,
        num_classes: int = 2,
        model_channels: int = 64,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (8, 16),
        channel_mult: Sequence[int] = (1, 2, 4, 8),
        num_heads: int = 4,
        num_head_channels: int = -1,
        use_scale_shift_norm: bool = True,
        pool: str = "adaptive",
        image_size: int | None = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if pool not in POOLS:
            raise ValueError(f"unknown pool '{pool}' (have {POOLS})")
        self.pool = pool
        self.dtype = dtype
        kw = dict(
            model_channels=model_channels,
            num_res_blocks=num_res_blocks,
            attention_resolutions=tuple(attention_resolutions),
            channel_mult=tuple(channel_mult),
            num_heads=num_heads,
            num_head_channels=num_head_channels,
            use_scale_shift_norm=use_scale_shift_norm,
            dtype=dtype,
        )
        self.time_embed = TimeEmbed(model_channels, 4 * model_channels,
                                    dtype=dtype)
        self.encoder = UNetEncoder(in_channels, **kw)
        ch = self.encoder.out_channels
        self.middle = UNetMiddle(ch, **kw)
        self.out_norm = GroupNorm32(ch)
        width = ch
        if pool == "attention":
            self.pool_query = nn.Parameter(torch.randn(ch) * 0.02)
        elif pool == "spatial":
            if image_size is None:
                raise ValueError("pool='spatial' needs image_size")
            side = image_size // 2 ** (len(channel_mult) - 1)
            self.spatial_fc = Dense(ch * side * side, 2048, dtype=dtype)
            width = 2048
        self.out = Dense(width, num_classes, dtype=dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C] NHWC, t [B] -> logits [B, num_classes] f32."""
        emb = self.time_embed(t)
        h, _ = self.encoder(x.permute(0, 3, 1, 2), emb)
        h = self.middle(h, emb)
        h = F.silu(self.out_norm(h))
        if self.pool == "adaptive":
            v = h.mean(dim=(2, 3))
        elif self.pool == "attention":
            B, C = h.shape[:2]
            tokens = h.float().flatten(2).transpose(1, 2)  # [B, HW, C]
            att = torch.softmax(tokens @ self.pool_query / math.sqrt(C),
                                dim=-1)
            v = torch.einsum("bn,bnc->bc", att, tokens)
        else:  # flattened in the JAX package's NHWC order
            v = F.relu(self.spatial_fc(h.permute(0, 2, 3, 1).flatten(1)))
        return self.out(v).float()


def classifier_gradient(model: nn.Module, x: torch.Tensor, t: torch.Tensor,
                        y: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """grad_x log p(y | x) * scale, the guided-diffusion classifier's cond_fn.

    Differentiates the classifier even where the caller runs under
    ``torch.inference_mode`` (a serving request): the classifier's forward
    and backward are built outside it, on a copy of x."""
    with torch.inference_mode(False), torch.enable_grad():
        x_in = x.detach().clone().requires_grad_(True)
        logits = model(x_in, t.clone())
        logp = torch.log_softmax(logits, dim=-1)
        chosen = logp.gather(1, y.clone().long()[:, None]).sum()
        (grad,) = torch.autograd.grad(chosen, x_in)
    return grad * scale
