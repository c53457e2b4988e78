"""SD/OpenAI-style conditional diffusion U-Net.

Port of the JAX package's ``models/unet.py:29-99 UNet``: the shared encoder,
middle and decoder of ``backbone.py``, with optional class (``num_classes``:
a label embedding) or vector (``adm_in_channels``: ``adm_fc1`` -> SiLU ->
``adm_fc2``) conditioning added to the time embedding. ``learn_sigma`` is
the caller doubling ``out_channels``; conditioning by concatenation is the
caller stacking channels into ``x``. With ``use_spatial_transformer``
(``use_fft_attention``: their FFT form) the attention blocks are
``SpatialTransformer``s whose second attention reads ``context`` [B, M,
``context_dim``] (the ``crossattn``, ``hybrid`` and ``crossattn-adm`` modes
of ``wrapper.conditioned_call``); without a context it attends over the map
itself. Without a spatial transformer ``context`` is taken and, as in the
JAX package, not read.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .backbone import OutHead, UNetDecoder, UNetEncoder, UNetMiddle
from .layers import Dense, TimeEmbed

__all__ = ["UNet"]


class UNet(nn.Module):
    def __init__(
        self,
        in_channels: int = 1,
        model_channels: int = 96,
        out_channels: int = 1,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (4, 8),
        dropout: float = 0.0,
        channel_mult: Sequence[int] = (1, 2, 4, 8),
        conv_resample: bool = True,
        num_heads: int = 8,
        num_head_channels: int = -1,
        use_scale_shift_norm: bool = False,
        resblock_updown: bool = False,
        use_spatial_transformer: bool = False,
        transformer_depth: int = 1,
        context_dim: int | None = None,
        use_fft_attention: bool = False,
        num_classes: int | None = None,
        adm_in_channels: int | None = None,
        remat: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        kw = dict(
            model_channels=model_channels,
            num_res_blocks=num_res_blocks,
            attention_resolutions=tuple(attention_resolutions),
            dropout=dropout,
            channel_mult=tuple(channel_mult),
            conv_resample=conv_resample,
            num_heads=num_heads,
            num_head_channels=num_head_channels,
            use_scale_shift_norm=use_scale_shift_norm,
            resblock_updown=resblock_updown,
            use_spatial_transformer=use_spatial_transformer,
            transformer_depth=transformer_depth,
            use_fft_attention=use_fft_attention,
            context_dim=context_dim,
            remat=remat,
            dtype=dtype,
        )
        time_dim = 4 * model_channels
        self.dtype = dtype
        self.num_classes = num_classes
        self.adm_in_channels = adm_in_channels
        self.time_embed = TimeEmbed(model_channels, time_dim, dtype=dtype)
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, time_dim)
        elif adm_in_channels is not None:
            self.adm_fc1 = Dense(adm_in_channels, time_dim, dtype=dtype)
            self.adm_fc2 = Dense(time_dim, time_dim, dtype=dtype)
        self.encoder = UNetEncoder(in_channels, **kw)
        ch = self.encoder.out_channels
        self.middle = UNetMiddle(ch, **kw)
        self.decoder = UNetDecoder(ch, self.encoder.skip_channels, **kw)
        self.out = OutHead(self.decoder.out_channels, out_channels, dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor | None = None,
                y: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, H, W, C] NHWC, t [B], context [B, M, context_dim] or None
        (y: class indices [B] or adm vectors [B, adm_in_channels]) ->
        [B, H, W, out] f32."""
        emb = self.time_embed(t)
        if self.num_classes is not None:
            if y is None:
                raise ValueError("class-conditional model needs y")
            emb = emb + self.label_emb(y).to(self.dtype)
        elif self.adm_in_channels is not None:
            if y is None:
                raise ValueError("adm-conditional model needs vector y")
            emb = emb + self.adm_fc2(F.silu(self.adm_fc1(y)))
        h, skips = self.encoder(x.permute(0, 3, 1, 2), emb, context)
        h = self.middle(h, emb, context)
        h = self.decoder(h, skips, emb, context)
        return self.out(h).permute(0, 2, 3, 1)
