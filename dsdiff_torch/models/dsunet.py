"""DS-Diff: the 4-stream disentangled conditional diffusion U-Net.

Port of the JAX package's ``models/dsunet.py`` with ``stream_mode='sequential'``
(four dense per-stream encoders ``encoder_{s}``) and ``fusion='concat'``:

- the input is channel-stacked ``[noise, anatomy, anatomy+lesion, lesion]``;
  2 or 3 channels zero-pad the missing streams;
- ``use_edge``: the last input channel is an edge map concatenated onto the
  noise stream's stem only;
- only the noise stream passes the middle block;
- ``FeatureDisentangle`` heads run with their streams folded into the batch;
- stream means through ``_SEProj``, concat + SiLU + ``all_proj`` 1x1 back
  into the trunk; decoder skips are the mean over the four encoders' skips;
- returns ``(prediction, features)``, both NHWC; each feature group is a
  stacked [k, B, h, w, c] tensor;
- ``remat`` checkpoints every ``ResBlock`` of the encoders, middle and
  decoder while training.

``stream_mode='vmap'`` (ROADMAP A11) and ``fusion='crossattn'`` (ROADMAP
A17) are not ported yet.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .backbone import OutHead, UNetDecoder, UNetEncoder, UNetMiddle
from .layers import Conv, GroupNorm32, SEBlock, TimeEmbed

__all__ = ["DSUNet"]

N_STREAMS = 4  # noise, anatomy, anatomy+lesion, lesion


class FeatureDisentangle(nn.Module):
    """Residual GN-SiLU-3x3 conv, then GN-SiLU-1x1 projection to half
    channels."""

    def __init__(self, channels: int, half_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = GroupNorm32(channels)
        self.conv1 = Conv(channels, channels, 3, padding=1, dtype=dtype)
        self.norm2 = GroupNorm32(channels)
        self.conv2 = Conv(channels, half_channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x))) + x
        return self.conv2(F.silu(self.norm2(h)))


class _SEProj(nn.Module):
    """SE gate + 3x3 conv."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.se = SEBlock(channels, reduction=8, dtype=dtype)
        self.conv = Conv(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.se(x))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """[..., C, H, W] -> [..., H, W, C] (a view)."""
    return x.movedim(-3, -1)


class DSUNet(nn.Module):
    def __init__(
        self,
        in_channels: int = 4,
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
        use_fft_attention: bool = False,
        fusion: str = "concat",
        stream_mode: str = "sequential",
        use_edge: bool = False,
        remat: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if stream_mode != "sequential":
            raise NotImplementedError(
                f"stream_mode='{stream_mode}' is not ported yet (ROADMAP A11)"
            )
        if fusion != "concat":
            raise NotImplementedError(
                f"fusion='{fusion}' is not ported yet (ROADMAP A17)"
            )
        self.use_edge = use_edge
        self.n_channels = in_channels - (1 if use_edge else 0)
        if self.n_channels not in (2, 3, N_STREAMS):
            raise ValueError(
                f"DSUNet expects 2-4 input channels"
                f"{' plus an edge channel' if use_edge else ''}, "
                f"got {in_channels}"
            )
        ch0 = model_channels
        kw = dict(
            model_channels=ch0,
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
            remat=remat,
            dtype=dtype,
        )
        self.time_embed = TimeEmbed(ch0, 4 * ch0, dtype=dtype)
        for s in range(N_STREAMS):
            stem = 2 if (s == 0 and use_edge) else 1
            self.add_module(f"encoder_{s}", UNetEncoder(stem, **kw))
        enc = self.encoder_0
        conv_ch = enc.out_channels
        half = conv_ch // 2
        self.middle = UNetMiddle(conv_ch, **kw)
        self.conv_style = FeatureDisentangle(conv_ch, half, dtype)
        self.conv_content = FeatureDisentangle(conv_ch, half, dtype)
        self.conv_anatomy = FeatureDisentangle(conv_ch, half, dtype)
        self.conv_lesion = FeatureDisentangle(conv_ch, half, dtype)
        self.style_proj = _SEProj(half, dtype)
        self.share_content_proj = _SEProj(half, dtype)
        self.anatomy_proj = _SEProj(half, dtype)
        self.lesion_proj = _SEProj(half, dtype)
        self.all_proj = Conv(conv_ch + 4 * half, conv_ch, 1, dtype=dtype)
        self.decoder = UNetDecoder(conv_ch, enc.skip_channels, **kw)
        self.out = OutHead(self.decoder.out_channels, out_channels, dtype)

    def _streams(self, x: torch.Tensor) -> list[torch.Tensor]:
        """NCHW input -> the four per-stream NCHW maps."""
        edge = None
        if self.use_edge:
            edge = x[:, -1:]
            x = x[:, :-1]
        zero = torch.zeros_like(x[:, 0:1])
        C = x.shape[1]
        if C != self.n_channels:
            raise ValueError(f"expected {self.n_channels} stream channels, got {C}")
        streams = [x[:, i : i + 1] for i in range(C)]
        streams += [zero] * (N_STREAMS - C)
        if edge is not None:
            streams[0] = torch.cat([streams[0], edge], dim=1)
        return streams

    def forward(self, x: torch.Tensor, t: torch.Tensor):
        """x [B, H, W, C] NHWC, t [B] -> (out [B, H, W, out] f32, features)."""
        B = x.shape[0]
        streams = self._streams(x.permute(0, 3, 1, 2))
        emb = self.time_embed(t)
        outs = [
            getattr(self, f"encoder_{s}")(streams[s], emb)
            for s in range(N_STREAMS)
        ]
        h_n = self.middle(outs[0][0], emb)
        h_a, h_al, h_l = outs[1][0], outs[2][0], outs[3][0]

        def apply_head(head, xs):
            # fold k stream applications into the batch: one call per head
            k = len(xs)
            out = head(torch.cat(xs, dim=0))
            return out.reshape((k, B) + out.shape[1:])

        styles4 = apply_head(self.conv_style, [h_n, h_a, h_al, h_l])
        contents4 = apply_head(self.conv_content, [h_n, h_a, h_al, h_l])
        anat2 = apply_head(self.conv_anatomy, [h_a, h_al])
        les2 = apply_head(self.conv_lesion, [h_al, h_l])

        h_n_style, style_list = styles4[0], styles4[1:]  # a, al, l styles
        h_n_content, content_list = contents4[0], contents4[1:]

        h_style = self.style_proj(style_list.mean(dim=0))
        h_share_content = self.share_content_proj(content_list.mean(dim=0))
        h_anatomy = self.anatomy_proj(anat2.mean(dim=0))
        h_lesion = self.lesion_proj(les2.mean(dim=0))

        fused = torch.cat(
            [h_n, h_share_content, h_style, h_anatomy, h_lesion], dim=1
        )
        h = self.all_proj(F.silu(fused))

        # decoder with mean-of-streams skips
        skips = [torch.stack(parts).mean(dim=0)
                 for parts in zip(*[o[1] for o in outs])]
        h = self.decoder(h, skips, emb)
        out = self.out(h)

        features = {
            "style": _nhwc(style_list),      # [3, B, ...] a/al/l
            "content": _nhwc(content_list),  # [3, B, ...]
            "anatomy": _nhwc(anat2),         # [2, B, ...] a/al
            "lesion": _nhwc(les2),           # [2, B, ...] al/l
            "n_style_content": _nhwc(torch.stack(
                [h_style, h_n_style, h_share_content, h_n_content]
            )),                              # [4, B, ...]
        }
        return _nhwc(out), features
