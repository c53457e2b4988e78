"""DS-Diff: the 4-stream disentangled conditional diffusion U-Net.

Port of the JAX package's ``models/dsunet.py``, in both stream layouts:
``stream_mode='sequential'`` (four dense per-stream
encoders ``encoder_{s}``) and ``'vmap'`` (one ``encoders`` subtree whose
parameters carry a leading [4] stream axis; it runs stream by stream on the
slices, and under ``use_edge`` every stream is padded to the noise stem's
two channels):

- the input is channel-stacked ``[noise, anatomy, anatomy+lesion, lesion]``;
  2 or 3 channels zero-pad the missing streams;
- ``use_edge``: the last input channel is an edge map concatenated onto the
  noise stream's stem only;
- only the noise stream passes the middle block;
- ``FeatureDisentangle`` heads run with their streams folded into the batch;
- stream means through ``_SEProj``; ``fusion='concat'``: concat + SiLU +
  ``all_proj`` 1x1 back into the trunk; ``fusion='crossattn'`` (the
  reference's cross-attention variant): the four projected features as
  [B, h*w, half] tokens, in the order share_content, style, anatomy,
  lesion, joined on the token axis, are the context of a depth-4
  ``SpatialTransformer`` ``fusion_attn`` over the noise stream's bottleneck
  (heads ``max(num_heads, 1)`` of ``conv_ch // heads``: 8 of 36 at the
  flagship's C = 96); decoder skips are the mean over the four encoders'
  skips;
- ``use_spatial_transformer`` / ``use_fft_attention``: the backbone's
  attention blocks become transformers (``backbone.py``);
- returns ``(prediction, features)``, both NHWC; each feature group is a
  stacked [k, B, h, w, c] tensor;
- ``remat`` checkpoints every ``ResBlock`` of the encoders, middle and
  decoder while training.

``DSTrunk`` holds what ``DSUNetSplit`` (``dsunet_cached.py``, concat
fusion only, as in the JAX package) shares with this model.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import span
from .backbone import (
    OutHead,
    StackedUNetEncoder,
    UNetDecoder,
    UNetEncoder,
    UNetMiddle,
)
from .attention import SpatialTransformer
from .layers import Conv, GroupNorm32, SEBlock, TimeEmbed

__all__ = ["DSUNet", "DSTrunk", "FUSIONS"]

N_STREAMS = 4  # noise, anatomy, anatomy+lesion, lesion
FUSIONS = ("concat", "crossattn")
FUSION_DEPTH = 4  # the cross-attention fusion's transformer blocks


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


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H*W, C], positions in row-major order."""
    return x.flatten(2).transpose(1, 2)


class DSTrunk(nn.Module):
    """What the DS-Diff models share after their encoders: the time
    embedding, the noise stream's middle block, the four disentangle heads,
    the four SE projections, ``all_proj``, the decoder and the out head."""

    @property
    def stacked_prefixes(self) -> tuple[str, ...]:
        """The parameters under these prefixes carry a leading stream axis."""
        return tuple(f"{name}." for name, child in self.named_children()
                     if isinstance(child, StackedUNetEncoder))

    def _build_trunk(self, encoder: UNetEncoder, out_channels: int, kw: dict,
                     fusion: str = "concat"):
        if fusion not in FUSIONS:
            raise ValueError(f"unknown fusion '{fusion}' (have {FUSIONS})")
        self.fusion = fusion
        dtype = kw["dtype"]
        ch0 = kw["model_channels"]
        conv_ch = encoder.out_channels
        half = conv_ch // 2
        self.time_embed = TimeEmbed(ch0, 4 * ch0, dtype=dtype)
        self.middle = UNetMiddle(conv_ch, **kw)
        self.conv_style = FeatureDisentangle(conv_ch, half, dtype)
        self.conv_content = FeatureDisentangle(conv_ch, half, dtype)
        self.conv_anatomy = FeatureDisentangle(conv_ch, half, dtype)
        self.conv_lesion = FeatureDisentangle(conv_ch, half, dtype)
        self.style_proj = _SEProj(half, dtype)
        self.share_content_proj = _SEProj(half, dtype)
        self.anatomy_proj = _SEProj(half, dtype)
        self.lesion_proj = _SEProj(half, dtype)
        if fusion == "concat":
            self.all_proj = Conv(conv_ch + 4 * half, conv_ch, 1, dtype=dtype)
        else:
            heads = max(kw["num_heads"], 1)
            self.fusion_attn = SpatialTransformer(
                conv_ch, depth=FUSION_DEPTH, heads=heads,
                dim_head=conv_ch // heads, context_dim=half, dtype=dtype)
        self.decoder = UNetDecoder(conv_ch, encoder.skip_channels, **kw)
        self.out = OutHead(self.decoder.out_channels, out_channels, dtype)

    def _fuse_and_decode(self, h_n, h_cond, skips, emb, context=None):
        """h_n: the noise stream after the middle block; h_cond: the three
        condition streams' bottlenecks (a, al, l); skips: the decoder's skip
        stack; context: the backbone transformers' (or None). Returns (out
        NHWC f32, features)."""
        B = h_n.shape[0]
        h_a, h_al, h_l = h_cond

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

        if self.fusion == "crossattn":
            ctx = torch.cat([_tokens(f) for f in (h_share_content, h_style,
                                                   h_anatomy, h_lesion)], dim=1)
            h = self.fusion_attn(h_n, ctx)
        else:
            fused = torch.cat(
                [h_n, h_share_content, h_style, h_anatomy, h_lesion], dim=1
            )
            h = self.all_proj(F.silu(fused))
        h = self.decoder(h, skips, emb, context)
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


class DSUNet(DSTrunk):
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
        if stream_mode not in ("sequential", "vmap"):
            raise ValueError(f"unknown stream_mode '{stream_mode}'")
        self.use_edge = use_edge
        self.stream_mode = stream_mode
        self.n_channels = in_channels - (1 if use_edge else 0)
        if self.n_channels not in (2, 3, N_STREAMS):
            raise ValueError(
                f"DSUNet expects 2-4 input channels"
                f"{' plus an edge channel' if use_edge else ''}, "
                f"got {in_channels}"
            )
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
            remat=remat,
            dtype=dtype,
        )
        noise_stem = 2 if use_edge else 1
        if stream_mode == "sequential":
            for s in range(N_STREAMS):
                self.add_module(
                    f"encoder_{s}",
                    UNetEncoder(noise_stem if s == 0 else 1, **kw),
                )
            encoder = self.encoder_0
        else:
            # the streams share one stem width: under use_edge the
            # condition streams get a zero channel beside their own
            self.encoders = StackedUNetEncoder(N_STREAMS, noise_stem, **kw)
            encoder = self.encoders
        self._build_trunk(encoder, out_channels, kw, fusion)

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
            if self.stream_mode == "vmap":
                streams[1:] = [torch.cat([s, zero], dim=1)
                               for s in streams[1:]]
        return streams

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor | None = None):
        """x [B, H, W, C] NHWC, t [B] -> (out [B, H, W, out] f32, features).
        ``context`` [B, M, C'] reaches the backbone's transformers, as in the
        JAX package (without ``context_dim`` here, C' is each transformer's
        own width)."""
        streams = self._streams(x.permute(0, 3, 1, 2))
        emb = self.time_embed(t)
        with span("model.encoders"):
            if self.stream_mode == "sequential":
                outs = [
                    getattr(self, f"encoder_{s}")(streams[s], emb, context)
                    for s in range(N_STREAMS)
                ]
            else:
                outs = self.encoders.encode_streams(streams, emb, context)
        h_n = self.middle(outs[0][0], emb, context)
        # decoder with mean-of-streams skips
        skips = [torch.stack(parts).mean(dim=0)
                 for parts in zip(*[o[1] for o in outs])]
        return self._fuse_and_decode(
            h_n, [o[0] for o in outs[1:]], skips, emb, context
        )
