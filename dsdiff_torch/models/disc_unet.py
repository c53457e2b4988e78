"""DisC-Diff multi-stream U-Net with common/distinct disentanglement.

Port of the JAX package's ``models/disc_unet.py:53-159 DiscUNet``: one
encoder per input channel (``n_streams``), in both stream layouts,
``stream_mode='sequential'`` (dense per-stream encoders ``encoder_{s}``) and
``'vmap'`` (one ``encoders`` subtree whose parameters carry a leading
[n_streams] axis, run stream by stream on the slices); decoder skips are the
stream mean; each stream's bottleneck passes the shared ``conv_common`` and
``conv_distinct`` 3x3+SiLU heads (the streams folded into the batch), the
common mean one SE gate (``se_com``), each distinct feature its own
(``se_dist_{i}``), then concat + 1x1 ``dim_reduction`` + SiLU feed the
middle block, which runs AFTER fusion here, unlike DSUNet. Returns
``(out, {'common': [n, B, h, w, c], 'distinct': [n, B, h, w, c]})``, NHWC.
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
from .layers import Conv, SEBlock, TimeEmbed

__all__ = ["DiscUNet"]


class _ConvSiLU(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, kernel,
                         padding=kernel // 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.conv(x))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """[..., C, H, W] -> [..., H, W, C] (a view)."""
    return x.movedim(-3, -1)


class DiscUNet(nn.Module):
    def __init__(
        self,
        n_streams: int = 4,
        model_channels: int = 96,
        out_channels: int = 1,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (8, 16),
        dropout: float = 0.0,
        channel_mult: Sequence[int] = (1, 2, 4, 8),
        conv_resample: bool = True,
        num_heads: int = 4,
        num_head_channels: int = -1,
        use_scale_shift_norm: bool = True,
        resblock_updown: bool = False,
        stream_mode: str = "sequential",
        remat: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if stream_mode not in ("sequential", "vmap"):
            raise ValueError(f"unknown stream_mode '{stream_mode}'")
        self.n_streams = n_streams
        self.stream_mode = stream_mode
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
            remat=remat,
            dtype=dtype,
        )
        self.time_embed = TimeEmbed(model_channels, 4 * model_channels,
                                    dtype=dtype)
        if stream_mode == "sequential":
            for s in range(n_streams):
                self.add_module(f"encoder_{s}", UNetEncoder(1, **kw))
            encoder = self.encoder_0
        else:
            self.encoders = StackedUNetEncoder(n_streams, 1, **kw)
            encoder = self.encoders
        conv_ch = encoder.out_channels
        half = conv_ch // 2
        self.conv_common = _ConvSiLU(conv_ch, half, dtype=dtype)
        self.conv_distinct = _ConvSiLU(conv_ch, half, dtype=dtype)
        self.se_com = SEBlock(half, reduction=8, dtype=dtype)
        for i in range(n_streams):
            self.add_module(f"se_dist_{i}", SEBlock(half, reduction=8,
                                                    dtype=dtype))
        self.dim_reduction = Conv((n_streams + 1) * half, conv_ch, 1,
                                  dtype=dtype)
        self.middle = UNetMiddle(conv_ch, **kw)
        self.decoder = UNetDecoder(conv_ch, encoder.skip_channels, **kw)
        self.out = OutHead(self.decoder.out_channels, out_channels, dtype)

    @property
    def stacked_prefixes(self) -> tuple[str, ...]:
        """The parameters under these prefixes carry a leading stream axis."""
        return ("encoders.",) if self.stream_mode == "vmap" else ()

    def forward(self, x: torch.Tensor, t: torch.Tensor):
        """x [B, H, W, n_streams] NHWC, t [B] -> (out [B, H, W, out] f32,
        features)."""
        B, _, _, C = x.shape
        n = self.n_streams
        if C != n:
            raise ValueError(
                f"DiscUNet({n} streams) expects {n} channels, got {C}")
        xc = x.permute(0, 3, 1, 2)
        streams = [xc[:, i : i + 1] for i in range(n)]
        emb = self.time_embed(t)
        with span("model.encoders"):
            if self.stream_mode == "sequential":
                outs = [getattr(self, f"encoder_{s}")(streams[s], emb)
                        for s in range(n)]
            else:
                outs = self.encoders.encode_streams(streams, emb)
        # the shared heads run once over all streams folded into the batch
        h_all = torch.cat([o[0] for o in outs], dim=0)
        com = self.conv_common(h_all)
        dist = self.conv_distinct(h_all)
        com = com.reshape((n, B) + com.shape[1:])
        dist = dist.reshape((n, B) + dist.shape[1:])

        com_h = self.se_com(com.mean(dim=0))
        dist_gated = [getattr(self, f"se_dist_{i}")(dist[i]) for i in range(n)]
        h = torch.cat([com_h] + dist_gated, dim=1)
        h = F.silu(self.dim_reduction(h))

        h = self.middle(h, emb)
        skips = [torch.stack(parts).mean(dim=0)
                 for parts in zip(*[o[1] for o in outs])]
        h = self.decoder(h, skips, emb)
        out = self.out(h)
        features = {"common": _nhwc(com),
                    "distinct": _nhwc(torch.stack(dist_gated))}
        return _nhwc(out), features
