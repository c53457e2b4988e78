"""DisC-Diff's DiscUNet (``model: disc_unet``) in plain f32 PyTorch: a
frozen copy of the port's ``models/disc_unet.py`` (layout 'sequential'),
one encoder stream per input channel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import (Conv, Decoder, Encoder, Middle,
                                        OutHead, SEBlock, TimeEmbed)
from benchmark.reference.models import (in_channels, nhwc, out_channels,
                                        stage_kw, unet_tiny)


def build(config: dict) -> nn.Module:
    return DiscUNet(config["trainer"]["unet_config"]["params"],
                    in_channels(config), out_channels(config))


def tiny(config: dict) -> dict:
    return unet_tiny(config)


class _ConvSiLU(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv(cin, cout, 3, padding=1)

    def forward(self, x):
        return F.silu(self.conv(x))


class DiscUNet(nn.Module):
    """One encoder per input channel; shared common / distinct heads over
    the bottlenecks, SE gates, concat + 1x1 reduction, then the middle
    block (after the fusion, unlike DSUNet) and the decoder over the mean
    of the encoders' skips."""

    def __init__(self, params: dict, n_streams: int, out_channels: int):
        super().__init__()
        kw = stage_kw(params)
        self.n_streams = n_streams
        ch0 = kw["model_channels"]
        self.time_embed = TimeEmbed(ch0, 4 * ch0)
        for s in range(n_streams):
            self.add_module(f"encoder_{s}", Encoder(1, **kw))
        conv_ch = self.encoder_0.out_channels
        half = conv_ch // 2
        self.conv_common = _ConvSiLU(conv_ch, half)
        self.conv_distinct = _ConvSiLU(conv_ch, half)
        self.se_com = SEBlock(half, 8)
        for i in range(n_streams):
            self.add_module(f"se_dist_{i}", SEBlock(half, 8))
        self.dim_reduction = Conv((n_streams + 1) * half, conv_ch, 1)
        self.middle = Middle(conv_ch, **kw)
        self.decoder = Decoder(conv_ch, self.encoder_0.skip_channels, **kw)
        self.out = OutHead(self.decoder.out_channels, out_channels)

    def forward(self, x, t):
        B, n = x.shape[0], self.n_streams
        xc = x.permute(0, 3, 1, 2)
        emb = self.time_embed(t)
        outs = [getattr(self, f"encoder_{s}")(xc[:, s:s + 1], emb)
                for s in range(n)]
        h_all = torch.cat([o[0] for o in outs], dim=0)
        com = self.conv_common(h_all)
        dist = self.conv_distinct(h_all)
        com = com.reshape((n, B) + com.shape[1:])
        dist = dist.reshape((n, B) + dist.shape[1:])
        com_h = self.se_com(com.mean(dim=0))
        dist_gated = [getattr(self, f"se_dist_{i}")(dist[i]) for i in range(n)]
        h = F.silu(self.dim_reduction(torch.cat([com_h] + dist_gated, dim=1)))
        h = self.middle(h, emb)
        skips = [torch.stack(parts).mean(dim=0)
                 for parts in zip(*[o[1] for o in outs])]
        out = self.out(self.decoder(h, skips, emb))
        features = {"common": nhwc(com),
                    "distinct": nhwc(torch.stack(dist_gated))}
        return nhwc(out), features
