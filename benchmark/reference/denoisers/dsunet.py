"""DS-Diff's 4-stream DSUNet (``model: dsunet``) in plain f32 PyTorch.

A frozen copy of the port's ``models/dsunet.py`` (stream layout
'sequential', fusion 'concat', no edge map, no transformer). Its features
are stream-major, as the disentangle losses read them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import (Conv, Decoder, Encoder, GroupNorm32,
                                        Middle, OutHead, SEBlock, TimeEmbed)
from benchmark.reference.models import (in_channels, nhwc, out_channels,
                                        stage_kw, unet_tiny)

N_STREAMS = 4


def build(config: dict) -> nn.Module:
    if in_channels(config) != N_STREAMS:
        raise ValueError("the reference DSUNet takes 4 input channels")
    return DSUNet(config["trainer"]["unet_config"]["params"],
                  out_channels(config))


def tiny(config: dict) -> dict:
    return unet_tiny(config)


class FeatureDisentangle(nn.Module):
    def __init__(self, channels, half):
        super().__init__()
        self.norm1 = GroupNorm32(channels)
        self.conv1 = Conv(channels, channels, 3, padding=1)
        self.norm2 = GroupNorm32(channels)
        self.conv2 = Conv(channels, half, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x))) + x
        return self.conv2(F.silu(self.norm2(h)))


class SEProj(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.se = SEBlock(channels, 8)
        self.conv = Conv(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(self.se(x))


class DSUNet(nn.Module):
    """Four encoders (noise, anatomy, anatomy+lesion, lesion); the noise
    stream alone passes the middle block; four disentangle heads over the
    bottlenecks, SE projections, concat fusion; the decoder takes the mean
    of the four encoders' skips."""

    def __init__(self, params: dict, out_channels: int):
        super().__init__()
        kw = stage_kw(params)
        for s in range(N_STREAMS):
            self.add_module(f"encoder_{s}", Encoder(1, **kw))
        enc = self.encoder_0
        ch0, conv_ch = kw["model_channels"], enc.out_channels
        half = conv_ch // 2
        self.time_embed = TimeEmbed(ch0, 4 * ch0)
        self.middle = Middle(conv_ch, **kw)
        self.conv_style = FeatureDisentangle(conv_ch, half)
        self.conv_content = FeatureDisentangle(conv_ch, half)
        self.conv_anatomy = FeatureDisentangle(conv_ch, half)
        self.conv_lesion = FeatureDisentangle(conv_ch, half)
        self.style_proj = SEProj(half)
        self.share_content_proj = SEProj(half)
        self.anatomy_proj = SEProj(half)
        self.lesion_proj = SEProj(half)
        self.all_proj = Conv(conv_ch + 4 * half, conv_ch, 1)
        self.decoder = Decoder(conv_ch, enc.skip_channels, **kw)
        self.out = OutHead(self.decoder.out_channels, out_channels)

    def forward(self, x, t):
        xc = x.permute(0, 3, 1, 2)
        B = xc.shape[0]
        streams = [xc[:, i:i + 1] for i in range(N_STREAMS)]
        emb = self.time_embed(t)
        outs = [getattr(self, f"encoder_{s}")(streams[s], emb)
                for s in range(N_STREAMS)]
        h_n = self.middle(outs[0][0], emb)
        skips = [torch.stack(parts).mean(dim=0)
                 for parts in zip(*[o[1] for o in outs])]
        h_a, h_al, h_l = [o[0] for o in outs[1:]]

        def apply_head(head, xs):
            out = head(torch.cat(xs, dim=0))
            return out.reshape((len(xs), B) + out.shape[1:])

        styles4 = apply_head(self.conv_style, [h_n, h_a, h_al, h_l])
        contents4 = apply_head(self.conv_content, [h_n, h_a, h_al, h_l])
        anat2 = apply_head(self.conv_anatomy, [h_a, h_al])
        les2 = apply_head(self.conv_lesion, [h_al, h_l])
        h_n_style, style_list = styles4[0], styles4[1:]
        h_n_content, content_list = contents4[0], contents4[1:]
        h_style = self.style_proj(style_list.mean(dim=0))
        h_share = self.share_content_proj(content_list.mean(dim=0))
        h_anatomy = self.anatomy_proj(anat2.mean(dim=0))
        h_lesion = self.lesion_proj(les2.mean(dim=0))
        fused = torch.cat([h_n, h_share, h_style, h_anatomy, h_lesion], dim=1)
        h = self.decoder(self.all_proj(F.silu(fused)), skips, emb)
        out = self.out(h)
        features = {
            "style": nhwc(style_list),
            "content": nhwc(content_list),
            "anatomy": nhwc(anat2),
            "lesion": nhwc(les2),
            "n_style_content": nhwc(torch.stack(
                [h_style, h_n_style, h_share, h_n_content])),
        }
        return nhwc(out), features
