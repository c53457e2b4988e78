"""The reference denoisers: DS-Diff's 4-stream DSUNet and DisC-Diff's
DiscUNet, in plain f32 PyTorch.

A frozen copy of the port's ``models/dsunet.py`` (stream layout
'sequential', fusion 'concat', no edge map, no transformer) and
``models/disc_unet.py`` (layout 'sequential'). Both take NHWC input and a
[B] float timestep and return ``(out [B, H, W, C_out], features)``, with
the features stream-major as the disentangle losses read them.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (Conv, Decoder, Encoder, GroupNorm32, Middle, OutHead,
                     SEBlock, TimeEmbed)

N_STREAMS = 4


def _nhwc(x):
    return x.movedim(-3, -1)


def _stage_kw(p: dict) -> dict:
    return dict(
        model_channels=int(p.get("model_channels", 96)),
        num_res_blocks=int(p.get("num_res_blocks", 2)),
        attention_resolutions=tuple(p.get("attention_resolutions", (4, 8))),
        channel_mult=tuple(p.get("channel_mult", (1, 2, 4, 8))),
        num_heads=int(p.get("num_heads", 8)),
        num_head_channels=int(p.get("num_head_channels", -1)),
        use_scale_shift_norm=bool(p.get("use_scale_shift_norm", False)),
    )


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
        kw = _stage_kw(params)
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
            "style": _nhwc(style_list),
            "content": _nhwc(content_list),
            "anatomy": _nhwc(anat2),
            "lesion": _nhwc(les2),
            "n_style_content": _nhwc(torch.stack(
                [h_style, h_n_style, h_share, h_n_content])),
        }
        return _nhwc(out), features


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
        kw = _stage_kw(params)
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
        features = {"common": _nhwc(com),
                    "distinct": _nhwc(torch.stack(dist_gated))}
        return _nhwc(out), features


def build(config: dict, device=None) -> nn.Module:
    """The reference model of a benchmark configuration file's ``model``
    ('dsunet' | 'disc_unet') at its ``trainer.unet_config.params``."""
    params = config["trainer"]["unet_config"]["params"]
    n_in = 1 + int(config["n_cond"])
    out_ch = int(config["trainer"].get("output_ch", 1))
    out_ch *= 2 if config["trainer"].get("learn_sigma", False) else 1
    kind = config["model"]
    if kind == "dsunet" and n_in != N_STREAMS:
        raise ValueError("the reference DSUNet takes 4 input channels")
    if kind not in ("dsunet", "disc_unet"):
        raise ValueError(f"no reference for model '{kind}'")
    with contextlib.nullcontext() if device is None else torch.device(device):
        if kind == "dsunet":
            return DSUNet(params, out_ch)
        return DiscUNet(params, n_in, out_ch)
