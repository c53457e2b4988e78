"""A reference for the port's plain ``ddpm`` UNet (``models/unet.py``), a
kind the benchmark has no cell of: the tests add it by this file alone."""
from torch import nn

from benchmark.reference.layers import (Decoder, Encoder, Middle, OutHead,
                                        TimeEmbed)
from benchmark.reference.models import (in_channels, out_channels, stage_kw,
                                        unet_tiny)


class UNet(nn.Module):
    def __init__(self, params: dict, n_in: int, n_out: int):
        super().__init__()
        kw = stage_kw(params)
        self.time_embed = TimeEmbed(kw["model_channels"],
                                    4 * kw["model_channels"])
        self.encoder = Encoder(n_in, **kw)
        ch = self.encoder.out_channels
        self.middle = Middle(ch, **kw)
        self.decoder = Decoder(ch, self.encoder.skip_channels, **kw)
        self.out = OutHead(self.decoder.out_channels, n_out)

    def forward(self, x, t):
        emb = self.time_embed(t)
        h, skips = self.encoder(x.permute(0, 3, 1, 2), emb)
        h = self.decoder(self.middle(h, emb), skips, emb)
        return self.out(h).permute(0, 2, 3, 1), None


def build(config: dict) -> nn.Module:
    return UNet(config["trainer"]["unet_config"]["params"],
                in_channels(config), out_channels(config))


def tiny(config: dict) -> dict:
    return unet_tiny(config)
