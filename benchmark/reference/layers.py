"""Plain f32 building blocks of the reference denoisers.

A frozen copy of the math of the port's ``models/layers.py``,
``models/attention.py`` (the qkv ``AttentionBlock``) and
``models/backbone.py``, written in plain PyTorch: every convolution and
linear layer computes in float32, attention is softmax(q kᵀ / sqrt(D)) v
by two einsums, and nothing of the port is imported. Parameter names are
the port's, so one seeded fill (``benchmark.harness.weights``) gives both
sides the same weights.

``PRECISION`` selects the arithmetic of every product (convolutions, linear
layers and both attention products): ``"f32"`` or ``"fp8"``, the control,
which rounds both operands of each product to float8 e4m3 with one scale a
tensor (its largest magnitude to 448) and keeps the gradient of the
unrounded value. ``REMAT`` checkpoints each ``ResBlock`` when gradients are
on, as the port does under ``remat``, so a training step at batch 32 fits.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

PRECISION = {"mode": "f32", "remat": False}
FP8_MAX = 448.0


def set_precision(mode: str) -> None:
    if mode not in ("f32", "fp8"):
        raise ValueError(f"unknown precision '{mode}'")
    PRECISION["mode"] = mode


def set_remat(on: bool) -> None:
    PRECISION["remat"] = bool(on)


def rounded(x: torch.Tensor) -> torch.Tensor:
    """x as the current precision holds an operand of a product."""
    if PRECISION["mode"] == "f32":
        return x
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class Dense(nn.Linear):
    def forward(self, x):
        return F.linear(rounded(x), rounded(self.weight), self.bias)


class Conv(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(rounded(x), rounded(self.weight), self.bias)


class TimeEmbed(nn.Module):
    def __init__(self, model_channels: int, out_dim: int):
        super().__init__()
        self.model_channels = model_channels
        self.fc1 = Dense(model_channels, out_dim)
        self.fc2 = Dense(out_dim, out_dim)

    def forward(self, t):
        emb = timestep_embedding(t, self.model_channels)
        return self.fc2(F.silu(self.fc1(emb)))


class GroupNorm32(nn.Module):
    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__()
        groups = min(num_groups, channels)
        while channels % groups:
            groups -= 1
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)

    def forward(self, x):
        return self.norm(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.op = Conv(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class ResBlock(nn.Module):
    """GN, SiLU, conv; FiLM by the timestep (scale-shift or additive);
    GN, SiLU, conv; a 1x1 skip on a channel change."""

    def __init__(self, channels: int, emb_dim: int, out_channels: int,
                 use_scale_shift_norm: bool):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_norm = GroupNorm32(channels)
        self.in_conv = Conv(channels, out_channels, 3, padding=1)
        self.emb_proj = Dense(
            emb_dim, 2 * out_channels if use_scale_shift_norm else out_channels)
        self.out_norm = GroupNorm32(out_channels)
        self.out_conv = Conv(out_channels, out_channels, 3, padding=1)
        self.skip = (Conv(channels, out_channels, 1)
                     if channels != out_channels else None)

    def forward(self, x, emb):
        h = self.in_conv(F.silu(self.in_norm(x)))
        emb_out = self.emb_proj(F.silu(emb))[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = F.silu(self.out_norm(h) * (1.0 + scale) + shift)
        else:
            h = F.silu(self.out_norm(h + emb_out))
        h = self.out_conv(h)
        if self.skip is not None:
            x = self.skip(x)
        return x + h


def plain_attention(q, k, v):
    """softmax(q kᵀ / sqrt(D)) v over [B, N, heads, D]."""
    D = q.shape[-1]
    s = torch.einsum("bnhd,bmhd->bhnm", rounded(q), rounded(k)) / math.sqrt(D)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", rounded(p), rounded(v))


class AttentionBlock(nn.Module):
    """GN, a fused qkv projection split into q|k|v thirds, heads, plain
    attention, the output projection, residual."""

    def __init__(self, channels: int, num_heads: int, num_head_channels: int):
        super().__init__()
        self.heads = (num_heads if num_head_channels == -1
                      else channels // num_head_channels)
        self.norm = GroupNorm32(channels)
        self.qkv = Dense(channels, 3 * channels)
        self.proj_out = Dense(channels, channels)

    def forward(self, x):
        B, C, H, W = x.shape
        N = H * W
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, N, C)
        q, k, v = self.qkv(h).view(B, N, 3, self.heads, C // self.heads).unbind(2)
        out = self.proj_out(plain_attention(q, k, v).reshape(B, N, C))
        return x + out.view(B, H, W, C).permute(0, 3, 1, 2)


class _Stages(nn.Module):
    """The shared settings and the forward plan of an encoder, middle or
    decoder: (name, kind) in order, kind res | attn | resample."""

    def __init__(self, model_channels, num_res_blocks, attention_resolutions,
                 channel_mult, num_heads, num_head_channels,
                 use_scale_shift_norm):
        super().__init__()
        self.ch0 = model_channels
        self.nrb = num_res_blocks
        self.att = tuple(attention_resolutions)
        self.mult = tuple(channel_mult)
        self.heads = (num_heads, num_head_channels)
        self.ssn = use_scale_shift_norm
        self.emb_dim = 4 * model_channels
        self.plan: list[tuple[str, str]] = []

    def _add(self, name, kind, module):
        self.add_module(name, module)
        self.plan.append((name, kind))

    def _res(self, name, ch, out_ch):
        self._add(name, "res", ResBlock(ch, self.emb_dim, out_ch, self.ssn))

    def _attn(self, name, ch):
        self._add(name, "attn", AttentionBlock(ch, *self.heads))

    def _run(self, name, kind, h, emb):
        block = getattr(self, name)
        if kind != "res":
            return block(h)
        if PRECISION["remat"] and torch.is_grad_enabled():
            return checkpoint(block, h, emb, use_reentrant=False)
        return block(h, emb)


class Encoder(_Stages):
    def __init__(self, in_channels, **kw):
        super().__init__(**kw)
        self.in_conv = Conv(in_channels, self.ch0, 3, padding=1)
        self.skip_channels = [self.ch0]
        self.skip_after = set()
        ch, ds = self.ch0, 1
        for level, mult in enumerate(self.mult):
            for i in range(self.nrb):
                self._res(f"down_{level}_{i}_res", ch, mult * self.ch0)
                ch = mult * self.ch0
                if ds in self.att:
                    self._attn(f"down_{level}_{i}_attn", ch)
                self.skip_after.add(self.plan[-1][0])
                self.skip_channels.append(ch)
            if level != len(self.mult) - 1:
                self._add(f"down_{level}_ds", "resample", Downsample(ch))
                self.skip_after.add(f"down_{level}_ds")
                self.skip_channels.append(ch)
                ds *= 2
        self.out_channels = ch

    def forward(self, x, emb):
        h = self.in_conv(x)
        skips = [h]
        for name, kind in self.plan:
            h = self._run(name, kind, h, emb)
            if name in self.skip_after:
                skips.append(h)
        return h, skips


class Middle(_Stages):
    def __init__(self, channels, **kw):
        super().__init__(**kw)
        self._res("mid_res1", channels, channels)
        self._attn("mid_attn", channels)
        self._res("mid_res2", channels, channels)

    def forward(self, h, emb):
        for name, kind in self.plan:
            h = self._run(name, kind, h, emb)
        return h


class Decoder(_Stages):
    def __init__(self, in_channels, skip_channels, **kw):
        super().__init__(**kw)
        skip_ch = list(skip_channels)
        ch = in_channels
        ds = 2 ** (len(self.mult) - 1)
        self.takes_skip = set()
        for level, mult in reversed(list(enumerate(self.mult))):
            for i in range(self.nrb + 1):
                name = f"up_{level}_{i}_res"
                self._res(name, ch + skip_ch.pop(), mult * self.ch0)
                self.takes_skip.add(name)
                ch = mult * self.ch0
                if ds in self.att:
                    self._attn(f"up_{level}_{i}_attn", ch)
                if level and i == self.nrb:
                    self._add(f"up_{level}_us", "resample", Upsample(ch))
                    ds //= 2
        self.out_channels = ch

    def forward(self, h, skips, emb):
        skips = list(skips)
        for name, kind in self.plan:
            if name in self.takes_skip:
                h = torch.cat([h, skips.pop()], dim=1)
            h = self._run(name, kind, h, emb)
        return h


class OutHead(nn.Module):
    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.norm = GroupNorm32(in_channels)
        self.conv = Conv(in_channels, out_channels, 3, padding=1)

    def forward(self, h):
        return self.conv(F.silu(self.norm(h)))


class SEBlock(nn.Module):
    def __init__(self, channels: int, reduction: int):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.fc1 = Dense(channels, hidden, bias=False)
        self.fc2 = Dense(hidden, channels, bias=False)

    def forward(self, x):
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3))))))
        return x * s[:, :, None, None]
