"""Shared building blocks of the denoisers.

Port of the JAX package's ``models/layers.py``. Blocks run NCHW inside (PyTorch's
convolution layout; a map permuted from NHWC keeps channels-last strides);
the models take and return NHWC at their public ``forward``. Submodule names
are the Flax module names, so ``utils.flax_bridge`` maps weights one to one.

Compute dtype: parameters are f32 (the master copy an optimizer updates);
``Dense`` and ``Conv`` cast their weight, bias and input to the block's
``dtype`` at call, as Flax's ``dtype`` attribute does with f32 params.
``GroupNorm32`` computes its statistics and affine in f32, then casts back.
``SpectralNormConv`` (the adversarial discriminator's conv) and
``ModulatedResBlock`` (a ResBlock whose out-norm a context map modulates)
are the JAX module's blocks of the same names.
``hold_in_compute_dtype`` turns a copy of a model into a serving copy whose
``Dense``/``Conv`` weights are stored in the compute dtype, so that the
casts at call are no-ops; the same f32 weights round to the same values
either way.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "timestep_embedding",
    "Dense",
    "Conv",
    "TimeEmbed",
    "GroupNorm32",
    "ResBlock",
    "Upsample",
    "Downsample",
    "SEBlock",
    "SpectralNormConv",
    "ModulatedResBlock",
    "zero_init",
    "hold_in_compute_dtype",
    "dropout_generator",
]


def zero_init(module: nn.Module) -> nn.Module:
    """Zero a layer's weight and bias (output layers start at zero)."""
    with torch.no_grad():
        for p in module.parameters():
            p.zero_()
    return module


def timestep_embedding(
    t: torch.Tensor, dim: int, max_period: float = 10000.0
) -> torch.Tensor:
    """Sinusoidal timestep embedding, [B] -> [B, dim], cos half first,
    zero-padded when ``dim`` is odd."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _cast(p: torch.Tensor | None, dtype: torch.dtype):
    return None if p is None else p.to(dtype)


class Dense(nn.Linear):
    """``nn.Linear`` with f32 parameters that computes in ``dtype``."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.linear(x.to(cd), self.weight.to(cd), _cast(self.bias, cd))


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with f32 parameters that computes in ``dtype``; with an
    ``int8`` attached (``ops.quant.quantize_model``) it runs that instead."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype
        self.int8 = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.int8 is not None:
            return self.int8(x, self.weight)
        cd = self.compute_dtype
        return self._conv_forward(x.to(cd), self.weight.to(cd),
                                  _cast(self.bias, cd))


def hold_in_compute_dtype(model: nn.Module) -> nn.Module:
    """Store every ``Dense``/``Conv`` weight of ``model`` in its compute
    dtype, in place (for a serving copy: its casts at call become no-ops).
    Norm parameters stay f32."""
    for m in model.modules():
        if isinstance(m, (Dense, Conv)):
            m.to(m.compute_dtype)
    return model


class TimeEmbed(nn.Module):
    """Two-layer SiLU MLP over the sinusoidal embedding."""

    def __init__(self, model_channels: int, out_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.model_channels = model_channels
        self.fc1 = Dense(model_channels, out_dim, dtype=dtype)
        self.fc2 = Dense(out_dim, out_dim, dtype=dtype)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(t, self.model_channels)
        return self.fc2(F.silu(self.fc1(emb)))


class GroupNorm32(nn.Module):
    """GroupNorm with f32 statistics and affine whatever the compute dtype;
    up to 32 groups (fewer where 32 does not divide the channels) and eps
    1e-6, the Flax default (torch's is 1e-5)."""

    EPS = 1e-6

    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__()
        groups = min(num_groups, channels)
        while channels % groups:
            groups -= 1
        self.norm = nn.GroupNorm(groups, channels, eps=self.EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x.float()).to(x.dtype)


def _upsample(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Upsample(nn.Module):
    """2x nearest upsample + optional 3x3 conv."""

    def __init__(self, channels: int, use_conv: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = (
            Conv(channels, channels, 3, padding=1, dtype=dtype)
            if use_conv else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _upsample(x)
        return self.conv(x) if self.conv is not None else x


class Downsample(nn.Module):
    """Stride-2 3x3 conv (padding 1), or 2x2 average pooling."""

    def __init__(self, channels: int, use_conv: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.op = (
            Conv(channels, channels, 3, stride=2, padding=1, dtype=dtype)
            if use_conv else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.op is not None:
            return self.op(x)
        return F.avg_pool2d(x, 2)


class ResBlock(nn.Module):
    """GN+SiLU+conv residual block with FiLM timestep conditioning: the
    scale-shift branch ``GN(h)*(1+scale)+shift`` or the additive branch
    ``GN(h+emb)``; optional up/down resampling inside the block; a 1x1 (or
    3x3) skip projection on a channel change; zero-init second conv."""

    def __init__(self, channels: int, emb_dim: int,
                 out_channels: int | None = None, dropout: float = 0.0,
                 use_scale_shift_norm: bool = False, up: bool = False,
                 down: bool = False, use_conv_skip: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = out_channels or channels
        self.up, self.down = up, down
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_norm = GroupNorm32(channels)
        self.in_conv = Conv(channels, out_ch, 3, padding=1, dtype=dtype)
        self.emb_proj = Dense(
            emb_dim, 2 * out_ch if use_scale_shift_norm else out_ch, dtype=dtype
        )
        self.out_norm = GroupNorm32(out_ch)
        self.dropout = float(dropout)
        # bound by ``dropout_generator`` for a train step
        self.generator: torch.Generator | None = None
        self.out_conv = zero_init(
            Conv(out_ch, out_ch, 3, padding=1, dtype=dtype)
        )
        if channels != out_ch:
            kernel = 3 if use_conv_skip else 1
            self.skip = Conv(channels, out_ch, kernel, padding=kernel // 2,
                             dtype=dtype)
        else:
            self.skip = None

    def drops(self) -> bool:
        """True where a forward applies dropout (training, rate above 0)."""
        return self.training and self.dropout > 0

    def dropout_mask(self, x: torch.Tensor) -> torch.Tensor:
        """The keep mask [B, out_ch, H', W'] of a forward on ``x``, drawn
        from the bound generator: an element is kept with probability
        ``1 - dropout``, as Flax's ``nn.Dropout``."""
        if self.generator is None:
            raise RuntimeError(
                "ResBlock dropout needs a mask or a generator bound by "
                "dropout_generator"
            )
        B, _, H, W = x.shape
        if self.up:
            H, W = 2 * H, 2 * W
        elif self.down:
            H, W = H // 2, W // 2
        shape = (B, self.out_conv.in_channels, H, W)
        return torch.rand(shape, generator=self.generator,
                          device=x.device) < 1.0 - self.dropout

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        h = F.silu(self.in_norm(x))
        if self.up:
            h, x = _upsample(h), _upsample(x)
        elif self.down:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        h = self.in_conv(h)
        emb_out = self.emb_proj(F.silu(emb))[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = F.silu(self.out_norm(h) * (1.0 + scale) + shift)
        else:
            h = F.silu(self.out_norm(h + emb_out))
        if self.drops():
            if mask is None:
                mask = self.dropout_mask(x)
            h = torch.where(mask, h / (1.0 - self.dropout), torch.zeros_like(h))
        h = self.out_conv(h)
        if self.skip is not None:
            x = self.skip(x)
        return x + h


@contextlib.contextmanager
def dropout_generator(model: nn.Module, generator: torch.Generator | None):
    """Bind ``generator`` to every module of ``model`` that draws in a
    training forward (one with a ``generator`` attribute: ``ResBlock``'s
    dropout masks, DiT's label dropout) inside the block."""
    blocks = [m for m in model.modules() if hasattr(m, "generator")]
    for b in blocks:
        b.generator = generator
    try:
        yield
    finally:
        for b in blocks:
            b.generator = None


class SEBlock(nn.Module):
    """Squeeze-and-excitation channel gate: global average pool (f32) ->
    fc/r -> ReLU -> fc -> sigmoid -> scale."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.fc1 = Dense(channels, hidden, bias=False, dtype=dtype)
        self.fc2 = Dense(hidden, channels, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean(dim=(2, 3))
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(s))))
        return x * s[:, :, None, None]


class SpectralNormConv(nn.Module):
    """Conv whose kernel is divided by its largest singular value, found by
    ``n_iter`` power-iteration steps run on every call from the fixed start
    ``u = 1/sqrt(out)``, over the f32 kernel as the matrix ``[kh*kw*cin,
    out]`` (the Flax HWIO kernel's rows): stateless, unlike
    ``torch.nn.utils.spectral_norm``, which keeps ``u`` between calls.
    sigma = v . (w u), with 1e-12 in both norms; the gradient flows
    through the iteration. ``weight`` is the raw OIHW kernel."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 n_iter: int = 3, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding, self.n_iter = stride, padding, n_iter
        self.compute_dtype = dtype
        fan_in = in_channels * kernel_size * kernel_size
        # lecun_normal: a normal truncated at two deviations, variance 1/fan_in
        std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
        self.weight = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size),
            std=std, a=-2 * std, b=2 * std))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def sigma(self) -> torch.Tensor:
        """The kernel's top singular value estimate (0-d, f32)."""
        out = self.weight.shape[0]
        w = self.weight.float().permute(2, 3, 1, 0).reshape(-1, out)
        u = torch.full((out,), 1.0 / math.sqrt(out), device=w.device)
        for _ in range(self.n_iter):
            v = w @ u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u = w.T @ v
            u = u / (torch.linalg.vector_norm(u) + 1e-12)
        return v @ (w @ u)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        w_sn = (self.weight.float() / self.sigma()).to(cd)
        return F.conv2d(x.to(cd), w_sn, _cast(self.bias, cd), self.stride,
                        self.padding)


class ModulatedResBlock(nn.Module):
    """ResBlock with two FiLMs: the timestep embedding scales and shifts
    the in-norm, ``GN(x) * (1 + s) + shift``; a context map [B, 2*out_ch,
    H, W] (scale channels first) scales and shifts the out-norm. Then
    SiLU, dropout by mask (as ``ResBlock``), the zero-initialised
    ``out_conv`` and a 1x1 skip on a channel change."""

    def __init__(self, channels: int, emb_dim: int,
                 out_channels: int | None = None, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = out_channels or channels
        self.emb_proj = Dense(emb_dim, 2 * channels, dtype=dtype)
        self.in_norm = GroupNorm32(channels)
        self.in_conv = Conv(channels, out_ch, 3, padding=1, dtype=dtype)
        self.out_norm = GroupNorm32(out_ch)
        self.dropout = float(dropout)
        self.generator: torch.Generator | None = None
        self.out_conv = zero_init(
            Conv(out_ch, out_ch, 3, padding=1, dtype=dtype))
        self.skip = (Conv(channels, out_ch, 1, dtype=dtype)
                     if channels != out_ch else None)

    def drops(self) -> bool:
        return self.training and self.dropout > 0

    def dropout_mask(self, x: torch.Tensor) -> torch.Tensor:
        """The keep mask [B, out_ch, H, W] of a forward on ``x``, drawn from
        the bound generator (``dropout_generator``)."""
        if self.generator is None:
            raise RuntimeError(
                "ModulatedResBlock dropout needs a mask or a generator bound "
                "by dropout_generator")
        B, _, H, W = x.shape
        return torch.rand((B, self.out_conv.in_channels, H, W),
                          generator=self.generator,
                          device=x.device) < 1.0 - self.dropout

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                context: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        e_scale, e_shift = self.emb_proj(F.silu(emb))[:, :, None, None].chunk(
            2, dim=1)
        h = F.silu(self.in_norm(x) * (1.0 + e_scale) + e_shift)
        h = self.in_conv(h)
        c_scale, c_shift = context.to(h.dtype).chunk(2, dim=1)
        h = F.silu(self.out_norm(h) * (1.0 + c_scale) + c_shift)
        if self.drops():
            if mask is None:
                mask = self.dropout_mask(x)
            h = torch.where(mask, h / (1.0 - self.dropout), torch.zeros_like(h))
        h = self.out_conv(h)
        if self.skip is not None:
            x = self.skip(x)
        return x + h
