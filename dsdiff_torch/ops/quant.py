"""Int8 serving of the denoisers' convolutions.

Port of the JAX package's ``ops/quant.py``, post-training quantisation of
every eligible convolution:

- weights: symmetric per-output-channel int8, scales from the f32 weights
  (``quantize_weight``);
- activations: symmetric per-tensor int8, either *dynamic* (the max-abs of
  the tensor, computed on the device at every call) or *static* (a scale per
  convolution from ``calibrate_act_scales``; values beyond it saturate at
  ±127) (``quantize_activation``);
- accumulation: exact int32 sums, dequantised in f32, the bias added in
  f32, cast back to the input's dtype (``int8_conv``).

``F.conv2d`` takes no int8 tensors, so ``int8_conv`` builds the im2col of
the int8 input by padding and strided slicing, one group at a time, and
multiplies it with ``torch._int_mm`` (cuBLASLt's int8 tensor-core GEMM on a
card). That GEMM needs more than 16 rows and K and N multiples of 8 on a
card: rows, K and N are padded with zeros, which leaves the sums exact.

``quantize_model`` attaches an ``Int8Conv`` to every eligible ``Conv`` of a
model (at least ``min_channels`` in and out, unit dilation, zero padding),
from f32 weights given by parameter name: the EMA weights a serving copy
was filled from, not its compute-dtype copy. The weights are quantised
there, once, and not at each call (the bias is kept in f32 from the same
weights); ``dequantize_model`` takes them off.
A convolution of the stacked stream layout (a weight with a leading stream
axis, run one stream at a time through ``functional_call``) holds one set
per stream, found by the address of the slice it is called with.
Static scales are keyed by module name, which names the same module as the
JAX package's module path with ``.`` for ``/``.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "quantize_weight",
    "quantize_activation",
    "pack_weight",
    "int8_sums",
    "int8_conv",
    "eligible",
    "Int8Conv",
    "quantize_model",
    "dequantize_model",
    "quantized_convs",
    "suspended",
    "calibrate_act_scales",
    "LAUNCHES",
]

# int8 convolutions run since import (or since a caller reset it to 0): one
# per ``int8_conv`` call, whatever its number of groups
LAUNCHES = 0

_ALIGN = 8  # K and N of torch._int_mm on a card
_MIN_ROWS = 17  # its rows


def quantize_weight(w: torch.Tensor):
    """Symmetric per-output-channel int8 of an OIHW conv weight: returns
    ``(w_i8, scale [O] f32)`` with ``w ≈ w_i8 * scale``."""
    w = w.float()
    amax = w.abs().amax(dim=tuple(range(1, w.ndim)))
    scale = torch.clamp(amax, min=1e-8) / 127.0
    shape = (-1,) + (1,) * (w.ndim - 1)
    w_i8 = torch.clamp(torch.round(w / scale.view(shape)), -127, 127)
    return w_i8.to(torch.int8), scale


def quantize_activation(x: torch.Tensor, scale=None):
    """Symmetric per-tensor int8 of an activation: ``(x_i8, scale)``. With
    ``scale=None`` the scale is the tensor's max-abs / 127, a 0-d f32 tensor
    on the device; a given scale (a float) saturates what lies beyond it."""
    x = x.float()
    if scale is None:
        scale = torch.clamp(x.abs().amax(), min=1e-8) / 127.0
    x_i8 = torch.clamp(torch.round(x / scale), -127, 127)
    return x_i8.to(torch.int8), scale


def _pad_amounts(padding, size: int, k: int, stride: int) -> tuple[int, int]:
    """(low, high) zero padding of one spatial axis: an int, a (low, high)
    pair, or 'SAME' / 'VALID' as XLA reads them."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return 0, 0
        if padding.upper() != "SAME":
            raise ValueError(f"unknown padding '{padding}'")
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        return total // 2, total - total // 2
    if isinstance(padding, int):
        return padding, padding
    return int(padding[0]), int(padding[1])


def _spatial_padding(padding, H, W, kh, kw, sh, sw):
    if isinstance(padding, (str, int)):
        return (_pad_amounts(padding, H, kh, sh),
                _pad_amounts(padding, W, kw, sw))
    ph, pw = padding
    return _pad_amounts(ph, H, kh, sh), _pad_amounts(pw, W, kw, sw)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pack_weight(w_i8: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """An OIHW int8 weight as the GEMM's right operand, one per group:
    ``[groups, N_pad, K_pad]`` with K ordered (kh, kw, in channel) and the
    padding zero."""
    O, I, kh, kw = w_i8.shape
    og = O // groups
    K = kh * kw * I
    packed = torch.zeros((groups, _round_up(og, _ALIGN), _round_up(K, _ALIGN)),
                         dtype=torch.int8, device=w_i8.device)
    rows = w_i8.permute(0, 2, 3, 1).reshape(groups, og, K)
    packed[:, :og, :K] = rows
    return packed


def _im2col(x: torch.Tensor, kh, kw, sh, sw, pads, k_pad: int):
    """[B, H, W, C] int8 -> ([M_pad, k_pad] int8 columns ordered (kh, kw,
    C), M, Ho, Wo)."""
    (pt, pb), (pl, pr) = pads
    if pt or pb or pl or pr:
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
    B, Hp, Wp, C = x.shape
    Ho = (Hp - kh) // sh + 1
    Wo = (Wp - kw) // sw + 1
    M = B * Ho * Wo
    K = kh * kw * C
    taps = [x[:, i:i + sh * (Ho - 1) + 1:sh, j:j + sw * (Wo - 1) + 1:sw]
            for i in range(kh) for j in range(kw)]
    if k_pad == K and M >= _MIN_ROWS:
        cols = torch.stack(taps, dim=3).view(M, K)
        return cols, M, Ho, Wo
    cols = torch.zeros((max(M, _MIN_ROWS), k_pad), dtype=torch.int8,
                       device=x.device)
    view = cols[:M, :K].view(B, Ho, Wo, kh * kw, C)
    for t, tap in enumerate(taps):
        view[:, :, :, t] = tap
    return cols, M, Ho, Wo


def int8_sums(x_i8: torch.Tensor, packed: torch.Tensor, kernel_size,
              out_channels: int, stride=(1, 1), padding=0,
              groups: int = 1) -> torch.Tensor:
    """The exact int32 sums of a conv of NCHW int8 ``x_i8`` with the int8
    weight ``packed`` (``pack_weight``), as NHWC [B, Ho, Wo, O]: the im2col
    of each group times its weight through ``torch._int_mm``."""
    kh, kw = kernel_size
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    B, C, H, W = x_i8.shape
    pads = _spatial_padding(padding, H, W, kh, kw, sh, sw)
    xh = x_i8.permute(0, 2, 3, 1)
    cg, og = C // groups, out_channels // groups
    outs = []
    for g in range(groups):
        xg = xh if groups == 1 else xh[..., g * cg:(g + 1) * cg]
        cols, M, Ho, Wo = _im2col(xg, kh, kw, sh, sw, pads, packed.shape[2])
        outs.append(torch._int_mm(cols, packed[g].t())[:M, :og])
    acc = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return acc.view(B, Ho, Wo, out_channels)


def int8_conv(x: torch.Tensor, w_i8: torch.Tensor, w_scale: torch.Tensor,
              bias: torch.Tensor | None, stride=(1, 1), padding=0,
              groups: int = 1, act_scale=None,
              packed: torch.Tensor | None = None) -> torch.Tensor:
    """Int8 replacement for a conv over NCHW ``x``: ``x`` quantised per
    tensor (``act_scale`` or dynamic), times the int8 OIHW weight ``w_i8``
    (``packed``: the same from ``pack_weight``) with exact int32 sums,
    dequantised with ``x``'s scale times ``w_scale`` [O] in f32, plus the
    f32 bias; returns NCHW in ``x``'s dtype."""
    global LAUNCHES
    x_i8, sx = quantize_activation(x, act_scale)
    O, _, kh, kw = w_i8.shape
    if packed is None:
        packed = pack_weight(w_i8, groups)
    acc = int8_sums(x_i8, packed, (kh, kw), O, stride, padding, groups)
    y = acc.float() * (sx * w_scale)
    if bias is not None:
        y = y + bias.float()
    LAUNCHES += 1
    return y.to(x.dtype).permute(0, 3, 1, 2)


def _unit(v) -> bool:
    return all(int(d) == 1 for d in (v if isinstance(v, tuple) else (v,)))


def eligible(conv: nn.Conv2d, min_channels: int = 32) -> bool:
    """Whether ``conv`` runs in int8: unit dilation, zero padding given as
    numbers, and at least ``min_channels`` channels in and out."""
    return (_unit(conv.dilation) and conv.padding_mode == "zeros"
            and not isinstance(conv.padding, str)
            and conv.in_channels >= min_channels
            and conv.out_channels >= min_channels)


class Int8Conv:
    """A conv's int8 weights and, when static, its activation scale.
    ``sets`` maps the address of the weight the conv is called with (the
    parameter itself, or one stream's slice of a stacked one) to
    ``(w_i8, w_scale, packed, bias)``, the bias f32 (or None)."""

    def __init__(self, conv: nn.Conv2d, sets: dict, act_scale=None):
        self.stride = conv.stride
        self.padding = conv.padding
        self.groups = conv.groups
        self.sets = sets
        self.act_scale = act_scale

    def __call__(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        found = self.sets.get(weight.data_ptr())
        if found is None:
            raise RuntimeError(
                "int8 weights were quantised from another copy of this "
                "conv's weight; quantize_model again")
        w_i8, w_scale, packed, bias = found
        return int8_conv(x, w_i8, w_scale, bias, self.stride, self.padding,
                         self.groups, self.act_scale, packed)


def _convs(model: nn.Module, min_channels: int):
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d) and hasattr(m, "int8") and eligible(
                m, min_channels):
            yield name, m


@torch.no_grad()
def quantize_model(model: nn.Module, weights: dict[str, torch.Tensor],
                   min_channels: int = 32,
                   act_scales: dict[str, float] | None = None) -> int:
    """Attach an ``Int8Conv`` to every eligible ``Conv`` of ``model``, its
    weights quantised from ``weights`` ({parameter name: f32 tensor}, the
    model's own names); a conv named in ``act_scales`` gets that static
    activation scale, any other a dynamic one. Returns the number of convs
    attached."""
    n = 0
    for name, m in _convs(model, min_channels):
        prefix = f"{name}." if name else ""
        dev = m.weight.device
        w = weights[prefix + "weight"].to(dev)
        b = weights.get(prefix + "bias") if m.bias is not None else None
        b = None if b is None else b.to(dev).float()
        if m.weight.ndim == 5:  # stacked streams: one set per stream
            stride = m.weight.stride(0) * m.weight.element_size()
            parts = [(m.weight.data_ptr() + s * stride, w[s],
                      None if b is None else b[s])
                     for s in range(w.shape[0])]
        else:
            parts = [(m.weight.data_ptr(), w, b)]
        sets = {}
        for ptr, ws, bs in parts:
            w_i8, w_scale = quantize_weight(ws)
            sets[ptr] = (w_i8, w_scale, pack_weight(w_i8, m.groups), bs)
        m.int8 = Int8Conv(m, sets, (act_scales or {}).get(name))
        n += 1
    return n


def dequantize_model(model: nn.Module) -> None:
    """Take every ``Int8Conv`` off ``model``: its convs run as they did."""
    for m in model.modules():
        if getattr(m, "int8", None) is not None:
            m.int8 = None


@contextlib.contextmanager
def suspended(model: nn.Module):
    """Inside the block every conv of ``model`` runs as it would without
    int8 (progressive denoising and the feature dump serve plain, as in the
    JAX package); the int8 weights are back after it."""
    held = [(m, m.int8) for m in model.modules()
            if getattr(m, "int8", None) is not None]
    for m, _ in held:
        m.int8 = None
    try:
        yield
    finally:
        for m, q in held:
            m.int8 = q


def quantized_convs(model: nn.Module) -> list[str]:
    """Names of the convs of ``model`` that run in int8."""
    return [n for n, m in model.named_modules()
            if getattr(m, "int8", None) is not None]


@torch.no_grad()
def calibrate_act_scales(model: nn.Module, inputs, min_channels: int = 32
                         ) -> dict[str, float]:
    """Run ``model(*args)`` for each argument tuple of ``inputs`` (denoiser
    forwards at representative (x_t, t)), recording each eligible conv's
    input max-abs; returns ``{conv name: max(amax, 1e-8) / 127}`` over all
    of them. The convs run as they would without int8 while recording."""
    amax: dict[str, torch.Tensor] = {}
    hooks = []

    def recorder(key):
        def hook(_mod, args):
            a = args[0].float().abs().amax()
            amax[key] = torch.maximum(amax[key], a) if key in amax else a
        return hook

    for name, m in _convs(model, min_channels):
        hooks.append(m.register_forward_pre_hook(recorder(name)))
    try:
        with suspended(model):
            for args in inputs:
                model(*args)
    finally:
        for h in hooks:
            h.remove()
    return {k: max(float(v), 1e-8) / 127.0 for k, v in amax.items()}
