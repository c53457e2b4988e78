"""Fused GroupNorm + SiLU: the CUDA kernel's wrapper and its plain version.

Port of the JAX package's ``ops/fused_norm.py:54-97``. The group statistics
are computed as there: in f32 PyTorch ops, ``var = E[x²] - mean²``, eps
1e-5, folded into per-(batch, channel) ``a = gamma * rsqrt(var + eps)`` and
``b = beta - mean * a`` (``coefficients``). ``apply_kernel`` then launches
``csrc/fused_norm.cu``, which computes ``SiLU(x * a + b)`` in one pass;
``apply_plain`` is the same apply in PyTorch. Layout: x ``[B, H, W, C]``,
contiguous; the output has x's dtype.

The JAX package's TPU gate ``supports()`` (a v5e measurement) is not carried
over: a CUDA tensor always goes to the kernel, a CPU tensor to the plain
version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "coefficients",
    "apply_plain",
    "apply_kernel",
    "group_norm_silu",
    "group_norm_silu_plain",
    "LAUNCHES",
]

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SHARED_BYTES = 232448  # a block's shared memory on Hopper; a and b take 8C
_lib = None


def coefficients(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 num_groups: int = 32, eps: float = 1e-5):
    """f32 group statistics of x [B, H, W, C] folded with the affine into
    ``(a, b)``, each [B, C] f32."""
    if x.ndim != 4:
        raise ValueError(f"group_norm_silu takes [B, H, W, C], got {tuple(x.shape)}")
    B, H, W, C = x.shape
    if C % num_groups:
        raise ValueError(f"{C} channels do not split into {num_groups} groups")
    per = C // num_groups
    xg = x.float().reshape(B, H * W, num_groups, per)
    mean = xg.mean(dim=(1, 3))  # [B, G]
    var = (xg * xg).mean(dim=(1, 3)) - mean**2
    inv = torch.rsqrt(var + eps)
    a = inv.repeat_interleave(per, dim=1) * scale.float()[None]
    b = bias.float()[None] - mean.repeat_interleave(per, dim=1) * a
    return a, b


def apply_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """SiLU(x * a + b) in plain PyTorch, f32 arithmetic, x's dtype out."""
    y = x.float() * a[:, None, None, :] + b[:, None, None, :]
    return (y * torch.sigmoid(y)).to(x.dtype)


def group_norm_silu_plain(x, scale, bias, num_groups: int = 32,
                          eps: float = 1e-5):
    """The whole op in plain PyTorch: ``coefficients`` then ``apply_plain``."""
    a, b = coefficients(x, scale, bias, num_groups, eps)
    return apply_plain(x, a, b)


def _check(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    """Raise on anything the kernel does not take."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"group_norm_silu takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"group_norm_silu takes [B, H, W, C], got {tuple(x.shape)}")
    B, H, W, C = x.shape
    if not x.is_contiguous():
        raise ValueError("x must be contiguous [B, H, W, C] (channels last)")
    if not 1 <= B <= 65535 or C < 1 or 8 * C > _SHARED_BYTES:
        raise ValueError(f"unsupported sizes B={B} C={C}")
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32 or t.shape != (B, C) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [B, C] tensor")
    if x.device.type != "cuda" or a.device != x.device or b.device != x.device:
        raise ValueError(
            f"group_norm_silu needs x, a, b on one CUDA device, got "
            f"{x.device}, {a.device}, {b.device}"
        )


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("fused_norm")
        fn = lib.dsdiff_group_norm_silu
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 3
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def apply_kernel(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Launch the CUDA kernel: SiLU(x * a + b), x [B, H, W, C] contiguous,
    a and b [B, C] f32. Raises on CPU tensors and on what the kernel does not
    take."""
    global LAUNCHES
    _check(x, a, b)
    B, H, W, C = x.shape
    row = H * W * C
    y = torch.empty_like(x)
    vec = x.data_ptr() % 16 == 0 and (row * x.element_size()) % 16 == 0
    fn = _library().dsdiff_group_norm_silu
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
                _DTYPES[x.dtype], int(vec), B, row, C, stream)
    if rc != 0:
        raise RuntimeError(f"group_norm_silu launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return y


def group_norm_silu(x, scale, bias, num_groups: int = 32, eps: float = 1e-5):
    """SiLU(GroupNorm(x)) through the CUDA kernel: x [B, H, W, C] contiguous
    on a CUDA device, scale and bias [C]. The kernel has no backward (nor
    has the JAX package's), so it raises rather than return a result with
    no gradient when an input requires one."""
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, scale, bias)
    ):
        raise RuntimeError("group_norm_silu has no backward; call it under "
                           "torch.no_grad() or torch.inference_mode()")
    a, b = coefficients(x, scale, bias, num_groups, eps)
    return apply_kernel(x, a, b)
