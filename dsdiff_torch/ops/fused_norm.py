"""Fused GroupNorm + SiLU: the CUDA kernels' wrapper and the plain version.

Port of the JAX package's ``ops/fused_norm.py:54-97``, the whole function:
group statistics in f32 with ``var = E[x²] - mean²`` and eps 1e-5, folded
into per-(batch, channel) ``a = gamma * rsqrt(var + eps)`` and
``b = beta - mean * a`` (``coefficients``), then ``SiLU(x * a + b)``
(``apply_plain``). ``group_norm_silu`` launches the two kernels of
``csrc/fused_norm.cu``, which compute all of it with no PyTorch op between
them: partial sums per chunk of spatial rows, then a pass that reduces them
per batch row and applies. ``chunking`` picks the chunks. Layout: x
``[B, H, W, C]``, contiguous; the output has x's dtype.

The JAX package's TPU gate ``supports()`` (a v5e measurement) is not carried
over: a CUDA tensor always goes to the kernels, a CPU tensor (through
``ops.fused_group_norm_silu``) to the plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = [
    "coefficients",
    "apply_plain",
    "chunking",
    "group_norm_silu",
    "group_norm_silu_plain",
    "LAUNCHES",
]

# kernel launches since import (or since a caller reset it to 0); a call of
# group_norm_silu launches two
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SHARED_BYTES = 232448  # a block's shared memory on Hopper
_THREADS = 256  # threads per block of both kernels
_SMS = 132  # streaming multiprocessors of an H100 SXM
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


def chunking(B: int, HW: int, C: int, vector: int) -> tuple[int, int]:
    """(rows, chunks): the kernels' blocks each own ``rows`` spatial rows of
    one batch row (the last chunk ``HW - (chunks - 1) * rows``). ``rows`` is
    a multiple of 8, so every chunk starts 16-byte aligned; there are about
    two blocks per SM over the batch, fewer where a chunk would give a thread
    under two ``vector``-element loads."""
    target = -(-2 * _SMS // B)
    by_size = max(1, HW * C // (2 * _THREADS * vector))
    rows = -(-HW // min(target, by_size))
    rows = -(-rows // 8) * 8
    return rows, -(-HW // rows)


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           num_groups: int) -> None:
    """Raise on anything the kernels do not take."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"group_norm_silu takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"group_norm_silu takes [B, H, W, C], got {tuple(x.shape)}")
    B, H, W, C = x.shape
    if not x.is_contiguous():
        raise ValueError("x must be contiguous [B, H, W, C] (channels last)")
    if C % num_groups:
        raise ValueError(f"{C} channels do not split into {num_groups} groups")
    smem = 8 * 2 * num_groups * max(1, _THREADS // (2 * num_groups)) + 8 * C
    if not 1 <= B <= 65535 or H * W * C >= 2**31 or smem > _SHARED_BYTES:
        raise ValueError(f"unsupported sizes B={B} H={H} W={W} C={C}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or t.shape != (C,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [C] tensor")
    if x.device.type != "cuda" or scale.device != x.device or bias.device != x.device:
        raise ValueError(
            f"group_norm_silu needs x, scale, bias on one CUDA device, got "
            f"{x.device}, {scale.device}, {bias.device}"
        )


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("fused_norm")
        fn = lib.dsdiff_group_norm_silu
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def group_norm_silu(x, scale, bias, num_groups: int = 32, eps: float = 1e-5):
    """SiLU(GroupNorm(x)) through the CUDA kernels, statistics included: x
    [B, H, W, C] contiguous on a CUDA device, scale and bias f32 [C]. Two
    launches. The kernels have no backward (nor has the JAX package's), so
    it raises rather than return a result with no gradient when an input
    requires one."""
    global LAUNCHES
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, scale, bias)
    ):
        raise RuntimeError("group_norm_silu has no backward; call it under "
                           "torch.no_grad() or torch.inference_mode()")
    _check(x, scale, bias, num_groups)
    B, H, W, C = x.shape
    HW, elem = H * W, x.element_size()
    vec = x.data_ptr() % 16 == 0 and HW * C * elem % 16 == 0
    vector = 16 // elem if vec else 1
    if C // math.gcd(C, vector) > _THREADS:
        raise ValueError(f"C={C} is not supported with {vector}-element loads")
    rows, chunks = chunking(B, HW, C, vector)
    partials = torch.empty(B * chunks * num_groups * 2, dtype=torch.float64,
                           device=x.device)
    y = torch.empty_like(x)
    index = x.device.index
    rc = _library().dsdiff_group_norm_silu(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), partials.data_ptr(),
        y.data_ptr(), _DTYPES[x.dtype], int(vec), index, B, HW, C,
        num_groups, rows, chunks, eps, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"group_norm_silu launch failed: CUDA error {rc}")
    LAUNCHES += 2
    return y
