"""Flash attention: the CUDA kernel's wrapper and its plain version.

Port of the JAX package's ``ops/flash_attention.py``. ``flash_attention`` launches
the hand-written kernel ``csrc/flash_attention.cu`` on CUDA tensors;
``reference_attention`` is the same math in plain PyTorch (an f32 softmax,
cast back to q's dtype), used for CPU tensors and to check the kernel.
Layout: ``[B, N, heads, D]`` in and out.

The gradient mirrors the JAX package's ``custom_vjp``: ``FlashAttention`` is
an ``autograd.Function`` whose forward is the kernel and whose backward is
the VJP of ``reference_attention``, recomputed from the saved q, k and v.
There is no backward kernel (ROADMAP B1). When no input needs a gradient
(serving, ``torch.inference_mode``) the kernel is launched directly and
nothing is saved.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "reference_attention", "FlashAttention",
           "LAUNCHES", "MAX_HEAD_DIM"]

# forward kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0
MAX_HEAD_DIM = 64  # the kernel pads the head dimension to 64 on chip

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """softmax(q k^T / sqrt(D)) v in plain PyTorch, f32 softmax."""
    D = q.shape[-1]
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) / math.sqrt(D)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", p, v.float()).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on anything the kernel does not take."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes [B, N, heads, D] tensors")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(
            f"flash_attention takes float32 or bfloat16 q, k, v of one dtype, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    B, N, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(
            f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} is outside 1..{MAX_HEAD_DIM}")
    if N < 1 or k.shape[1] < 1 or B * H > 65535:
        raise ValueError(f"unsupported sizes B={B} N={N} M={k.shape[1]} H={H}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the last dimension of q, k and v must be contiguous")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"flash_attention needs q, k, v on one CUDA device, got "
            f"{q.device}, {k.device}, {v.device}"
        )


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        fn = lib.dsdiff_flash_attention
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 12
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Launch the CUDA kernel once; raises on what it does not take."""
    global LAUNCHES
    _check(q, k, v)
    B, N, H, D = q.shape
    M = k.shape[1]
    fn = _library().dsdiff_flash_attention
    o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPES[q.dtype], B, H, N, M, D,
            *(q.stride(i) for i in (0, 1, 2)),
            *(k.stride(i) for i in (0, 1, 2)),
            *(v.stride(i) for i in (0, 1, 2)),
            *(o.stride(i) for i in (0, 1, 2)),
            math.log2(math.e) / math.sqrt(D), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return o


class FlashAttention(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward: the VJP of
    ``reference_attention`` at the saved inputs, as the JAX package's
    ``_fa_bwd`` differentiates its plain math."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [x.detach().requires_grad_(need)
                  for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [x for x in inputs if x.requires_grad]
        with torch.enable_grad():
            out = reference_attention(*inputs)
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return tuple(next(grads) if x.requires_grad else None for x in inputs)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """softmax(q k^T / sqrt(D)) v through the CUDA kernel, [B, N, heads, D].

    q, k and v may be strided views (only the last dimension must be
    contiguous). Differentiable when an input requires grad. Raises on CPU
    tensors and on shapes the kernel does not take.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v)
    return _launch(q, k, v)
