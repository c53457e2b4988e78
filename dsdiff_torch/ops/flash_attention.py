"""Flash attention: the CUDA kernel's wrapper and its plain version.

Port of the JAX package's ``ops/flash_attention.py``. ``flash_attention`` launches
the hand-written kernel ``csrc/flash_attention.cu`` on CUDA tensors;
``reference_attention`` is the same math in plain PyTorch (an f32 softmax,
cast back to q's dtype), used for CPU tensors and to check the kernel.
Layout: ``[B, N, heads, D]`` in and out, head dims 1 to 512: the TPU
kernel's up to 256 (the flagship's 48, DiT-B's 64, DiT-XL's 72, the
disc_diff and palette U-Nets' 192) and the KL-VAE's single 512-wide head,
which the JAX package sends to XLA and the port to the kernel. Above 256
each 64-row Q tile takes two blocks, each owning half of the output's
columns (both compute the full scores).

The kernel has one route per dtype (``ROUTES``), both on the tensor cores:
bf16 through ``wgmma`` with K/V fed by TMA, f32 through ``mma.sync`` in three
TF32 passes (``tf32x3``: each operand split into a TF32 high and low part,
which keeps the products f32-accurate) with K/V fed by ``cp.async``. The
bf16 route reads q, k and v through TMA tensor maps, which need 16-byte
aligned bases and batch, row and head strides that are multiples of 8
elements; the f32 route takes any strides (16-byte copies where the layout
allows them, 4-byte copies otherwise).

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
           "LAUNCHES", "MAX_HEAD_DIM", "ROUTES"]

# forward kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0
# bf16 pads the head dimension to a multiple of 64 on chip (one 128-byte
# swizzle atom; 384 or 512 above 256), f32 to a multiple of 8 up to 64 and
# to 96, 128, 192, 256, 384 or 512 above
MAX_HEAD_DIM = 512
# the kernel's route for each dtype it takes
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LOG2E = math.log2(math.e)
_lib = None


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """softmax(q k^T / sqrt(D)) v in plain PyTorch, f32 softmax."""
    D = q.shape[-1]
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) / math.sqrt(D)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", p, v.float()).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Raise on anything the kernel does not take; returns the strides of
    q, k and v. Kept lean: it runs before every launch."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes [B, N, heads, D] tensors")
    dtype = q.dtype
    if not (dtype == k.dtype == v.dtype) or dtype not in _DTYPES:
        raise TypeError(
            f"flash_attention takes float32 or bfloat16 q, k, v of one dtype, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    B, N, H, D = q.shape
    kshape = k.shape
    if kshape != v.shape or kshape[0] != B or kshape[2] != H or kshape[3] != D:
        raise ValueError(
            f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} is outside 1..{MAX_HEAD_DIM}")
    if N < 1 or kshape[1] < 1 or B * H > 65535:
        raise ValueError(f"unsupported sizes B={B} N={N} M={kshape[1]} H={H}")
    strides = (q.stride(), k.stride(), v.stride())
    if strides[0][3] != 1 or strides[1][3] != 1 or strides[2][3] != 1:
        raise ValueError("the last dimension of q, k and v must be contiguous")
    if dtype == torch.bfloat16:  # what a TMA tensor map can describe
        for name, x, st in zip("qkv", (q, k, v), strides):
            if x.data_ptr() % 16:
                raise ValueError(f"bf16 {name} must start 16-byte aligned")
            if st[0] % 8 or st[1] % 8 or st[2] % 8:
                raise ValueError(
                    f"bf16 {name}'s batch, row and head strides must be "
                    f"multiples of 8 elements, got {st}")
    device = q.device
    if device.type != "cuda" or k.device != device or v.device != device:
        raise ValueError(
            f"flash_attention needs q, k, v on one CUDA device, got "
            f"{q.device}, {k.device}, {v.device}"
        )
    return strides


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        fn = lib.dsdiff_flash_attention
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 12
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Launch the CUDA kernel once; raises on what it does not take. The
    C entry launches on q's device and that device's current stream."""
    global LAUNCHES
    qs, ks, vs = _check(q, k, v)
    B, N, H, D = q.shape
    fn = _library().dsdiff_flash_attention
    o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    index = q.device.index
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPES[q.dtype], index, B, H, N, k.shape[1], D,
        qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
        N * H * D, H * D, D,  # o is contiguous
        # the current stream's raw handle: torch.cuda.current_stream()
        # builds a Stream object, microseconds of host time per launch
        _LOG2E / math.sqrt(D), torch._C._cuda_getCurrentRawStream(index),
    )
    if rc == -1:
        raise RuntimeError("flash_attention: the CUDA driver has no "
                           "cuTensorMapEncodeTiled")
    if rc <= -1000:
        raise RuntimeError(f"flash_attention: TMA tensor map refused, "
                           f"CUresult {-rc - 1000}")
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
