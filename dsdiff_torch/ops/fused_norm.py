"""Fused GroupNorm + SiLU: the CUDA kernels' wrappers and the plain versions.

Port of the JAX package's ``ops/fused_norm.py:54-97``, the whole function:
group statistics in f32 with ``var = E[x²] - mean²`` and eps 1e-5, folded
into per-(batch, channel) ``a = gamma * rsqrt(var + eps)`` and
``b = beta - mean * a`` (``coefficients``), then ``SiLU(x * a + b)``
(``apply_plain``). ``group_norm_silu`` is ``group_norm_film_silu`` (below)
without the FiLM, at eps 1e-5, on x's channels-last ``[B, C, H, W]`` view:
the two kernels of ``csrc/fused_norm.cu`` compute all of it with no PyTorch
op between them, partial sums per chunk of spatial rows, then a pass that
reduces them per batch row and applies. ``chunking`` picks the chunks.
Layout: x ``[B, H, W, C]``, contiguous; the output has x's dtype.

The JAX package's TPU gate ``supports()`` (a v5e measurement) is not carried
over: a CUDA tensor always goes to the kernels, a CPU tensor (through
``ops.fused_group_norm_silu``) to the plain version.

``group_norm_film_silu`` is the ResBlock's norm site in one op (no TPU
kernel behind it; ``csrc/fused_norm.cu`` says why it exists):
``SiLU(GroupNorm32(x) * (1 + scale) + shift)``, the FiLM optional, with
GroupNorm32's eps 1e-6 and its groups, on an NCHW map ``[B, C, H, W]``
held either NCHW-contiguous or channels last, returned in the same memory
format. Its plain version ``group_norm_film_silu_plain`` is the same
function in f32, rounded once to x's dtype. Models reach it through
``ops.group_norm_film_silu`` while no gradient is recorded
(``models.layers.GroupNorm32.silu``).
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build

__all__ = [
    "coefficients",
    "apply_plain",
    "chunking",
    "group_norm_silu",
    "group_norm_silu_plain",
    "nchw_chunking",
    "group_norm_film_silu",
    "group_norm_film_silu_plain",
    "needs_grad",
    "LAUNCHES",
]

# kernel launches since import (or since a caller reset it to 0); a call of
# group_norm_film_silu, and so of group_norm_silu, launches one or two
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SHARED_BYTES = 232448  # a block's shared memory on Hopper
_THREADS = 256  # threads per block of both kernels
_SMS = 132  # streaming multiprocessors of an H100 SXM
_NCHW_BLOCKS = 4 * _SMS  # the NCHW kernels' target grid
_FILM_SHARED_BYTES = 48 * 1024  # the NCHW apply's a and b, static launch
_lib = None
# group_norm_film_silu's launch plans (``_plan``)
_PLANS: dict = {}
_PLANS_MAX = 256


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


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("fused_norm")
        film = lib.dsdiff_group_norm_film_silu
        film.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 2
            + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
        )
        film.restype = ctypes.c_int
        _lib = lib
    return _lib


def group_norm_silu(x, scale, bias, num_groups: int = 32, eps: float = 1e-5):
    """SiLU(GroupNorm(x)) through the CUDA kernels, statistics included: x
    [B, H, W, C] contiguous on a CUDA device, scale and bias f32 [C].
    ``group_norm_film_silu`` on x's channels-last view with no FiLM: two
    launches, or its NCHW kernels where that view is also NCHW-contiguous
    (H * W = 1 or C = 1) or, on a copy, where a thread's loads cannot keep
    the channels (above 1,024 f32 or 2,048 bf16, above 256 unaligned). The
    kernels have no backward (nor has the JAX package's), so it raises
    rather than return a result with no gradient when an input requires
    one."""
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, scale, bias)
    ):
        raise RuntimeError("group_norm_silu has no backward; call it under "
                           "torch.no_grad() or torch.inference_mode()")
    if x.ndim != 4:
        raise ValueError(f"group_norm_silu takes [B, H, W, C], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous [B, H, W, C] (channels last)")
    y = group_norm_film_silu(x.permute(0, 3, 1, 2), scale, bias, num_groups,
                             eps=eps)
    return y.permute(0, 2, 3, 1)


def group_norm_film_silu_plain(x, gamma, beta, num_groups: int, scale=None,
                               shift=None, eps: float = 1e-6):
    """``SiLU(GroupNorm(x) * (1 + scale) + shift)`` (``SiLU(GroupNorm(x))``
    without scale and shift) in plain PyTorch: x [B, C, ...], gamma and beta
    [C], scale and shift broadcast to [B, C, 1, 1]; every step in f32, one
    rounding to x's dtype. In f32 it is ``GroupNorm32`` -> FiLM -> SiLU op
    for op."""
    h = F.group_norm(x.float(), num_groups, gamma.float(), beta.float(), eps)
    if scale is not None:
        h = h * (1.0 + scale.float()) + shift.float()
    return F.silu(h).to(x.dtype)


def needs_grad(x, gamma, beta, scale=None, shift=None) -> bool:
    """Whether autograd records a gradient through the norm site: grad mode
    is on and an input requires one. ``group_norm_film_silu`` raises then
    (its kernels have no backward); ``GroupNorm32.silu`` takes the eager
    chain."""
    return torch.is_grad_enabled() and (
        x.requires_grad or gamma.requires_grad or beta.requires_grad
        or (scale is not None
            and (scale.requires_grad or shift.requires_grad)))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def nchw_chunking(B: int, G: int, run: int, vector: int) -> tuple[int, int]:
    """(len, chunks) for the NCHW kernels: each of the ``B * G`` runs of
    ``run`` elements is cut into ``chunks`` chunks of ``len`` elements (a
    multiple of 8, so each starts 16-byte aligned; the last ragged), to give
    about ``_NCHW_BLOCKS`` blocks, a thread from 4 to 32 ``vector``-element
    loads where the run allows. One chunk means one launch."""
    lo, hi = _THREADS * vector * 4, _THREADS * vector * 32
    chunks = max(_cdiv(_NCHW_BLOCKS, B * G), _cdiv(run, hi))
    chunks = max(1, min(chunks, _cdiv(run, lo)))
    length = _cdiv(_cdiv(run, chunks), 8) * 8
    return length, _cdiv(run, length)


def _film_plan(x, gamma, beta, num_groups, scale, shift) -> tuple:
    """Check what the kernels take (raise on anything else) and plan the
    launch: (channels_last, vec possible, B, HW, C, chunk, chunks, partials
    numel, film stride, launches)."""
    if x.dtype not in _DTYPES:
        raise TypeError("group_norm_film_silu takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.ndim != 4:
        raise ValueError("group_norm_film_silu takes [B, C, H, W], got "
                         f"{tuple(x.shape)}")
    B, C, H, W = x.shape
    HW, G = H * W, num_groups
    if x.device.type != "cuda":
        raise ValueError("group_norm_film_silu needs a CUDA tensor, got "
                         f"{x.device}")
    if G < 1 or C % G:
        raise ValueError(f"{C} channels do not split into {G} groups")
    if B < 1 or B * C * HW >= 2**31:
        raise ValueError(f"unsupported sizes B={B} C={C} H={H} W={W}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if (t.dtype != torch.float32 or t.shape != (C,) or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"{name} must be a contiguous float32 [C] tensor "
                             f"on {x.device}")
    film_stride = 0
    if (scale is None) != (shift is None):
        raise ValueError("give both scale and shift, or neither")
    if scale is not None:
        for name, t in (("scale", scale), ("shift", shift)):
            if (t.dtype != x.dtype or t.device != x.device
                    or tuple(t.shape) not in ((B, C), (B, C, 1, 1))
                    or (C > 1 and t.stride(1) != 1)):
                raise ValueError(
                    f"{name} must be {x.dtype} [B, C] or [B, C, 1, 1] on "
                    f"{x.device} with its channels contiguous")
        if scale.stride(0) != shift.stride(0):
            raise ValueError("scale and shift need the same batch stride")
        film_stride = scale.stride(0)
    vector = 16 // x.element_size()
    if x.is_contiguous():
        if B * G > 65535 or 8 * (C // G) > _FILM_SHARED_BYTES:
            raise ValueError(f"unsupported sizes B={B} C={C} groups={G}")
        run = C // G * HW
        length, chunks = nchw_chunking(B, G, run, vector)
        partials = 2 * B * G * chunks if chunks > 1 else 0
        return (False, HW % vector == 0, B, HW, C, length, chunks, partials,
                film_stride, 1 if chunks == 1 else 2)
    if x.is_contiguous(memory_format=torch.channels_last):
        smem = 8 * 2 * G * max(1, _THREADS // (2 * G)) + 8 * C
        if B > 65535 or smem > _SHARED_BYTES:
            raise ValueError(f"unsupported sizes B={B} C={C} groups={G}")
        # a thread's loads keep their channels: C / gcd(C, vector) <= 256
        vec = (HW * C * x.element_size() % 16 == 0
               and C // math.gcd(C, vector) <= _THREADS)
        rows, chunks = chunking(B, HW, C, vector)
        return (True, vec, B, HW, C, rows, chunks, 2 * B * chunks * G,
                film_stride, 2)
    raise ValueError("x must be NCHW-contiguous or channels last")


def _plan(x, gamma, beta, num_groups, scale, shift) -> tuple:
    """``_film_plan`` cached by the inputs' shapes, strides, dtypes and
    devices; past _PLANS_MAX plans the oldest is dropped."""
    key = (x.shape, x.stride(), x.dtype, x.device, num_groups,
           gamma.shape, gamma.stride(), gamma.dtype, gamma.device,
           beta.shape, beta.stride(), beta.dtype, beta.device,
           None if scale is None else (scale.shape, scale.stride(),
                                       scale.dtype, scale.device,
                                       shift.shape, shift.stride(),
                                       shift.dtype, shift.device))
    plan = _PLANS.get(key)
    if plan is None:
        if len(_PLANS) >= _PLANS_MAX:
            del _PLANS[next(iter(_PLANS))]
        plan = _PLANS[key] = _film_plan(x, gamma, beta, num_groups, scale,
                                        shift)
    return plan


def group_norm_film_silu(x, gamma, beta, num_groups: int, scale=None,
                         shift=None, eps: float = 1e-6):
    """``group_norm_film_silu_plain``'s function through the CUDA kernels: x
    [B, C, H, W] f32 or bf16 on a CUDA device, NCHW-contiguous or channels
    last (y has x's memory format and dtype); gamma and beta f32 [C]; scale
    and shift (both or neither) of x's dtype, [B, C] or [B, C, 1, 1] with
    contiguous channels (a ``chunk`` of a [B, 2C, 1, 1] map will do). One
    launch (NCHW, small maps) or two. Raises where an input requires a
    gradient: the kernels have no backward."""
    global LAUNCHES
    if needs_grad(x, gamma, beta, scale, shift):
        raise RuntimeError("group_norm_film_silu has no backward; call it "
                           "under torch.no_grad() or torch.inference_mode()")
    plan = _plan(x, gamma, beta, num_groups, scale, shift)
    cl, vec_ok, B, HW, C, chunk, chunks, n_partials, film_stride, launches = plan
    vec = vec_ok and x.data_ptr() % 16 == 0
    if cl and not vec and C > _THREADS:
        # channels last with channels the kernels' element loads cannot
        # keep per thread (f32 above 1024 channels, an unaligned start):
        # the NCHW kernels on an NCHW copy
        y = group_norm_film_silu(x.contiguous(), gamma, beta, num_groups,
                                 scale, shift, eps)
        return y.contiguous(memory_format=torch.channels_last)
    partials = (torch.empty(n_partials, dtype=torch.float64, device=x.device)
                if n_partials else None)
    y = torch.empty_like(x)
    index = x.device.index
    rc = _library().dsdiff_group_norm_film_silu(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if shift is None else shift.data_ptr(), film_stride,
        None if partials is None else partials.data_ptr(), y.data_ptr(),
        _DTYPES[x.dtype], int(vec), int(cl), index, B, HW, C, num_groups,
        chunk, chunks, eps, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(
            f"group_norm_film_silu launch failed: CUDA error {rc}")
    LAUNCHES += launches
    return y
