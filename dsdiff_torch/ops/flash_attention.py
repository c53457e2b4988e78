"""Flash attention: the CUDA kernel's wrapper and its plain version.

Port of the JAX package's ``ops/flash_attention.py``. ``flash_attention`` launches
the hand-written kernel ``csrc/flash_attention.cu`` on CUDA tensors;
``reference_attention`` is the same math in plain PyTorch (an f32 softmax,
cast back to q's dtype), used for CPU tensors and to check the kernel.
Layout: ``[B, N, heads, D]`` in and out, head dims 1 to 512: the TPU
kernel's up to 256 (the flagship's 48, DiT-B's 64, DiT-XL's 72, the
disc_diff and palette U-Nets' 192) and the KL-VAE's single 512-wide head,
which the JAX package sends to XLA and the port to the kernel.

The kernel has one route per dtype (``ROUTES``), both on the tensor cores:
bf16 through ``wgmma`` (``bf16_plan`` names its kernel: for 64 < D <= 256
a warp-specialised block of 128 Q rows, two consumer warpgroups and a
producer, ``wgmma_ws``), f32 in three TF32 passes (``tf32x3``: each operand
split into a TF32 high and low part, which keeps the products
f32-accurate; ``f32_plan`` names its kernel: above D = 64 ``tf32x3_ws``,
``wgmma`` with two consumer warpgroups and a producer that loads K and V
through TMA and splits each tile once, up to 64 ``tf32x3``, ``mma.sync``
with tiles by ``cp.async``). Both routes take any strides with a contiguous
last dimension. Up to D = 64 the bf16 route reads q, k and v through TMA
tensor maps where they can describe the layout (16-byte aligned bases,
batch, row and head strides that are multiples of 8 elements); otherwise
(a head of D = 36 has a 72-byte head stride) the kernel's threads load the
same swizzled tiles themselves, 8, 4 or 2 bytes a copy (``bf16_load`` says
which); the f32 route copies 16 bytes where the layout allows it and 4
otherwise (``f32_load``). Above D = 64 both kernels read through TMA only
(f32: 16-byte aligned bases, strides multiples of 4 floats), and the
wrapper hands a layout no map describes to them as contiguous copies of q,
k and v, rows padded to a multiple of 8 elements (load ``"copy"``). Every
head above 64 that a shipped model makes lies on a TMA layout.

The gradient is the VJP of ``reference_attention``, the f32 math the JAX
package's ``custom_vjp`` (``_fa_bwd``) differentiates. ``FlashAttention`` is
an ``autograd.Function`` whose forward is the kernel and whose backward
takes one of two routes (``backward_route``): bf16 q, k, v with D <= 128
(every trained head of the shipped configurations below DisC-Diff's) go to
the backward kernels ``attn_bwd_dq`` and ``attn_bwd_dkdv`` of the same
source, whose forward launch also writes each row's log-sum-exp
(``_launch_lse``); f32 and D > 128 go to ``attention_vjp``, the plain
math's gradient in f32, recomputed from the saved q, k and v. The backward
kernels keep the scores on chip, put every product on the tensor cores and
give each f32 operand (P, dS) as a bf16 high and low part, so they compute
the same f32 VJP (the source's header says how). Their dq is a
deterministic sum: two calls give the same bits. The backward runs in an
``attention.backward`` span (``utils.profiling``; attributes B, N, heads,
D) and counts ``attention.bwd_kernel`` or ``attention.bwd_plain`` in it.
When no input needs a gradient (serving, ``torch.inference_mode``) the
forward kernel is launched directly, without the log-sum-exp, and nothing
is saved.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..utils.profiling import count, span
from . import _build

__all__ = ["flash_attention", "reference_attention", "reference_lse",
           "attention_vjp", "FlashAttention",
           "bf16_load", "bf16_plan", "f32_load", "f32_plan", "route",
           "backward_route", "bwd_plan",
           "LAUNCHES", "BACKWARD_LAUNCHES", "MAX_HEAD_DIM", "MAX_BWD_HEAD_DIM",
           "ROUTES", "BF16_LOADS", "BF16_KERNELS", "F32_KERNELS",
           "BWD_KERNELS", "SMEM_LIMIT"]

# forward kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0
# backward kernel launches (one a backward call: attn_bwd_dq and / or
# attn_bwd_dkdv) since import, or since a caller reset it to 0
BACKWARD_LAUNCHES = 0
# bf16 pads the head dimension to a multiple of 64 on chip (one 128-byte
# swizzle atom; 384 or 512 above 256), f32 to a multiple of 8 up to 64 and
# to 96, 128, 192, 256, 384 or 512 above
MAX_HEAD_DIM = 512
# the kernel's route for each dtype it takes
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}
# how the bf16 route loads its tiles, by the kernel's `vec` argument: TMA,
# or (D <= 64) its threads this many elements a copy; above D = 64 a layout
# with vec != 0 is copied first (bf16_load's "copy")
BF16_LOADS = {0: "tma", 4: "cp.async 8 B", 2: "cp.async 4 B", 1: "ld 2 B"}

# the bf16 route's two kernels (csrc/flash_attention.cu): one warpgroup a
# 64-row Q tile (attn_fwd_wgmma), or, for 64 < D <= 256, two consumer
# warpgroups and a producer a 128-row Q tile (attn_fwd_ws)
BF16_KERNELS = ("wgmma", "wgmma_ws")
# the f32 route's two kernels (csrc/flash_attention.cu): up to D = 64
# mma.sync with the threads' copies, one block a 64-row Q tile
# (attn_fwd_tf32x3), above it wgmma with two consumer warpgroups and a
# producer (attn_fwd_tf32x3_ws)
F32_KERNELS = ("tf32x3", "tf32x3_ws")
# the backward's two kernels (csrc/flash_attention.cu): delta and dq over
# 128 query rows a block, then dk and dv over 128 key rows a block
BWD_KERNELS = ("attn_bwd_dq", "attn_bwd_dkdv")
# the widest head the backward kernels take (bf16)
MAX_BWD_HEAD_DIM = 128
# shared memory a block may have on an H100
SMEM_LIMIT = 232448
# attn_fwd_tf32x3_ws: ring stages (atoms of 32 columns) and the registers
# of its producer and of each consumer thread after setmaxnreg
_FW_STAGES, _FW_PRODUCER_REGS, _FW_CONSUMER_REGS = 8, 72, 216

# csrc/flash_attention.cu's tile constants: K/V tile and attn_fwd_wgmma's Q
# rows, one 128-byte swizzle atom of a 64-row tile, attn_fwd_ws's consumer
# warpgroups and K/V ring depth
_TILE, _ATOM_BYTES, _WS_CONSUMERS, _WS_STAGES = 64, 64 * 64 * 2, 2, 2
# the backward kernels: rows a block, column-tile stages, one tile's LSE and
# delta bytes; and, as the source's bw_plan, (the widest D padded to 8 a
# row takes, the k-steps of S and dP, the output products' n)
_BW_ROWS, _BW_STAGES, _BW_STATS_BYTES = 2 * _TILE, 3, 2 * _TILE * 4
_BW_TILES = ((32, 2, 32), (48, 3, 48), (64, 4, 64), (72, 5, 72), (80, 5, 80),
             (96, 6, 96), (128, 8, 128))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LOG2E = math.log2(math.e)
_lib = None


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """softmax(q k^T / sqrt(D)) v in plain PyTorch, f32 softmax."""
    D = q.shape[-1]
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) / math.sqrt(D)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", p, v.float()).to(q.dtype)


def reference_lse(q: torch.Tensor, k: torch.Tensor):
    """The row log-sum-exp the gradient path's forward writes, in plain
    PyTorch: ``[B·heads, npad]`` f32, log2 units of the scores scaled by
    log2(e)/sqrt(D) (log2 of the softmax's denominator), rows padded to a
    multiple of 64 with +inf."""
    B, N, H, D = q.shape
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    lse = torch.logsumexp(s / math.sqrt(D), dim=-1) / math.log(2.0)
    out = torch.full((B * H, -(-N // _TILE) * _TILE), math.inf,
                     dtype=torch.float32, device=q.device)
    out[:, :N] = lse.reshape(B * H, N)
    return out


def attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  grad_out: torch.Tensor, needs=(True, True, True)):
    """The VJP of ``reference_attention`` at q, k, v ([B, N|M, heads, D])
    for the cotangent ``grad_out``: (dq, dk, dv) in the inputs' dtypes,
    None where ``needs`` is False. The plain math's gradient, f32
    throughout, as autograd through it gives it to rounding, in five
    batched products over [B·heads, rows, D] copies: S = (q / sqrt(D)) kᵀ,
    P = softmax(S), dv = Pᵀ dO, dP = dO vᵀ, dS = softmax's backward,
    dq = dS k / sqrt(D), dk = dSᵀ (q / sqrt(D)). The scale rides on q and
    dq (no pass over the scores for it), and the forward's second product,
    which no gradient reads, is not made."""
    B, N, H, D = q.shape
    scale = 1.0 / math.sqrt(D)

    def heads(x):  # a fresh f32 [B·heads, rows, D] copy, in one pass
        out = torch.empty((B, H, x.shape[1], D), dtype=torch.float32,
                          device=x.device)
        return out.copy_(x.transpose(1, 2)).view(B * H, -1, D)

    def back(x, like):
        return x.view(B, H, -1, D).transpose(1, 2).to(like.dtype)

    qs = heads(q).mul_(scale)
    kf, vf, g = heads(k), heads(v), heads(grad_out)
    p = torch.softmax(torch.bmm(qs, kf.transpose(1, 2)), dim=-1)
    dq = dk = dv = None
    if needs[2]:
        dv = back(torch.bmm(p.transpose(1, 2), g), v)
    if needs[0] or needs[1]:
        ds = torch._softmax_backward_data(torch.bmm(g, vf.transpose(1, 2)),
                                          p, -1, torch.float32)
        del p
        if needs[0]:
            dq = back(torch.bmm(ds, kf).mul_(scale), q)
        if needs[1]:
            dk = back(torch.bmm(ds.transpose(1, 2), qs), k)
    return dq, dk, dv


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
    device = q.device
    if device.type != "cuda" or k.device != device or v.device != device:
        raise ValueError(
            f"flash_attention needs q, k, v on one CUDA device, got "
            f"{q.device}, {k.device}, {v.device}"
        )
    return strides


def _vec(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, strides) -> int:
    """The bf16 kernel's ``vec``: 0 where TMA tensor maps describe q, k and
    v (16-byte aligned bases, batch, row and head strides multiples of 8
    elements), else the widest copy of 4, 2 or 1 elements that divides D,
    every stride and every base's alignment in elements."""
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    for vec in (8, 4, 2):
        if (all(p % (2 * vec) == 0 for p in ptrs)
                and all(st[i] % vec == 0 for st in strides for i in range(3))
                and (vec == 8 or q.shape[3] % vec == 0)):
            return 0 if vec == 8 else vec
    return 1


def bf16_load(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """How the bf16 route loads these q, k and v (``BF16_LOADS``): "tma",
    or where a tensor map cannot describe the layout its threads' copies
    (D <= 64) or, above 64, "copy": TMA from the wrapper's contiguous
    copies."""
    vec = _vec(q, k, v, (q.stride(), k.stride(), v.stride()))
    return "copy" if vec and q.shape[3] > 64 else BF16_LOADS[vec]


def bf16_plan(B: int, N: int, H: int, D: int) -> dict:
    """The bf16 launch the C entry makes for [B, N, H, D] q, on every
    layout (above D = 64 a TMA one, the caller's or the wrapper's copy):
    its kernel (``BF16_KERNELS``), the 128-byte atoms of a Q/K row
    (``atoms``) and of O a block owns (``o_atoms``), the Q rows, K/V ring
    stages, consumer warpgroups and threads of a block, its dynamic shared
    memory in bytes (the tiles and 1024 to align them) and its grid.
    ``dsdiff_flash_attention_bf16_plan`` in the source returns the same
    numbers."""
    if D <= 64:
        na, nv = 1, 1
    elif D <= 256:
        na = nv = -(-D // 64)
    else:  # two blocks a Q tile, each owning half of O's columns
        na = 6 if D <= 384 else 8
        nv = na // 2
    if 64 < D <= 256:
        rows, stages, consumers = _TILE * _WS_CONSUMERS, _WS_STAGES, _WS_CONSUMERS
        threads = 128 * (consumers + 1)  # + the producer's warpgroup
        # Q, and each stage of the K ring and of the V ring
        smem = (consumers + 2 * stages) * na * _ATOM_BYTES + 1024
        kernel = "wgmma_ws"
    else:
        rows, consumers, threads = _TILE, 1, 128
        stages = 2 if na == 1 else 1
        smem = (na + stages * (na + nv)) * _ATOM_BYTES + 1024
        kernel = "wgmma"
    return dict(kernel=kernel, atoms=na, o_atoms=nv, q_rows=rows,
                stages=stages, consumers=consumers, threads=threads,
                smem_bytes=smem, grid=(-(-N // rows), B * H, na // nv))


def _f32_vec(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             strides) -> int:
    """The f32 route's ``vec``: 0 where TMA maps describe q, k and v
    (16-byte aligned bases, batch, row and head strides multiples of 4
    floats; the kernel's own test), else 1."""
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    aligned = (all(p % 16 == 0 for p in ptrs)
               and all(st[i] % 4 == 0 for st in strides for i in range(3)))
    return 0 if aligned else 1


def f32_load(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """How the f32 route loads these q, k and v: above D = 64 "tma" where a
    tensor map describes them, else "copy" (TMA from the wrapper's
    contiguous copies); up to 64 its threads' "cp.async 16 B" (the same
    alignment and D a multiple of 4) or "cp.async 4 B"."""
    D = q.shape[3]
    vec = _f32_vec(q, k, v, (q.stride(), k.stride(), v.stride()))
    if D > 64:
        return "copy" if vec else "tma"
    return "cp.async 16 B" if vec == 0 and D % 4 == 0 else "cp.async 4 B"


def f32_plan(B: int, N: int, H: int, D: int) -> dict:
    """The f32 launch the C entry makes for [B, N, H, D] q, on every layout
    (above D = 64 a TMA one, the caller's or the wrapper's copy): its kernel
    (``F32_KERNELS``), D padded in k-steps of 8 (``dk``; ``tf32x3_ws``
    reads ``dk / 4`` atoms of 32 columns), the Q rows of a block, the keys
    of a K/V tile, ring stages, consumer warpgroups, threads, its dynamic
    shared memory in bytes and its grid; for ``tf32x3_ws`` also whether its
    two consumers share one 64-row Q tile, each owning half of O's columns
    (``split``), and the registers of its warpgroups (``producer_regs``,
    ``consumer_regs``) and of a consumer thread's accumulators
    (``accumulator_regs``: O, the fused S, Q's lo fragments of an atom).
    ``dsdiff_flash_attention_f32_plan`` in the source returns the same
    numbers."""
    dk = (-(-D // 8) if D <= 64 else 12 if D <= 96 else 16 if D <= 128
          else 24 if D <= 192 else 32 if D <= 256 else 48 if D <= 384 else 64)
    if D > 64:
        split = D > 256
        # O's 128 registers a thread at D = 256 and 512 leave room for the
        # scores of 32 keys only
        na, kt = dk // 4, 64 if dk <= 24 else 32
        rows = _TILE if split else 2 * _TILE
        xbuf = 2 * 2 * _TILE * kt * 4 if split else 0
        smem = rows * na * 128 + xbuf + _FW_STAGES * 2 * kt * 128 + 1024
        o_atoms = na // 2 if split else na
        return dict(kernel="tf32x3_ws", dk=dk, q_rows=rows, key_rows=kt,
                    stages=_FW_STAGES, consumers=2, threads=384,
                    smem_bytes=smem, grid=(-(-N // rows), B * H, 1),
                    split=split, producer_regs=_FW_PRODUCER_REGS,
                    consumer_regs=_FW_CONSUMER_REGS,
                    accumulator_regs=16 * o_atoms + kt + 16)
    ld = 8 * dk + 4  # a tile row in floats, padded against bank conflicts
    stages = 2  # the K/V ring
    return dict(kernel="tf32x3", dk=dk, q_rows=_TILE, key_rows=_TILE,
                stages=stages, consumers=1, threads=128,
                smem_bytes=(1 + 2 * stages) * _TILE * ld * 4,
                grid=(-(-N // _TILE), B * H, 1), split=False)


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel these q, k, v run: the ``bf16_plan`` or ``f32_plan``
    kernel of their dtype and head dim (above D = 64 on the wrapper's
    copies where no TMA map describes the layout)."""
    B, N, H, D = q.shape
    plan = bf16_plan if q.dtype == torch.bfloat16 else f32_plan
    return plan(B, N, H, D)["kernel"]


def backward_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Where ``FlashAttention.backward`` takes these q, k, v: "kernel"
    (``BWD_KERNELS``) for bf16 with D <= 128, else "plain"
    (``attention_vjp``: f32, and DisC-Diff's, palette's and the VAE's wider
    heads)."""
    if q.dtype == torch.bfloat16 and q.shape[3] <= MAX_BWD_HEAD_DIM:
        return "kernel"
    return "plain"


def bwd_plan(B: int, N: int, M: int, H: int, D: int) -> dict:
    """The backward launches for [B, N, H, D] q and [B, M, H, D] k, v
    (bf16, D <= 128): its kernels (``BWD_KERNELS``), D padded to a multiple
    of 8 (``dp``; the wrapper copies an operand to that width where D is
    not), the k-steps of 16 of S = Q Kᵀ and dP = dO Vᵀ, the n of the output
    products (``n``), the 64-column atoms a tile row spans, the rows a block
    owns (two consumer warpgroups of 64 and a producer), the rows of a
    streamed column tile, its ring's stages, threads, dynamic shared memory
    in bytes, each kernel's grid and the padded length of the LSE and delta
    rows (``npad``). ``dsdiff_flash_attention_bwd_plan`` in the source
    returns the same numbers."""
    dp = -(-D // 8) * 8
    ksteps, n = next((k, n) for top, k, n in _BW_TILES if dp <= top)
    atoms = -(-ksteps // 4)
    smem = (2 * atoms * _BW_ROWS * 128
            + _BW_STAGES * (2 * atoms * _ATOM_BYTES + _BW_STATS_BYTES) + 1024)
    return dict(kernels=BWD_KERNELS, dp=dp, ksteps=ksteps, n=n, atoms=atoms,
                rows=_BW_ROWS, key_rows=_TILE, stages=_BW_STAGES,
                threads=3 * 128, smem_bytes=smem,
                grid_dq=(-(-N // _BW_ROWS), B * H, 1),
                grid_dkdv=(-(-M // _BW_ROWS), B * H, 1),
                npad=-(-N // _TILE) * _TILE)


def native_bwd_plan(B: int, N: int, M: int, H: int, D: int) -> dict:
    """``bwd_plan``'s numbers as the built kernel library gives them (needs
    the library, so ``nvcc``)."""
    fn = _library().dsdiff_flash_attention_bwd_plan
    out = (ctypes.c_int * 10)()
    fn(B, H, N, M, D, out)
    return dict(ksteps=out[0], n=out[1], stages=out[2], threads=out[3],
                smem_bytes=out[4], grid_dq=(out[5], out[6], 1),
                grid_dkdv=(out[7], out[8], 1), npad=out[9])


def native_bf16_plan(B: int, N: int, H: int, D: int) -> dict:
    """``bf16_plan``'s numbers as the built kernel library gives them
    (needs the library, so ``nvcc``)."""
    fn = _library().dsdiff_flash_attention_bf16_plan
    out = (ctypes.c_int * 8)()
    fn(B, H, N, D, out)
    return dict(kernel=BF16_KERNELS[out[0]], q_rows=out[1], stages=out[2],
                threads=out[3], smem_bytes=out[4],
                grid=(out[5], out[6], out[7]))


def native_f32_plan(B: int, N: int, H: int, D: int) -> dict:
    """``f32_plan``'s numbers as the built kernel library gives them
    (needs the library, so ``nvcc``)."""
    fn = _library().dsdiff_flash_attention_f32_plan
    out = (ctypes.c_int * 9)()
    fn(B, H, N, D, out)
    return dict(kernel=F32_KERNELS[out[0]], q_rows=out[1], key_rows=out[2],
                stages=out[3], threads=out[4], smem_bytes=out[5],
                grid=(out[6], out[7], out[8]))


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        fn = lib.dsdiff_flash_attention
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 8
            + [ctypes.c_longlong] * 12
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        fn = lib.dsdiff_flash_attention_lse
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 8
            + [ctypes.c_longlong] * 12
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        fn = lib.dsdiff_flash_attention_backward
        fn.argtypes = (
            [ctypes.c_void_p] * 9
            + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 12
            + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        plan = lib.dsdiff_flash_attention_bwd_plan
        plan.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
        plan.restype = None
        plan = lib.dsdiff_flash_attention_bf16_plan
        plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        plan.restype = None
        plan = lib.dsdiff_flash_attention_f32_plan
        plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        plan.restype = None
        _lib = lib
    return _lib


def _raise_rc(rc: int, what: str) -> None:
    if rc == -1:
        raise RuntimeError(f"{what}: the CUDA driver has no "
                           "cuTensorMapEncodeTiled")
    if rc <= -1000:
        raise RuntimeError(f"{what}: TMA tensor map refused, "
                           f"CUresult {-rc - 1000}")
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse=None):
    """Launch the CUDA kernel once; raises on what it does not take. The
    C entry launches on q's device and that device's current stream.
    ``lse`` (``_launch_lse``): the gradient path's launch, which also
    writes each row's log-sum-exp there. Above D = 64 q, k and v that no
    TMA map describes go to the kernel as contiguous copies."""
    global LAUNCHES
    qs, ks, vs = _check(q, k, v)
    B, N, H, D = q.shape
    lib = _library()
    is_bf16 = _DTYPES[q.dtype]
    vec = (_vec(q, k, v, (qs, ks, vs)) if is_bf16
           else _f32_vec(q, k, v, (qs, ks, vs)) if D > 64 else 0)
    if vec and D > 64:
        q, k, v = (_tma_operand(x, -(-D // 8) * 8)[..., :D] for x in (q, k, v))
        qs, ks, vs, vec = q.stride(), k.stride(), v.stride(), 0
    o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    index = q.device.index
    args = (
        index, B, H, N, k.shape[1], D,
        qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
        N * H * D, H * D, D,  # o is contiguous
        # the current stream's raw handle: torch.cuda.current_stream()
        # builds a Stream object, microseconds of host time per launch
        _LOG2E / math.sqrt(D), torch._C._cuda_getCurrentRawStream(index),
    )
    if lse is None:
        rc = lib.dsdiff_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            is_bf16, vec, *args)
    else:
        rc = lib.dsdiff_flash_attention_lse(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), lse.shape[1], vec, *args)
    _raise_rc(rc, "flash_attention")
    LAUNCHES += 1
    return o


def _launch_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The gradient path's forward (bf16, D <= 128): (o, lse), lse as
    ``reference_lse`` gives it, written by the same launch."""
    B, N, H, _ = q.shape
    lse = torch.empty((B * H, -(-N // _TILE) * _TILE), dtype=torch.float32,
                      device=q.device)
    return _launch(q, k, v, lse), lse


def _tma_operand(x: torch.Tensor, dp: int) -> torch.Tensor:
    """x as a TMA tensor map can describe it: itself where one does at
    width ``dp`` (16-byte aligned base, batch, row and head strides positive
    multiples of 8 elements), else a contiguous copy zero-padded to ``dp``
    columns (the backward kernels' operands: a head of D = 36; the
    forward's above D = 64)."""
    if (x.shape[3] == dp and x.data_ptr() % 16 == 0
            and all(s > 0 and s % 8 == 0 for s in x.stride()[:3])):
        return x
    out = x.new_zeros(x.shape[:3] + (dp,))
    out[..., :x.shape[3]] = x
    return out


def _launch_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     grad_out: torch.Tensor, lse: torch.Tensor,
                     needs=(True, True, True)):
    """(dq, dk, dv) of the forward that wrote ``lse`` (``_launch_lse``),
    through the backward kernels, None where ``needs`` is False:
    ``attn_bwd_dq`` for dq or dk (its delta feeds dk), ``attn_bwd_dkdv`` for
    dk or dv. The same values as ``attention_vjp`` to f32 rounding before
    the cast to bf16; raises on what the kernels do not take."""
    global BACKWARD_LAUNCHES
    _check(q, k, v)
    B, N, H, D = q.shape
    M = k.shape[1]
    if (q.dtype != torch.bfloat16 or D > MAX_BWD_HEAD_DIM
            or grad_out.shape != q.shape or grad_out.dtype != q.dtype
            or grad_out.device != q.device):
        raise ValueError(
            f"the backward kernels take bf16 q, k, v with D <= "
            f"{MAX_BWD_HEAD_DIM} and a cotangent like q, got {q.dtype} "
            f"{tuple(q.shape)}, {grad_out.dtype} {tuple(grad_out.shape)}")
    dp = -(-D // 8) * 8
    ops = [_tma_operand(x, dp) for x in (q, k, v, grad_out)]
    run_dq, run_dkdv = needs[0] or needs[1], needs[1] or needs[2]
    dq = ops[0].new_empty((B, N, H, dp)) if run_dq else None
    dk = ops[1].new_empty((B, M, H, dp)) if run_dkdv else None
    dv = ops[2].new_empty((B, M, H, dp)) if run_dkdv else None
    delta = torch.empty_like(lse)
    index = q.device.index
    strides = [s for x in ops for s in x.stride()[:3]]
    rc = _library().dsdiff_flash_attention_backward(
        *(x.data_ptr() for x in ops), lse.data_ptr(), delta.data_ptr(),
        *(x.data_ptr() if x is not None else None for x in (dq, dk, dv)),
        lse.shape[1], index, B, H, N, M, dp, *strides,
        _LOG2E / math.sqrt(D), 1.0 / math.sqrt(D), int(run_dq), int(run_dkdv),
        torch._C._cuda_getCurrentRawStream(index))
    _raise_rc(rc, "flash_attention backward")
    BACKWARD_LAUNCHES += 1
    return tuple(None if not need else x if dp == D else x[..., :D]
                 for x, need in zip((dq, dk, dv), needs))


class FlashAttention(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward: the VJP of
    ``reference_attention`` at the saved inputs, as the JAX package's
    ``_fa_bwd`` differentiates its plain math, by ``backward_route``: the
    backward kernels (the forward then also saves its row log-sum-exp) or
    ``attention_vjp``."""

    @staticmethod
    def forward(ctx, q, k, v):
        if backward_route(q, k, v) == "kernel":
            o, lse = _launch_lse(q, k, v)
            ctx.save_for_backward(q, k, v, lse)
            return o
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, *lse = ctx.saved_tensors
        B, N, H, D = q.shape
        with span("attention.backward", B=B, N=N, heads=H, D=D):
            if lse:
                count("attention.bwd_kernel")
                return _launch_backward(q, k, v, grad_out, lse[0],
                                        ctx.needs_input_grad)
            count("attention.bwd_plain")
            return attention_vjp(q, k, v, grad_out, ctx.needs_input_grad)


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
