"""The port's attention against the JAX package's.

On the CPU the port's ``scaled_attention`` runs ``reference_attention``;
it is held against the Pallas kernel run in interpret mode and against the
JAX dispatch, in f32, atol 2e-5 (the tolerance of the JAX package's own
interpret-mode test). The CUDA kernel itself is checked by the ``gpu``
test, which skips where there is no card. JAX is imported inside the tests
that use it, so the ``gpu`` test also runs where only PyTorch is installed:
``python -m pytest --noconftest -m gpu tests/test_torch_flash_attention.py``.
"""
import numpy as np
import pytest
import torch

from dsdiff_torch import ops as P
from dsdiff_torch.ops import flash_attention as PF

ATOL = 2e-5


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def test_reference_matches_pallas_kernel_in_interpret_mode():
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from dsdiff_tpu.ops import flash_attention as fa

    q, k, v = _qkv((1, 512, 2, 48))
    orig = pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    pl.pallas_call = interp
    try:
        want = fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    finally:
        pl.pallas_call = orig
    got = PF.reference_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 64, 6, 48), (1, 100, 2, 16),
                                   (2, 256, 4, 48)])
def test_scaled_attention_on_cpu_matches_jax_dispatch(shape):
    import jax.numpy as jnp

    from dsdiff_tpu import ops as J

    q, k, v = _qkv(shape, seed=1)
    want = J.scaled_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = P.scaled_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_scaled_attention_on_cpu_does_not_launch():
    q, k, v = map(torch.from_numpy, _qkv((1, 8, 1, 8)))
    before = PF.LAUNCHES
    P.scaled_attention(q, k, v)
    assert PF.LAUNCHES == before


def _tf32(x, nearest=True):
    """x cut to TF32's 10 mantissa bits: rounded to nearest, ties away from
    zero (as cvt.rna.tf32.f32 and the kernel's split round hi), or
    truncated (as the tensor cores read an f32 operand, the split's lo)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + (0x1000 if nearest else 0)) & 0xFFFFE000
    return bits.astype(np.uint32).view(np.float32)


def _tf32_product(eq, a, b, passes, nearest=True):
    """einsum of f32 a and b as the f32 route's tensor cores compute it:
    one pass hi*hi, or three (lo*hi + hi*lo + hi*hi), with a = hi + lo, hi
    rounded to nearest (the mma.sync kernel's split) or truncated (the raw
    word, as tf32x3_ws hands the tensor cores its hi operands), lo read
    truncated. A product of two TF32 values is exact in f32; the sums run
    in f64."""
    a_hi, b_hi = _tf32(a, nearest), _tf32(b, nearest)
    a_lo, b_lo = _tf32(a - a_hi, False), _tf32(b - b_hi, False)
    out = np.einsum(eq, a_hi.astype(np.float64), b_hi.astype(np.float64))
    if passes == 3:
        out = (np.einsum(eq, a_lo.astype(np.float64), b_hi.astype(np.float64))
               + np.einsum(eq, a_hi.astype(np.float64), b_lo.astype(np.float64))
               + out)
    return out.astype(np.float32)


@pytest.mark.parametrize(
    "passes, within_tol, hi, D",
    [pytest.param(3, True, "nearest", 48, id="3-True"),
     pytest.param(1, False, "nearest", 48, id="1-False")]
    + [pytest.param(passes, passes == 3, "truncated", D,
                    id=f"{passes}-{passes == 3}-truncated-{D}")
       for D in (48, 192, 512) for passes in (3, 1)])
def test_three_tf32_passes_hold_the_f32_tolerance_and_one_does_not(
        passes, within_tol, hi, D):
    """The f32 route's arithmetic, emulated: S = q k^T and O = P v through
    TF32 products, softmax in f32. ``nearest``: the mma.sync kernel (D up
    to 64), q pre-scaled by
    log2(e)/sqrt(D) and every hi rounded to nearest; ``truncated``:
    tf32x3_ws (above 64), q k^T of the raw words scaled in the softmax,
    every hi the raw word truncated. Three passes match
    reference_attention within ATOL; one pass misses it by over 1e-4,
    which is why the route splits every operand."""
    q, k, v = _qkv((1, 64, 2, D), seed=3)
    scale = np.float32(np.log2(np.e) / np.sqrt(D))
    if hi == "nearest":
        s = _tf32_product("bnhd,bmhd->bhnm", q * scale, k, passes)
    else:
        s = _tf32_product("bnhd,bmhd->bhnm", q, k, passes, False) * scale
    p = np.exp2(s - s.max(-1, keepdims=True))
    o = _tf32_product("bhnm,bmhd->bnhd", p, v, passes, hi == "nearest")
    got = o / np.moveaxis(p.sum(-1, keepdims=True), 1, 2)
    want = PF.reference_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    err = np.abs(got - want).max()
    assert (err <= ATOL) if within_tol else (err > 1e-4), (passes, err)


def _bf16_misaligned():
    """[1, 8, 2, 8] bf16 views 2 bytes past an aligned start (strides fine)."""
    flat = torch.zeros(1 + 8 * 2 * 8, dtype=torch.bfloat16)
    return [flat[1:].view(1, 8, 2, 8)] * 3


@pytest.mark.parametrize(
    "make, err, match",
    [
        (lambda: [torch.zeros(1, 8, 2, 8)] * 3, ValueError, "CUDA"),
        (lambda: [torch.zeros(1, 8, 2, 513)] * 3, ValueError, "head dim"),
        (lambda: [torch.zeros(1, 8, 2, 8, dtype=torch.float16)] * 3, TypeError,
         None),
        (lambda: [torch.zeros(8, 2, 8)] * 3, ValueError, None),  # rank
        (lambda: [torch.zeros(1, 8, 8, 2).transpose(2, 3)] * 3, ValueError,
         "contiguous"),
        (lambda: [torch.zeros(1, 8, 2, 8), torch.zeros(1, 8, 3, 8),
                  torch.zeros(1, 8, 3, 8)], ValueError, "shapes"),
        # bf16 layouts no TMA tensor map describes are the kernel's too
        # (its threads load them): refused here only for want of a card
        (_bf16_misaligned, ValueError, "CUDA device"),
        (lambda: [torch.zeros(1, 8, 2, 12, dtype=torch.bfloat16)[..., :8]] * 3,
         ValueError, "CUDA device"),
    ],
)
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(make, err, match):
    with pytest.raises(err, match=match):
        PF.flash_attention(*make())


def _dense_heads(B, N, H, D, dtype, device="cpu", gen=None):
    """[B, N, H, D] as a Dense(H*D) output viewed as heads: head stride D,
    row stride H*D."""
    x = torch.randn(B, N, H * D, generator=gen, device=device, dtype=dtype)
    return x.view(B, N, H, D)


@pytest.mark.parametrize(
    "make, load",
    [
        # the flagship's qkv thirds and a contiguous D = 48 head: TMA
        (lambda: torch.zeros(2, 64, 3, 6, 48, dtype=torch.bfloat16).unbind(2),
         "tma"),
        (lambda: [torch.zeros(2, 64, 6, 48, dtype=torch.bfloat16)] * 3, "tma"),
        # DSUNet's cross-attention fusion at C = 96: D = 36 (a 72-byte head
        # stride), separate Dense outputs or thirds of a fused qkv
        (lambda: [_dense_heads(2, 64, 8, 36, torch.bfloat16)] * 3,
         "cp.async 8 B"),
        (lambda: torch.zeros(2, 64, 3, 8, 36, dtype=torch.bfloat16).unbind(2),
         "cp.async 8 B"),
        (lambda: [_dense_heads(1, 16, 2, 10, torch.bfloat16)] * 3,
         "cp.async 4 B"),
        (lambda: [_dense_heads(1, 16, 2, 7, torch.bfloat16)] * 3, "ld 2 B"),
        (_bf16_misaligned, "ld 2 B"),
    ],
)
def test_bf16_load_takes_tma_where_a_tensor_map_describes_the_layout(make,
                                                                     load):
    """TMA for the layouts it took before; the threads' widest aligned copy
    for the rest, and every such layout passes the wrapper's checks."""
    q, k, v = make()
    assert PF.bf16_load(q, k, v) == load
    with pytest.raises(ValueError, match="CUDA device"):
        PF._check(q, k, v)


def test_bf16_refusals_do_not_touch_the_qkv_thirds():
    """The model's q, k, v (strided thirds of one qkv tensor) at every
    shipped head width pass the bf16 layout checks and fail only on the
    device."""
    for heads, D in [(4, 48), (6, 48), (2, 32), (3, 64), (1, 16)]:
        qkv = torch.zeros(2, 40, 3, heads, D, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="CUDA device"):
            PF.flash_attention(*qkv.unbind(2))


@pytest.mark.parametrize("shape", [(2, 1024, 4, 192), (2, 64, 2, 256),
                                   (2, 1024, 12, 64), (1, 70, 2, 72)])
def test_wrapper_takes_head_dims_up_to_256(shape):
    """The head dims of the TPU kernel's gate (up to 256; 192 in the
    disc_diff and palette U-Nets, 64 in DiT-B, 72 in DiT-XL) pass every
    check of both routes, as strided qkv thirds, and fail only for want of
    a CUDA device; 513 is refused."""
    B, N, H, D = shape
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.zeros(B, N, 3, H, D, dtype=dtype)
        with pytest.raises(ValueError, match="CUDA device"):
            PF._check(*qkv.unbind(2))
    with pytest.raises(ValueError, match="outside 1..512"):
        PF._check(*[torch.zeros(B, N, H, 513)] * 3)


@pytest.mark.parametrize("D", [264, 320, 384, 512])
def test_wrapper_takes_head_dims_up_to_512(D):
    """Above the TPU kernel's 256: the KL-VAE's single head of 512 channels
    (separate q, k, v projections, so each is its own contiguous
    [B, N, 1, 512] view) and the widths between pass every check of both
    routes and fail only for want of a CUDA device; 513 does not."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.zeros(2, 1024, D, dtype=dtype)[:, :, None, :]
                   for _ in range(3))
        with pytest.raises(ValueError, match="CUDA device"):
            PF._check(q, k, v)
        with pytest.raises(ValueError, match="head dim 513 is outside"):
            PF._check(*[torch.zeros(2, 64, 1, 513, dtype=dtype)] * 3)


GPU_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B, N, M, H, D",
    [(2, 1024, 1024, 4, 48), (3, 256, 256, 6, 48), (2, 64, 64, 6, 48),
     (1, 100, 100, 2, 64), (1, 77, 77, 3, 16),
     # M != N and ragged tails on both sides, at every head width up to 64
     (2, 1000, 77, 2, 16), (1, 77, 1000, 3, 32), (2, 1000, 77, 2, 48),
     (1, 130, 200, 2, 64), (1, 64, 1, 1, 48),
     # MedSegDiffUNet at its defaults, 256²: 32² tokens, 4 heads of 32
     (2, 1024, 1024, 4, 32)],
)
def test_cuda_kernel_matches_plain_version(B, N, M, H, D, dtype):
    """q from one qkv tensor, k and v from another (so M may differ from
    N), all strided thirds as the model passes them; f32 runs the tf32x3
    route, bf16 the wgmma route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(N * 131 + M + D)
    q = torch.randn(B, N, 3, H, D, generator=g, device="cuda",
                    dtype=dtype).unbind(2)[0]
    _, k, v = torch.randn(B, M, 3, H, D, generator=g, device="cuda",
                          dtype=dtype).unbind(2)
    before = PF.LAUNCHES
    got = PF.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert PF.LAUNCHES == before + 1
    want = PF.reference_attention(q, k, v)
    assert got.dtype == dtype and got.shape == (B, N, H, D)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= GPU_TOL[dtype], (B, N, M, H, D, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B, N, M, H, D",
    [(2, 1024, 1024, 4, 192), (2, 1024, 1024, 12, 64), (1, 130, 200, 2, 72),
     (1, 1000, 77, 2, 96), (1, 77, 300, 2, 256), (1, 64, 64, 1, 128),
     (1, 100, 1, 2, 160), (1, 65, 129, 1, 200)],
)
def test_cuda_kernel_takes_head_dims_up_to_256(B, N, M, H, D, dtype):
    """Every head dim the TPU kernel takes, on both routes, as strided
    thirds: bf16 reads ceil(D/64) swizzle atoms a row (its k-steps cross
    atoms, one PV product per atom), f32 rounds D up to 96, 128, 192 or 256
    with Q left in shared memory; ragged N and M tails included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(N * 7 + M + D)
    q = torch.randn(B, N, 3, H, D, generator=g, device="cuda",
                    dtype=dtype).unbind(2)[0]
    _, k, v = torch.randn(B, M, 3, H, D, generator=g, device="cuda",
                          dtype=dtype).unbind(2)
    got = PF.flash_attention(q, k, v)
    torch.cuda.synchronize()
    want = PF.reference_attention(q, k, v)
    err = (got.float() - want.float()).abs().max().item()
    assert got.shape == (B, N, H, D) and err <= GPU_TOL[dtype], (D, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B, N, M, H, D",
    [(2, 1024, 1024, 1, 512), (1, 1024, 1024, 1, 384), (1, 130, 200, 2, 320),
     (1, 77, 300, 2, 264), (2, 100, 1, 1, 512), (1, 65, 129, 1, 296)],
)
def test_cuda_kernel_takes_head_dims_up_to_512(B, N, M, H, D, dtype):
    """Head dims past the TPU kernel's 256, on both routes, as strided
    thirds: two blocks a Q tile, each owning half of the output's columns
    (bf16: Q and K in 6 or 8 atoms, atoms wholly past D zeroed; f32: D
    rounded up to 384 or 512, K streamed in 64-column chunks); the VAE's
    [B, 1024, 1, 512] first, ragged N and M tails after it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(N * 5 + M + D)
    q = torch.randn(B, N, 3, H, D, generator=g, device="cuda",
                    dtype=dtype).unbind(2)[0]
    _, k, v = torch.randn(B, M, 3, H, D, generator=g, device="cuda",
                          dtype=dtype).unbind(2)
    before = PF.LAUNCHES
    got = PF.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert PF.LAUNCHES == before + 1
    want = PF.reference_attention(q, k, v)
    err = (got.float() - want.float()).abs().max().item()
    assert got.shape == (B, N, H, D) and err <= GPU_TOL[dtype], (D, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [7, 12, 20, 100, 250, 300])
def test_cuda_kernel_takes_head_dims_that_are_not_multiples_of_8(D, dtype):
    """q, k, v cut from a buffer whose head width is padded to a multiple
    of 8, so the bf16 stride rule holds while D itself does not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(D)
    padded = -(-D // 8) * 8
    q, k, v = torch.randn(2, 70, 3, 3, padded, generator=g, device="cuda",
                          dtype=dtype)[..., :D].unbind(2)
    got = PF.flash_attention(q, k, v)
    torch.cuda.synchronize()
    want = PF.reference_attention(q, k, v)
    err = (got.float() - want.float()).abs().max().item()
    assert got.shape == (2, 70, 3, D) and err <= GPU_TOL[dtype], (D, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 2e-5),
                                         (torch.bfloat16, 1e-2)])
def test_cuda_kernel_gradient_matches_plain_version(dtype, atol):
    """The autograd.Function over the kernel against autograd through the
    plain version: one forward launch, and the same gradients (the backward
    is the plain math in both; the upstream gradient differs only by the
    forward's rounding, which it does not read)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn(2, 256, 3, 4, 48, generator=g, device="cuda",
                      dtype=dtype, requires_grad=True)
    w = torch.randn(2, 256, 4, 48, generator=g, device="cuda", dtype=dtype)
    before = PF.LAUNCHES
    out = PF.flash_attention(*qkv.unbind(2))
    assert out.grad_fn is not None and PF.LAUNCHES == before + 1
    (got,) = torch.autograd.grad((out * w).float().sum(), qkv)
    (want,) = torch.autograd.grad(
        (PF.reference_attention(*qkv.unbind(2)) * w).float().sum(), qkv)
    assert PF.LAUNCHES == before + 1
    err = (got.float() - want.float()).abs().max().item()
    assert err <= atol * max(1.0, want.float().abs().max().item()), err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [48, 192, 512])
def test_cuda_kernel_with_one_hot_v_returns_p(dtype, D):
    """v[m] = e_(m mod D), so out[n, d] sums P[n, m] over keys m = d mod D:
    a key that the second product took in another order than the first
    (the routes permute the keys of each 8- or 16-key step between S's
    accumulator and P's operand) moves its mass to another column."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, N, M, H = 2, 70, 200, 2
    g = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn(B, N, H, D, generator=g, device="cuda", dtype=dtype)
    k = torch.randn(B, M, H, D, generator=g, device="cuda", dtype=dtype)
    onehot = torch.eye(D, device="cuda")[torch.arange(M, device="cuda") % D]
    v = onehot[None, :, None, :].expand(B, M, H, D).to(dtype).contiguous()
    got = PF.flash_attention(q, k, v)
    torch.cuda.synchronize()
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) / D**0.5
    want = torch.einsum("bhnm,md->bnhd", torch.softmax(s, -1), onehot)
    err = (got.float() - want).abs().max().item()
    assert err <= GPU_TOL[dtype], err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B, N, M, H, D",
    [(4, 64, 64, 8, 36), (4, 64, 256, 8, 36), (2, 100, 77, 3, 12),
     (2, 77, 200, 2, 20), (1, 130, 64, 4, 44), (2, 64, 300, 2, 100),
     (1, 1, 65, 2, 36), (1, 70, 130, 2, 130), (1, 65, 129, 1, 300),
     (2, 100, 70, 1, 510)],
)
def test_cuda_kernel_takes_heads_of_dense_outputs(B, N, M, H, D, dtype):
    """q, k and v as Dense(H*D) outputs viewed as heads (head stride D, not
    a multiple of 8 elements): DSUNet's cross-attention fusion at C = 96
    (self [4, 64, 8, 36], cross with M = 256) and other widths, ragged N
    and M included, up to the two-block tiles above D = 256. Up to D = 64
    bf16 loads through the kernel's threads (no TMA map describes a
    72-byte head stride), f32 pads D = 36 to 40; above it both take
    the wrapper's contiguous copies where no map describes the heads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(N * 3 + M + D)
    q = _dense_heads(B, N, H, D, dtype, "cuda", g)
    k = _dense_heads(B, M, H, D, dtype, "cuda", g)
    v = _dense_heads(B, M, H, D, dtype, "cuda", g)
    if dtype == torch.bfloat16:
        assert PF.bf16_load(q, k, v) != "tma"
    before = PF.LAUNCHES
    got = PF.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert PF.LAUNCHES == before + 1
    want = PF.reference_attention(q, k, v)
    err = (got.float() - want.float()).abs().max().item()
    assert got.shape == (B, N, H, D) and err <= GPU_TOL[dtype], (D, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D, offset", [(36, 0), (36, 1), (7, 0), (10, 0)])
def test_cuda_kernel_takes_qkv_thirds_no_tensor_map_describes(D, offset,
                                                              dtype):
    """Strided thirds of a fused qkv (head stride D, row stride 3*H*D),
    D = 36 as in the fusion at C = 96, and 7 and 10; with ``offset`` 1 the
    buffer starts one element past an aligned address, so only 2-byte
    copies are aligned; a gradient through the kernel's autograd.Function
    included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, N, H = 3, 130, 8
    g = torch.Generator(device="cuda").manual_seed(D + offset)
    flat = torch.randn(offset + B * N * 3 * H * D, generator=g, device="cuda",
                       dtype=dtype)
    qkv = flat[offset:].view(B, N, 3, H, D).requires_grad_(False)
    q, k, v = qkv.unbind(2)
    got = PF.flash_attention(q, k, v)
    torch.cuda.synchronize()
    want = PF.reference_attention(q, k, v)
    err = (got.float() - want.float()).abs().max().item()
    assert got.shape == (B, N, H, D) and err <= GPU_TOL[dtype], (D, err)
    leaf = qkv.detach().clone().requires_grad_(True)
    w = torch.randn(B, N, H, D, generator=g, device="cuda", dtype=dtype)
    (got_g,) = torch.autograd.grad(
        (PF.flash_attention(*leaf.unbind(2)) * w).float().sum(), leaf)
    (want_g,) = torch.autograd.grad(
        (PF.reference_attention(*leaf.unbind(2)) * w).float().sum(), leaf)
    gerr = (got_g.float() - want_g.float()).abs().max().item()
    assert gerr <= GPU_TOL[dtype] * max(1.0, want_g.float().abs().max().item())


@pytest.mark.gpu
def test_classifier_gradient_through_the_kernel_matches_plain_attention():
    """A guidance classifier (EncoderUNet, attention pool, random weights)
    on the card: its attention blocks run the kernel, and
    ``classifier_gradient`` reaches x through the kernel's
    autograd.Function, one forward launch a block and none in the backward;
    the gradient within 1e-3 of the one through plain attention (f32, TF32
    off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dsdiff_torch.models import attention as attention_module
    from dsdiff_torch.models.encoder_unet import (EncoderUNet,
                                                  classifier_gradient)
    from dsdiff_torch.utils.flax_bridge import random_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clf = EncoderUNet(num_classes=3, model_channels=32, channel_mult=(1, 2),
                      attention_resolutions=(2,), num_heads=2,
                      num_res_blocks=1, pool="attention")
    clf = random_params(clf, 3).cuda().eval()
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(2, 16, 16, 1, generator=g, device="cuda")
    t = torch.tensor([3.0, 500.0], device="cuda")
    y = torch.tensor([0, 1], device="cuda")
    before = PF.LAUNCHES
    with torch.inference_mode():
        got = classifier_gradient(clf, x, t, y)
    assert PF.LAUNCHES - before == 2  # the encoder's block and the middle's
    kernel = attention_module.scaled_attention
    attention_module.scaled_attention = PF.reference_attention
    try:
        want = classifier_gradient(clf, x, t, y)
    finally:
        attention_module.scaled_attention = kernel
    err = (got - want).abs().max().item()
    assert 0 < want.abs().max().item() and err <= 1e-3 * want.abs().max().item()



@pytest.mark.gpu
@pytest.mark.parametrize("name", ["medseg_v1", "medseg_new"])
def test_cuda_medseg_forward_matches_plain_attention(name):
    """MedSegDiffUNet (highway and anchor mode) on the card at 64²,
    attention at rate 8 ([2, 64, 4, 32], four blocks), f32 with TF32 off:
    the kernel against plain attention, within 1e-3 of max(1, max |out|)
    for the output and the seg map, one launch a block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dsdiff_torch.models import attention as attention_module
    from dsdiff_torch.models import build_model
    from dsdiff_torch.utils.device import disable_tf32
    from dsdiff_torch.utils.flax_bridge import random_params

    disable_tf32()
    model = build_model(name, device="cuda", in_channels=4, image_size=64)
    model = random_params(model, 23).eval()
    g = torch.Generator(device="cuda").manual_seed(24)
    x = torch.randn(2, 64, 64, 4, generator=g, device="cuda")
    t = torch.tensor([5.0, 600.0], device="cuda")
    with torch.inference_mode():
        before = PF.LAUNCHES
        out, aux = model(x, t)
        torch.cuda.synchronize()
        assert PF.LAUNCHES - before == 4
        kernel = attention_module.scaled_attention
        attention_module.scaled_attention = PF.reference_attention
        try:
            want, want_aux = model(x, t)
        finally:
            attention_module.scaled_attention = kernel
    for got, ref in ((out, want), (aux["cal"], want_aux["cal"])):
        assert torch.isfinite(got).all()
        err = (got - ref).abs().max().item()
        assert err <= 1e-3 * max(1.0, ref.abs().max().item()), (name, err)


WS_HEAD_DIMS = [65, 72, 128, 192, 256]
RAGGED = [1, 63, 64, 65, 1000, 1024]


@pytest.mark.gpu
@pytest.mark.parametrize("M", RAGGED)
@pytest.mark.parametrize("N", RAGGED)
@pytest.mark.parametrize("D", WS_HEAD_DIMS)
def test_cuda_warp_specialised_route_matches_plain_version(D, N, M):
    """bf16 above D = 64 on TMA layouts (``wgmma_ws``: 128 Q rows a block,
    two consumer warpgroups sharing each K/V tile, two-stage K and V
    rings): q a strided third of one qkv tensor, k and v of another (heads
    padded to a multiple of 8 elements, as a tensor map needs), N and M on
    both sides of the 64-row tile and of the 128-row Q tile (a Q tile
    whose second warpgroup holds no row at N <= 64, one key tile, a ragged
    last key tile)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, H, padded = 1, 2, -(-D // 8) * 8
    g = torch.Generator(device="cuda").manual_seed(D * 10007 + N * 131 + M)
    q = torch.randn(B, N, 3, H, padded, generator=g, device="cuda",
                    dtype=torch.bfloat16)[..., :D].unbind(2)[0]
    _, k, v = torch.randn(B, M, 3, H, padded, generator=g, device="cuda",
                          dtype=torch.bfloat16)[..., :D].unbind(2)
    assert PF.route(q, k, v) == "wgmma_ws"
    before = PF.LAUNCHES
    got = PF.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert PF.LAUNCHES == before + 1
    want = PF.reference_attention(q, k, v)
    err = (got.float() - want.float()).abs().max().item()
    assert got.shape == (B, N, H, D) and err <= GPU_TOL[torch.bfloat16], err


def _padded_heads(B, N, H, D, stride, offset, gen):
    """[B, N, H, D] bf16 cut from heads of ``stride`` elements, the buffer
    starting ``offset`` elements past an aligned address."""
    flat = torch.randn(offset + B * N * H * stride, generator=gen,
                       device="cuda", dtype=torch.bfloat16)
    return flat[offset:].view(B, N, H, stride)[..., :D]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "D, stride, offset",
    [(100, 100, 0), (72, 76, 0), (130, 130, 0), (192, 200, 1), (256, 260, 0)],
)
def test_cuda_thread_loaded_layouts_above_64_keep_the_one_warpgroup_kernel(
        D, stride, offset):
    """Layouts no TMA map describes above D = 64 (a head stride that is not
    a multiple of 8 elements, or an unaligned base) go to ``wgmma_ws`` as
    the wrapper's contiguous copies, at ragged N and M: one launch, the
    same bits as the kernel on the caller's own contiguous copies, and the
    plain version's output within tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(D + stride + offset)
    q = _padded_heads(2, 130, 2, D, stride, offset, g)
    k = _padded_heads(2, 77, 2, D, stride, offset, g)
    v = _padded_heads(2, 77, 2, D, stride, offset, g)
    assert PF.bf16_load(q, k, v) == "copy"
    assert PF.route(q, k, v) == "wgmma_ws"
    before = PF.LAUNCHES
    got = PF.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert PF.LAUNCHES == before + 1
    same = PF.flash_attention(*(x.contiguous() for x in (q, k, v)))
    assert torch.equal(got, same)
    want = PF.reference_attention(q, k, v)
    err = (got.float() - want.float()).abs().max().item()
    assert got.shape == (2, 130, 2, D) and err <= GPU_TOL[torch.bfloat16], err


@pytest.mark.gpu
def test_library_plan_matches_the_wrappers_description():
    """``dsdiff_flash_attention_bf16_plan`` in the built library against
    ``bf16_plan`` at every head dim: kernel, Q rows, stages, threads,
    shared memory and grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    keys = ("kernel", "q_rows", "stages", "threads", "smem_bytes", "grid")
    for D in range(1, PF.MAX_HEAD_DIM + 1):
        want = PF.bf16_plan(3, 1000, 5, D)
        got = PF.native_bf16_plan(3, 1000, 5, D)
        assert got == {k: want[k] for k in keys}, D
