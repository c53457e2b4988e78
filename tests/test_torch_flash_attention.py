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


def _tf32_product(eq, a, b, passes):
    """einsum of f32 a and b as the f32 route's tensor cores compute it:
    one pass hi*hi, or three (lo*hi + hi*lo + hi*hi), with a = hi + lo.
    A product of two TF32 values is exact in f32; the sums run in f64."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi, False), _tf32(b - b_hi, False)
    out = np.einsum(eq, a_hi.astype(np.float64), b_hi.astype(np.float64))
    if passes == 3:
        out = (np.einsum(eq, a_lo.astype(np.float64), b_hi.astype(np.float64))
               + np.einsum(eq, a_hi.astype(np.float64), b_lo.astype(np.float64))
               + out)
    return out.astype(np.float32)


@pytest.mark.parametrize("passes, within_tol", [(3, True), (1, False)])
def test_three_tf32_passes_hold_the_f32_tolerance_and_one_does_not(
        passes, within_tol):
    """The f32 route's arithmetic, emulated: q pre-scaled by log2(e)/sqrt(D),
    S = q k^T and O = P v through TF32 products, softmax in f32. Three passes
    match reference_attention within ATOL; one pass misses it by over 1e-4,
    which is why the route splits every operand."""
    q, k, v = _qkv((1, 64, 2, 48), seed=3)
    scale = np.float32(np.log2(np.e) / np.sqrt(48))
    s = _tf32_product("bnhd,bmhd->bhnm", q * scale, k, passes)
    p = np.exp2(s - s.max(-1, keepdims=True))
    o = _tf32_product("bhnm,bmhd->bnhd", p, v, passes)
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
        # bf16 goes through TMA tensor maps: refused before the device check
        (_bf16_misaligned, ValueError, "16-byte aligned"),
        (lambda: [torch.zeros(1, 8, 2, 12, dtype=torch.bfloat16)[..., :8]] * 3,
         ValueError, "multiples of 8"),
    ],
)
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(make, err, match):
    with pytest.raises(err, match=match):
        PF.flash_attention(*make())


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
     (1, 130, 200, 2, 64), (1, 64, 1, 1, 48)],
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
