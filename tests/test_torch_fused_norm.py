"""The port's fused GroupNorm + SiLU against the JAX package's.

On the CPU the port's ``ops.fused_group_norm_silu`` runs its plain version
(the JAX kernel's math: f32 statistics with var = E[x²] - mean², eps 1e-5,
folded into per-channel a and b). It is held against the Pallas kernel in
interpret mode and against the JAX op's CPU path (``jnp.var``): f32 to
2e-5, the JAX package's own interpret-mode tolerance; bf16 to 0.05, as
``tests/test_ops.py`` holds the bf16 kernel. The CUDA kernels' chunked
two-level reduction is emulated here and held against ``coefficients``;
the kernels themselves are checked by the ``gpu`` tests, which skip where
there is no card:
``python -m pytest --noconftest -m gpu tests/test_torch_fused_norm.py``.
"""
import numpy as np
import pytest
import torch

from dsdiff_torch import ops as P
from dsdiff_torch.ops import fused_norm as PF


def _inputs(shape, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    scale = (rng.standard_normal(C) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(C) * 0.1).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape, groups", [((2, 8, 8, 32), 8),
                                           ((1, 4, 6, 96), 32)])
def test_plain_version_matches_pallas_kernel_in_interpret_mode(shape, groups):
    import jax.numpy as jnp

    from dsdiff_tpu.ops import fused_norm as JF

    x, s, b = _inputs(shape)
    want = JF.group_norm_silu(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                              num_groups=groups, interpret=True)
    got = PF.group_norm_silu_plain(*map(torch.from_numpy, (x, s, b)), groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_plain_version_bf16_matches_pallas_kernel_in_interpret_mode():
    import jax.numpy as jnp

    from dsdiff_tpu.ops import fused_norm as JF

    x, s, b = _inputs((1, 4, 4, 16), seed=1)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = JF.group_norm_silu(xj, jnp.asarray(s), jnp.asarray(b), num_groups=4,
                              interpret=True)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    got = PF.group_norm_silu_plain(xt, torch.from_numpy(s), torch.from_numpy(b), 4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=0.05)


def test_op_on_cpu_matches_jax_op_and_does_not_launch():
    import jax.numpy as jnp

    from dsdiff_tpu import ops as J

    x, s, b = _inputs((2, 8, 8, 64), seed=2)
    want = J.fused_group_norm_silu(jnp.asarray(x), jnp.asarray(s),
                                   jnp.asarray(b), num_groups=32)
    before = PF.LAUNCHES
    got = P.fused_group_norm_silu(*map(torch.from_numpy, (x, s, b)), 32)
    assert PF.LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def _xsb(B=1, H=4, W=4, C=8, dtype=torch.float32, device="cpu"):
    x = torch.zeros(B, H, W, C, dtype=dtype, device=device)
    return x, torch.ones(C, device=device), torch.zeros(C, device=device)


@pytest.mark.parametrize("make, err", [
    (lambda: _xsb(), ValueError),  # CPU tensors
    (lambda: _xsb(dtype=torch.float16), TypeError),
    (lambda: (_xsb()[0][0],) + _xsb()[1:], ValueError),  # rank
    (lambda: (torch.zeros(1, 4, 8, 4).transpose(2, 3),) + _xsb()[1:],
     ValueError),  # channels not contiguous
    (lambda: _xsb()[:2] + (torch.zeros(8, dtype=torch.bfloat16),),
     ValueError),  # bias not f32
    (lambda: _xsb()[:2] + (torch.zeros(2, 8),), ValueError),  # bias shape
])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(make, err):
    with pytest.raises(err):
        PF.group_norm_silu(*make(), num_groups=4)


def _two_level_coefficients(x, scale, bias, groups, rows, eps=1e-5):
    """(a, b) as the kernels form them: f64 sums per chunk of ``rows``
    spatial rows (the last one ragged), reduced over the chunks in order,
    then mean, E[x²] - mean² and rsqrt in f64, a and b in f32."""
    B, H, W, C = x.shape
    per = C // groups
    xg = x.double().reshape(B, H * W, groups, per)
    s = torch.zeros(B, groups, dtype=torch.float64)
    q = torch.zeros(B, groups, dtype=torch.float64)
    for r0 in range(0, H * W, rows):
        part = xg[:, r0:r0 + rows]
        s += part.sum(dim=(1, 3))
        q += (part * part).sum(dim=(1, 3))
    n = H * W * per
    mean = s / n
    inv = torch.rsqrt(q / n - mean**2 + eps).float()
    a = inv.repeat_interleave(per, dim=1) * scale[None]
    b = bias[None] - mean.float().repeat_interleave(per, dim=1) * a
    return a, b


@pytest.mark.parametrize("B, HW, C, vector", [
    (4, 256 * 256, 96, 8), (4, 128 * 128, 96, 8), (4, 64 * 64, 192, 8),
    (4, 32 * 32, 192, 8), (4, 16 * 16, 288, 8), (4, 8 * 8, 288, 8),
    (16, 256 * 256, 96, 4), (16, 16 * 16, 288, 4), (1, 37 * 37, 96, 8),
    (2, 35, 20, 1), (1, 9, 6, 1),
])
def test_chunking_covers_every_row_once(B, HW, C, vector):
    """Rows per chunk are a multiple of 8 (each chunk starts 16-byte
    aligned), the chunks cover the rows with only the last one ragged, and
    there are at most about two blocks per SM over the batch."""
    rows, chunks = PF.chunking(B, HW, C, vector)
    assert rows % 8 == 0 and rows > 0
    assert (chunks - 1) * rows < HW <= chunks * rows
    assert B * chunks <= 2 * 132 + B


@pytest.mark.parametrize("shape, groups, rows", [
    ((2, 10, 10, 64), 32, 8), ((2, 10, 10, 64), 32, 24),
    ((1, 37, 37, 96), 32, None), ((3, 5, 7, 20), 4, 16)])
def test_two_level_reduction_matches_coefficients_and_jax(shape, groups, rows):
    """The kernels' chunked reduction, with chunks that do not divide H*W,
    gives ``coefficients``' (a, b), and with the apply the JAX op's output
    (Pallas kernel in interpret mode)."""
    import jax.numpy as jnp

    from dsdiff_tpu.ops import fused_norm as JF

    x, s, b = map(torch.from_numpy, _inputs(shape, seed=4))
    B, H, W, C = shape
    if rows is None:
        rows, _ = PF.chunking(B, H * W, C, 8)
    assert (H * W) % rows, "the last chunk must be ragged"
    a2, b2 = _two_level_coefficients(x, s, b, groups, rows)
    a1, b1 = PF.coefficients(x, s, b, groups)
    torch.testing.assert_close(a2, a1, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(b2, b1, rtol=1e-5, atol=1e-6)
    want = JF.group_norm_silu(jnp.asarray(x.numpy()), jnp.asarray(s.numpy()),
                              jnp.asarray(b.numpy()), num_groups=groups,
                              interpret=True)
    got = PF.apply_plain(x, a2, b2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_op_refuses_groups_that_do_not_divide_and_inputs_needing_grad():
    x, s, b = map(torch.from_numpy, _inputs((1, 4, 4, 20)))
    with pytest.raises(ValueError, match="do not split"):
        PF.group_norm_silu_plain(x, s, b, 8)
    with pytest.raises(RuntimeError, match="no backward"):
        PF.group_norm_silu(x.requires_grad_(), s, b, 4)


# kernels vs plain, relative to max(1, max |plain|): the statistics are
# summed in another order (f64 in the kernels), so f32 differs by a few ulps
# of a and b, and a bf16 output may land one bf16 ulp (2^-7 relative at
# most) from the plain one anywhere in its range (chip_smoke.NORM_TOL)
GPU_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_version(dtype):
    """The whole op, statistics included: two launches, the plain version's
    output, and bitwise the same output from a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape, groups in [((2, 64, 64, 96), 32), ((3, 16, 16, 288), 32),
                          ((2, 5, 7, 20), 4), ((1, 3, 3, 6), 2),
                          ((4, 8, 8, 288), 32),
                          # 16-byte loads, C not a multiple of 8 bf16
                          ((2, 4, 6, 20), 4)]:
        x = torch.randn(*shape, generator=g, device="cuda", dtype=dtype)
        C = shape[-1]
        s = torch.randn(C, generator=g, device="cuda") * 0.1 + 1.0
        b = torch.randn(C, generator=g, device="cuda") * 0.1
        before = PF.LAUNCHES
        got = PF.group_norm_silu(x, s, b, groups)
        torch.cuda.synchronize()
        assert PF.LAUNCHES == before + 2
        want = PF.group_norm_silu_plain(x, s, b, groups)
        assert got.dtype == dtype and got.shape == x.shape
        err = (got.float() - want.float()).abs().max().item()
        tol = GPU_TOL[dtype] * max(1.0, want.float().abs().max().item())
        assert err <= tol, (shape, err, tol)
        assert torch.equal(PF.group_norm_silu(x, s, b, groups), got), shape


@pytest.mark.gpu
def test_cuda_kernel_keeps_the_variance_where_the_mean_dwarfs_it():
    """f32 x with mean 8 and std 0.5: E[x²] - mean² cancels 8 of its ~9
    significant digits. The kernels' f64 sums keep them: the output matches
    the formula evaluated in f64 within the f32 tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn(2, 32, 32, 96, generator=g, device="cuda") * 0.5 + 8.0
    s = torch.randn(96, generator=g, device="cuda") * 0.1 + 1.0
    b = torch.randn(96, generator=g, device="cuda") * 0.1
    got = PF.group_norm_silu(x, s, b, 32)
    xd = x.double().reshape(2, 32 * 32, 32, 3)
    mean = xd.mean(dim=(1, 3))
    var = (xd * xd).mean(dim=(1, 3)) - mean**2
    a = torch.rsqrt(var + 1e-5).repeat_interleave(3, dim=1) * s.double()
    shift = b.double() - mean.repeat_interleave(3, dim=1) * a
    y = x.double() * a[:, None, None] + shift[:, None, None]
    want = y * torch.sigmoid(y)
    err = (got.double() - want).abs().max().item()
    assert err <= GPU_TOL[torch.float32] * max(1.0, want.abs().max().item()), err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_op_is_the_film_op_on_the_channels_last_view(dtype):
    """``group_norm_silu`` is ``group_norm_film_silu`` with no FiLM at eps
    1e-5 on x's channels-last [B, C, H, W] view: the same bits, the
    flagship's two-launch shapes, channels no thread's loads keep (an NCHW
    copy: f32 above 1024) and an unaligned map included; where H * W = 1 or
    C = 1 the view is also NCHW-contiguous and the NCHW kernels run. Each
    result is held to the plain version. At H * W = 1 a group holds nine
    channels, as at the flagship's widest level: with two or three, the
    plain version's E[x²] - mean² in f32 cancels (the kernels sum in
    f64), and the two part by more than the tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(24)
    for shape, groups, offset in [((4, 64, 64, 192), 32, 0),
                                  ((4, 8, 8, 288), 32, 0),
                                  ((2, 16, 16, 1536), 32, 0),
                                  ((2, 16, 16, 96), 32, 1),
                                  ((2, 1, 1, 288), 32, 0), ((2, 4, 4, 1), 1, 0)]:
        flat = torch.randn(offset + int(np.prod(shape)), generator=g,
                           device="cuda", dtype=dtype)
        x = flat[offset:].view(shape)
        C = shape[-1]
        s = torch.randn(C, generator=g, device="cuda") * 0.1 + 1.0
        b = torch.randn(C, generator=g, device="cuda") * 0.1
        got = PF.group_norm_silu(x, s, b, groups)
        film = PF.group_norm_film_silu(x.permute(0, 3, 1, 2), s, b, groups,
                                       eps=1e-5).permute(0, 2, 3, 1)
        assert got.is_contiguous() and torch.equal(got, film), shape
        want = PF.group_norm_silu_plain(x, s, b, groups)
        err = (got.float() - want.float()).abs().max().item()
        tol = GPU_TOL[dtype] * max(1.0, want.float().abs().max().item())
        assert err <= tol, (shape, err, tol)
