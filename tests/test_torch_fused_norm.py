"""The port's fused GroupNorm + SiLU against the JAX package's.

On the CPU the port's ``ops.fused_group_norm_silu`` runs its plain version
(the JAX kernel's math: f32 statistics with var = E[x²] - mean², eps 1e-5,
folded into per-channel a and b). It is held against the Pallas kernel in
interpret mode and against the JAX op's CPU path (``jnp.var``): f32 to
2e-5, the JAX package's own interpret-mode tolerance; bf16 to 0.05, as
``tests/test_ops.py`` holds the bf16 kernel. The CUDA kernel is checked by
the ``gpu`` test, which skips where there is no card:
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


def _abc(B=1, H=4, W=4, C=8, dtype=torch.float32, device="cpu"):
    x = torch.zeros(B, H, W, C, dtype=dtype, device=device)
    return x, torch.ones(B, C, device=device), torch.zeros(B, C, device=device)


@pytest.mark.parametrize("make, err", [
    (lambda: _abc(), ValueError),  # CPU tensors
    (lambda: _abc(dtype=torch.float16), TypeError),
    (lambda: (_abc()[0][0],) + _abc()[1:], ValueError),  # rank
    (lambda: (torch.zeros(1, 4, 8, 4).transpose(2, 3),) + _abc()[1:],
     ValueError),  # channels not contiguous
    (lambda: _abc()[:2] + (torch.zeros(1, 8, dtype=torch.bfloat16),),
     ValueError),  # b not f32
    (lambda: _abc()[:2] + (torch.zeros(2, 8),), ValueError),  # b shape
])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(make, err):
    with pytest.raises(err):
        PF.apply_kernel(*make())


def test_op_refuses_groups_that_do_not_divide_and_inputs_needing_grad():
    x, s, b = map(torch.from_numpy, _inputs((1, 4, 4, 20)))
    with pytest.raises(ValueError, match="do not split"):
        PF.group_norm_silu_plain(x, s, b, 8)
    with pytest.raises(RuntimeError, match="no backward"):
        PF.group_norm_silu(x.requires_grad_(), s, b, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 2e-5),
                                         (torch.bfloat16, 1e-2)])
def test_cuda_kernel_matches_plain_version(dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape, groups in [((2, 64, 64, 96), 32), ((3, 16, 16, 288), 32),
                          ((2, 5, 7, 20), 4), ((1, 3, 3, 6), 2)]:
        x = torch.randn(*shape, generator=g, device="cuda", dtype=dtype)
        C = shape[-1]
        s = torch.randn(C, generator=g, device="cuda") * 0.1 + 1.0
        b = torch.randn(C, generator=g, device="cuda") * 0.1
        a_, b_ = PF.coefficients(x, s, b, groups)
        before = PF.LAUNCHES
        got = PF.apply_kernel(x, a_, b_)
        torch.cuda.synchronize()
        assert PF.LAUNCHES == before + 1
        want = PF.apply_plain(x, a_, b_)
        assert got.dtype == dtype and got.shape == x.shape
        err = (got.float() - want.float()).abs().max().item()
        assert err <= atol, (shape, err)
