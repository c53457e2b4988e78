"""The attention backward kernels (``attn_bwd_dq``, ``attn_bwd_dkdv``) on a card.

Marked ``gpu``: each test skips where there is no CUDA device. No JAX is
imported, so on the card's machine it runs with
``python -m pytest --noconftest -m gpu tests/test_torch_attention_bwd_gpu.py``.

- ``FlashAttention``'s backward through the kernels against
  ``attention_vjp`` (the plain f32 VJP, cast to bf16) at DiT-XL/8's
  [32,1024,16,72], the flagship's three shapes, D = 32, 36 (M = 256, a
  cross-attention whose 72-byte head stride no tensor map describes), 64
  and 128, and ragged N and M; q, k, v the strided thirds of a fused qkv
  projection as the models give them. Tolerance 2^-7 of max(1, max |ref|),
  as the CPU test holds ``attention_vjp``'s bf16 outputs.
- Each ``needs`` subset; two calls give the same bits (dq is a sum in a
  fixed order).
- Precision: at the DiT shape, with dO·Vᵀ nearly constant along each row
  (where a delta taken from a rounded O cancels), each of dq, dk, dv errs
  against an f64 VJP of the same bf16 inputs by at most twice what
  ``attention_vjp``'s bf16 outputs err.
- The gradient path's forward: its log-sum-exp against ``reference_lse``,
  its output bit for bit the serving launch's.
- One bf16 ``_DiTBlock`` and one flagship ``AttentionBlock``: gradients
  through the kernels against the same block on the plain VJP.
- ``bwd_plan`` equal to the library's.
"""
import math

import pytest
import torch

from dsdiff_torch.models.attention import AttentionBlock
from dsdiff_torch.models.dit import _DiTBlock
from dsdiff_torch.ops import flash_attention as fa

BF16_TOL = 2**-7
BLOCK_TOL = 2e-2

# (B, N, M, H, D): DiT-XL/8, the flagship's three, the other trained heads,
# ragged lengths
SHAPES = [(32, 1024, 1024, 16, 72), (32, 1024, 1024, 4, 48),
          (32, 256, 256, 6, 48), (32, 64, 64, 6, 48), (4, 1024, 1024, 4, 32),
          (4, 64, 256, 8, 36), (4, 1024, 1024, 12, 64),
          (4, 1024, 1024, 4, 128), (2, 1000, 1000, 4, 72), (3, 35, 35, 2, 48),
          (2, 35, 100, 3, 64), (2, 200, 70, 2, 96)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


def _qkv(B, N, M, H, D, seed=0, scale=1.0):
    """q, k, v as strided views: the thirds of a fused [B, N, 3, H, D]
    projection where N == M, else q alone and k, v the halves of a
    [B, M, 2, H, D] one; a bf16 cotangent."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return (torch.randn(*shape, generator=g, device="cuda")
                * scale).to(torch.bfloat16)

    if N == M:
        q, k, v = randn(B, N, 3, H, D).unbind(2)
    else:
        q = randn(B, N, H, D)
        k, v = randn(B, M, 2, H, D).unbind(2)
    return q, k, v, randn(B, N, H, D)


def _through_kernels(q, k, v, dout):
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    before = fa.BACKWARD_LAUNCHES
    o = fa.flash_attention(*leaves)
    got = torch.autograd.grad(o, leaves, dout)
    assert fa.BACKWARD_LAUNCHES == before + 1
    return got


def _assert_close(got, want, tol, what):
    for name, x, w in zip("q k v".split(), got, want):
        assert x.dtype == w.dtype and x.shape == w.shape
        err = float((x.float() - w.float()).abs().max())
        bound = tol * max(1.0, float(w.float().abs().max()))
        assert err <= bound, f"{what} d{name}: {err} > {bound}"


@pytest.mark.gpu
@pytest.mark.parametrize("B, N, M, H, D", SHAPES)
def test_backward_kernels_match_attention_vjp(B, N, M, H, D):
    _card()
    q, k, v, dout = _qkv(B, N, M, H, D, seed=N + M + D)
    assert fa.backward_route(q, k, v) == "kernel"
    got = _through_kernels(q, k, v, dout)
    torch.cuda.synchronize()
    want = fa.attention_vjp(q, k, v, dout)
    _assert_close(got, want, BF16_TOL, f"[{B},{N},{M},{H},{D}]")


@pytest.mark.gpu
@pytest.mark.parametrize("B, N, M, H, D", [(2, 200, 200, 3, 72),
                                           (2, 64, 256, 4, 36)])
def test_backward_kernels_each_needs_subset_and_repeat_bitwise(B, N, M, H, D):
    _card()
    q, k, v, dout = _qkv(B, N, M, H, D, seed=7)
    lse = fa._launch_lse(q, k, v)[1]
    full = fa._launch_backward(q, k, v, dout, lse)
    again = fa._launch_backward(q, k, v, dout, lse)
    assert all(torch.equal(a, b) for a, b in zip(full, again))
    for i in range(3):
        needs = [j == i for j in range(3)]
        alone = fa._launch_backward(q, k, v, dout, lse, needs)
        assert all((a is None) != needs[j] for j, a in enumerate(alone))
        assert torch.equal(alone[i], full[i])


def _vjp_f64(q, k, v, dout):
    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    D = q.shape[-1]
    s = torch.einsum("bnhd,bmhd->bhnm", leaves[0], leaves[1]) / math.sqrt(D)
    o = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, -1), leaves[2])
    return torch.autograd.grad(o, leaves, dout.double())


@pytest.mark.gpu
def test_backward_kernels_hold_f32_precision_where_delta_cancels():
    """dO·Vᵀ nearly constant along each row: V is one shared row plus 1 %
    noise, so dP - delta is ~1 % of dP and an error of delta shows whole.
    Both the kernels and ``attention_vjp`` are judged against f64."""
    _card()
    B, N, H, D = 32, 1024, 16, 72
    g = torch.Generator(device="cuda").manual_seed(3)
    qkv = torch.randn(B, N, 3, H, D, generator=g, device="cuda")
    common = torch.randn(1, 1, H, D, generator=g, device="cuda")
    qkv[:, :, 2] = common + 0.01 * qkv[:, :, 2]
    q, k, v = qkv.to(torch.bfloat16).unbind(2)
    dout = torch.randn(B, N, H, D, generator=g, device="cuda").to(
        torch.bfloat16)
    exact = _vjp_f64(q, k, v, dout)
    got = _through_kernels(q, k, v, dout)
    plain = fa.attention_vjp(q, k, v, dout)
    for name, x, p, e in zip("q k v".split(), got, plain, exact):
        err = float((x.double() - e).abs().max())
        plain_err = float((p.double() - e).abs().max())
        assert err <= 2 * plain_err, f"d{name}: {err} > 2 x {plain_err}"


@pytest.mark.gpu
@pytest.mark.parametrize("B, N, M, H, D", [(32, 1024, 1024, 16, 72),
                                           (3, 35, 35, 2, 48),
                                           (4, 64, 256, 8, 36),
                                           (2, 200, 70, 2, 128)])
def test_gradient_forward_writes_lse_and_the_serving_output(B, N, M, H, D):
    _card()
    q, k, v, _ = _qkv(B, N, M, H, D, seed=11)
    o, lse = fa._launch_lse(q, k, v)
    assert torch.equal(o, fa._launch(q, k, v))
    want = fa.reference_lse(q, k)
    assert lse.shape == want.shape
    assert torch.isinf(lse[:, N:]).all() and (lse[:, N:] > 0).all()
    assert float((lse[:, :N] - want[:, :N]).abs().max()) <= 1e-4 * max(
        1.0, float(want[:, :N].abs().max()))


def _grads(module, x, dout, *extra):
    module.zero_grad()
    x = x.detach().requires_grad_()
    out = module(x, *extra)
    out.backward(dout)
    return [x.grad] + [p.grad for p in module.parameters()
                       if p.grad is not None]


def _plain_route(q, k, v):
    return "plain"


@pytest.mark.gpu
@pytest.mark.parametrize("block", ["dit", "flagship"])
def test_block_backward_through_kernels_matches_plain_vjp(block, monkeypatch):
    _card()
    torch.manual_seed(0)
    if block == "dit":
        module = _DiTBlock(1152, 16, dtype=torch.bfloat16).cuda()
        x = torch.randn(8, 1024, 1152, device="cuda")
        c = torch.randn(8, 1152, device="cuda")
        extra = (c,)
    else:
        module = AttentionBlock(192, num_heads=4, dtype=torch.bfloat16).cuda()
        x = torch.randn(8, 192, 32, 32, device="cuda")  # NCHW, N = 1024
        extra = ()
    for p in module.parameters():  # zero-init projections would hide dq, dk
        torch.nn.init.normal_(p, std=0.02)
    dout = torch.randn_like(module(x, *extra).float())
    before = fa.BACKWARD_LAUNCHES
    got = _grads(module, x, dout, *extra)
    assert fa.BACKWARD_LAUNCHES == before + 1
    monkeypatch.setattr(fa, "backward_route", _plain_route)
    want = _grads(module, x, dout, *extra)
    assert fa.BACKWARD_LAUNCHES == before + 1
    assert len(got) == len(want)
    for g, w in zip(got, want):
        err = float((g.float() - w.float()).abs().max())
        assert err <= BLOCK_TOL * max(1.0, float(w.float().abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("D", [8, 32, 36, 48, 64, 72, 80, 96, 112, 128])
def test_library_bwd_plan_matches_the_wrappers_description(D):
    _card()
    want = fa.bwd_plan(32, 1000, 256, 16, D)
    got = fa.native_bwd_plan(32, 1000, 256, 16, D)
    assert got == {key: want[key] for key in got}
