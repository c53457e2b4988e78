"""The attention backward's routing, plans and counters, on the CPU.

- ``bwd_plan`` for every head dim the backward kernels take and the
  shipped shapes: D padded to 8, the k-steps of S and dP, the output
  products' n, the grids, and shared memory under ``SMEM_LIMIT``;
- ``backward_route``: bf16 up to D = 128 to the kernels, f32 and the wider
  heads (DisC-Diff's and palette's 192, 256, the VAE's 512) to
  ``attention_vjp``; the forward saves its log-sum-exp only on the
  kernels' route;
- ``reference_lse``, the log-sum-exp the gradient path's forward writes;
- ``_tma_operand``: the qkv thirds pass as they are, what no tensor map
  describes is copied to a padded width;
- the ``attention.bwd_kernel`` and ``attention.bwd_plain`` counters: one a
  backward call inside its ``attention.backward`` span while the tracer is
  on, nothing while it is off (the kernels played by the plain math).
"""
import math

import pytest
import torch

from dsdiff_torch.ops import flash_attention as fa
from dsdiff_torch.utils import profiling as P


@pytest.fixture(autouse=True)
def _tracer_off():
    P.disable()
    P.drain()
    yield
    P.disable()
    P.drain()


# (B, N, M, heads, D) of the trained heads the kernels take: DiT-XL/8, the
# flagship's three, latent, MedSegDiff, crossattn, the guided classifier
SHIPPED = [(32, 1024, 1024, 16, 72), (32, 1024, 1024, 4, 48),
           (32, 256, 256, 6, 48), (32, 64, 64, 6, 48), (8, 1024, 1024, 3, 64),
           (8, 1024, 1024, 4, 32), (4, 64, 256, 8, 36), (4, 1024, 1024, 4, 128)]


@pytest.mark.parametrize("D", range(1, fa.MAX_BWD_HEAD_DIM + 1))
def test_bwd_plan_covers_every_head_dim(D):
    p = fa.bwd_plan(2, 100, 70, 3, D)
    assert p["dp"] % 8 == 0 and D <= p["dp"] < D + 8
    # S and dP reduce over D padded to k-steps of 16, not to 64-column
    # atoms; the outputs' n covers D and is a multiple of 8
    assert p["dp"] <= 16 * p["ksteps"] < p["dp"] + 32
    assert p["dp"] <= p["n"] < p["dp"] + 32 and p["n"] % 8 == 0
    assert p["n"] <= 64 * p["atoms"]
    assert p["atoms"] == -(-p["ksteps"] // 4)
    assert p["smem_bytes"] <= fa.SMEM_LIMIT
    assert p["grid_dq"] == (1, 6, 1) and p["grid_dkdv"] == (1, 6, 1)
    assert p["npad"] == 128 and p["kernels"] == fa.BWD_KERNELS


@pytest.mark.parametrize("B, N, M, H, D", SHIPPED)
def test_bwd_plan_at_the_shipped_shapes(B, N, M, H, D):
    p = fa.bwd_plan(B, N, M, H, D)
    assert p["grid_dq"] == (-(-N // 128), B * H, 1)
    assert p["grid_dkdv"] == (-(-M // 128), B * H, 1)
    assert p["rows"] == 128 and p["key_rows"] == 64 and p["threads"] == 384
    assert p["npad"] == -(-N // 64) * 64
    assert p["smem_bytes"] <= fa.SMEM_LIMIT
    if D == 72:  # DiT-XL: 5 k-steps (80 columns), outputs at n = 72
        assert (p["ksteps"], p["n"], p["atoms"]) == (5, 72, 2)
        assert p["smem_bytes"] == 166400


def _qkv(dtype, D, N=20, M=20, H=2, B=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = torch.randn(B, N, 3, H, D, generator=g).to(dtype).unbind(2)
    if M != N:
        k, v = torch.randn(B, M, 2, H, D, generator=g).to(dtype).unbind(2)
    return q, k, v


@pytest.mark.parametrize("dtype, D, route", [
    (torch.bfloat16, 32, "kernel"), (torch.bfloat16, 36, "kernel"),
    (torch.bfloat16, 48, "kernel"), (torch.bfloat16, 72, "kernel"),
    (torch.bfloat16, 128, "kernel"), (torch.float32, 48, "plain"),
    (torch.float32, 72, "plain"), (torch.bfloat16, 192, "plain"),
    (torch.bfloat16, 256, "plain"), (torch.bfloat16, 512, "plain"),
    (torch.float32, 192, "plain")])
def test_backward_route(dtype, D, route):
    assert fa.backward_route(*_qkv(dtype, D, N=4, M=4)) == route


def test_reference_lse_is_the_softmax_denominator_in_log2():
    q, k, v = _qkv(torch.float32, 24, N=70, M=33)
    lse = fa.reference_lse(q, k)
    assert lse.shape == (4, 128)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(24)
    want = torch.log2(torch.exp(s).sum(-1)).reshape(4, 70)
    assert torch.allclose(lse[:, :70], want, atol=1e-5, rtol=1e-6)
    assert torch.isinf(lse[:, 70:]).all() and (lse[:, 70:] > 0).all()
    # P = 2^(S log2(e) / sqrt(D) - lse) sums to 1 along each row
    p = torch.exp2(s.reshape(4, 70, 33) * (math.log2(math.e))
                   - lse[:, :70, None])
    assert torch.allclose(p.sum(-1), torch.ones(4, 70), atol=1e-5)


def test_tma_operand_keeps_the_qkv_thirds_and_pads_what_no_map_describes():
    q, k, v = _qkv(torch.bfloat16, 72)
    for x in (q, k, v):  # 144-byte head stride: a tensor map describes it
        assert fa._tma_operand(x, 72) is x
    q36, k36, _ = _qkv(torch.bfloat16, 36)
    for x in (q36, k36):  # 72-byte head stride: a copy 40 wide
        y = fa._tma_operand(x, 40)
        assert y.shape == x.shape[:3] + (40,) and y.is_contiguous()
        assert torch.equal(y[..., :36], x) and not y[..., 36:].any()
    odd = torch.zeros(2, 20, 2, 80, dtype=torch.bfloat16)[..., 4:76]
    assert fa._tma_operand(odd, 72) is not odd  # base 8 bytes off alignment


def _play_kernels(monkeypatch):
    """The kernels' launches played by the plain math on the CPU."""
    def launch_lse(q, k, v):
        return fa.reference_attention(q, k, v), fa.reference_lse(q, k)

    def launch_backward(q, k, v, grad_out, lse, needs=(True, True, True)):
        assert torch.equal(lse, fa.reference_lse(q, k))
        return fa.attention_vjp(q, k, v, grad_out, needs)

    monkeypatch.setattr(fa, "_launch", fa.reference_attention)
    monkeypatch.setattr(fa, "_launch_lse", launch_lse)
    monkeypatch.setattr(fa, "_launch_backward", launch_backward)


@pytest.mark.parametrize("dtype, D, counter", [
    (torch.bfloat16, 72, "attention.bwd_kernel"),
    (torch.bfloat16, 36, "attention.bwd_kernel"),
    (torch.float32, 72, "attention.bwd_plain"),
    (torch.bfloat16, 192, "attention.bwd_plain")])
def test_backward_counters_only_while_the_tracer_is_on(dtype, D, counter,
                                                       monkeypatch):
    _play_kernels(monkeypatch)
    q, k, v = (x.detach().requires_grad_() for x in _qkv(dtype, D))
    dout = torch.randn(q.shape).to(dtype)
    other = ({"attention.bwd_kernel", "attention.bwd_plain"} - {counter}).pop()
    want = fa.attention_vjp(q.detach(), k.detach(), v.detach(), dout)
    for on in (False, True, True):
        o = fa.FlashAttention.apply(q, k, v)
        if on:
            P.enable()
        got = torch.autograd.grad(o, (q, k, v), dout)
        P.disable()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        drained = P.drain()
        spans = [r for r in drained["spans"] if r.name == "attention.backward"]
        if not on:
            assert spans == [] and drained["counts"] == {}
            continue
        assert len(spans) == 1 and spans[0].counts == {counter: 1}
        assert drained["counts"].get(counter) == 1
        assert other not in drained["counts"]
