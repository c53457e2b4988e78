"""dsdiff_torch.core.losses against dsdiff_tpu.core.losses, f32 on the CPU.

Values agree to 1e-5 (absolute plus relative): the same elementwise math,
summed in another order. Gradients of a seeded weighted sum of each output
agree to 1e-5 of the largest gradient of that input (plus 1e-5 relative):
some gradients are small differences of large terms (the discretized
likelihood's pdf(x+1/255) - pdf(x-1/255) near a bin's centre), so their
rounding scales with the terms, not with the difference.

Pairwise distances of a point to itself are rounding noise in both
frameworks (|a|² + |b|² - 2a·b at a = b), so the distance logits are
compared off the diagonal and the gradients are taken with zero weight on
it; the losses themselves exclude the diagonal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.core import losses as JL
from dsdiff_torch.core import losses as PL

TOL = 1e-5


def _arr(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _close(got, want, err_msg="", atol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=atol, err_msg=err_msg)


def _offdiag(m):
    m = np.array(m)
    np.fill_diagonal(m, 0.0)
    return m


def _value_and_grads(jfn, pfn, inputs, seed=0, offdiag=False):
    """Hold pfn against jfn on ``inputs`` (numpy): the output, and the
    gradient of sum(w * output) for seeded w, for every input. With
    ``offdiag`` the output is a square matrix compared off its diagonal."""
    jout = jfn(*map(jnp.asarray, inputs))
    w = np.asarray(_arr(np.shape(jout), seed + 100))
    if offdiag:
        w = _offdiag(w)
    jgrads = jax.grad(
        lambda *xs: jnp.sum(jnp.asarray(w) * jfn(*xs)),
        argnums=tuple(range(len(inputs))),
    )(*map(jnp.asarray, inputs))
    ts = [torch.from_numpy(x).requires_grad_() for x in inputs]
    pout = pfn(*ts)
    (torch.from_numpy(w) * pout).sum().backward()
    got, want = pout.detach().numpy(), np.asarray(jout)
    if offdiag:
        got, want = _offdiag(got), _offdiag(want)
    _close(got, want, "value")
    for i, (t, jg) in enumerate(zip(ts, jgrads)):
        jg = np.asarray(jg)
        _close(t.grad, jg, f"grad of input {i}",
               atol=TOL * max(np.abs(jg).max(), 1.0))


def test_mean_flat_normal_kl_and_cdf():
    x = _arr((3, 4, 5, 2), 0)
    _value_and_grads(JL.mean_flat, PL.mean_flat, [x])
    m1, l1, m2, l2 = (_arr((3, 4, 4, 1), s, 0.5) for s in range(1, 5))
    _value_and_grads(JL.normal_kl, PL.normal_kl, [m1, l1, m2, l2])
    _value_and_grads(JL.approx_standard_normal_cdf,
                     PL.approx_standard_normal_cdf, [_arr((64,), 5, 2.0)])


def test_discretized_gaussian_log_likelihood():
    # x spans the three branches: below -0.999, inside, above 0.999
    x = np.clip(_arr((2, 8, 8, 1), 6, 0.8), -1.0, 1.0)
    x[0, 0, :4, 0] = -1.0
    x[1, 0, :4, 0] = 1.0
    # means near x at a small scale, where the bins' CDF difference is not
    # lost to f32 cancellation (there both clip at 1e-12 and log differ)
    means = x + _arr((2, 8, 8, 1), 7, 0.05)
    log_scales = _arr((2, 8, 8, 1), 8, 0.3, -3.0)

    def jf(x, m, s):
        return JL.discretized_gaussian_log_likelihood(x, means=m, log_scales=s)

    def pf(x, m, s):
        return PL.discretized_gaussian_log_likelihood(x, means=m, log_scales=s)

    _value_and_grads(jf, pf, [x, means, log_scales])


def test_charbonnier():
    _value_and_grads(JL.charbonnier, PL.charbonnier,
                     [_arr((2, 6, 6, 1), 9), _arr((2, 6, 6, 1), 10)])


@pytest.mark.parametrize("labels_2d", [True, False])
def test_supervised_contrastive_loss(labels_2d):
    feats = _arr((3, 4, 2, 2, 5), 11)
    if labels_2d:
        labels = np.array([[0, 0, 1, -1], [1, 1, 0, -2], [2, 0, 1, -1]])
    else:
        labels = np.array([0, 1, 0])
    for i in range(2):  # loss, logits
        _value_and_grads(
            lambda f, i=i: JL.supervised_contrastive_loss(
                f, jnp.asarray(labels), 0.07, 0.1)[i],
            lambda f, i=i: PL.supervised_contrastive_loss(
                f, torch.from_numpy(labels), 0.07, 0.1)[i],
            [feats],
        )
    _, _, want = JL.supervised_contrastive_loss(
        jnp.asarray(feats), jnp.asarray(labels), 0.07, 0.1)
    _, _, got = PL.supervised_contrastive_loss(
        torch.from_numpy(feats), torch.from_numpy(labels), 0.07, 0.1)
    _close(got, want, "perfect logits")


def test_euclidean_disentangle_loss():
    feats = _arr((2, 5, 3, 3, 4), 12)
    labels = np.array([[0, 0, 0, -1, -2], [1, 1, 1, -1, -2]])
    for i in range(2):  # loss, distance logits
        _value_and_grads(
            lambda f, i=i: JL.euclidean_disentangle_loss(f, jnp.asarray(labels))[i],
            lambda f, i=i: PL.euclidean_disentangle_loss(
                f, torch.from_numpy(labels))[i],
            [feats], offdiag=i == 1,
        )
    _, _, want = JL.euclidean_disentangle_loss(jnp.asarray(feats),
                                               jnp.asarray(labels))
    _, _, got = PL.euclidean_disentangle_loss(torch.from_numpy(feats),
                                              torch.from_numpy(labels))
    _close(got, want)


@pytest.mark.parametrize("mode", ["eu", "contrast", "eu&contrast"])
def test_ds_disentangle_losses(mode):
    B = 2
    feats = {
        "content": _arr((3, B, 4, 4, 6), 13),
        "style": _arr((3, B, 4, 4, 6), 14),
        "anatomy": _arr((2, B, 4, 4, 6), 15),
        "lesion": _arr((2, B, 4, 4, 6), 16),
    }
    keys = sorted(feats)

    def jf(*xs):
        cs, sal, _ = JL.ds_disentangle_losses(dict(zip(keys, xs)), mode, 0.05)
        return jnp.stack([cs, sal])

    def pf(*xs):
        cs, sal, _ = PL.ds_disentangle_losses(dict(zip(keys, xs)), mode, 0.05)
        return torch.stack([cs, sal])

    _value_and_grads(jf, pf, [feats[k] for k in keys])
    _, _, jmaps = JL.ds_disentangle_losses(
        {k: jnp.asarray(v) for k, v in feats.items()}, mode, 0.05)
    _, _, pmaps = PL.ds_disentangle_losses(
        {k: torch.from_numpy(v) for k, v in feats.items()}, mode, 0.05)
    assert set(pmaps) == set(jmaps)
    for name in jmaps:
        _close(_offdiag(pmaps[name]), _offdiag(jmaps[name]), name)


def test_disentangle_loss_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown disentangle mode"):
        PL.disentangle_loss(torch.zeros(2, 2, 3), torch.zeros(2, 2), "cos")
