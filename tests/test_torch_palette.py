"""The port's Palette math (``core/palette.py``) against the JAX package's:
the gamma tables, ``q_sample``, the training loss (plain and masked), the
ancestral loop and DDIM (uniform and quadratic subsequences, with and
without eta), with a closed-form denoiser written in both frameworks and
JAX's own draws of y_T and the per-step noise replayed into the port. f32,
1e-5 absolute."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.core import palette as JP
from dsdiff_torch.core import palette as PP

ATOL = 1e-5
SHAPE = (2, 8, 8, 1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _model_jax(x, gamma):
    return jnp.tanh(0.3 * x.sum(-1, keepdims=True)
                    + gamma[:, None, None, None] - 0.5)


def _model_torch(x, gamma):
    return torch.tanh(0.3 * x.sum(-1, keepdim=True)
                      + gamma[:, None, None, None] - 0.5)


def _cond(seed=0):
    return np.random.default_rng(seed).standard_normal(
        SHAPE[:-1] + (3,)).astype(np.float32)


def test_gamma_tables_match_jax():
    js = JP.GammaSchedule.create(n_timestep=50, linear_start=1e-4,
                                 linear_end=0.09)
    ps = PP.GammaSchedule.create(n_timestep=50, linear_start=1e-4,
                                 linear_end=0.09)
    assert ps.num_timesteps == js.num_timesteps == 50
    for name in JP.GammaSchedule._fields:
        np.testing.assert_array_equal(getattr(ps, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_q_sample_and_training_loss_match_jax(masked):
    rng = np.random.default_rng(1)
    y0 = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    noise = rng.standard_normal(SHAPE).astype(np.float32)
    mask = (rng.uniform(size=SHAPE) > 0.5).astype(np.float32) if masked else None
    t = np.array([3, 1800])
    js = JP.GammaSchedule.create()
    ps = PP.GammaSchedule.create()
    g = np.asarray(js.gammas)[t]
    np.testing.assert_allclose(
        PP.q_sample(_t(g), _t(y0), _t(noise)).numpy(),
        np.asarray(JP.q_sample(jnp.asarray(g), y0, noise)), atol=ATOL)
    want = JP.training_loss(js, _model_jax, y0, _cond(), jnp.asarray(t), noise,
                            mask=None if mask is None else jnp.asarray(mask))
    got = PP.training_loss(ps, _model_torch, _t(y0), _t(_cond()), _t(t),
                           _t(noise), mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL)


def _jax_draws(rng, steps):
    """y_T and the per-step noise the JAX loops draw from ``rng``."""
    rng, init = jax.random.split(rng)
    y_T = jax.random.normal(init, SHAPE, jnp.float32)
    noise = []
    for _ in range(steps):
        rng, k = jax.random.split(rng)
        noise.append(_t(jax.random.normal(k, SHAPE, jnp.float32)))
    return _t(y_T), noise


def test_ancestral_loop_matches_jax_given_its_draws():
    js = JP.GammaSchedule.create(n_timestep=12, linear_start=1e-4,
                                 linear_end=0.09)
    ps = PP.GammaSchedule.create(n_timestep=12, linear_start=1e-4,
                                 linear_end=0.09)
    rng = jax.random.PRNGKey(2)
    want = JP.p_sample_loop(js, _model_jax, jnp.asarray(_cond()), rng)
    y_T, noise = _jax_draws(rng, 12)
    got = PP.p_sample_loop(ps, _model_torch, _t(_cond()), y_T=y_T, noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("method, steps, eta", [
    ("uniform", 5, 1.0), ("uniform", 7, 0.0), ("quad", 6, 0.5)])
def test_ddim_loop_matches_jax_given_its_draws(method, steps, eta):
    """uniform over T=40 with 7 steps takes 8 subsequence entries and uses
    the first 7, as JAX's scan does."""
    js = JP.GammaSchedule.create(n_timestep=40, linear_start=1e-4,
                                 linear_end=0.09)
    ps = PP.GammaSchedule.create(n_timestep=40, linear_start=1e-4,
                                 linear_end=0.09)
    rng = jax.random.PRNGKey(3)
    want = JP.ddim_sample_loop(js, _model_jax, jnp.asarray(_cond(4)), rng,
                               ddim_steps=steps, eta=eta, method=method)
    y_T, noise = _jax_draws(rng, steps)
    got = PP.ddim_sample_loop(ps, _model_torch, _t(_cond(4)),
                              ddim_steps=steps, eta=eta, method=method,
                              y_T=y_T, noise=noise if eta else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_loops_draw_from_a_generator():
    ps = PP.GammaSchedule.create(n_timestep=20)
    gen = torch.Generator().manual_seed(0)
    out = PP.ddim_sample_loop(ps, _model_torch, _t(_cond()), gen,
                              ddim_steps=4, eta=1.0)
    assert out.shape == SHAPE and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="generator"):
        PP.p_sample_loop(ps, _model_torch, _t(_cond()), y_T=torch.zeros(SHAPE))
    with pytest.raises(ValueError, match="discretization"):
        PP.ddim_sample_loop(ps, _model_torch, _t(_cond()), gen, method="cubic")
