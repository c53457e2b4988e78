"""dsdiff_torch.train.schedule_sampler against dsdiff_tpu's: the same t and
losses go into both states, duplicates within a batch included; the buffers
must agree exactly (they copy values) and the pmf to 1e-7 (f32 math in
another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.train import schedule_sampler as JS
from dsdiff_torch.train import schedule_sampler as PS

T = 6


def _feed(history, batches, seed=0):
    """Run both update_state chains over ``batches`` of t; return the last
    states."""
    rng = np.random.default_rng(seed)
    js = JS.loss2_init(T, history)
    ps = PS.loss2_init(T, history)
    for t in batches:
        t = np.asarray(t, np.int64)
        losses = rng.uniform(0.1, 2.0, t.shape).astype(np.float32)
        js = JS.update_state(js, jnp.asarray(t, jnp.int32), jnp.asarray(losses))
        ps = PS.update_state(ps, torch.from_numpy(t), torch.from_numpy(losses))
        np.testing.assert_array_equal(ps.loss_history.numpy(),
                                      np.asarray(js.loss_history))
        np.testing.assert_array_equal(ps.loss_counts.numpy(),
                                      np.asarray(js.loss_counts))
    return js, ps


def test_update_state_with_duplicates_matches_the_scan():
    batches = [[0, 0, 0, 1], [2, 2, 5, 5], [0, 1, 2, 3], [4, 4, 4, 4],
               [3, 3, 0, 5], [1, 1, 1, 2]]
    _feed(3, batches)


@pytest.mark.parametrize("warm", [False, True])
def test_weights_match(warm):
    batches = [[t] * 3 for t in range(T)] if warm else [[0, 1], [1, 1]]
    js, ps = _feed(3, batches, seed=1)
    assert bool(ps.loss_counts.eq(3).all()) == warm
    np.testing.assert_allclose(PS._weights(ps).numpy(),
                               np.asarray(JS._weights(js)), atol=1e-7)
    # importance weights 1 / (T p_t), for a given t and for drawn ones
    p = np.asarray(JS._weights(js))
    t = np.array([0, 3, 3, 5])
    got_t, got_w = PS.sample_t(ps, 4, t=torch.from_numpy(t))
    np.testing.assert_array_equal(got_t.numpy(), t)
    np.testing.assert_allclose(got_w.numpy(), 1.0 / (T * p[t]), rtol=1e-6)
    drawn, w = PS.sample_t(ps, 16, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(w.numpy(), 1.0 / (T * p[drawn.numpy()]),
                               rtol=1e-6)


def test_uniform_sampler_draws_in_range_with_unit_weights():
    state = PS.make_schedule_sampler("uniform", 1000)
    gen = torch.Generator().manual_seed(0)
    t, w = PS.sample_t(state, 64, gen)
    assert t.dtype == torch.int64 and 0 <= int(t.min()) and int(t.max()) < 1000
    assert torch.all(w == 1.0)
    assert PS.update_state(state, t, torch.ones(64)) is state
    with pytest.raises(ValueError, match="unknown schedule sampler"):
        PS.make_schedule_sampler("lossaware", 10)
