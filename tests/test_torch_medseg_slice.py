"""A MedSegDiff train step and request through the port's entry points
against the JAX package's, f32 on the CPU: ``make_train_step`` over a
``TrainState`` and ``make_sample_fn``, on ``medseg_v1`` (highway) and
``medseg_new`` (anchor) at the narrow widths of ``torch_medseg_utils``,
given JAX's draws. The JAX ``Trainer`` cannot build these models (it
passes ``remat``, which MedSegDiffUNet does not take; the port's fails
alike, ``test_torch_seg_unet.py``), so the library functions are their
entry point in both packages.

Tolerances: metrics 1e-4 relative; gradients (read off AdamW's first
moment) 1e-4 of each leaf's largest, floored at 1e-2 of the model's largest
(a conv bias before a one-channel group norm has no gradient in exact
arithmetic and holds rounding noise); parameters 1e-6 absolute where the
gradient is firm, as ``test_torch_train_step.py`` sets out; the DDIM-3
request, given JAX's x_T, 1e-4 absolute on a chain clipped to [-1, 1].
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.core import schedules as JSch
from dsdiff_tpu.train import schedule_sampler as JSS
from dsdiff_tpu.train import state as JState
from dsdiff_tpu.train import step as JStep
from dsdiff_torch.core import schedules as PSch
from dsdiff_torch.train import schedule_sampler as PSS
from dsdiff_torch.train import step as PStep
from dsdiff_torch.train.state import TrainState, make_optimizer
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict
from torch_medseg_utils import B, HW, MODES, N_COND, RTOL, medseg_pair
from torch_parity_utils import one_thread

pytestmark = pytest.mark.usefixtures("one_thread")

GRAD_TOL = 1e-4
NOISE_FLOOR = 1e-2
FIRM = 1e-2
PARAM_ATOL = 1e-6
SAMPLE_ATOL = 1e-4


def _adam(state):
    return state.opt_state[-1][0]


@pytest.mark.parametrize("name", sorted(MODES))
def test_train_step_and_ddim_request_match_jax(name):
    """One step of ``make_train_step`` over a ``TrainState`` (AdamW, lr
    1e-4, EMA) on a MedSegDiff model, given JAX's t and noise, then a
    DDIM-3 request through ``make_sample_fn`` from the stepped weights,
    given JAX's x_T: the model's ``(out, {"cal": ...})`` passes through
    both as through the JAX package's."""
    jm, tree, pm = medseg_pair(name, 19)
    rng = np.random.default_rng(20)
    batch = {"target": rng.uniform(-1, 1, (B, HW, HW, 1)).astype(np.float32),
             "image": rng.standard_normal((B, HW, HW, N_COND)).astype(
                 np.float32)}
    task = dict(parameterization="v", loss_type="charbonnier")
    betas = JSch.make_beta_schedule("scaled_linear", 1000)

    jstate = JState.TrainState.create(jm.apply, {"params": tree},
                                      JState.make_optimizer(1e-4))
    jstep = JStep.make_train_step(JStep.TaskConfig(**task),
                                  JSch.DiffusionSchedule.create(betas),
                                  donate=False)
    key = jax.random.PRNGKey(21)
    jstate1, _, jm1 = jstep(jstate, JSS.uniform_init(1000),
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            key)
    t_rng, n_rng, _, _ = jax.random.split(jax.random.fold_in(key, 0), 4)
    t = torch.from_numpy(np.array(
        jax.random.randint(t_rng, (B,), 0, 1000), np.int64))
    noise = torch.from_numpy(np.array(
        jax.random.normal(n_rng, (B, HW, HW, 1), jnp.float32)))

    state = TrainState(pm, lambda p: make_optimizer(p, 1e-4))
    step = PStep.make_train_step(PStep.TaskConfig(**task),
                                 PSch.DiffusionSchedule.create(betas,
                                                               device="cpu"))
    _, _, metrics = step(state, PSS.uniform_init(1000),
                         {k: torch.from_numpy(v) for k, v in batch.items()},
                         t=t, noise=noise)
    assert set(metrics) == set(jm1) == {"loss", "loss_simple", "grad_norm"}
    for k in jm1:
        np.testing.assert_allclose(float(metrics[k]), float(jm1[k]),
                                   rtol=RTOL, err_msg=k)
    want_g = {n: v.numpy() / 0.1 for n, v in flax_to_state_dict(
        _adam(jstate1).mu, pm).items()}
    top = max(np.abs(g).max() for g in want_g.values())
    want_p = flax_to_state_dict(jstate1.params, pm)
    compared = 0
    for i, n in enumerate(state.names):
        got_g = state.tx.mu[i].numpy() / 0.1
        scale = max(np.abs(want_g[n]).max(), NOISE_FLOOR * top)
        np.testing.assert_allclose(got_g, want_g[n], rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=n)
        g = np.abs(want_g[n])
        firm = g >= max(FIRM * g.max(), 1e-6)
        compared += firm.sum()
        np.testing.assert_allclose(state.params[i].detach().numpy()[firm],
                                   want_p[n].numpy()[firm], rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
    assert compared > 0.3 * sum(p.numel() for p in state.params)
    assert state.step == int(jstate1.step) == 1

    rsched = JSch.respace(betas, JSch.space_timesteps(1000, "3"))
    jfn = JStep.make_sample_fn(jm.apply, rsched, JStep.TaskConfig(**task),
                               sampler="ddim")
    srng = jax.random.PRNGKey(22)
    want = np.asarray(jfn(jstate1.params, jnp.asarray(batch["image"]), srng))
    x_rng, _ = jax.random.split(srng)
    x_T = torch.from_numpy(np.array(
        jax.random.normal(x_rng, (B, HW, HW, 1), jnp.float32)))
    fn = PStep.make_sample_fn(
        pm.eval(), PSch.respace(betas, PSch.space_timesteps(1000, "3"),
                                device="cpu"),
        PStep.TaskConfig(**task), sampler="ddim")
    got = fn(torch.from_numpy(batch["image"]), x_T=x_T)
    assert got.shape == (B, HW, HW, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SAMPLE_ATOL)
