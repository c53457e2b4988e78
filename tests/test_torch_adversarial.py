"""The adversarial disentanglement of the port (``train/adversarial.py``,
``SpectralNormConv`` and ``ModulatedResBlock`` of ``models/layers.py``)
against the JAX package's, f32 on the CPU, the same seeded inputs and Flax
weights carried across by ``utils.flax_bridge``.

Tolerances: the blocks and the discriminator 1e-4 of max(1, max |out|)
(conv summation order); the power iteration's sigma 1e-5 relative. The
steps: two rounds of ``model_step`` then ``disc_step`` on the ``TINY``
DSUNet and a narrow spectral-norm discriminator, each step started from
JAX's state before it and given JAX's t and noise, as
``test_torch_train_step.py`` holds its second step: metrics 1e-4 relative
(``disc_acc`` exactly); gradients, read off AdamW's first moment, 1e-4 of
each leaf's largest, floored at 1e-2 of the model's largest; parameters
1e-6 absolute where the gradient is firm (at least 1e-2 of its leaf's
largest and 1e-6), since elsewhere Adam turns rounding noise into steps of
±lr in either package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.core import schedules as JSch
from dsdiff_tpu.models import layers as JL
from dsdiff_tpu.models.dsunet import DSUNet as JDSUNet
from dsdiff_tpu.train import adversarial as JA
from dsdiff_tpu.train import schedule_sampler as JSS
from dsdiff_tpu.train import state as JState
from dsdiff_tpu.train.step import TaskConfig as JTaskConfig
from dsdiff_torch.core import schedules as PSch
from dsdiff_torch.models import layers as PL
from dsdiff_torch.models import build_model
from dsdiff_torch.train import adversarial as PA
from dsdiff_torch.train import schedule_sampler as PSS
from dsdiff_torch.train.state import TrainState, make_optimizer
from dsdiff_torch.train.step import TaskConfig
from dsdiff_torch.utils.flax_bridge import (flax_to_state_dict,
                                            train_state_from_flax)
from torch_parity_utils import (TINY, nchw_to_nhwc, nhwc_to_nchw, one_thread,
                                random_flax_params)

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL = 1e-4
GRAD_TOL = 1e-4
NOISE_FLOOR = 1e-2
FIRM = 1e-2
PARAM_ATOL = 1e-6
B, HW, LR = 2, 16, 1e-4
# TINY's bottleneck: 64 channels at 8², content features of half the width
CONTENT = 32
DISC = dict(n_streams=3, base_channels=8)
# on 8² content the third conv's output is 1²: its GroupNorm (32 groups)
# must see more than one element a group, or it outputs its bias alone and
# no gradient reaches the layers before it (the flagship's 256 channels
# give 8 a group; these 128, 4)
DISC_STEPS = dict(n_streams=3, base_channels=32)


def _close(got, want, rtol=RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rtol * max(1.0, float(np.abs(want).max())), (what, err)


def _init(jm, seed, *args):
    tree = jm.init(jax.random.PRNGKey(0), *map(jnp.asarray, args))["params"]
    return random_flax_params(tree, seed)


# ------------------------------------------------------------ the blocks
@pytest.mark.parametrize("stride, n_iter, bias", [(1, 3, True), (2, 3, False),
                                                  (1, 20, False)])
def test_spectral_norm_conv_matches_jax(stride, n_iter, bias):
    """Output and the kernel's gradient (through the power iteration)."""
    x = np.random.default_rng(1).standard_normal((2, 8, 8, 3)).astype(
        np.float32)
    jm = JL.SpectralNormConv(6, (3, 3), strides=(stride, stride), padding=1,
                             n_iter=n_iter, use_bias=bias)
    tree = _init(jm, 2, x)
    pm = PL.SpectralNormConv(3, 6, 3, stride=stride, padding=1,
                             n_iter=n_iter, bias=bias)
    pm.load_state_dict(flax_to_state_dict(tree, pm))
    got = pm(nhwc_to_nchw(x))
    want = jm.apply({"params": tree}, jnp.asarray(x))
    _close(nchw_to_nhwc(got), want)
    jgrad = jax.grad(lambda p: jnp.sum(jm.apply({"params": p},
                                                jnp.asarray(x)) ** 2))(tree)
    (got ** 2).sum().backward()
    _close(pm.weight.grad.permute(2, 3, 1, 0), jgrad["kernel"],
           what="kernel gradient")


def test_spectral_norm_conv_divides_out_the_kernel_scale():
    """As the JAX package's test: at 20 iterations the output does not
    change when the kernel is scaled by 37. The iteration's sigma is a
    Rayleigh quotient, so it approaches the top singular value from below:
    the normalised kernel's top singular value is 1 within 1e-2 here (the
    rate is (s2/s1)^2 an iteration), and at 200 iterations within 1e-5."""
    with torch.random.fork_rng():
        torch.manual_seed(3)
        pm = PL.SpectralNormConv(3, 6, 3, padding=1, n_iter=20, bias=False)
        x = torch.randn(2, 3, 8, 8)
    with torch.no_grad():
        out = pm(x)
        w = pm.weight.permute(2, 3, 1, 0).reshape(-1, 6)
        top = float(torch.linalg.svdvals(w)[0])
        assert 1.0 - 1e-6 <= top / float(pm.sigma()) < 1.0 + 1e-2
        pm.n_iter = 200
        np.testing.assert_allclose(float(pm.sigma()), top, rtol=1e-5)
        pm.n_iter = 20
        pm.weight.mul_(37.0)
        np.testing.assert_allclose(pm(x).numpy(), out.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_modulated_resblock_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    emb = rng.standard_normal((2, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    jm = JL.ModulatedResBlock(out_channels=16)
    tree = _init(jm, 5, x, emb, ctx)
    pm = PL.ModulatedResBlock(8, 32, 16)
    pm.load_state_dict(flax_to_state_dict(tree, pm))
    got = pm(nhwc_to_nchw(x), torch.from_numpy(emb), nhwc_to_nchw(ctx))
    _close(nchw_to_nhwc(got), jm.apply({"params": tree}, x, emb, ctx))
    # fresh, the zero-initialised out conv leaves the skip alone
    fresh = PL.ModulatedResBlock(8, 32, 16).eval()
    x = torch.randn(2, 8, 8, 8)
    with torch.no_grad():
        out = fresh(x, torch.ones(2, 32), torch.randn(2, 32, 8, 8))
    torch.testing.assert_close(out, fresh.skip(x), rtol=0, atol=0)


def test_modulated_resblock_dropout_draws_from_the_bound_generator():
    pm = PL.ModulatedResBlock(8, 32, 8, dropout=0.5).train()
    x, emb, ctx = torch.randn(1, 8, 4, 4), torch.randn(1, 32), torch.randn(
        1, 16, 4, 4)
    with pytest.raises(RuntimeError, match="dropout_generator"):
        pm(x, emb, ctx)
    outs = []
    for _ in range(2):
        with PL.dropout_generator(pm, torch.Generator().manual_seed(6)):
            outs.append(pm(x, emb, ctx))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    mask = torch.rand((1, 8, 4, 4), generator=torch.Generator().manual_seed(
        6)) < 0.5
    torch.testing.assert_close(pm(x, emb, ctx, mask=mask), outs[0],
                               rtol=0, atol=0)


@pytest.mark.parametrize("spectral", [True, False])
def test_content_discriminator_matches_jax(spectral):
    f = np.random.default_rng(7).standard_normal((4, 16, 16, 8)).astype(
        np.float32)
    jm = JA.ContentDiscriminator(use_spectral_norm=spectral, **DISC)
    tree = _init(jm, 8, f)
    pm = PA.ContentDiscriminator(8, use_spectral_norm=spectral, **DISC)
    pm.load_state_dict(flax_to_state_dict(tree, pm))
    got = pm(torch.from_numpy(f))
    assert got.shape == (4, 3) and got.dtype == torch.float32
    _close(got, jm.apply({"params": tree}, jnp.asarray(f)))
    # bf16 features are read in f32, as Flax promotes them
    _close(pm(torch.from_numpy(f).bfloat16()),
           jm.apply({"params": tree}, jnp.asarray(f, jnp.bfloat16)))


# ------------------------------------------------------------ the steps
def _adam(state):
    return state.opt_state[-1][0]


def _flax_state(state):
    adam = _adam(state)
    return {"params": state.params, "ema_params": state.ema_params,
            "mu": adam.mu, "nu": adam.nu, "count": int(adam.count),
            "step": int(state.step)}


def _draws(rng, step, shape):
    """The t and noise either JAX step draws at ``step``."""
    t_rng, n_rng, _ = jax.random.split(jax.random.fold_in(rng, step), 3)
    t = jax.random.randint(t_rng, (shape[0],), 0, 1000)
    noise = jax.random.normal(n_rng, shape, jnp.float32)
    return (torch.from_numpy(np.array(t, np.int64)),
            torch.from_numpy(np.array(noise)))


def _hold_state(state, before, jbefore, jafter, what):
    """The port's ``state`` after a step from ``jbefore`` against JAX's
    ``jafter``: gradients (from AdamW's first moment) and the updated
    parameters where the gradient is firm."""
    model = state.model
    want_mu = flax_to_state_dict(_adam(jafter).mu, model)
    prev_mu = flax_to_state_dict(_adam(jbefore).mu, model)
    want_p = flax_to_state_dict(jafter.params, model)
    want_g = {n: ((want_mu[n] - 0.9 * prev_mu[n]) / 0.1).numpy()
              for n in state.names}
    top = max(np.abs(g).max() for g in want_g.values())
    compared = 0
    for i, n in enumerate(state.names):
        got_g = ((state.tx.mu[i] - 0.9 * before[i]) / 0.1).numpy()
        scale = max(np.abs(want_g[n]).max(), NOISE_FLOOR * top)
        np.testing.assert_allclose(got_g, want_g[n], rtol=0,
                                   atol=GRAD_TOL * scale,
                                   err_msg=f"{what} gradient {n}")
        g = np.abs(want_g[n])
        firm = g >= max(FIRM * g.max(), 1e-6)
        compared += firm.sum()
        np.testing.assert_allclose(state.params[i].detach().numpy()[firm],
                                   want_p[n].numpy()[firm], rtol=0,
                                   atol=PARAM_ATOL,
                                   err_msg=f"{what} parameter {n}")
    assert compared > 0.3 * sum(p.numel() for p in state.params), what
    assert state.step == int(jafter.step)


def _hold_metrics(got, want, what):
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for k in want:
        if k == "disc_acc":
            assert float(got[k]) == float(want[k]), (what, k)
        else:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=RTOL, err_msg=f"{what} {k}")


def _copy(tree):
    """A copy of a JAX state for a jitted step that donates its buffers."""
    return jax.tree.map(lambda a: jnp.array(a, copy=True), tree)


def test_two_adversarial_rounds_match_jax():
    """disc_start 1: the first model step (step 0) leaves the adversarial
    term out of its loss and gradients, the second takes it in."""
    disc_start = 1
    task = dict(parameterization="v", loss_type="charbonnier",
                feature_kind="ds", disen_lambda=0.1)
    adv = dict(adv_lambda=0.1, disc_start=disc_start)
    betas = JSch.make_beta_schedule("scaled_linear", 1000)
    rng = np.random.default_rng(9)
    batch = {"target": rng.uniform(-1, 1, (B, HW, HW, 1)).astype(np.float32),
             "image": rng.standard_normal((B, HW, HW, 3)).astype(np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    jm = JDSUNet(in_channels=4, out_channels=1, **TINY)
    mtree = _init(jm, 10, np.zeros((1, HW, HW, 4), np.float32),
                  np.zeros((1,), np.float32))
    jd = JA.ContentDiscriminator(**DISC_STEPS)
    dtree = _init(jd, 11, np.zeros((1, 8, 8, CONTENT), np.float32))
    jms = JState.TrainState.create(jm.apply, {"params": mtree},
                                   JState.make_optimizer(LR))
    jds = JState.TrainState.create(jd.apply, {"params": dtree},
                                   JState.make_optimizer(LR))
    j_model_step, j_disc_step = JA.make_adversarial_steps(
        JTaskConfig(**task), JSch.DiffusionSchedule.create(betas), jd.apply,
        JA.AdvConfig(**adv))
    key = jax.random.PRNGKey(12)
    jsampler = JSS.uniform_init(1000)

    model = build_model("dsunet", device="cpu", in_channels=4,
                        out_channels=1, **TINY)
    disc = PA.ContentDiscriminator(CONTENT, **DISC_STEPS)
    ms = TrainState(model, lambda p: make_optimizer(p, LR))
    ds = TrainState(disc, lambda p: make_optimizer(p, LR))
    model_step, disc_step = PA.make_adversarial_steps(
        TaskConfig(**task), PSch.DiffusionSchedule.create(betas, device="cpu"),
        PA.AdvConfig(**adv))
    sampler = PSS.uniform_init(1000)

    for rnd in range(2):
        # the model step, from JAX's states before it
        ms.load(**train_state_from_flax(_flax_state(jms), model))
        ds.load(**train_state_from_flax(_flax_state(jds), disc))
        before = [m.clone() for m in ms.tx.mu]
        jms1, jsampler, jmetrics = j_model_step(
            _copy(jms), _copy(jsampler), jds.params, jbatch, key)
        t, noise = _draws(key, rnd, (B, HW, HW, 1))
        _, sampler, metrics = model_step(ms, sampler, ds, pbatch, t=t,
                                         noise=noise)
        _hold_metrics(metrics, jmetrics, f"round {rnd} model step")
        # the gate: without the adversarial term, the loss is the rest
        rest = float(metrics["loss_simple"] + 0.1 * (
            metrics["loss_disen_cs"] + metrics["loss_disen_sal"]))
        gated = float(metrics["loss"]) - rest
        np.testing.assert_allclose(
            gated, 0.0 if rnd < disc_start else 0.1 * float(
                metrics["loss_adv"]), atol=1e-5)
        _hold_state(ms, before, jms, jms1, f"round {rnd} model")
        jms = jms1
        # the disc step on the stepped model
        ms.load(**train_state_from_flax(_flax_state(jms), model))
        before = [m.clone() for m in ds.tx.mu]
        jds1, jdmetrics = j_disc_step(_copy(jds), jms, jbatch, key)
        t, noise = _draws(key, rnd, (B, HW, HW, 1))
        _, dmetrics = disc_step(ds, ms, pbatch, t=t, noise=noise)
        assert model.training  # the step restores the model's mode
        _hold_metrics(dmetrics, jdmetrics, f"round {rnd} disc step")
        assert 0.0 <= float(dmetrics["disc_acc"]) <= 1.0
        _hold_state(ds, before, jds, jds1, f"round {rnd} disc")
        jds = jds1


def test_steps_draw_from_a_generator():
    """Without given draws both steps draw t and noise from the generator:
    the same seed repeats a step's loss; the model parameters move, the
    discriminator's do not in the model step and do in the disc step."""
    model = build_model("dsunet", device="cpu", in_channels=4,
                        out_channels=1, **TINY)
    disc = PA.ContentDiscriminator(CONTENT, **DISC_STEPS)
    ms = TrainState(model, lambda p: make_optimizer(p, LR))
    ds = TrainState(disc, lambda p: make_optimizer(p, LR))
    model_step, disc_step = PA.make_adversarial_steps(
        TaskConfig(feature_kind="ds"),
        PSch.DiffusionSchedule.create(
            JSch.make_beta_schedule("scaled_linear", 1000), device="cpu"))
    g = torch.Generator().manual_seed(13)
    batch = {"target": torch.rand(B, HW, HW, 1, generator=g) * 2 - 1,
             "image": torch.randn(B, HW, HW, 3, generator=g)}
    d0 = [p.detach().clone() for p in ds.params]
    m0 = [p.detach().clone() for p in ms.params]
    _, _, m1 = model_step(ms, PSS.uniform_init(1000), ds, batch,
                          torch.Generator().manual_seed(0))
    assert all(torch.equal(a, p) for a, p in zip(d0, ds.params))
    assert any(not torch.equal(a, p) for a, p in zip(m0, ms.params))
    assert all(p.grad is None for p in ds.params)
    _, dm = disc_step(ds, ms, batch, torch.Generator().manual_seed(0))
    assert any(not torch.equal(a, p) for a, p in zip(d0, ds.params))
    _, dm2 = disc_step(ds, ms, batch, torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v) for v in (*m1.values(), *dm.values()))
    # the same draws on a moved discriminator: a different loss
    assert float(dm["disc_ce"]) != float(dm2["disc_ce"])
