"""The training slice end to end: the port's ``Trainer.train_step`` against
the JAX package's ``make_train_step`` on the tiny flagship config (the
``TINY`` DSUNet of ``torch_parity_utils.py`` with remat, 16², batch 2, f32 on
the CPU), the same bridged weights and batch, and JAX's own draws of t and
noise replayed into the port. Step 2 starts in both from JAX's state after
step 1, carried into the port by ``train_state_from_flax``.

Tolerances:

- metrics and grad_norm: 1e-4 relative.
- gradients: 1e-4 of each leaf's largest magnitude (XLA and PyTorch sum
  the convolutions in another order). Some leaves have no gradient in exact
  arithmetic (a conv bias that feeds a GroupNorm with one channel per group,
  as in TINY's 32-channel blocks) and hold rounding noise only, so a leaf's
  scale is at least 1e-2 of the model's largest gradient. The gradients
  are read off AdamW's first moment, mu_k = 0.9 mu_(k-1) + 0.1 g_k.
- updated parameters and EMA: 1e-6 absolute, on the elements whose
  gradient is at least 1e-2 of its leaf's largest and at least 1e-6. Adam
  moves an element by lr·g/(|g| + 1e-8), about ±lr whatever |g| is, so
  where g is rounding noise the two frameworks move it by ±lr at random;
  the optimizer itself is held on identical gradients by
  ``test_torch_state.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.core import schedules as JSch
from dsdiff_tpu.eval import metrics as JM
from dsdiff_tpu.models.dsunet import DSUNet as JDSUNet
from dsdiff_tpu.train import schedule_sampler as JSS
from dsdiff_tpu.train import state as JState
from dsdiff_tpu.train import step as JStep
from dsdiff_torch.eval import metrics as PM
from dsdiff_torch.ops import flash_attention as PF
from dsdiff_torch.train.trainer import Trainer
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict
from torch_parity_utils import (TINY, one_thread, random_flax_params,
                                tiny_cfg)

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL = 1e-4
GRAD_TOL = 1e-4
NOISE_FLOOR = 1e-2
FIRM = 1e-2
PARAM_ATOL = 1e-6
B = 2


def _trainer():
    return Trainer(tiny_cfg(), device="cpu")  # remat on, as the flagship


def _batch(seed=21):
    rng = np.random.default_rng(seed)
    return {
        "target": rng.uniform(-1, 1, (B, 16, 16, 1)).astype(np.float32),
        "image": rng.standard_normal((B, 16, 16, 3)).astype(np.float32),
    }


def _jax_draws(rng, step, shape):
    """The t and noise that ``make_train_step`` draws at ``step``."""
    key = jax.random.fold_in(rng, step)
    t_rng, n_rng, _, _ = jax.random.split(key, 4)
    t = jax.random.randint(t_rng, (shape[0],), 0, 1000)
    noise = jax.random.normal(n_rng, shape, jnp.float32)
    return torch.from_numpy(np.array(t, np.int64)), torch.from_numpy(np.array(noise))


def _adam(state):
    return state.opt_state[-1][0]


def _flax_state(state):
    adam = _adam(state)
    return {"params": state.params, "ema_params": state.ema_params,
            "mu": adam.mu, "nu": adam.nu, "count": int(adam.count),
            "step": int(state.step)}


@pytest.fixture(scope="module")
def jax_run():
    """Two JAX train steps from seeded weights; the states after each."""
    trainer = _trainer()
    jm = JDSUNet(in_channels=4, out_channels=2, remat=True, **TINY)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)),
                     jnp.zeros((1,)))["params"]
    params = random_flax_params(params, 5)
    lr = JState.cosine_lr(1e-4, 250 * 1000, warmup_steps=0, min_lr=1e-7)
    state0 = JState.TrainState.create(
        jm.apply, {"params": params}, JState.make_optimizer(lr), ema_decay=0.9999
    )
    sched = JSch.DiffusionSchedule.create(
        JSch.make_beta_schedule("scaled_linear", 1000))
    task = JStep.TaskConfig(**dataclasses.asdict(trainer.task))
    step_fn = JStep.make_train_step(task, sched, donate=False)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(3)
    sampler = JSS.uniform_init(1000)
    state1, sampler, m1 = step_fn(state0, sampler, jbatch, rng)
    state2, sampler, m2 = step_fn(state1, sampler, jbatch, rng)
    return dict(params=params, batch=batch, rng=rng, states=(state0, state1, state2),
                metrics=(m1, m2), sampler=sampler)


def _check_step(trainer, jax_run, step):
    """Run the port's step ``step`` (1 or 2) and hold it against JAX's."""
    batch = {k: torch.from_numpy(v) for k, v in jax_run["batch"].items()}
    t, noise = _jax_draws(jax_run["rng"], step - 1, batch["target"].shape)
    before = [m.clone() for m in trainer.state.tx.mu]
    metrics = trainer.train_step(batch, t=t, noise=noise)
    want_m = jax_run["metrics"][step - 1]
    assert set(metrics) == set(want_m) == {
        "loss", "loss_simple", "loss_vlb", "loss_disen_cs", "loss_disen_sal",
        "grad_norm"}
    for k in want_m:
        np.testing.assert_allclose(float(metrics[k]), float(want_m[k]),
                                   rtol=RTOL, err_msg=k)

    jstate = jax_run["states"][step]
    model = trainer.model
    state = trainer.state
    # gradients: mu_k = 0.9 mu_{k-1} + 0.1 g_k, from the same mu_{k-1}
    want_mu = flax_to_state_dict(_adam(jstate).mu, model)
    prev_mu = flax_to_state_dict(_adam(jax_run["states"][step - 1]).mu, model)
    got_g, want_g = {}, {}
    for i, name in enumerate(state.names):
        got_g[name] = ((state.tx.mu[i] - 0.9 * before[i]) / 0.1).numpy()
        want_g[name] = ((want_mu[name] - 0.9 * prev_mu[name]) / 0.1).numpy()
    top = max(np.abs(g).max() for g in want_g.values())
    for name in state.names:
        scale = max(np.abs(want_g[name]).max(), NOISE_FLOOR * top)
        np.testing.assert_allclose(got_g[name], want_g[name], rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)
    # updated parameters and EMA, where Adam's update is decided by the
    # gradient and not by its rounding
    compared = 0
    for got, tree in ((dict(zip(state.names, state.params)), jstate.params),
                      (state.ema_state_dict(), jstate.ema_params)):
        want = flax_to_state_dict(tree, model)
        for name in state.names:
            g = np.abs(want_g[name])
            firm = g >= max(FIRM * g.max(), 1e-6)
            compared += firm.sum()
            np.testing.assert_allclose(got[name].detach().numpy()[firm],
                                       want[name].numpy()[firm], rtol=0,
                                       atol=PARAM_ATOL, err_msg=name)
    assert compared > 0.5 * 2 * sum(p.numel() for p in state.params)
    assert state.step == int(jstate.step) == step
    assert state.tx.count == int(_adam(jstate).count)


def test_first_train_step_matches_jax(jax_run):
    trainer = _trainer()
    trainer.load_flax_params({"params": jax_run["params"]})
    _check_step(trainer, jax_run, 1)


def test_second_train_step_from_the_jax_state_matches_jax(jax_run):
    trainer = _trainer()
    state1 = jax_run["states"][1]
    trainer.load_flax_state(_flax_state(state1), sampler={
        "kind": "uniform", "loss_history": np.zeros((1000, 1), np.float32),
        "loss_counts": np.zeros(1000, np.int32)})
    assert trainer.state.step == 1 and trainer.state.tx.count == 1
    assert trainer.sampler_state.kind == "uniform"
    _check_step(trainer, jax_run, 2)
    # sampling refreshes its copy from the EMA weights changed by the step
    cond = torch.from_numpy(jax_run["batch"]["image"])
    out = trainer.sample_fn(cond, torch.Generator().manual_seed(0))
    assert out.shape == (B, 16, 16, 1) and bool(torch.isfinite(out).all())
    ema = trainer.state.ema_state_dict()
    for name, p in trainer.sample_model.named_parameters():
        assert torch.equal(p, ema[name]), name


def test_train_step_draws_from_a_generator_and_counts_no_launch_on_cpu():
    trainer = _trainer()
    batch = {k: torch.from_numpy(v) for k, v in _batch(22).items()}
    before = PF.LAUNCHES
    p0 = [p.detach().clone() for p in trainer.state.params]
    m1 = trainer.train_step(batch, torch.Generator().manual_seed(0))
    m2 = trainer.train_step(batch, torch.Generator().manual_seed(0))
    assert PF.LAUNCHES == before
    assert all(torch.isfinite(v) for v in m1.values())
    # the same draws at a moved state: a different loss
    assert float(m1["loss"]) != float(m2["loss"])
    assert any(not torch.equal(a, p) for a, p in zip(p0, trainer.state.params))
    assert float(m1["grad_norm"]) > 0


def test_attention_function_backward_matches_jax_grad(monkeypatch):
    """The kernel's autograd.Function on the CPU, its launch replaced by the
    plain math, against jax.grad of the JAX flash_attention (the Pallas
    kernel in interpret mode, whose VJP differentiates the XLA math);
    atol 2e-5."""
    from jax.experimental import pallas as pl

    from dsdiff_tpu.ops import flash_attention as JF

    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 512, 2, 48)).astype(np.float32)
               for _ in range(3))
    w = rng.standard_normal((1, 512, 2, 48)).astype(np.float32)
    orig = pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jnp.asarray(w) * JF.flash_attention(q, k, v)),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    launched = []

    def plain_launch(q, k, v):
        launched.append(1)
        return PF.reference_attention(q, k, v)

    monkeypatch.setattr(PF, "_launch", plain_launch)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = PF.flash_attention(*ts)
    assert out.grad_fn is not None and len(launched) == 1
    (torch.from_numpy(w) * out).sum().backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=2e-5)
    # no input needs a gradient: the kernel is launched directly
    with torch.no_grad():
        assert PF.flash_attention(*ts).grad_fn is None
    assert len(launched) == 2


def test_val_metrics_and_ssim_match_jax():
    rng = np.random.default_rng(4)
    target = np.clip(rng.standard_normal((3, 32, 32, 1)) * 0.5, -1, 1).astype(np.float32)
    pred = np.clip(target + rng.standard_normal(target.shape) * 0.1, -1, 1).astype(np.float32)
    pred[1, :16] = 0.8  # a flat region with |mean| near 1
    target[1, :16] = 0.8
    valid = np.array([1.0, 1.0, 0.0], np.float32)
    np.testing.assert_allclose(
        PM.ssim(torch.from_numpy(target[..., 0]), torch.from_numpy(pred[..., 0]),
                data_range=2.0).numpy(),
        np.asarray(JM.ssim(jnp.asarray(target[..., 0]), jnp.asarray(pred[..., 0]),
                           data_range=2.0)),
        rtol=1e-5, atol=1e-6,
    )
    want = JStep.make_val_metrics()(jnp.asarray(pred), jnp.asarray(target),
                                    jnp.asarray(valid))
    got = _trainer().val_metrics(torch.from_numpy(pred), torch.from_numpy(target),
                                 torch.from_numpy(valid))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(got["ssim"]) <= 1.0
