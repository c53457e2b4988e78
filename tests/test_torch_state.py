"""dsdiff_torch.train.state against the JAX package's TrainState (optax
AdamW + the LitEma-style EMA) on identical gradients, f32 on the CPU.

Three updates; after each, the parameters, EMA and both moments agree to
1e-6 relative (plus 1e-9 absolute): the same f32 formulas, with the bias
correction's ``decay**count`` rounded once in each framework. The learning
rate schedule agrees with optax's to 1e-6 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dsdiff_tpu.train import state as JS
from dsdiff_torch.train import state as PS

SHAPES = {"a": (3, 4), "b": (5,)}


class _Leaves(nn.Module):
    def __init__(self, values):
        super().__init__()
        for k in sorted(values):
            self.register_parameter(k, nn.Parameter(torch.from_numpy(values[k])))


def _close(got, want, err_msg):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6,
                               atol=1e-9, err_msg=err_msg)


def _run(jax_lr, port_lr, weight_decay=0.0, grad_clip=None, steps=3, seed=0):
    rng = np.random.default_rng(seed)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    tx = JS.make_optimizer(jax_lr, weight_decay=weight_decay, grad_clip=grad_clip)
    jstate = JS.TrainState.create(None, {k: jnp.asarray(v) for k, v in p0.items()},
                                  tx, ema_decay=0.9999)
    model = _Leaves({k: v.copy() for k, v in p0.items()})
    pstate = PS.TrainState(
        model, lambda params: PS.make_optimizer(
            params, port_lr, weight_decay=weight_decay, grad_clip=grad_clip),
        ema_decay=0.9999,
    )
    for step in range(steps):
        # gradients of mixed scales, some elements near zero
        g = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 2, s))
             .astype(np.float32) for k, s in SHAPES.items()}
        jstate = jstate.apply_gradients({k: jnp.asarray(v) for k, v in g.items()})
        pstate.apply_gradients([torch.from_numpy(g[k]) for k in pstate.names])
        assert pstate.step == int(jstate.step) == step + 1
        adam = jstate.opt_state[-1][0]
        for i, k in enumerate(pstate.names):
            _close(pstate.params[i].detach(), jstate.params[k], f"{k} step {step}")
            _close(pstate.ema[i], jstate.ema_params[k], f"ema {k} step {step}")
            _close(pstate.tx.mu[i], adam.mu[k], f"mu {k} step {step}")
            _close(pstate.tx.nu[i], adam.nu[k], f"nu {k} step {step}")
        assert pstate.tx.count == int(adam.count)
    return p0, pstate


@pytest.mark.parametrize("schedule, weight_decay, grad_clip", [
    (False, 0.0, None),
    (True, 0.0, None),  # warmup: the first update takes lr(0) = 0
    (False, 0.05, 1.0),  # decoupled weight decay and a global-norm clip
])
def test_adamw_and_ema_match_optax(schedule, weight_decay, grad_clip):
    if schedule:
        jax_lr = JS.cosine_lr(1e-3, 10, warmup_steps=2, min_lr=1e-5)
        port_lr = PS.cosine_lr(1e-3, 10, warmup_steps=2, min_lr=1e-5)
    else:
        jax_lr = port_lr = 1e-2 if grad_clip else 1e-3
    _run(jax_lr, port_lr, weight_decay, grad_clip)


def test_ema_after_one_step_is_a_tenth_of_the_start():
    """decay = min(0.9999, (1 + 0) / (10 + 0)) at the first update."""
    p0, pstate = _run(1e-3, 1e-3, steps=1)
    for i, k in enumerate(pstate.names):
        want = 0.1 * p0[k] + 0.9 * pstate.params[i].detach().numpy()
        np.testing.assert_allclose(pstate.ema[i].numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("total, warmup", [(1000, 0), (1000, 100), (7, 3)])
def test_cosine_lr_matches_optax(total, warmup):
    want = JS.cosine_lr(1e-4, total, warmup_steps=warmup, min_lr=1e-7)
    got = PS.cosine_lr(1e-4, total, warmup_steps=warmup, min_lr=1e-7)
    for step in sorted({0, 1, max(warmup - 1, 0), warmup, warmup + 1,
                        total // 2, total - 1, total, total + 5}):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(step))


def test_global_norm_and_refusals():
    g = [torch.tensor([3.0, 0.0]), torch.tensor([[4.0]])]
    assert float(PS.global_norm(g)) == 5.0
    # accumulation is ported (held against optax in test_torch_checkpoints)
    assert PS.make_optimizer([torch.zeros(1)], 1e-4, accum_steps=2).accum_steps == 2
    assert PS.ema_decay_at(0, 0.9999) == pytest.approx(0.1)
    assert PS.ema_decay_at(10**6, 0.9999) == pytest.approx(0.9999)
