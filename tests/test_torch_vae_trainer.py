"""The KL-VAE GAN steps against the JAX package's ``make_vae_steps``, on
the CPU in f32: the same tiny VAE and discriminator (every Flax weight
random and carried across), the perceptual proxy with the JAX pyramid's
weights, AdamW (betas 0.5, 0.9) on the cosine schedule, and JAX's posterior
draws replayed. Two rounds of ``ae_step`` then ``disc_step``, with
``disc_start`` 0 (both GAN terms on from the start), 1 (the generator term
joins at the second AE step) and 2 (the disc loss joins at the second disc
step), and ``decoder_only`` on and off. Every metric (``d_weight`` and
``logvar`` among them) within 1e-4 relative (or 1e-5 absolute, for the
means of logits near zero), and after each round, for
every VAE and discriminator parameter, its AdamW moments and the parameter
itself within 1e-4 of the tensor's largest magnitude (see ``_close_state``
for the elements whose gradient is rounding noise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.eval.perceptual import PerceptualLoss as JPerceptual
from dsdiff_tpu.models import AutoencoderKL as JVae
from dsdiff_tpu.models import PatchDiscriminator as JDisc
from dsdiff_tpu.train import state as JState
from dsdiff_tpu.train import vae_trainer as JT
from dsdiff_torch.eval.perceptual import PerceptualLoss
from dsdiff_torch.models import AutoencoderKL, PatchDiscriminator
from dsdiff_torch.train import vae_trainer as PT
from dsdiff_torch.train.state import TrainState, cosine_lr, make_optimizer
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict
from torch_parity_utils import one_thread, random_flax_params

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL = 1e-4
# ch 64: GroupNorm32's 32 groups hold two channels each. At 32 channels or
# fewer a group is one channel, and a conv bias right before a GroupNorm
# then has a gradient of exactly zero in exact arithmetic: both packages
# return rounding noise (~1e-9) there, which AdamW's first update,
# g / (|g| + 1e-8), turns into steps of either sign.
VAE = dict(ch=64, ch_mult=(1, 2), num_res_blocks=1, z_channels=4,
           embed_dim=4)
DISC = dict(base_channels=8, n_layers=2)
B, HW = 2, 16
# a step of lr moves a parameter by ~5x the parameter tolerance (1e-4 of a
# tensor of scale ~0.2). Above NOISY, AdamW turns the gradients' rounding
# (~5e-5 of a tensor's largest) into at most ~5e-2 of a step, well inside
# that tolerance; at or below it, into up to a whole step (``_close_state``)
LR, TOTAL = 1e-4, 10
NOISY = 1e-3
# the share of parameter elements held to 2 lr a round: 0.51-0.84 % of the
# 2.6 M in these cases, conv kernels' smallest gradients most of them
MAX_NOISY_SHARE = 1e-2
# g_loss and the logit means are means of logits of both signs: near zero
# they carry the logits' rounding (~1e-6 of their ~0.1 scale) as a large
# relative error, so metrics also pass within this absolute floor
METRIC_ATOL = 1e-5


def _adam_moments(opt_state):
    """optax's ScaleByAdamState (mu, nu) inside a chain's state."""
    for node in jax.tree.leaves(
            opt_state, is_leaf=lambda n: hasattr(n, "mu") and hasattr(n, "nu")):
        if hasattr(node, "mu"):
            return node.mu, node.nu
    raise AssertionError("no Adam state")


def _close_state(state, jstate, before, what, rounds, noisy):
    """AdamW's moments (functions of the gradients alone) within RTOL of
    each tensor's largest (2 RTOL for nu, which is quadratic in them),
    floored at 1e-3 of the model's largest (a tensor whose gradient is zero
    in exact arithmetic, as the attention's k bias under the softmax, holds
    rounding noise in both packages), and the parameters within RTOL of each
    tensor's largest, their update since ``before`` (the torch and JAX
    parameters before the round) of the same sign as JAX's.

    AdamW moves a parameter by lr * mu / sqrt(nu), so the gradients'
    absolute rounding (~5e-5 of a tensor's largest) moves an element whose
    gradient RMS, sqrt(nu), is within a few times that rounding by up to lr
    in either package, in any direction. Those elements, sqrt(nu) at most
    NOISY of the tensor's largest (floored as above; kept over the rounds,
    since an element that took such a step stays that far apart), are held
    to 2 lr a round instead, with no sign; returns how many elements were
    held so, and how many there were."""
    mu, nu = (flax_to_state_dict(jax.device_get(t)["params"], state.model)
              for t in _adam_moments(jstate.opt_state))
    want = flax_to_state_dict(jax.device_get(jstate.params)["params"],
                              state.model)
    floor = {id(ref): 1e-3 * max(float(t.abs().max()) for t in ref.values())
             for ref in (mu, nu)}
    n_noisy = n_all = 0
    for i, name in enumerate(state.names):
        scale = {}
        for got, ref, kind, rtol in ((state.tx.mu[i], mu, "mu", RTOL),
                                     (state.tx.nu[i], nu, "nu", 2 * RTOL)):
            r = ref[name].numpy()
            scale[kind] = max(float(np.abs(r).max()), floor[id(ref)])
            np.testing.assert_allclose(got.numpy(), r, rtol=0,
                                       atol=rtol * scale[kind],
                                       err_msg=f"{what} {kind} {name}")
        w, n = want[name].numpy(), nu[name].numpy()
        # gradients zeroed in both (decoder_only's encoder) are exact
        zero = (n == 0) & (state.tx.nu[i].numpy() == 0)
        small = ~zero & (n <= NOISY ** 2 * scale["nu"])
        noisy[name] = noisy[name] | small if name in noisy else small
        tol = np.where(noisy[name], 2 * LR * rounds, RTOL * np.abs(w).max())
        got = state.params[i].detach().numpy()
        err = np.abs(got - w)
        assert (err <= tol).all(), (what, name, float(err.max()))
        # beta1 0.5 lets mu pass through zero, so a step can be tiny for
        # any gradient: the sign is held where JAX moved a quarter step
        t0, j0 = before[0][i].numpy(), before[1][name].numpy()
        same = np.sign(got - t0) == np.sign(w - j0)
        held = ~noisy[name] & (np.abs(w - j0) > LR / 4)
        assert (same | ~held).all(), (what, "update sign", name)
        n_noisy += int(noisy[name].sum())
        n_all += noisy[name].size
    return n_noisy, n_all


def _snapshot(state, jstate):
    """The torch and the JAX parameters as they stand, for ``_close_state``."""
    return ([p.detach().clone() for p in state.params],
            flax_to_state_dict(jax.device_get(jstate.params)["params"],
                               state.model))


@pytest.mark.parametrize("disc_start, decoder_only",
                         [(0, False), (1, True), (2, False)])
def test_two_gan_rounds_match_jax(disc_start, decoder_only):
    x0 = jnp.zeros((1, HW, HW, 1))
    jvae, jdisc = JVae(**VAE), JDisc(**DISC)
    rng = jax.random.PRNGKey(0)
    vtree = random_flax_params(jvae.init(rng, x0, rng)["params"], 31)
    dtree = random_flax_params(jdisc.init(rng, x0)["params"], 32)
    jperc = JPerceptual(seed=0)
    jtx = lambda: JState.make_optimizer(  # noqa: E731
        JState.cosine_lr(LR, TOTAL), betas=(0.5, 0.9))
    jvs = JState.TrainState.create(jvae.apply, {"params": vtree}, jtx())
    jds = JState.TrainState.create(jdisc.apply, {"params": dtree}, jtx())
    cfg = JT.VaeGanConfig(disc_start=disc_start, decoder_only=decoder_only)
    j_ae, j_disc = JT.make_vae_steps(jvae.apply, jdisc.apply, cfg,
                                     jperc.distance_fn())

    vae, disc = AutoencoderKL(**VAE), PatchDiscriminator(**DISC)
    vae.load_state_dict(flax_to_state_dict(vtree, vae))
    disc.load_state_dict(flax_to_state_dict(dtree, disc))
    perc = PerceptualLoss(seed=0, device="cpu")
    perc.net.load_state_dict(flax_to_state_dict(jperc.params, perc.net))
    lr = cosine_lr(LR, TOTAL)
    vs = TrainState(vae, lambda p: make_optimizer(p, lr, betas=(0.5, 0.9)))
    ds = TrainState(disc, lambda p: make_optimizer(p, lr, betas=(0.5, 0.9)))
    ae, d_step = PT.make_vae_steps(vae, disc, PT.VaeGanConfig(
        disc_start=disc_start, decoder_only=decoder_only), perc.distance_fn())

    jlogvar, logvar = jnp.zeros(()), torch.zeros(())
    noisy = {}
    data = np.random.default_rng(33)
    enc_before = {n: p.detach().clone() for n, p in vae.named_parameters()
                  if n.startswith("encoder.")}
    for r in range(2):
        x = data.uniform(-1, 1, (B, HW, HW, 1)).astype(np.float32)
        batch = {"image": torch.from_numpy(x)}
        r1, r2 = jax.random.split(jax.random.PRNGKey(40 + r))
        noise = [torch.from_numpy(np.array(jax.random.normal(
            k, (B, HW // 2, HW // 2, 4), jnp.float32))) for k in (r1, r2)]
        vae_before = _snapshot(vs, jvs)
        disc_before = _snapshot(ds, jds)
        jvs, jlogvar, jm = j_ae(jvs, jlogvar, jds.params,
                                {"image": jnp.asarray(x)}, r1)
        jds, jdm = j_disc(jds, jvs.params, {"image": jnp.asarray(x)}, r2)
        logvar, m = ae(vs, logvar, batch, noise[0])
        dm = d_step(ds, batch, noise[1])
        for k, want in {**jm, **jdm}.items():
            got = {**m, **dm}[k]
            np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                       atol=METRIC_ATOL,
                                       err_msg=f"round {r} {k}")
        assert set(m) | set(dm) == set(jm) | set(jdm)
        np.testing.assert_allclose(float(logvar), float(jlogvar), rtol=RTOL,
                                   atol=1e-9)
        # the gates: the generator term from AE step disc_start on, the
        # disc loss from disc step disc_start - 1 on
        v = {k: float(t) for k, t in m.items()}
        g_term = v["d_weight"] * v["g_loss"] if r >= disc_start else 0.0
        np.testing.assert_allclose(
            v["ae_loss"], v["nll"] + 1e-6 * v["kl"] + g_term, rtol=1e-5)
        assert v["d_weight"] > 0
        assert (float(dm["disc_loss"]) != 0) == (r + 1 >= disc_start)
        counts = [_close_state(vs, jvs, vae_before, f"round {r} vae", r + 1,
                               noisy),
                  _close_state(ds, jds, disc_before, f"round {r} disc", r + 1,
                               noisy)]
        n_noisy, n_all = map(sum, zip(*counts))
        assert n_noisy <= MAX_NOISY_SHARE * n_all, (r, n_noisy, n_all)
    assert vs.step == ds.step == 2
    moved = [not torch.equal(p, dict(vae.named_parameters())[n])
             for n, p in enc_before.items()]
    assert not any(moved) if decoder_only else all(moved)
