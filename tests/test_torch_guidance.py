"""Classifier guidance and the conditioning encoders of the port against the
JAX package's, f32 on the CPU, numpy inputs from a seed, every Flax leaf
random and carried across by ``utils.flax_bridge``:

- ``EncoderUNet`` with each pool (``adaptive``, ``attention``,
  ``spatial``): logits to 1e-4 of max(1, max |logits|);
- ``classifier_gradient``, also under ``torch.inference_mode``: 1e-4 of
  the gradient's largest magnitude;
- guided DDIM (clipped, the score rescored by the classifier's gradient)
  and guided ancestral DDPM chains over an analytic denoiser, given JAX's
  x_T and noise, the classifier's gradient replayed from JAX at every step
  (so the chain compares the samplers' guidance arithmetic): 1e-5; and the
  same chains with the port's own classifier gradient, whose forward and
  backward sum in another order than XLA's: 1e-4;
- ``ClassEmbedder`` (label dropout by a given mask), the embedding noise
  augmentation and ``unclip_adm_cond`` given JAX's draws: 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.core import sampling as JS
from dsdiff_tpu.core import schedules as JSch
from dsdiff_tpu.models import encoders as JE
from dsdiff_tpu.models.encoder_unet import EncoderUNet as JEncoderUNet
from dsdiff_tpu.models.encoder_unet import \
    classifier_gradient as j_classifier_gradient
from dsdiff_torch.core import sampling as PS
from dsdiff_torch.core import schedules as PSch
from dsdiff_torch.models import encoders as PE
from dsdiff_torch.models.encoder_unet import EncoderUNet, classifier_gradient
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict
from torch_parity_utils import one_thread, random_flax_params

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL = 1e-4
CHAIN_ATOL = 1e-5
STEPS = 4
KW = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2,),
          channel_mult=(1, 2), num_heads=2)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _classifier(pool, seed=3):
    """The JAX and port classifiers with one random weight tree."""
    x, t = _x(0, 2, 16, 16, 1), np.array([3.0, 500.0], np.float32)
    jm = JEncoderUNet(in_channels=1, num_classes=3, pool=pool, **KW)
    params = random_flax_params(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))[
            "params"], seed)
    pm = EncoderUNet(in_channels=1, num_classes=3, pool=pool, image_size=16,
                     **KW)
    pm.load_state_dict(flax_to_state_dict(params, pm))
    return jm, params, pm.eval()


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.detach().numpy()
    tol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("pool", ["adaptive", "attention", "spatial"])
def test_encoder_unet_pools_match_jax(pool):
    jm, params, pm = _classifier(pool)
    x, t = _x(1, 2, 16, 16, 1), np.array([3.0, 742.0], np.float32)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == (2, 3)
    _close(got, want)


@pytest.mark.parametrize("pool", ["adaptive", "attention"])
def test_classifier_gradient_matches_jax_also_under_inference_mode(pool):
    """grad_x log p(y|x) * scale; a serving request runs under
    ``torch.inference_mode``, and the gradient is still built there."""
    jm, params, pm = _classifier(pool)
    x, t = _x(2, 2, 16, 16, 1), np.array([40.0, 900.0], np.float32)
    y = np.array([2, 0])
    want = j_classifier_gradient(jm.apply, {"params": params},
                                 jnp.asarray(x), jnp.asarray(t),
                                 jnp.asarray(y), scale=3.0)
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y))
    with torch.inference_mode():
        got = classifier_gradient(pm, *args, scale=3.0)
    assert float(np.abs(np.asarray(want)).max()) > 0
    _close(got, want, RTOL * float(np.abs(np.asarray(want)).max()))
    assert torch.equal(got, classifier_gradient(pm, *args, scale=3.0))


def _scheds():
    betas = JSch.make_beta_schedule("scaled_linear", 1000)
    use = JSch.space_timesteps(1000, str(STEPS))
    return JSch.respace(betas, use), PSch.respace(betas, use, device="cpu")


def _denoiser(lib):
    """A smooth eps denoiser, elementwise in x and t."""

    def fn(x, t_model):
        return 0.3 * x + 0.1 * lib.sin(t_model.reshape(-1, 1, 1, 1) / 100.0)

    return fn


def _ancestral_noise(rng, shape):
    noise = []
    for _ in range(STEPS):
        rng, key = jax.random.split(rng)
        noise.append(torch.from_numpy(np.array(
            jax.random.normal(key, shape, jnp.float32))))
    return noise


def _chains(sampler, jguide, pguide):
    """(JAX chain, port chain) of ``sampler`` guided by the two; the JAX
    chain runs eagerly (``jax.disable_jit``), so its guidance sees
    concrete arrays at every step."""
    jsched, psched = _scheds()
    x_T = _x(4, 2, 16, 16, 1)
    rng = jax.random.PRNGKey(9)
    with jax.disable_jit():
        if sampler == "ddim":
            want = JS.ddim_sample_loop(jsched, _denoiser(jnp),
                                       jnp.asarray(x_T), rng,
                                       parameterization="eps",
                                       guidance_fn=jguide)
        else:
            want = JS.p_sample_loop(jsched, _denoiser(jnp), jnp.asarray(x_T),
                                    rng, parameterization="eps",
                                    guidance_fn=jguide)
    if sampler == "ddim":
        got = PS.ddim_sample_loop(psched, _denoiser(torch),
                                  torch.from_numpy(x_T),
                                  parameterization="eps", guidance_fn=pguide)
    else:
        got = PS.p_sample_loop(psched, _denoiser(torch),
                               torch.from_numpy(x_T), parameterization="eps",
                               guidance_fn=pguide,
                               noise=_ancestral_noise(rng, x_T.shape))
    return np.asarray(want), got


@pytest.mark.parametrize("sampler", ["ddim", "ddpm"])
def test_guided_chains_match_jax_given_its_noise_and_gradients(sampler):
    """The classifier's gradient as JAX computes it at each step, replayed
    into the port's loop in order: the samplers' guidance arithmetic (DDIM:
    eps rescored, x0 re-derived and clipped; DDPM: mean += var * grad)."""
    jm, params, _ = _classifier("attention")
    y = jnp.array([1, 2])
    grads = []

    def jguide(x, t):
        g = j_classifier_gradient(jm.apply, {"params": params}, x, t, y,
                                  scale=20.0)
        grads.append(torch.from_numpy(np.array(g)))
        return g

    replay = iter(grads)
    want, got = _chains(sampler, jguide, lambda x, t: next(replay))
    assert len(grads) == STEPS
    np.testing.assert_allclose(got.numpy(), want, atol=CHAIN_ATOL)
    unguided, _ = _chains(sampler, None, None)
    assert np.abs(want - unguided).max() > 1e-3  # the guidance moved it


@pytest.mark.parametrize("sampler", ["ddim", "ddpm"])
def test_guided_chains_with_the_ports_classifier(sampler):
    jm, params, pm = _classifier("attention")
    y = np.array([1, 2])
    want, got = _chains(
        sampler,
        lambda x, t: j_classifier_gradient(jm.apply, {"params": params}, x,
                                           t, jnp.asarray(y), scale=20.0),
        lambda x, t: classifier_gradient(pm, x, t, torch.from_numpy(y),
                                         scale=20.0))
    np.testing.assert_allclose(got.numpy(), want, atol=RTOL)


def test_class_embedder_drops_to_the_null_class_by_mask():
    rng = jax.random.PRNGKey(1)
    y = np.array([0, 3, 1, 2, 2, 0, 1, 3])
    jm = JE.ClassEmbedder(n_classes=5, embed_dim=8, ucg_rate=0.5)
    params = random_flax_params(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(y))["params"], 2)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(y),
                               deterministic=False, rngs={"dropout": rng}))
    # the rows Flax dropped hold the null class's embedding
    null = params["embedding"]["embedding"][4]
    drop = np.array([np.array_equal(w, null) for w in want])
    assert 0 < drop.sum() < len(y)
    pm = PE.ClassEmbedder(5, 8, ucg_rate=0.5)
    pm.load_state_dict(flax_to_state_dict(params, pm))
    with torch.no_grad():
        got = pm(torch.from_numpy(y), deterministic=False,
                 drop=torch.from_numpy(drop))
        kept = pm(torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, atol=CHAIN_ATOL)
    want_kept = jm.apply({"params": params}, jnp.asarray(y))
    np.testing.assert_allclose(kept.numpy(), np.asarray(want_kept),
                               atol=CHAIN_ATOL)
    with pytest.raises(ValueError, match="mask or a generator"):
        pm(torch.from_numpy(y), deterministic=False)


@pytest.mark.parametrize("level_emb_dim, dropout", [(0, 0.0), (6, 0.5)])
def test_noise_augmentation_and_unclip_adm_cond_given_jax_draws(
        level_emb_dim, dropout):
    betas = JSch.make_beta_schedule("linear", 1000)
    jsched = JSch.DiffusionSchedule.create(betas)
    psched = PSch.DiffusionSchedule.create(betas, device="cpu")
    emb = _x(6, 4, 10)
    rng = jax.random.PRNGKey(3)
    jaug = JE.EmbeddingNoiseAugmentation(jsched, max_noise_level=400,
                                         mean=0.2, std=1.5)
    paug = PE.EmbeddingNoiseAugmentation(psched, max_noise_level=400,
                                         mean=0.2, std=1.5)
    want = JE.unclip_adm_cond(jnp.asarray(emb), rng, jaug,
                              level_emb_dim=level_emb_dim,
                              embedding_dropout=dropout,
                              deterministic=dropout == 0.0)
    a_rng, d_rng = jax.random.split(rng)
    t_rng, n_rng = jax.random.split(a_rng)
    level = np.array(jax.random.randint(t_rng, (4,), 0, 400))
    noise = np.array(jax.random.normal(n_rng, emb.shape, jnp.float32))
    keep = np.array(jax.random.uniform(d_rng, (4, 1)) >= dropout)[:, 0]
    got = PE.unclip_adm_cond(
        torch.from_numpy(emb), paug, level_emb_dim=level_emb_dim,
        embedding_dropout=dropout, deterministic=dropout == 0.0,
        noise=torch.from_numpy(noise), noise_level=torch.from_numpy(level),
        keep=torch.from_numpy(keep))
    assert got.shape == (4, 10 + level_emb_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CHAIN_ATOL)
    noisy, lvl = paug(torch.from_numpy(emb),
                      generator=torch.Generator().manual_seed(0))
    assert noisy.shape == emb.shape and int(lvl.max()) < 400
