"""The slice as a whole for the other denoisers the run config names: for
each of ``ddpm``, ``disc_diff``, ``dit`` and ``palette``, the JAX package's
``Trainer`` and the port's on the same tiny config (narrow models at 16²,
f32, batch 2), the same seeded weights (every leaf random), and JAX's own
draws replayed into the port:

- one train step (``make_train_step``, or the palette step over the train
  gamma schedule), given JAX's t and noise: every metric JAX reports to
  1e-4 relative (the port adds grad_norm);
- ``sample_fn`` (DDIM from the EMA weights; palette's with eta 1, over the
  test gamma schedule), given JAX's x_T and per-step noise: 1e-4 absolute;
- ``progressive_denoise`` given JAX's x_T (``disc_diff``'s model returns
  ``(out, features)``): every step's x0, 1e-4 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.parallel import mesh as pmesh
from dsdiff_tpu.train import Trainer as JTrainer
from dsdiff_tpu.train import state as JState
from dsdiff_tpu.train.config import Config as JConfig
from dsdiff_torch.train.trainer import Trainer
from torch_parity_utils import one_thread, random_flax_params, tiny_cfg

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL = 1e-4
ATOL = 1e-4
B = 2
STEPS = 3

UNET = dict(model_channels=32, num_res_blocks=1, attention_resolutions=[2],
            channel_mult=[1, 2], num_heads=2, use_scale_shift_norm=True)
# each family's keys over the tiny flagship config, as its config file sets
# them (configs/ddpm.yaml, disc_diff.yaml, palette.yaml; dit reads
# ViT_config)
FAMILIES = {
    "ddpm": dict(parameterization="eps", loss_type="l2", learn_sigma=False,
                 disentangle_distance=None, unet_config={"params": UNET}),
    "disc_diff": dict(parameterization="eps", learn_sigma=True,
                      contrast_lambda=0.1, unet_config={"params": UNET}),
    "dit": dict(ViT_config={"params": dict(input_size=16, patch_size=4,
                                           hidden_size=64, depth=2,
                                           num_heads=2)}),
    "palette": dict(learn_sigma=False, disentangle_distance=None,
                    unet_config={"params": UNET},
                    sampler_setting={"sampler": "ddim",
                                     "sample_steps": STEPS, "ddim_eta": 1.0},
                    palette={"train_schedule": {"n_timestep": 2000,
                                                "linear_start": 1e-6,
                                                "linear_end": 0.01},
                             "test_schedule": {"n_timestep": 30,
                                               "linear_start": 1e-4,
                                               "linear_end": 0.09}}),
}


def _cfg(net_mode):
    cfg = tiny_cfg(STEPS)
    cfg.update(net_mode=net_mode, image_size=16, **FAMILIES[net_mode])
    return cfg


def _batch(seed=31):
    rng = np.random.default_rng(seed)
    return {"target": rng.uniform(-1, 1, (B, 16, 16, 1)).astype(np.float32),
            "image": rng.standard_normal((B, 16, 16, 3)).astype(np.float32)}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", params=list(FAMILIES))
def pair(request, tmp_path_factory):
    net_mode = request.param
    cfg = _cfg(net_mode)
    jt = JTrainer(JConfig.wrap(cfg), tmp_path_factory.mktemp(net_mode),
                  mesh=pmesh.local_mesh())
    params = random_flax_params(jt.state.params["params"], 17)
    jt.state = JState.TrainState.create(jt.model.apply, {"params": params},
                                        jt.state.tx, ema_decay=0.9999)
    pt = Trainer(cfg, device="cpu")
    pt.load_flax_params({"params": params})
    assert pt.n_params == sum(p.size for p in jax.tree.leaves(params))
    yield net_mode, jt, pt, params
    jt.ckpt.close()


def test_train_step_matches_jax_given_its_draws(pair):
    net_mode, jt, pt, params = pair
    batch = _batch()
    rng = jax.random.PRNGKey(4)
    # the step donates its state: step a copy
    _, _, want = jt.train_step(jax.tree.map(jnp.copy, jt.state),
                               jt.sampler_state,
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               rng)
    key = jax.random.fold_in(rng, 0)
    shape = batch["target"].shape
    if net_mode == "palette":
        t_rng, n_rng = jax.random.split(key)
        t = jax.random.randint(t_rng, (B,), 0, pt.gs_train.num_timesteps)
    else:
        t_rng, n_rng, _, _ = jax.random.split(key, 4)
        t = jax.random.randint(t_rng, (B,), 0, 1000)
    noise = jax.random.normal(n_rng, shape, jnp.float32)
    got = pt.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                        t=_t(t).long(), noise=_t(noise))
    pt.load_flax_params({"params": params})  # back to the shared start
    assert set(got) == set(want) | {"grad_norm"}
    if net_mode == "disc_diff":
        assert "loss_disen" in want
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=f"{net_mode} {k}")


def test_sample_fn_matches_jax_given_its_draws(pair):
    net_mode, jt, pt, _ = pair
    cond = _batch(32)["image"]
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jt.sample_fn(jt.state.ema_params, jnp.asarray(cond),
                                   rng))
    if net_mode == "palette":
        # the palette DDIM loop: one split for y_T, then one a step
        rng, init = jax.random.split(rng)
        x_T = jax.random.normal(init, (B, 16, 16, 1), jnp.float32)
        noise = []
        for _ in range(STEPS):
            rng, k = jax.random.split(rng)
            noise.append(_t(jax.random.normal(k, (B, 16, 16, 1), jnp.float32)))
    else:
        x_rng, _ = jax.random.split(rng)
        x_T = jax.random.normal(x_rng, (B, 16, 16, 1), jnp.float32)
        noise = None
    got = pt.sample_fn(torch.from_numpy(cond), x_T=_t(x_T), noise=noise)
    assert got.shape == want.shape == (B, 16, 16, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, err_msg=net_mode)


def test_progressive_denoise_and_features(pair):
    """The x0 of every DDIM step against JAX's (disc_diff's model returns
    ``(out, features)``, and ``_val_features`` gives its feature dict);
    palette: no progressive row, as in JAX's image dump, and
    ``set_sampler`` is refused."""
    net_mode, jt, pt, _ = pair
    batch = _batch(33)
    if net_mode == "palette":
        assert pt._row_fn is None
        with pytest.raises(RuntimeError, match="unavailable"):
            pt.progressive_denoise(torch.from_numpy(batch["image"]))
        with pytest.raises(ValueError, match="own sampler"):
            pt.set_sampler("ddim", sample_steps=5)
        return
    rng = jax.random.PRNGKey(6)
    _, want = jt.progressive_denoise(jnp.asarray(batch["image"]), rng)
    x_T = jax.random.normal(jax.random.split(rng)[0], (B, 16, 16, 1))
    final, got = pt.progressive_denoise(torch.from_numpy(batch["image"]),
                                        x_T=_t(x_T))
    assert got.shape == np.asarray(want).shape == (STEPS, B, 16, 16, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               err_msg=net_mode)
    assert torch.equal(final, got[-1])
    feats = pt._val_features(batch)
    if net_mode == "disc_diff":
        assert set(feats) == {"common", "distinct"}
        assert feats["common"].shape == (4, B, 8, 8, 32)
    else:
        assert feats is None
