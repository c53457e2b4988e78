"""The slice end to end: the port's ``Trainer.sample_fn`` against the JAX
``ddim_sample_loop`` over the JAX ``DSUNet.apply``, both given the same
x_T, condition and (bridged) weights, 3 re-spaced DDIM steps, f32 on the
CPU. The chain is clipped to [-1, 1]; 1e-4 absolute covers the model's
summation-order differences carried through three steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dsdiff_tpu.core import sampling as JS
from dsdiff_tpu.core import schedules as JSch
from dsdiff_tpu.models.dsunet import DSUNet as JDSUNet
from dsdiff_torch.core import sampling as PS
from dsdiff_torch.train.config import load_run_config
from dsdiff_torch.train.trainer import Trainer
from torch_parity_utils import TINY, random_flax_params, tiny_cfg

ATOL = 1e-4

# every config key the port reads (Trainer.__init__ and what it calls)
SLICE_KEYS = (
    "net_mode", "train_keys", "use_edge", "h5_2d_img_dir", "diffusion",
    "diffusion_steps", "noise_schedule", "linear_start", "linear_end",
    "learn_sigma", "disentangle_distance", "loss_type", "parameterization",
    "variance_type", "contrast_lambda", "cond_dropout", "sampler_setting",
    "unet_config", "output_ch", "bf16", "seed", "rescale_timesteps",
    "clip_denoised", "split_input_params", "remat", "lr", "lr_low",
    "num_epochs", "lr_warm_epoch", "beta1", "beta2", "weight_decay",
    "grad_clip", "accum_steps", "ema_rate", "schedule_sampler",
)


def _flax_model(seed=5):
    jm = JDSUNet(in_channels=4, out_channels=2, **TINY)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)),
                     jnp.zeros((1,)))["params"]
    return jm, random_flax_params(params, seed)


def _inputs(seed=11, B=2):
    rng = np.random.default_rng(seed)
    x_T = rng.standard_normal((B, 16, 16, 1)).astype(np.float32)
    cond = rng.standard_normal((B, 16, 16, 3)).astype(np.float32)
    return x_T, cond


def _jax_denoise(jm, params, cond):
    def fn(x, t):
        out, _ = jm.apply({"params": params},
                          jnp.concatenate([x, jnp.asarray(cond)], -1), t)
        return out

    return fn


def test_trainer_sample_fn_matches_jax_ddim_chain():
    jm, params = _flax_model()
    x_T, cond = _inputs()
    betas = JSch.make_beta_schedule("scaled_linear", 1000)
    rsched = JSch.respace(betas, JSch.space_timesteps(1000, "3"))
    want = JS.ddim_sample_loop(
        rsched, _jax_denoise(jm, params, cond), jnp.asarray(x_T),
        jax.random.PRNGKey(0), parameterization="v", learn_sigma=True,
        clip_denoised=True,
    )

    trainer = Trainer(tiny_cfg(3), device="cpu")
    trainer.load_flax_params(params)
    got = trainer.sample_fn(torch.from_numpy(cond),
                            x_T=torch.from_numpy(x_T))
    assert got.shape == (2, 16, 16, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_stochastic_ddim_with_collected_x0_matches_jax():
    """eta > 0: the JAX chain's own normal draws are replayed into the port
    through its ``noise`` list."""
    jm, params = _flax_model(6)
    x_T, cond = _inputs(12)
    betas = JSch.make_beta_schedule("scaled_linear", 1000)
    use = JSch.space_timesteps(1000, "3")
    rng = jax.random.PRNGKey(3)
    want, want_x0s = JS.ddim_sample_loop(
        JSch.respace(betas, use), _jax_denoise(jm, params, cond),
        jnp.asarray(x_T), rng, parameterization="v", learn_sigma=True,
        eta=0.5, collect_x0=True,
    )
    noise = []
    for _ in range(3):  # the draws of the JAX loop body, in order
        rng, key = jax.random.split(rng)
        noise.append(torch.from_numpy(np.array(
            jax.random.normal(key, x_T.shape, jnp.float32))))

    trainer = Trainer(tiny_cfg(3), device="cpu")
    trainer.load_flax_params(params)
    c = torch.from_numpy(cond)

    def denoise(x, t):
        return trainer.model(torch.cat([x, c], -1), t)[0]

    with torch.no_grad():
        got, got_x0s = PS.ddim_sample_loop(
            trainer.rsched, denoise, torch.from_numpy(x_T),
            parameterization="v", learn_sigma=True, eta=0.5,
            collect_x0=True, noise=noise,
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_x0s.numpy(), np.asarray(want_x0s),
                               atol=ATOL)


def test_smoke_config_is_the_flagship_config():
    yaml_cfg = load_run_config("configs/train_config.yaml")
    smoke = chip_smoke.FLAGSHIP_CONFIG
    for key in SLICE_KEYS:
        assert smoke.get(key) == yaml_cfg.get(key), key


def test_trainer_builds_the_flagship_schedule():
    trainer_cfg = dict(chip_smoke.FLAGSHIP_CONFIG, unet_config={"params": TINY})
    trainer = Trainer(trainer_cfg, device="cpu")
    # 'linear' means the OpenAI scaled linear for ds_diff_gaussian
    np.testing.assert_array_equal(
        trainer.betas, JSch.make_beta_schedule("scaled_linear", 1000)
    )
    assert trainer.rsched.num_timesteps == 20
    assert trainer.task.learn_sigma and trainer.task.parameterization == "v"
    assert trainer.task.variance_type == "fixed_large"
    # f32 master parameters computing in bf16; the serving copy holds its
    # Dense/Conv weights in bf16 and its norms in f32
    assert {p.dtype for p in trainer.model.parameters()} == {torch.float32}
    assert trainer.model.time_embed.fc1.compute_dtype == torch.bfloat16
    assert next(trainer.sample_model.parameters()).dtype == torch.bfloat16
    assert trainer.sample_model.encoder_0.down_0_0_res.in_norm.norm.weight.dtype == (
        torch.float32
    )


def test_trainer_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(tiny_cfg())


def test_trainer_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="A12"):
        Trainer(dict(tiny_cfg(), sampler_setting={"sampler": "plms"}),
                device="cpu")
    with pytest.raises(NotImplementedError, match="A14"):
        Trainer(dict(tiny_cfg(), h5_2d_img_dir="/data"), device="cpu")
    with pytest.raises(ValueError, match="not yet ported"):
        Trainer(dict(tiny_cfg(), net_mode="disc_diff"), device="cpu")
