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
from dsdiff_torch.parallel.mesh import Mesh
from dsdiff_torch.train.config import load_run_config
from dsdiff_torch.train.trainer import Trainer
from torch_parity_utils import (TINY, one_thread, random_flax_params,
                                tiny_cfg)

pytestmark = pytest.mark.usefixtures("one_thread")

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


def test_trainer_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(ValueError, match="unknown sampler 'heun'"):
        Trainer(dict(tiny_cfg(), sampler_setting={"sampler": "heun"}),
                device="cpu")
    # split-input sampling is ported (test_torch_patching.py): tiles that
    # leave pixels uncovered are refused at the first request
    patched = Trainer(dict(tiny_cfg(), image_size=16,
                           split_input_params={"ks": (8, 8),
                                               "stride": (5, 5)}),
                      device="cpu")
    with pytest.raises(ValueError, match="do not tile the H extent"):
        patched.sample_fn(torch.zeros(1, 16, 16, 3),
                          generator=torch.Generator().manual_seed(0))
    # int8 serving, the device data cache and palette training under a
    # mesh of more than one rank are ported (test_torch_mesh_eval.py): a
    # palette trainer builds on a two-rank mesh
    palette = Trainer(dict(tiny_cfg(), net_mode="palette"), device="cpu",
                      mesh=Mesh(2, 1, distributed=True))
    assert palette.palette and palette.ranks == 2
    # net_mode latent is ported, and an SD VAE file as its first stage
    # (test_torch_sd_vae_file.py); a file in no checkpoint format is refused
    sd_vae = tmp_path / "sd_vae.safetensors"
    sd_vae.write_bytes(b"")
    with pytest.raises(ValueError, match="unrecognized checkpoint format"):
        Trainer(dict(tiny_cfg(), net_mode="latent", vae_checkpoint=str(sd_vae),
                     first_stage={"params": {"ch": 8, "ch_mult": [1, 2]}}),
                device="cpu")
    # the MedSegDiff models are ported, but neither Trainer can build them:
    # both pass ``remat``, which the MedSegDiff factory does not take
    from dsdiff_tpu.train.config import Config as JConfig
    from dsdiff_tpu.train.trainer import Trainer as JTrainer

    medseg = dict(tiny_cfg(), net_mode="medseg_v1", unet_config={"params": {
        "model_channels": 8, "channel_mult": [1, 2], "num_heads": 2}})
    with pytest.raises(TypeError, match="'remat'"):
        Trainer(medseg, device="cpu")
    with pytest.raises(TypeError, match="'remat'"):
        JTrainer(JConfig.wrap(medseg), tmp_path / "jax")


# ------------------------------------------------ every way the model serves
def _jax_x_T_and_noise(rng, shape, steps):
    """What the JAX sample functions draw from ``rng``: x_T, then the
    per-step noise of the loop (ancestral; DDIM with eta > 0 splits the
    same way)."""
    x_rng, loop_rng = jax.random.split(rng)
    x_T = np.array(jax.random.normal(x_rng, shape, jnp.float32))
    noise = []
    for _ in range(steps):
        loop_rng, key = jax.random.split(loop_rng)
        noise.append(torch.from_numpy(np.array(
            jax.random.normal(key, shape, jnp.float32))))
    return torch.from_numpy(x_T), noise


# sampler -> absolute tolerance on a chain clipped to [-1, 1] (the DPM-Solver
# family does not clip; its outputs stay of order 1 here). The model's
# summation-order differences (~1e-6 per call) are carried through the chain;
# the multistep and singlestep formulas weigh them by a few units.
SAMPLER_ATOL = {
    "ddim": 1e-4, "ancestral": 1e-4, "ddpm": 1e-4, "dpm++": 1e-4,
    "dpm_solver++": 1e-4, "plms": 3e-4, "dpm": 3e-4, "dpm_solver": 3e-4,
    "dpm_singlestep": 3e-4,
}


@pytest.fixture(scope="module")
def flax_model():
    return _flax_model(7)


@pytest.mark.parametrize("sampler", sorted(SAMPLER_ATOL))
def test_make_sample_fn_matches_jax_for_each_sampler(flax_model, sampler):
    from dsdiff_tpu.train import step as JStep

    jm, params = flax_model
    _, cond = _inputs(13)
    steps = 4
    trainer = Trainer(dict(tiny_cfg(steps), sampler_setting={
        "sampler": sampler, "sample_steps": steps}), device="cpu")
    trainer.load_flax_params(params)
    betas = JSch.make_beta_schedule("scaled_linear", 1000)
    jfn = JStep.make_sample_fn(
        jm.apply, JSch.respace(betas, JSch.space_timesteps(1000, str(steps))),
        JStep.TaskConfig(parameterization="v", learn_sigma=True,
                         variance_type="fixed_large"),
        sampler=sampler, out_channels=1,
        full_sched=JSch.DiffusionSchedule.create(betas), sample_steps=steps,
    )
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jfn({"params": params}, jnp.asarray(cond), rng))
    x_T, noise = _jax_x_T_and_noise(rng, (2, 16, 16, 1), steps)
    got = trainer.sample_fn(torch.from_numpy(cond), x_T=x_T, noise=noise)
    assert got.shape == (2, 16, 16, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=SAMPLER_ATOL[sampler])


class _Analytic(torch.nn.Module):
    """x0-prediction smooth in x and t (no parameters): the adaptive
    solver's accept/reject decisions then do not hang on a network's
    rounding."""

    def forward(self, x, t):
        t = (t.reshape(-1, 1, 1, 1) + 1.0) / 1000.0
        return 0.5 * torch.sin(3.0 * t) + 0.2 * torch.tanh(x[..., :1])


def test_make_sample_fn_dpm_adaptive_matches_jax():
    from dsdiff_tpu.train import step as JStep
    from dsdiff_torch.core import schedules as PSch
    from dsdiff_torch.train import step as PStep

    def japply(params, x, t):
        t = (t.reshape(-1, 1, 1, 1) + 1.0) / 1000.0
        return 0.5 * jnp.sin(3.0 * t) + 0.2 * jnp.tanh(x[..., :1])

    betas = JSch.make_beta_schedule("scaled_linear", 1000)
    _, cond = _inputs(14)
    rng = jax.random.PRNGKey(6)
    jfn = JStep.make_sample_fn(
        japply, JSch.DiffusionSchedule.create(betas),
        JStep.TaskConfig(parameterization="x0"), sampler="dpm_adaptive",
        sample_steps=20,
    )
    # eagerly: XLA's fused arithmetic moves the controller's step sizes by
    # ulps, which the adaptive grid carries to ~4e-5 in the result
    with jax.disable_jit():
        want = jfn({}, jnp.asarray(cond), rng)
    x_T, _ = _jax_x_T_and_noise(rng, (2, 16, 16, 1), 0)
    got = PStep.make_sample_fn(
        _Analytic(), PSch.DiffusionSchedule.create(betas, device="cpu"),
        PStep.TaskConfig(parameterization="x0"), sampler="dpm_adaptive",
        sample_steps=20,
    )(torch.from_numpy(cond), x_T=x_T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def _split_cfg(steps=3, **more):
    cfg = tiny_cfg(steps)
    cfg.update(net_mode="ds_diff_split", **more)
    return cfg


def _flax_split(seed=9, **kw):
    from dsdiff_tpu.models.dsunet_cached import DSUNetSplit as JSplit

    jm = JSplit(in_channels=4, out_channels=2, dtype=jnp.float32, **kw, **TINY)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)),
                     jnp.zeros((1,)))["params"]
    return jm, random_flax_params(params, seed)


@pytest.mark.parametrize("sampler", ["ddim", "dpm++", "plms", "ancestral"])
def test_cached_trainer_path_matches_jax(sampler):
    """``net_mode: ds_diff_split`` serves through the cached-condition
    sampler by default; held against the JAX trainer's
    ``_make_cached_sample_fn`` (given a stand-in for the trainer that holds
    the attributes it reads)."""
    import types

    from dsdiff_tpu.train import step as JStep
    from dsdiff_tpu.train.trainer import Trainer as JTrainer

    jm, params = _flax_split()
    steps = 3
    trainer = Trainer(_split_cfg(steps, sampler_setting={
        "sampler": sampler, "sample_steps": steps}), device="cpu")
    assert trainer.model_name == "dsunet_split"
    trainer.load_flax_params(params)
    betas = JSch.make_beta_schedule("scaled_linear", 1000)
    stand_in = types.SimpleNamespace(
        model=jm, sampler_name=sampler, eta=0.0, cfg={"clip_denoised": True},
        base_out=1, task=JStep.TaskConfig(
            parameterization="v", learn_sigma=True,
            variance_type="fixed_large"))
    jfn = JTrainer._make_cached_sample_fn(
        stand_in, JSch.respace(betas, JSch.space_timesteps(1000, str(steps))))
    _, cond = _inputs(15)
    rng = jax.random.PRNGKey(8)
    want = np.asarray(jfn({"params": params}, jnp.asarray(cond), rng))
    x_T, noise = _jax_x_T_and_noise(rng, (2, 16, 16, 1), steps)
    got = trainer.sample_fn(torch.from_numpy(cond), x_T=x_T, noise=noise)
    np.testing.assert_allclose(got.numpy(), want, atol=SAMPLER_ATOL[sampler])
    # uncached, the same weights give another sample: the condition
    # encoders then see every step's own embedding
    trainer.set_sampler(cached=False)
    full = trainer.sample_fn(torch.from_numpy(cond), x_T=x_T, noise=noise)
    assert (full - got).abs().max() > 1e-3


def test_cached_sampling_is_exact_with_cond_t_ref_and_can_be_turned_off():
    params = {"params": dict(TINY, cond_t_ref=500.0)}
    trainer = Trainer(_split_cfg(unet_config=params), device="cpu")
    assert trainer.model.cond_t_ref == 500.0
    _, cond = _inputs(16)
    cond = torch.from_numpy(cond)
    x_T = torch.from_numpy(_inputs(17)[0])
    from dsdiff_torch.utils.flax_bridge import random_params
    random_params(trainer.model, 3)
    trainer.reset_state()
    cached = trainer.sample_fn(cond, x_T=x_T)
    trainer.set_sampler(cached=False)
    full = trainer.sample_fn(cond, x_T=x_T)
    np.testing.assert_allclose(cached.numpy(), full.numpy(), atol=1e-5)
    off = Trainer(_split_cfg(cached_cond_sampling=False), device="cpu")
    assert off._row_fn is None
    with pytest.raises(RuntimeError, match="unavailable"):
        off.progressive_denoise(cond)


def test_cached_path_serves_ddim_for_a_sampler_it_has_no_loop_for():
    """As the JAX trainer's cached closure: 'dpm++', 'plms' and 'ancestral'
    have loops of their own there, any other name is served by DDIM."""
    from dsdiff_torch.utils.flax_bridge import random_params
    trainer = Trainer(_split_cfg(3), device="cpu")
    random_params(trainer.model, 4)
    trainer.reset_state()
    x_T, cond = (torch.from_numpy(a) for a in _inputs(19))
    ddim = trainer.sample_fn(cond, x_T=x_T)
    trainer.set_sampler("dpm")
    assert torch.equal(trainer.sample_fn(cond, x_T=x_T), ddim)
    trainer.set_sampler("plms")
    assert not torch.equal(trainer.sample_fn(cond, x_T=x_T), ddim)


def test_set_sampler_switches_on_a_live_trainer(flax_model):
    _, params = flax_model
    trainer = Trainer(tiny_cfg(3), device="cpu")
    trainer.load_flax_params(params)
    x_T, cond = (torch.from_numpy(a) for a in _inputs(18))
    first = trainer.sample_fn(cond, x_T=x_T)
    c = cond

    def denoise(x, t):
        return trainer.sample_model(torch.cat([x, c], -1), t)[0]

    kw = dict(parameterization="v", learn_sigma=True)
    # sampler and steps
    trainer.set_sampler("plms", sample_steps=4)
    assert trainer.rsched.num_timesteps == 4 and trainer.sampler_name == "plms"
    with torch.no_grad():
        want = PS.plms_sample_loop(trainer.rsched, denoise, x_T, **kw)
    assert torch.equal(trainer.sample_fn(cond, x_T=x_T), want)
    # the DPM-Solver family with options on top of the config's
    trainer.set_sampler("dpm", sample_steps=5, order=3, skip_type="time_uniform")
    from dsdiff_torch.core import dpm_solver as PDS
    with torch.no_grad():
        want = PDS.dpm_solver_sample_loop(
            trainer.sched, denoise, x_T, steps=5, order=3,
            skip_type="time_uniform", **kw)
    assert torch.equal(trainer.sample_fn(cond, x_T=x_T), want)
    # eta: stochastic DDIM from the generator, repeatable
    trainer.set_sampler("ddim", sample_steps=3, ddim_eta=0.7)
    a = trainer.sample_fn(cond, torch.Generator().manual_seed(1), x_T=x_T)
    b = trainer.sample_fn(cond, torch.Generator().manual_seed(1), x_T=x_T)
    assert torch.equal(a, b) and not torch.equal(a, first)
    # and back: the first request again, bit for bit
    trainer.set_sampler(ddim_eta=0.0)
    assert trainer.sampler_name == "ddim" and trainer.sample_steps == 3
    assert torch.equal(trainer.sample_fn(cond, x_T=x_T), first)
    with pytest.raises(ValueError, match="unknown sampler"):
        trainer.set_sampler("heun")


def test_progressive_denoise_collects_every_step(flax_model):
    _, params = flax_model
    trainer = Trainer(tiny_cfg(3), device="cpu")
    trainer.load_flax_params(params)
    x_T, cond = (torch.from_numpy(a) for a in _inputs(19))
    final, frames = trainer.progressive_denoise(cond, x_T=x_T)
    assert frames.shape == (3, 2, 16, 16, 1)
    assert torch.equal(final, frames[-1])
    # the last x0 prediction is where the DDIM chain ends (sqrt(acp_prev) = 1
    # and no direction term at t = 0)
    np.testing.assert_allclose(final.numpy(),
                               trainer.sample_fn(cond, x_T=x_T).numpy(),
                               atol=1e-6)
    trainer.set_sampler(sample_steps=2)
    assert trainer.progressive_denoise(cond, x_T=x_T)[1].shape[0] == 2


def test_split_train_step_loss_and_gradients_match_jax():
    """One ``Trainer.train_step`` on ``ds_diff_split`` against the JAX
    ``make_train_step`` over ``DSUNetSplit``: the metrics to 1e-4 relative
    and every gradient (read off AdamW's first moment, mu_1 = 0.1 g) to 1e-4
    of its leaf's largest magnitude, floored at 1e-2 of the model's largest
    (leaves whose gradient is rounding noise)."""
    import dataclasses

    from dsdiff_tpu.train import schedule_sampler as JSS
    from dsdiff_tpu.train import state as JState
    from dsdiff_tpu.train import step as JStep
    from dsdiff_torch.utils.flax_bridge import flax_to_state_dict

    jm, params = _flax_split(10, remat=True)
    trainer = Trainer(_split_cfg(), device="cpu")
    trainer.load_flax_params(params)
    lr = JState.cosine_lr(1e-4, 250 * 1000, warmup_steps=0, min_lr=1e-7)
    state0 = JState.TrainState.create(
        jm.apply, {"params": params}, JState.make_optimizer(lr),
        ema_decay=0.9999)
    step_fn = JStep.make_train_step(
        JStep.TaskConfig(**dataclasses.asdict(trainer.task)),
        JSch.DiffusionSchedule.create(
            JSch.make_beta_schedule("scaled_linear", 1000)), donate=False)
    rng_np = np.random.default_rng(23)
    batch = {"target": rng_np.uniform(-1, 1, (2, 16, 16, 1)).astype(np.float32),
             "image": rng_np.standard_normal((2, 16, 16, 3)).astype(np.float32)}
    rng = jax.random.PRNGKey(4)
    state1, _, want_m = step_fn(state0, JSS.uniform_init(1000),
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                rng)
    t_rng, n_rng, _, _ = jax.random.split(jax.random.fold_in(rng, 0), 4)
    t = torch.from_numpy(np.array(jax.random.randint(t_rng, (2,), 0, 1000),
                                  np.int64))
    noise = torch.from_numpy(np.array(
        jax.random.normal(n_rng, (2, 16, 16, 1), jnp.float32)))
    got_m = trainer.train_step({k: torch.from_numpy(v)
                                for k, v in batch.items()}, t=t, noise=noise)
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=1e-4, err_msg=k)
    want_mu = flax_to_state_dict(state1.opt_state[-1][0].mu, trainer.model)
    want_g = {k: v.numpy() / 0.1 for k, v in want_mu.items()}
    top = max(np.abs(g).max() for g in want_g.values())
    for i, name in enumerate(trainer.state.names):
        got = trainer.state.tx.mu[i].numpy() / 0.1
        scale = max(np.abs(want_g[name]).max(), 1e-2 * top)
        np.testing.assert_allclose(got, want_g[name], rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def test_smoke_split_config_is_the_split_config():
    yaml_cfg = load_run_config("configs/train_config.yaml",
                               "dsdiff_split.yaml")
    smoke = chip_smoke.SPLIT_CONFIG
    for key in SLICE_KEYS + ("cached_cond_sampling",):
        assert smoke.get(key) == yaml_cfg.get(key), key
    assert smoke["net_mode"] == "ds_diff_split"


def test_smoke_launch_counts_follow_from_the_backbone():
    """The counts ``chip_smoke.py`` asserts on the card, derived here from
    the models themselves at the flagship's depth (narrow, on the CPU)."""
    from dsdiff_torch.models import build_model

    params = dict(chip_smoke.FLAGSHIP_CONFIG["unet_config"]["params"],
                  model_channels=32, num_head_channels=16)
    split = build_model("dsunet_split", device="cpu", in_channels=4,
                        out_channels=2, dtype=torch.float32, **params)
    blocks = chip_smoke._attention_blocks
    assert blocks(split.noise_encoder) == chip_smoke.ENCODER_ATTN == 6
    assert blocks(split.middle) == chip_smoke.MIDDLE_ATTN == 1
    assert blocks(split.decoder) == chip_smoke.DECODER_ATTN == 9
    assert blocks(split) == chip_smoke.CALLS_PER_FORWARD == 34
    assert (blocks(split.cond_encoder_0) + blocks(split.cond_encoder_1)
            + blocks(split.cond_encoder_2)) == chip_smoke.ENCODE_CALLS == 18
    assert chip_smoke.CACHED_STEP_CALLS == 16
    assert chip_smoke.CACHED_REQUEST_CALLS == 338
    flagship = build_model("dsunet", device="cpu", in_channels=4,
                           out_channels=2, **params)
    assert blocks(flagship) == 34


def test_smoke_flax_tree_inverts_the_bridge(flax_model):
    from dsdiff_torch.models import build_model
    from dsdiff_torch.utils.flax_bridge import flatten_tree, flax_to_state_dict

    _, params = flax_model
    pm = build_model("dsunet", device="cpu", in_channels=4, out_channels=2,
                     **TINY)
    pm.load_state_dict(flax_to_state_dict(params, pm))
    got, want = flatten_tree(chip_smoke._flax_tree(pm)), flatten_tree(params)
    assert set(got) == set(want)
    for k in want:  # the bridge holds f32
        np.testing.assert_array_equal(got[k], want[k].astype(np.float32),
                                      err_msg=k)
