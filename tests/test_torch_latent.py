"""The latent pipeline against the JAX package's, on the CPU in f32: a tiny
KL-VAE (ch 8, ``ch_mult`` (1, 2): 16² images, 8² latents of 4 channels)
and a tiny latent UNet, every Flax weight random and carried across, and
JAX's draws replayed:

- ``LatentAdapter``: ``encode_batch`` (each condition alone, then the
  target), ``encode_cond``, ``decode_batch`` and the ``scale_by_std``
  calibration, within 1e-4;
- the latent ``Trainer``: one train step on the encoded batch (metrics to
  1e-4 relative), one request (conditions encoded, DDIM in latent space,
  the sample decoded; 1e-4) and ``progressive_denoise`` (every step's
  latent x0 and the decoded final; 1e-4);
- ``VaeTrainer`` on a synthetic npy store: ``fit`` for 2 steps, its
  checkpoint, ``reconstruction_metrics``, then that checkpoint restored as
  ``vae_checkpoint`` into a latent ``Trainer`` that trains, validates and
  predicts NIfTI volumes at image resolution.
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
from dsdiff_tpu.train.latent import LatentAdapter as JAdapter
from dsdiff_torch.data import synthetic
from dsdiff_torch.data.nifti import read_nifti
from dsdiff_torch.train.latent import LatentAdapter
from dsdiff_torch.train.trainer import Trainer
from dsdiff_torch.train.vae_loop import VaeTrainer, build_vae
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict
from torch_parity_utils import one_thread, random_flax_params, tiny_cfg

pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 1e-4
RTOL = 1e-4
B, HW, Z, STEPS = 2, 16, 4, 3
FIRST_STAGE = {"params": {"ch": 8, "ch_mult": [1, 2], "num_res_blocks": 1,
                          "z_channels": Z, "embed_dim": Z}}
UNET = dict(model_channels=32, num_res_blocks=1, attention_resolutions=[2],
            channel_mult=[1, 2], num_heads=2, use_scale_shift_norm=True)


def _cfg(**kw):
    """The tiny flagship config as configs/latent.yaml turns it latent."""
    cfg = tiny_cfg(STEPS)
    cfg.update(net_mode="latent", image_size=HW, parameterization="v",
               loss_type="l2", learn_sigma=False, disentangle_distance=None,
               scale_factor=0.18215, scale_by_std=False, vae_checkpoint="",
               first_stage=FIRST_STAGE, unet_config={"params": UNET})
    cfg.update(kw)
    return cfg


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"target": rng.uniform(-1, 1, (B, HW, HW, 1)).astype(np.float32),
            "image": rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32)}


def _cond_noise(key, n):
    """The JAX adapter's posterior draws for ``n`` sequences from ``key``."""
    return [_t(jax.random.normal(k, (B, HW // 2, HW // 2, Z), jnp.float32))
            for k in jax.random.split(key, n)]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    cfg = _cfg()
    jt = JTrainer(JConfig.wrap(cfg), tmp_path_factory.mktemp("latent"),
                  mesh=pmesh.local_mesh())
    vtree = random_flax_params(jt.first_stage.params["params"], 41)
    jt.first_stage.params = {"params": vtree}
    params = random_flax_params(jt.state.params["params"], 42)
    jt.state = JState.TrainState.create(jt.model.apply, {"params": params},
                                        jt.state.tx, ema_decay=0.9999)
    pt = Trainer(cfg, device="cpu")
    vae = pt.first_stage.vae
    vae.load_state_dict(flax_to_state_dict(vtree, vae))
    pt.load_flax_params({"params": params})
    assert pt.in_ch == Z * 4 and pt.base_out == Z
    assert pt.n_params == sum(p.size for p in jax.tree.leaves(params))
    yield jt, pt, vtree
    jt.ckpt.close()


def test_adapter_encode_decode_match_jax(pair):
    jt, pt, _ = pair
    batch = _batch(1)
    key = jax.random.PRNGKey(3)
    want = jt.first_stage.encode_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    got = pt.first_stage.encode_batch(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        noise=_cond_noise(key, 4))
    assert got["image"].shape == (B, HW // 2, HW // 2, 3 * Z)
    assert got["target"].shape == (B, HW // 2, HW // 2, Z)
    for k in ("image", "target"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, err_msg=k)
    zc = pt.first_stage.encode_cond(torch.from_numpy(batch["image"]),
                                    noise=_cond_noise(key, 3))
    np.testing.assert_allclose(
        zc.numpy(), np.asarray(jt.first_stage.encode_cond(
            jnp.asarray(batch["image"]), key)), atol=ATOL)
    dec = pt.first_stage.decode_batch(got["target"])
    assert dec.shape == (B, HW, HW, 1)
    np.testing.assert_allclose(
        dec.numpy(), np.asarray(jt.first_stage.decode_batch(want["target"])),
        atol=ATOL)
    # the frozen first stage: compute-dtype weights, no gradients
    assert all(not p.requires_grad for p in pt.first_stage.vae.parameters())


def test_scale_by_std_calibrates_from_the_first_batch(pair):
    jt, pt, vtree = pair
    batch = _batch(2)
    key = jax.random.PRNGKey(4)
    ja = JAdapter(jt.first_stage.vae, {"params": vtree}, scale_by_std=True)
    want = ja.encode_batch({k: jnp.asarray(v) for k, v in batch.items()}, key)
    pa = LatentAdapter(pt.first_stage.vae, scale_by_std=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    calib = _t(jax.random.normal(key, (B, HW // 2, HW // 2, Z), jnp.float32))
    pa.calibrate(tb, noise=calib)
    np.testing.assert_allclose(pa.scale_factor, float(ja.scale_factor),
                               rtol=1e-5)
    got = pa.encode_batch(tb, noise=_cond_noise(key, 4))
    np.testing.assert_allclose(got["target"].numpy(), np.asarray(want["target"]),
                               atol=ATOL)
    before = pa.scale_factor
    pa.calibrate(tb, noise=calib * 2)  # once only
    assert pa.scale_factor == before


def test_latent_train_step_matches_jax_given_its_draws(pair):
    jt, pt, _ = pair
    batch = _batch(5)
    enc = jax.random.PRNGKey(6)
    rng = jax.random.PRNGKey(7)
    zb = jt.first_stage.encode_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, enc)
    _, _, want = jt.train_step(jax.tree.map(jnp.copy, jt.state),
                               jt.sampler_state, zb, rng)
    t_rng, n_rng, _, _ = jax.random.split(jax.random.fold_in(rng, 0), 4)
    t = jax.random.randint(t_rng, (B,), 0, 1000)
    noise = jax.random.normal(n_rng, (B, HW // 2, HW // 2, Z), jnp.float32)
    pb = pt.first_stage.encode_batch(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        noise=_cond_noise(enc, 4))
    got = pt.train_step(pb, t=_t(t).long(), noise=_t(noise))
    pt.load_flax_params({"params": jax.device_get(jt.state.params)["params"]})
    assert set(got) == set(want) | {"grad_norm"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=k)


def test_latent_request_matches_jax_given_its_draws(pair):
    """Conditions encoded, DDIM over the latents, the sample decoded, as
    the JAX package's validate and predict compose them."""
    jt, pt, _ = pair
    cond = _batch(8)["image"]
    erng, srng = jax.random.split(jax.random.PRNGKey(9))
    zc = jt.first_stage.encode_cond(jnp.asarray(cond), erng)
    want = np.asarray(jt.first_stage.decode_batch(
        jt.sample_fn(jt.state.ema_params, zc, srng)))
    x_T = jax.random.normal(jax.random.split(srng)[0], (B, HW // 2, HW // 2, Z))
    got = pt.sample_images(torch.from_numpy(cond), x_T=_t(x_T),
                           cond_noise=_cond_noise(erng, 3))
    assert got.shape == want.shape == (B, HW, HW, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_latent_progressive_denoise_matches_jax(pair):
    jt, pt, _ = pair
    cond = _batch(10)["image"]
    rng = jax.random.PRNGKey(11)
    want_final, want = jt.progressive_denoise(jnp.asarray(cond), rng)
    rng2, erng = jax.random.split(rng)
    x_T = jax.random.normal(jax.random.split(rng2)[0],
                            (B, HW // 2, HW // 2, Z))
    final, got = pt.progressive_denoise(torch.from_numpy(cond), x_T=_t(x_T),
                                        cond_noise=_cond_noise(erng, 3))
    assert got.shape == (STEPS, B, HW // 2, HW // 2, Z)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert final.shape == (B, HW, HW, 1)
    np.testing.assert_allclose(final.numpy(), np.asarray(want_final),
                               atol=ATOL)
    assert pt._val_features(_batch(12)) is None


def test_vae_trainer_checkpoint_serves_a_latent_trainer(tmp_path):
    # 32²: the loader pads slices to a multiple of 32
    root = synthetic.make_structured_dataset(
        tmp_path / "data", n_cases=6, n_slices=4, hw=32, seed=0, store="npy")
    common = dict(h5_2d_img_dir=str(root), data_store="npy", image_size=32,
                  train_keys=["A", "B", "C", "GT"], bf16=False, seed=5)
    vcfg = dict(common, train_batch_size=4, num_epochs=1,
                lr=1e-4, disc_start=0, disc_channels=8, disc_num_layers=2,
                first_stage=FIRST_STAGE)
    vt = VaeTrainer(vcfg, tmp_path / "vae", device="cpu")
    start = {n: p.detach().clone() for n, p in vt.vae.named_parameters()}
    dstart = [p.detach().clone() for p in vt.disc_state.params]
    step = vt.fit(max_steps=2, log_every=1)
    assert step == 2 and vt.vae_state.step == vt.disc_state.step == 2
    assert vt.ckpt.all_steps() == [2]
    assert all(not torch.equal(p, start[n])
               for n, p in vt.vae.named_parameters())
    assert all(not torch.equal(a, b)
               for a, b in zip(dstart, vt.disc_state.params))
    assert float(vt.logvar) != 0.0
    rec = vt.reconstruction_metrics(max_batches=2)
    assert set(rec) == {"rec_ssim", "rec_psnr", "rec_mae"}
    assert np.isfinite(list(rec.values())).all()
    rows = (tmp_path / "vae" / "logs" / "progress.csv").read_text()
    assert "d_weight" in rows and "disc_loss" in rows

    lcfg = _cfg(**common, vae_checkpoint=str(tmp_path / "vae" / "checkpoint"),
                train_batch_size=4, val_batch_size=4, fold_K=3, fold_idx=0,
                num_epochs=1, log_images=True)
    lt = Trainer(lcfg, tmp_path / "latent", device="cpu")
    for n, p in lt.first_stage.vae.named_parameters():
        assert torch.equal(p, dict(vt.vae.named_parameters())[n]), n
    assert lt.fit(max_steps=2, log_every=1, val_every_epochs=1) == 2
    assert (tmp_path / "latent" / "images").exists()
    out_dir, _ = lt.predict()
    preds = sorted(out_dir.glob("*_pred.nii.gz"))
    assert preds and read_nifti(preds[0]).data.shape[:2] == (32, 32)


def test_vae_checkpoint_file_is_refused(tmp_path):
    """An SD VAE file as ``vae_checkpoint`` is read (test_torch_sd_vae_file.py);
    a file in no checkpoint format is refused."""
    path = tmp_path / "sd_vae.safetensors"
    path.write_bytes(b"")
    with pytest.raises(ValueError, match="unrecognized checkpoint format"):
        Trainer(_cfg(vae_checkpoint=str(path)), device="cpu")


def test_build_vae_reads_first_stage_and_bf16():
    from dsdiff_torch.train.config import Config

    vae = build_vae(Config.wrap(_cfg(bf16=True)), "cpu")
    assert vae.compute_dtype == torch.bfloat16 and vae.downsample == 2
    assert all(p.dtype == torch.float32 for p in vae.parameters())
