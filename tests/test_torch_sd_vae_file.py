"""An SD VAE file in the published vae-ft-mse-840000 layout (the port's
``utils.inventories.fake_state_dict``: 248 tensors of seeded random
weights) against the JAX package's reading of it, on the CPU:

- ``map_sd_vae``: the same Flax paths and arrays, key for key;
- the port's inventories are the JAX package's, byte for byte, and draw
  the same state dicts from a seed;
- ``load_sd_vae`` onto a tiny ``AutoencoderKL`` (ch 8, (1, 2), one block,
  one input and output channel) equals the JAX params through the bridge,
  exactly: the 3 -> 1-channel fit of ``encoder.conv_in`` keeps input
  channel 0 unscaled and ``decoder.conv_out`` output channel 0 unscaled
  (the fit runs in the Flax layout; in OIHW both would be halved), and
  ``missing`` / ``unused`` are the JAX lists;
- a latent ``Trainer`` whose ``vae_checkpoint`` is the file (a zip pickle
  with the ``first_stage_model.`` prefix and ``state_dict`` nesting) holds
  the JAX ``Trainer``'s ``first_stage`` params, and a DDIM-3 request given
  JAX's draws matches it within 1e-4 of max(1, max |out|).
"""
import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.models import AutoencoderKL as JAutoencoderKL
from dsdiff_tpu.parallel import mesh as pmesh
from dsdiff_tpu.train import Trainer as JTrainer
from dsdiff_tpu.train import state as JState
from dsdiff_tpu.train.config import Config as JConfig
from dsdiff_tpu.utils import inventories as JInv
from dsdiff_tpu.utils import torch_io as JIO
from dsdiff_torch.models.vae import AutoencoderKL
from dsdiff_torch.train.trainer import Trainer
from dsdiff_torch.utils import inventories as PInv
from dsdiff_torch.utils import torch_io as PIO
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict
from torch_eval_weights import write_safetensors
from torch_parity_utils import one_thread, random_flax_params, tiny_cfg  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TINY = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=4,
            embed_dim=4)
B, HW, Z, STEPS = 2, 16, 4, 3
RTOL = 1e-4


@pytest.fixture(scope="module")
def sd():
    """The published layout's state dict, seeded random weights."""
    return PInv.fake_state_dict("sd_vae_ft_mse", seed=0)


@pytest.fixture(scope="module")
def files(sd, tmp_path_factory):
    """The state dict as .safetensors, and as a zip pickle of a full SD
    checkpoint (``first_stage_model.`` keys under ``state_dict``)."""
    root = tmp_path_factory.mktemp("sd_vae")
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    write_safetensors(root / "vae.safetensors", tensors)
    torch.save({"state_dict": {f"first_stage_model.{k}": v
                               for k, v in tensors.items()}},
               root / "sd.ckpt")
    return root / "vae.safetensors", root / "sd.ckpt"


def test_map_sd_vae_equals_jax(sd):
    want = JIO.map_sd_vae(sd)
    got = PIO.map_sd_vae(sd)
    assert len(sd) == 248 and sd.read == set(sd)  # every key was read
    assert list(got) == list(want) and len(got) == 248
    for k, v in want.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # a full SD checkpoint's and a Lightning module's prefixes are stripped
    prefixed = {f"first_stage_model.{k}": v for k, v in list(sd.items())[:6]}
    prefixed.update({f"model.{k}": v for k, v in list(sd.items())[6:12]})
    assert list(PIO.map_sd_vae(prefixed)) == list(JIO.map_sd_vae(prefixed))


@pytest.mark.parametrize("name", JInv.INVENTORIES)
def test_inventories_are_the_jax_packages(name):
    jdir, pdir = JInv._DIR, PInv._DIR
    assert filecmp.cmp(jdir / f"{name}.json", pdir / f"{name}.json",
                       shallow=False)
    assert filecmp.cmp(jdir / "__init__.py", pdir / "__init__.py",
                       shallow=False)
    assert PInv.load_inventory(name) == JInv.load_inventory(name)
    if name == "lpips_vgg_lins":  # the smallest; the others take seconds
        want, got = JInv.fake_state_dict(name, 3), PInv.fake_state_dict(name, 3)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def _jax_tiny_params():
    vae = JAutoencoderKL(**TINY)
    rng = jax.random.PRNGKey(0)
    return jax.device_get(vae.init(rng, jnp.zeros((1, HW, HW, 1)), rng))


def test_load_sd_vae_equals_jax_with_the_channel_fit(sd, files):
    init = _jax_tiny_params()
    want, want_missing, want_unused = JIO.load_sd_vae(files[0], init)
    vae = AutoencoderKL(**TINY)
    vae.load_state_dict(flax_to_state_dict(init, vae))  # the same fresh init
    state, missing, unused = PIO.load_sd_vae(files[0], vae)
    assert missing == list(want_missing) and unused == list(want_unused)
    assert unused and "params/encoder/down_2_0/conv1/kernel" in unused
    want_state = flax_to_state_dict(jax.device_get(want), vae)
    assert set(state) == set(want_state)
    for k, v in want_state.items():
        assert state[k].dtype == torch.float32
        assert torch.equal(state[k], v), k
    # conv_in [128, 3, 3, 3] -> [8, 1, 3, 3]: input channel 0 as it is
    conv_in = sd["encoder.conv_in.weight"]
    np.testing.assert_array_equal(state["encoder.conv_in.weight"][:, 0],
                                  conv_in[:8, 0])
    # decoder.conv_out [3, 128, 3, 3] -> [1, 8, 3, 3], and its bias
    np.testing.assert_array_equal(state["decoder.conv_out.weight"][0],
                                  sd["decoder.conv_out.weight"][0, :8])
    np.testing.assert_array_equal(state["decoder.conv_out.bias"],
                                  sd["decoder.conv_out.bias"][:1])
    # the same file, read as a full SD zip pickle
    again, _, _ = PIO.load_sd_vae(files[1], vae)
    assert all(torch.equal(again[k], v) for k, v in state.items())
    with pytest.raises(ValueError, match="shape mismatch"):
        PIO.assign(vae, PIO.map_sd_vae(sd), make_fit=False)


UNET = dict(model_channels=32, num_res_blocks=1, attention_resolutions=[2],
            channel_mult=[1, 2], num_heads=2, use_scale_shift_norm=True)


def _latent_cfg(vae_file):
    """The tiny flagship config as configs/latent.yaml turns it latent, the
    SD file as its first stage."""
    cfg = tiny_cfg(STEPS)
    cfg.update(net_mode="latent", image_size=HW, parameterization="v",
               loss_type="l2", learn_sigma=False, disentangle_distance=None,
               scale_factor=0.18215, scale_by_std=False,
               vae_checkpoint=str(vae_file),
               first_stage={"params": dict(TINY, ch_mult=list(TINY["ch_mult"]))},
               unet_config={"params": UNET})
    return cfg


def _t(x):
    return torch.from_numpy(np.array(x))


def test_latent_trainer_with_the_file_matches_jax(files, tmp_path):
    cfg = _latent_cfg(files[1])
    jt = JTrainer(JConfig.wrap(cfg), tmp_path / "jax", mesh=pmesh.local_mesh())
    pt = Trainer(cfg, tmp_path / "port", device="cpu")
    # every leaf of the tiny VAE has a source in the file
    vae = pt.first_stage.vae
    want = flax_to_state_dict(jax.device_get(jt.first_stage.params), vae)
    for k, v in vae.state_dict().items():
        assert torch.equal(v, want[k]), k
    log = (tmp_path / "port" / "log_txt.txt").read_text()
    assert f"vae init from {files[1]}: 0 params kept fresh" in log

    params = random_flax_params(jax.device_get(jt.state.params)["params"], 7)
    jt.state = JState.TrainState.create(jt.model.apply, {"params": params},
                                        jt.state.tx, ema_decay=0.9999)
    pt.load_flax_params({"params": params})
    cond = np.random.default_rng(8).uniform(-1, 1, (B, HW, HW, 3)).astype(
        np.float32)
    erng, srng = jax.random.split(jax.random.PRNGKey(9))
    zc = jt.first_stage.encode_cond(jnp.asarray(cond), erng)
    want = np.asarray(jt.first_stage.decode_batch(
        jt.sample_fn(jt.state.ema_params, zc, srng)))
    x_T = jax.random.normal(jax.random.split(srng)[0],
                            (B, HW // 2, HW // 2, Z))
    cond_noise = [_t(jax.random.normal(k, (B, HW // 2, HW // 2, Z)))
                  for k in jax.random.split(erng, 3)]
    got = pt.sample_images(torch.from_numpy(cond), x_T=_t(x_T),
                           cond_noise=cond_noise)
    assert got.shape == want.shape == (B, HW, HW, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RTOL * max(1.0, np.abs(want).max()))
    jt.ckpt.close()
