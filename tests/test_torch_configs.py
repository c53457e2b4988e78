"""The port builds the model of each of the other DS-Diff configs through
the trainer's own config mapping (``train.trainer.model_params``), on
torch's ``meta`` device (no weights allocated), and its parameter count
equals the JAX package's ``jax.eval_shape`` count of the same config's
model, as ``tests/test_ref_scale_configs.py`` builds it; equal means
equal, to the parameter."""
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from dsdiff_tpu.models import build_model as jax_build_model
from dsdiff_torch.models import build_model
from dsdiff_torch.train.config import load_run_config
from dsdiff_torch.train.trainer import FEATURE_KINDS, model_params

CONFIGS = Path(__file__).parent.parent / "configs"
# the JAX trainer's unet_config keys that describe the reference's module
_DROPPED = ("image_size", "use_checkpoint", "legacy", "use_new_attention_order",
            "use_linear_in_transformer", "adm_in_channels", "context_dim",
            "num_classes", "in_channels", "out_channels")


@pytest.mark.parametrize("run, model, width, hw", [
    ("train_config.yaml", "dsdiff_flagship128.yaml", 128, 256),
    ("train_config.yaml", "dsdiff_thesis160.yaml", 160, 256),
    ("train_config.yaml", "dsdiff_ldm320.yaml", 320, 320),
    ("train_config_BraTs.yaml", None, 96, 192),
])
def test_port_model_matches_the_jax_parameter_count(run, model, width, hw):
    cfg = load_run_config(CONFIGS / run, CONFIGS / model if model else None)
    assert int(cfg.get_path("unet_config.params.model_channels")) == width
    assert int(cfg.get("image_size")) == hw
    name, _ = FEATURE_KINDS[cfg.get("net_mode")]
    n_cond = len(cfg.get("train_keys")) - 1
    params = model_params(cfg, name, n_cond)
    with torch.device("meta"):
        port = build_model(name, device="meta", **params)
    assert all(p.is_meta for p in port.parameters())
    n_port = sum(p.numel() for p in port.parameters())

    jp = {k: v for k, v in dict(cfg.get_path("unet_config.params")).items()
          if k not in _DROPPED}
    jm = jax_build_model(name, in_channels=1 + n_cond,
                         out_channels=params["out_channels"],
                         dtype=jnp.bfloat16, **jp)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, hw, hw, 1 + n_cond), jnp.float32),
                            jnp.zeros((1,), jnp.float32))
    assert n_port == sum(s.size for s in jax.tree.leaves(shapes))


# the keys the fit, validate and predict path reads beyond the model's
FIT_KEYS = ("Task_name", "Task_id", "fold_K", "fold_idx", "train_batch_size",
            "val_batch_size", "image_size", "val_step", "augmentation_prob",
            "h5_2d_img_dir", "train_keys", "seed", "num_epochs")


def test_smoke_fit_config_is_the_flagship_config_but_its_cuts():
    import chip_smoke

    yaml_cfg = load_run_config(CONFIGS / "train_config.yaml")
    for key in FIT_KEYS:
        assert chip_smoke.FLAGSHIP_CONFIG.get(key) == yaml_cfg.get(key), key
    fit = chip_smoke._fit_config(Path("/data"))
    changed = {k for k in set(fit) | set(chip_smoke.FLAGSHIP_CONFIG)
               if fit.get(k) != chip_smoke.FLAGSHIP_CONFIG.get(k)}
    assert changed == set(chip_smoke.FIT_CUTS) | {"h5_2d_img_dir",
                                                  "data_store", "train_keys"}
    for key, (full, cut) in chip_smoke.FIT_CUTS.items():
        assert yaml_cfg.get(key, full) == full and fit[key] == cut, key
    assert chip_smoke.FIT_BATCH == 32 and chip_smoke.VAL_BATCH == 8
