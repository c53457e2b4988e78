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


@pytest.mark.parametrize("net_mode, model, millions", [
    ("ddpm", "ddpm.yaml", 47.55),
    ("disc_diff", "disc_diff.yaml", 250.83),
    ("palette", "palette.yaml", 142.43),
    ("dit", "dsdiff_gaussian.yaml", 129.81),
])
def test_other_families_match_the_jax_parameter_count(net_mode, model,
                                                      millions):
    """The other denoisers the run config names, built as each trainer
    builds them (DiscUNet one stream per input channel, DiT sized by
    ``ViT_config``); ``ddpm.yaml`` sets no net_mode, so the run sets it."""
    cfg = load_run_config(CONFIGS / "train_config.yaml", CONFIGS / model,
                          overrides={"net_mode": net_mode})
    name, _ = FEATURE_KINDS[net_mode]
    params = model_params(cfg, name, len(cfg.get("train_keys")) - 1)
    with torch.device("meta"):
        port = build_model(name, device="meta", **params)
    assert all(p.is_meta for p in port.parameters())
    n_port = sum(p.numel() for p in port.parameters())

    jm = jax_build_model(name, **dict(params, dtype=jnp.bfloat16))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 256, 256, 4), jnp.float32),
                            jnp.zeros((1,), jnp.float32))
    assert n_port == sum(s.size for s in jax.tree.leaves(shapes))
    assert round(n_port / 1e6, 2) == millions


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


def test_smoke_families_are_the_config_files_and_their_attention_calls():
    """chip_smoke's families phase runs each family's config file as a user
    would, and its expected attention calls a forward are the attention
    blocks of the model built from that file (16 / 12 / 6 / 12)."""
    import chip_smoke

    from dsdiff_torch.models.attention import AttentionBlock

    want = {"ddpm": 16, "disc_diff": 12, "palette": 6, "dit": 12}
    for net_mode, yaml_name, shapes in chip_smoke.FAMILIES:
        cfg = chip_smoke.family_config(net_mode, yaml_name)
        assert cfg["net_mode"] == net_mode and cfg["image_size"] == 256
        name, _ = FEATURE_KINDS[net_mode]
        with torch.device("meta"):
            model = build_model(name, device="meta", **model_params(
                cfg, name, len(cfg["train_keys"]) - 1))
        blocks = sum(isinstance(m, AttentionBlock) for m in model.modules())
        if net_mode == "dit":
            blocks = model.depth
            assert (model.pos_embed.shape[0], model.block_0.heads,
                    model.block_0.hidden // model.block_0.heads) == shapes[0][:3]
        assert blocks == sum(c for *_, c in shapes) == want[net_mode]
    with pytest.raises(SystemExit):
        chip_smoke.main(["--phases", "kernels,nothing"])
