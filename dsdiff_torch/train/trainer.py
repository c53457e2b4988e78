"""The trainer: config -> schedule -> model -> sample function.

Port of the sampling half of the JAX package's ``train/trainer.py`` ``Trainer``
(``:74-130, 181-231, 284-324``): the net_mode / schedule / variance
defaults, ``TaskConfig``, the model build and the re-spaced sampler.
``fit``, ``validate``, ``predict``, checkpoints and the data pipeline come
with later slices (ROADMAP A7, A13, A14).
"""
from __future__ import annotations

from pathlib import Path
from typing import Mapping

import torch

from ..core import schedules
from ..models import build_model
from ..utils.device import resolve_device
from ..utils.flax_bridge import flax_to_state_dict
from .config import Config
from .step import TaskConfig, make_sample_fn

__all__ = ["Trainer", "FEATURE_KINDS", "OPENAI_SCHEDULE_MODES"]

# net_mode -> (model registry key, feature kind)
FEATURE_KINDS = {
    "ds_diff_gaussian": ("dsunet", "ds"),
    "ds_diff": ("dsunet", "ds"),
    "ds_diff_split": ("dsunet_split", "ds"),
    "disc_diff": ("disc_unet", "disc"),
    "ddpm": ("unet", None),
    "dit": ("dit", None),
    "latent": ("unet", None),
    "palette": ("unet", None),
    "diffusion": ("unet", None),
}

# net_modes whose diffusion math follows the OpenAI fork: their 'linear'
# noise_schedule is our 'scaled_linear' and their non-learned variance is
# fixed_large. The LDM-math modes keep the sqrt-space 'linear' and the
# posterior variance.
OPENAI_SCHEDULE_MODES = frozenset(
    {"ds_diff_gaussian", "ds_diff_split", "disc_diff", "dit"}
)

# unet_config keys that describe the reference's torch module, not ours
_DROPPED_MODEL_KEYS = (
    "image_size", "use_checkpoint", "legacy", "use_new_attention_order",
    "use_linear_in_transformer", "adm_in_channels", "context_dim",
    "num_classes", "in_channels", "out_channels",
)


class Trainer:
    """Builds the schedule, model and ``sample_fn`` from a run config.

    ``sample_fn(cond [B,H,W,n_cond], generator=None, x_T=None)`` returns
    samples [B, H, W, output_ch]. ``device`` defaults to ``"cuda"``.
    """

    def __init__(self, cfg: Mapping, workdir=None, device=None):
        cfg = Config.wrap(dict(cfg))
        self.cfg = cfg
        self.workdir = Path(workdir) if workdir is not None else None
        self.device = resolve_device(device or "cuda")

        net_mode = cfg.get("net_mode", "ds_diff_gaussian")
        model_name, feature_kind = FEATURE_KINDS.get(net_mode, (net_mode, None))
        if net_mode in ("latent", "palette", "diffusion"):
            raise NotImplementedError(
                f"net_mode '{net_mode}' is not ported yet (ROADMAP A17)"
            )
        if cfg.get("h5_2d_img_dir"):
            raise NotImplementedError(
                "the data pipeline is not ported yet (ROADMAP A14)"
            )
        self.keys = list(cfg.get("train_keys",
                                 ["F_Data1", "F_Data2", "S_Data1", "S_Data2"]))
        self.use_edge = cfg.get("use_edge", False) or False
        n_cond = len(self.keys) - 1 + (1 if self.use_edge else 0)

        # ---- diffusion schedule
        T = int(cfg.get_path("diffusion.steps", cfg.get("diffusion_steps", 1000)))
        beta_schedule = cfg.get_path("diffusion.beta_schedule", None)
        if beta_schedule is None:
            # for the OpenAI-math pipelines 'linear' means
            # scale*linspace(1e-4, 2e-2), our 'scaled_linear'
            beta_schedule = cfg.get("noise_schedule", "linear")
            if beta_schedule == "linear" and net_mode in OPENAI_SCHEDULE_MODES:
                beta_schedule = "scaled_linear"
        self.betas = schedules.make_beta_schedule(
            beta_schedule, T, float(cfg.get("linear_start", 1e-4)),
            float(cfg.get("linear_end", 2e-2)),
        )
        self.sched = schedules.DiffusionSchedule.create(
            self.betas, device=self.device
        )

        learn_sigma = bool(cfg.get("learn_sigma", False))
        disen = cfg.get("disentangle_distance", "eu")
        loss_type = cfg.get("loss_type", "charbonnier")
        self.task = TaskConfig(
            parameterization=cfg.get("parameterization", "v"),
            variance_type=cfg.get(
                "variance_type",
                "fixed_large" if net_mode in OPENAI_SCHEDULE_MODES
                else "fixed_small",
            ),
            loss_type={"charbonnie": "charbonnier"}.get(loss_type, loss_type),
            learn_sigma=learn_sigma,
            feature_kind=feature_kind if disen else None,
            disentangle_mode=disen or "eu",
            disen_lambda=float(cfg.get("contrast_lambda", 0.5)),
            cond_dropout=float(cfg.get("cond_dropout", 0.0)),
            cfg_scale=float(
                (cfg.get("sampler_setting", {}) or {}).get("cfg_scale", 1.0)
            ),
        )

        # ---- model
        model_params = dict(cfg.get_path("unet_config.params", {}) or {})
        for drop in _DROPPED_MODEL_KEYS:
            model_params.pop(drop, None)
        self.base_out = int(cfg.get("output_ch", 1))
        in_ch = 1 + n_cond
        out_ch = self.base_out * (2 if learn_sigma else 1)
        # bf16 compute: weights held in bf16, GroupNorm in f32
        dtype = torch.bfloat16 if cfg.get("bf16", True) else torch.float32
        if model_name == "dsunet":
            model_params.setdefault("model_channels", 96)
            model_params.setdefault("use_edge", bool(self.use_edge))
        seed = int(cfg.get("seed", 2024))
        # modules initialise on the CPU from its default generator: seed it
        # for this build only
        with torch.random.fork_rng(devices=[]):
            torch.default_generator.manual_seed(seed)
            self.model = build_model(
                model_name, device=self.device, in_channels=in_ch,
                out_channels=out_ch, dtype=dtype, **model_params,
            )
        self.model.eval()
        self.in_ch = in_ch
        self.n_cond = n_cond
        self.model_name = model_name
        self.n_params = sum(p.numel() for p in self.model.parameters())

        # ---- sampler over the re-spaced schedule
        samp = cfg.get("sampler_setting", {}) or {}
        self.sample_steps = int(samp.get("sample_steps", 20))
        self.sampler_name = samp.get("sampler", "ddim")
        self.eta = float(samp.get("ddim_eta", 0.0))
        if bool(samp.get("ddim_use_original_steps", False)):
            self.rsched = self.sched
        else:
            self.rsched = schedules.respace(
                self.betas,
                schedules.space_timesteps(T, str(self.sample_steps)),
                rescale_timesteps=bool(cfg.get("rescale_timesteps", False)),
                device=self.device,
            )
        self.sample_fn = make_sample_fn(
            self.model, self.rsched, self.task, self.sampler_name, self.eta,
            clip_denoised=bool(cfg.get("clip_denoised", True)),
            out_channels=self.base_out,
            patch_params=cfg.get("split_input_params"),
        )

    def load_flax_params(self, tree: Mapping) -> None:
        """Load a Flax param tree (nested dicts of numpy arrays) through the
        layout bridge; raises on any missing or unused key."""
        self.model.load_state_dict(flax_to_state_dict(tree, self.model))
