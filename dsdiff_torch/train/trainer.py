"""The trainer: config -> schedule -> model -> train step and samplers.

Port of the JAX package's ``train/trainer.py`` ``Trainer`` without its data,
mesh and logging parts: the net_mode / schedule / variance defaults,
``TaskConfig``, the model build (bf16 compute over f32 master parameters,
``remat``; ``ds_diff_gaussian`` and the cached-condition ``ds_diff_split``),
the cosine learning rate, AdamW, the EMA, the schedule sampler, the train
step, every sampler over the EMA weights (``set_sampler`` switches on a live
trainer), ``progressive_denoise`` and the validation metrics. ``fit``,
``validate``, ``predict``, checkpoints and the data pipeline come with later
slices (ROADMAP A13, A14): batches are fed to ``train_step`` from memory.
"""
from __future__ import annotations

import copy
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from ..core import sampling, schedules
from ..models import build_model, make_cached_denoiser
from ..models.layers import hold_in_compute_dtype
from ..utils.device import resolve_device
from ..utils.flax_bridge import flax_to_state_dict, train_state_from_flax
from . import schedule_sampler as ss
from .config import Config
from .state import TrainState, cosine_lr, make_optimizer
from .step import (
    TaskConfig,
    draw_x_T,
    make_sample_fn,
    make_train_step,
    make_val_metrics,
    run_sampler_loop,
)

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
    """Builds the schedule, model, train state and samplers from a run
    config. ``device`` defaults to ``"cuda"``.

    - ``train_step(batch, generator=None, t=None, noise=None)`` takes one
      optimizer step on an NHWC batch ``{"target": [B,H,W,1], "image":
      [B,H,W,n_cond]}`` and returns the metrics (0-d tensors).
    - ``sample_fn(cond [B,H,W,n_cond], generator=None, x_T=None,
      noise=None)`` returns samples [B, H, W, output_ch] from the EMA
      weights, through a serving copy of the model whose weights are held
      in the compute dtype and refreshed from the EMA when it has changed.
      The sampler comes from ``sampler_setting`` (``sampler``,
      ``sample_steps``, ``ddim_eta``, and for the DPM-Solver family
      ``order``, ``method``, ``skip_type``, ``algorithm_type``);
      ``set_sampler`` changes it. ``ds_diff_split`` serves through the
      cached-condition sampler unless ``cached_cond_sampling`` is false.
    - ``progressive_denoise(cond, generator=None, x_T=None)``: DDIM with
      every step's x0 prediction kept.
    - ``val_metrics(pred, target, valid=None)``: SSIM, MAE, PSNR.
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
        # bf16 compute over f32 master parameters; GroupNorm in f32
        dtype = torch.bfloat16 if cfg.get("bf16", True) else torch.float32
        if model_name in ("dsunet", "dsunet_split"):
            model_params.setdefault("model_channels", 96)
            model_params.setdefault("use_edge", bool(self.use_edge))
        seed = int(cfg.get("seed", 2024))
        # modules initialise on the CPU from its default generator: seed it
        # for this build only
        with torch.random.fork_rng(devices=[]):
            torch.default_generator.manual_seed(seed)
            self.model = build_model(
                model_name, device=self.device, in_channels=in_ch,
                out_channels=out_ch, dtype=dtype,
                remat=bool(cfg.get("remat", False)), **model_params,
            )
        self.in_ch = in_ch
        self.n_cond = n_cond
        self.model_name = model_name
        self.n_params = sum(p.numel() for p in self.model.parameters())

        # ---- optimizer, EMA, schedule sampler (no loader yet: 1000 steps
        # per epoch, as the JAX trainer assumes without one)
        steps_per_epoch = 1000
        lr = cosine_lr(
            float(cfg.get("lr", 1e-4)),
            int(cfg.get("num_epochs", 250)) * steps_per_epoch,
            warmup_steps=int(cfg.get("lr_warm_epoch", 0)) * steps_per_epoch,
            min_lr=float(cfg.get("lr_low", 1e-7)),
        )
        grad_clip = cfg.get("grad_clip", None)
        opt = dict(
            weight_decay=float(cfg.get("weight_decay", 0.0)),
            betas=(float(cfg.get("beta1", 0.9)), float(cfg.get("beta2", 0.999))),
            grad_clip=float(grad_clip) if grad_clip else None,
            accum_steps=int(cfg.get("accum_steps", 1)),
        )
        self.state = TrainState(
            self.model, lambda params: make_optimizer(params, lr, **opt),
            ema_decay=float(cfg.get("ema_rate", 0.9999)),
        )
        self.sampler_state = ss.make_schedule_sampler(
            cfg.get("schedule_sampler", "uniform"), T, device=self.device
        )
        self._train_step = make_train_step(self.task, self.sched)
        self.val_metrics = make_val_metrics()

        # ---- samplers over the EMA weights
        samp = cfg.get("sampler_setting", {}) or {}
        self.sample_steps = int(samp.get("sample_steps", 20))
        self.sampler_name = samp.get("sampler", "ddim")
        self.eta = float(samp.get("ddim_eta", 0.0))
        # the serving copy: compute-dtype weights, filled from the EMA
        self.sample_model = hold_in_compute_dtype(
            copy.deepcopy(self.model).requires_grad_(False)
        ).eval()
        self._sample_version = None
        if bool(samp.get("ddim_use_original_steps", False)):
            self.rsched = self.sched
        else:
            self.rsched = self._respaced()
        self._build_sampler(
            model_name == "dsunet_split"
            and bool(cfg.get("cached_cond_sampling", True)), {}
        )

    def _respaced(self) -> schedules.DiffusionSchedule:
        return schedules.respace(
            self.betas,
            schedules.space_timesteps(len(self.betas), str(self.sample_steps)),
            rescale_timesteps=bool(self.cfg.get("rescale_timesteps", False)),
            device=self.device,
        )

    def _build_sampler(self, cached: bool, solver_options: dict) -> None:
        """(Re)build ``_sample`` over ``rsched`` from the current sampler
        name, step count and eta; the progressive-denoise loop follows."""
        if cached:
            self._sample = self._make_cached_sample_fn(self.rsched)
        else:
            samp = self.cfg.get("sampler_setting", {}) or {}
            opts = {k: samp[k] for k in
                    ("order", "method", "skip_type", "algorithm_type")
                    if k in samp}
            opts.update(solver_options)
            self._sample = make_sample_fn(
                self.sample_model, self.rsched, self.task, self.sampler_name,
                self.eta,
                clip_denoised=bool(self.cfg.get("clip_denoised", True)),
                out_channels=self.base_out,
                full_sched=self.sched,
                sample_steps=self.sample_steps,
                solver_options=opts,
                patch_params=self.cfg.get("split_input_params"),
            )
        self._row_fn = self._make_denoise_row_fn()

    def set_sampler(self, sampler: str | None = None,
                    sample_steps: int | None = None,
                    ddim_eta: float | None = None,
                    cached: bool | None = None,
                    int8: bool | str | None = None,
                    **solver_options) -> None:
        """Rebuild the sampling path with new settings on a live trainer:
        evaluate ONE set of weights under ddim-50 / dpm-20 / cached-cond
        without building the trainer again. Arguments left ``None`` keep
        their value; ``cached`` defaults to the model's own kind (cached
        for ``ds_diff_split``). ``solver_options`` (order, method,
        skip_type, algorithm_type, ...) go to the DPM-Solver family on top
        of ``sampler_setting``'s."""
        if int8 is not None:
            raise NotImplementedError(
                "int8 serving is not ported yet (ROADMAP A16)"
            )
        if sampler is not None:
            self.sampler_name = sampler
        if sample_steps is not None:
            self.sample_steps = int(sample_steps)
        if ddim_eta is not None:
            self.eta = float(ddim_eta)
        self.rsched = self._respaced()
        # only the split model has a cache to serve from
        use_cached = self.model_name == "dsunet_split" and (
            cached is None or bool(cached))
        self._build_sampler(use_cached, solver_options)

    def _make_cached_sample_fn(self, rsched):
        """DSUNetSplit: the condition encoders run once per sample call
        (``models/dsunet_cached.py``); a step is the noise encoder and the
        trunk. Serves 'dpm++' / 'dpm_solver++', 'plms', 'ancestral' /
        'ddpm', and DDIM for any other sampler name, as the JAX package
        does."""
        model = self.sample_model
        task = self.task
        eta = self.eta
        clip = bool(self.cfg.get("clip_denoised", True))
        out_ch = self.base_out
        loop = sampling.SAMPLERS.get(self.sampler_name,
                                     sampling.ddim_sample_loop)

        @torch.inference_mode()
        def fn(cond, generator=None, x_T=None, noise=None):
            denoise = make_cached_denoiser(model, cond)
            if x_T is None:
                x_T = draw_x_T(cond, out_ch, generator)
            return run_sampler_loop(loop, rsched, denoise, x_T, task, eta,
                                    clip, generator, noise)

        return fn

    def _make_denoise_row_fn(self):
        """DDIM over ``rsched`` that keeps every step's x0 prediction;
        ``None`` for ``ds_diff_split`` (the cached-condition sampler has its
        own closure)."""
        if self.cfg.get("net_mode") == "ds_diff_split":
            return None
        model = self.sample_model
        task = self.task
        rsched = self.rsched
        out_ch = self.base_out
        clip = bool(self.cfg.get("clip_denoised", True))

        @torch.inference_mode()
        def fn(cond, generator=None, x_T=None):
            if x_T is None:
                x_T = draw_x_T(cond, out_ch, generator)

            def denoise(x, t_model):
                out = model(torch.cat([x, cond], dim=-1), t_model)
                return out[0] if isinstance(out, tuple) else out

            _, x0s = sampling.ddim_sample_loop(
                rsched, denoise, x_T,
                parameterization=task.parameterization,
                learn_sigma=task.learn_sigma, clip_denoised=clip,
                collect_x0=True,
            )
            return x0s

        return fn

    def _refresh_sample_model(self) -> None:
        """Bring the serving copy up to the EMA weights if they moved."""
        if self._sample_version != self.state.version:
            with torch.no_grad():
                ema = self.state.ema_state_dict()
                for name, p in self.sample_model.named_parameters():
                    p.copy_(ema[name])
            self._sample_version = self.state.version

    def sample_fn(self, cond: torch.Tensor,
                  generator: torch.Generator | None = None,
                  x_T: torch.Tensor | None = None,
                  noise=None) -> torch.Tensor:
        """Samples [B, H, W, output_ch] from the EMA weights. ``x_T`` and a
        stochastic sampler's per-step ``noise`` (a list, one tensor per
        step) are drawn from ``generator`` unless given."""
        self._refresh_sample_model()
        return self._sample(cond, generator, x_T, noise)

    def progressive_denoise(self, cond: torch.Tensor,
                            generator: torch.Generator | None = None,
                            x_T: torch.Tensor | None = None):
        """Sample by DDIM (eta 0) with the intermediate x0 predictions
        collected along the chain. Returns (final [B,H,W,C], intermediates
        [T,B,H,W,C]); the final is the last intermediate."""
        if self._row_fn is None:
            raise RuntimeError(
                "progressive denoising is unavailable for this net_mode"
            )
        self._refresh_sample_model()
        frames = self._row_fn(cond, generator, x_T)
        return frames[-1], frames

    def train_step(self, batch: Mapping[str, torch.Tensor],
                   generator: torch.Generator | None = None,
                   t: torch.Tensor | None = None,
                   noise: torch.Tensor | None = None) -> dict:
        """One optimizer step; returns the metrics as 0-d f32 tensors."""
        _, self.sampler_state, metrics = self._train_step(
            self.state, self.sampler_state, batch, generator, t, noise
        )
        return metrics

    def reset_state(self) -> None:
        """Restart training from the model's current weights: step 0, fresh
        optimizer moments, EMA = weights. Call it after writing the model's
        parameters directly."""
        self.state.reset()

    def load_flax_params(self, tree: Mapping) -> None:
        """Load a Flax param tree (nested dicts of numpy arrays) through the
        layout bridge and restart the train state from it; raises on any
        missing or unused key."""
        self.model.load_state_dict(flax_to_state_dict(tree, self.model))
        self.reset_state()

    def load_flax_state(self, tree: Mapping, sampler: Mapping | None = None):
        """Continue a run of the JAX package. ``tree`` is the training state
        as ``utils.flax_bridge.train_state_from_flax`` takes it; ``sampler``,
        when given, holds the schedule sampler's ``kind``, ``loss_history``
        and ``loss_counts`` as numpy."""
        self.state.load(**train_state_from_flax(tree, self.model))
        if sampler is not None:
            dev = self.state.ema[0].device
            self.sampler_state = ss.SamplerState(
                str(sampler["kind"]),
                torch.as_tensor(np.asarray(sampler["loss_history"], np.float32),
                                device=dev),
                torch.as_tensor(np.asarray(sampler["loss_counts"], np.int32),
                                device=dev),
            )
