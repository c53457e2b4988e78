"""Task knobs, the concat-conditioned denoiser and the sample function.

Port of the JAX package's ``train/step.py``: ``TaskConfig``, ``_denoiser`` and the
ddim branch of ``make_sample_fn``. The train step and validation metrics
come with the training slice (ROADMAP A7, A8); the other samplers with A12;
split-input (patched) sampling with A17.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from ..core import sampling
from ..core.schedules import DiffusionSchedule

__all__ = ["TaskConfig", "make_sample_fn"]


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    """Static per-run knobs."""

    parameterization: str = "v"
    loss_type: str = "charbonnier"
    learn_sigma: bool = False
    # ancestral-sampling variance when learn_sigma is False: 'fixed_small'
    # or 'fixed_large'
    variance_type: str = "fixed_small"
    vlb_weight: float = 1.0
    # 'ds' (C-S + S-A-L), 'disc' (com/dist), or None
    feature_kind: str | None = None
    disentangle_mode: str = "eu"  # eu | contrast | eu&contrast
    disen_lambda: float = 0.5
    disen_temperature: float = 0.05
    elbo_lambda: float = 0.0
    # classifier-free guidance: train-time condition dropout probability and
    # inference guidance scale (1.0 = no guidance)
    cond_dropout: float = 0.0
    cfg_scale: float = 1.0


def _denoiser(model: nn.Module, cond: torch.Tensor | None):
    """concat-conditioned denoiser closure: (x_t, t_model) -> raw output."""

    def fn(x, t_model):
        xin = x if cond is None else torch.cat([x, cond], dim=-1)
        return model(xin, t_model)

    return fn


def make_sample_fn(
    model: nn.Module,
    sched: DiffusionSchedule,
    task: TaskConfig,
    sampler: str = "ddim",
    eta: float = 0.0,
    clip_denoised: bool = True,
    out_channels: int = 1,
    patch_params: dict | None = None,
) -> Callable:
    """Returns ``fn(cond, generator=None, x_T=None) -> samples [B, H, W, C]``.

    ``sched`` is already re-spaced to the inference step count. ``x_T`` is
    drawn from ``generator`` unless given; with ``eta > 0`` the per-step
    noise is drawn from ``generator`` too.
    """
    if sampler != "ddim":
        raise NotImplementedError(
            f"sampler '{sampler}' is not ported yet (ROADMAP A12)"
        )
    if patch_params:
        raise NotImplementedError(
            "split-input (patched) sampling is not ported yet (ROADMAP A17)"
        )

    @torch.inference_mode()
    def fn(cond: torch.Tensor, generator: torch.Generator | None = None,
           x_T: torch.Tensor | None = None) -> torch.Tensor:
        B, H, W, _ = cond.shape
        if x_T is None:
            x_T = torch.randn((B, H, W, out_channels), generator=generator,
                              dtype=torch.float32, device=cond.device)

        def make_denoise(c):
            raw = _denoiser(model, c)

            def denoise(x, t_model):
                out = raw(x, t_model)
                # feature models (DSUNet) yield (out, features)
                return out[0] if isinstance(out, tuple) else out

            return denoise

        denoise = make_denoise(cond)
        if task.cfg_scale != 1.0:
            denoise = sampling.cfg_wrap(
                denoise, make_denoise(torch.zeros_like(cond)), task.cfg_scale
            )
        return sampling.ddim_sample_loop(
            sched, denoise, x_T, generator, eta=eta,
            parameterization=task.parameterization,
            learn_sigma=task.learn_sigma,
            clip_denoised=clip_denoised,
        )

    return fn
