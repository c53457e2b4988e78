"""The Gaussian diffusion process: the sampling half.

Port of the JAX package's ``core/process.py:55-233``. Every per-timestep
coefficient is a gather from a [T] table of the schedule; ``t`` is a [B]
integer tensor. Images are NHWC, so a learned-sigma output splits on the
trailing channel axis. The training losses come with the training slice.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .schedules import DiffusionSchedule

__all__ = [
    "extract",
    "model_timestep",
    "q_sample",
    "q_posterior_mean_variance",
    "predict_x0_from_eps",
    "predict_eps_from_x0",
    "predict_x0_from_v",
    "predict_eps_from_v",
    "split_model_output",
    "learned_log_variance",
    "PMeanVariance",
    "p_mean_variance",
]


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather ``table[t]`` and reshape to [B, 1, 1, ...] for broadcasting."""
    out = table[t].float()
    return out.reshape(out.shape[0], *([1] * (ndim - 1)))


def model_timestep(sched: DiffusionSchedule, t: torch.Tensor) -> torch.Tensor:
    """Map re-spaced step index -> model timestep (float, rescaled)."""
    return sched.timestep_map[t].float() * sched.rescale_factor


def q_sample(sched: DiffusionSchedule, x0, t, noise):
    """Sample x_t ~ q(x_t | x_0)."""
    nd = x0.ndim
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * x0
        + extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * noise
    )


def q_posterior_mean_variance(sched: DiffusionSchedule, x0, xt, t):
    """Moments of q(x_{t-1} | x_t, x_0)."""
    nd = x0.ndim
    mean = (
        extract(sched.posterior_mean_coef1, t, nd) * x0
        + extract(sched.posterior_mean_coef2, t, nd) * xt
    )
    variance = extract(sched.posterior_variance, t, nd)
    log_variance = extract(sched.posterior_log_variance_clipped, t, nd)
    return mean, variance, log_variance


def predict_x0_from_eps(sched: DiffusionSchedule, xt, t, eps):
    nd = xt.ndim
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, nd) * xt
        - extract(sched.sqrt_recipm1_alphas_cumprod, t, nd) * eps
    )


def predict_eps_from_x0(sched: DiffusionSchedule, xt, t, x0):
    nd = xt.ndim
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, nd) * xt - x0
    ) / extract(sched.sqrt_recipm1_alphas_cumprod, t, nd)


def predict_x0_from_v(sched: DiffusionSchedule, xt, t, v):
    """v-parameterization x0 recovery."""
    nd = xt.ndim
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * xt
        - extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * v
    )


def predict_eps_from_v(sched: DiffusionSchedule, xt, t, v):
    nd = xt.ndim
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * v
        + extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * xt
    )


def split_model_output(model_output: torch.Tensor, x_channels: int):
    """Split a learned-sigma NHWC output on the trailing channel axis."""
    return model_output[..., :x_channels], model_output[..., x_channels:]


def learned_log_variance(sched: DiffusionSchedule, var_values, t):
    """Interpolated log-variance for LEARNED_RANGE models: the model emits v
    in [-1, 1], interpolating between the clipped posterior floor and
    log(beta_t)."""
    nd = var_values.ndim
    min_log = extract(sched.posterior_log_variance_clipped, t, nd)
    max_log = torch.log(extract(sched.betas, t, nd))
    frac = (var_values + 1.0) / 2.0
    return frac * max_log + (1.0 - frac) * min_log


class PMeanVariance(NamedTuple):
    mean: torch.Tensor
    variance: torch.Tensor
    log_variance: torch.Tensor
    pred_x0: torch.Tensor
    eps: torch.Tensor


def p_mean_variance(
    sched: DiffusionSchedule,
    model_output: torch.Tensor,
    xt: torch.Tensor,
    t: torch.Tensor,
    parameterization: str = "eps",
    learn_sigma: bool = False,
    clip_denoised: bool = True,
    denoised_fn: Callable | None = None,
    variance_type: str = "fixed_small",
) -> PMeanVariance:
    """p(x_{t-1} | x_t) moments from a raw denoiser output, for eps / x0 / v
    parameterizations and fixed-small, fixed-large or learned-range
    variance (``variance_type`` applies when ``learn_sigma`` is False)."""
    C = xt.shape[-1]
    if learn_sigma:
        pred, var_values = split_model_output(model_output, C)
        log_variance = learned_log_variance(sched, var_values, t)
        variance = torch.exp(log_variance)
    elif variance_type == "fixed_large":
        pred = model_output
        if sched.num_timesteps > 1:
            var_table = torch.cat(
                [sched.posterior_variance[1:2], sched.betas[1:]]
            )
        else:
            var_table = sched.posterior_variance
        variance = extract(var_table, t, xt.ndim)
        log_variance = torch.log(torch.clamp(variance, min=1e-20))
    else:
        pred = model_output
        _, variance, log_variance = q_posterior_mean_variance(sched, xt, xt, t)

    if parameterization == "eps":
        pred_x0 = predict_x0_from_eps(sched, xt, t, pred)
    elif parameterization == "x0":
        pred_x0 = pred
    elif parameterization == "v":
        pred_x0 = predict_x0_from_v(sched, xt, t, pred)
    else:
        raise ValueError(f"unknown parameterization {parameterization}")

    if denoised_fn is not None:
        pred_x0 = denoised_fn(pred_x0)
    if clip_denoised:
        pred_x0 = torch.clamp(pred_x0, -1.0, 1.0)

    mean, _, _ = q_posterior_mean_variance(sched, pred_x0, xt, t)
    eps = predict_eps_from_x0(sched, xt, t, pred_x0)
    return PMeanVariance(mean, variance, log_variance, pred_x0, eps)
