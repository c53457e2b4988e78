"""The Gaussian diffusion process: sampling moments and training losses.

Port of the JAX package's ``core/process.py:55-355`` (``prior_bpd`` comes
with the evaluation tools, ROADMAP A17b). Every per-timestep coefficient is a
gather from a [T] table of the schedule; ``t`` is a [B] integer tensor.
Images are NHWC, so a learned-sigma output splits on the trailing channel
axis.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from .losses import (
    charbonnier,
    discretized_gaussian_log_likelihood,
    mean_flat,
    normal_kl,
)
from .schedules import DiffusionSchedule

__all__ = [
    "extract",
    "model_timestep",
    "q_mean_variance",
    "q_sample",
    "q_posterior_mean_variance",
    "predict_x0_from_eps",
    "predict_eps_from_x0",
    "predict_x0_from_v",
    "predict_eps_from_v",
    "get_v",
    "split_model_output",
    "learned_log_variance",
    "PMeanVariance",
    "p_mean_variance",
    "vb_terms_bpd",
    "training_losses",
    "lvlb_weights",
]


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather ``table[t]`` and reshape to [B, 1, 1, ...] for broadcasting."""
    out = table[t].float()
    return out.reshape(out.shape[0], *([1] * (ndim - 1)))


def model_timestep(sched: DiffusionSchedule, t: torch.Tensor) -> torch.Tensor:
    """Map re-spaced step index -> model timestep (float, rescaled)."""
    return sched.timestep_map[t].float() * sched.rescale_factor


def q_mean_variance(sched: DiffusionSchedule, x0, t):
    """Moments of q(x_t | x_0)."""
    nd = x0.ndim
    mean = extract(sched.sqrt_alphas_cumprod, t, nd) * x0
    variance = extract(1.0 - sched.alphas_cumprod, t, nd)
    log_variance = extract(sched.log_one_minus_alphas_cumprod, t, nd)
    return mean, variance, log_variance


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


def get_v(sched: DiffusionSchedule, x0, noise, t):
    """Target of the v-parameterization."""
    nd = x0.ndim
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * noise
        - extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * x0
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


def vb_terms_bpd(
    sched: DiffusionSchedule,
    model_output: torch.Tensor,
    x0: torch.Tensor,
    xt: torch.Tensor,
    t: torch.Tensor,
    parameterization: str = "eps",
    learn_sigma: bool = False,
    clip_denoised: bool = True,
):
    """KL(q(x_{t-1}|x_t,x_0) || p(x_{t-1}|x_t)) in bits, with the t=0
    discretized decoder NLL. Returns ([B] terms, pred_x0)."""
    true_mean, _, true_logvar = q_posterior_mean_variance(sched, x0, xt, t)
    out = p_mean_variance(
        sched, model_output, xt, t, parameterization, learn_sigma, clip_denoised
    )
    kl = normal_kl(true_mean, true_logvar, out.mean, out.log_variance)
    kl = mean_flat(kl) / math.log(2.0)
    decoder_nll = -discretized_gaussian_log_likelihood(
        x0, means=out.mean, log_scales=0.5 * out.log_variance
    )
    decoder_nll = mean_flat(decoder_nll) / math.log(2.0)
    return torch.where(t == 0, decoder_nll, kl), out.pred_x0


def training_losses(
    sched: DiffusionSchedule,
    model_fn: Callable[..., Any],
    x0: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    model_kwargs: dict | None = None,
    parameterization: str = "v",
    loss_type: str = "charbonnier",
    learn_sigma: bool = False,
    vlb_weight: float = 1.0,
    charbonnier_eps: float = 1e-3,
    elbo_weight: float = 0.0,
):
    """Per-batch-element diffusion training loss.

    ``model_fn(x_t, t_model, **model_kwargs)`` returns an output or an
    ``(output, aux)`` tuple; aux (the feature dict) is passed through.
    loss_type: 'l2' | 'mse' | 'rescaled_mse' | 'l1' | 'charbonnier'. With
    ``learn_sigma`` the VB term is computed on the detached mean half and the
    live variance half, scaled by ``num_timesteps / 1000 * vlb_weight``.
    Returns (terms: dict of [B] tensors, aux).
    """
    model_kwargs = model_kwargs or {}
    xt = q_sample(sched, x0, t, noise)
    raw = model_fn(xt, model_timestep(sched, t), **model_kwargs)
    if isinstance(raw, tuple):
        model_output, aux = raw
    else:
        model_output, aux = raw, None

    terms: dict[str, torch.Tensor] = {}
    C = x0.shape[-1]
    if learn_sigma:
        pred, var_values = split_model_output(model_output, C)
        # the VB term trains the variance only: the mean half is frozen
        frozen = torch.cat([pred.detach(), var_values], dim=-1)
        vb, _ = vb_terms_bpd(
            sched, frozen, x0, xt, t, parameterization, learn_sigma=True
        )
        terms["vb"] = vb * (sched.num_timesteps / 1000.0) * vlb_weight
    else:
        pred = model_output

    if parameterization == "eps":
        target = noise
    elif parameterization == "x0":
        target = x0
    elif parameterization == "v":
        target = get_v(sched, x0, noise, t)
    else:
        raise ValueError(f"unknown parameterization {parameterization}")

    if loss_type in ("l2", "mse", "rescaled_mse"):
        terms["mse"] = mean_flat((target - pred) ** 2)
    elif loss_type == "l1":
        terms["mse"] = mean_flat(torch.abs(target - pred))
    elif loss_type == "charbonnier":
        terms["mse"] = mean_flat(charbonnier(pred, target, charbonnier_eps))
    else:
        raise ValueError(f"unknown loss_type {loss_type}")

    if elbo_weight > 0:
        lvlb_w = lvlb_weights(sched, parameterization)[t]
        terms["elbo"] = elbo_weight * lvlb_w * terms["mse"]
    loss = terms["mse"]
    for extra in ("vb", "elbo"):
        if extra in terms:
            loss = loss + terms[extra]
    terms["loss"] = loss
    return terms, aux


def lvlb_weights(sched: DiffusionSchedule,
                 parameterization: str = "eps") -> torch.Tensor:
    """Per-timestep VLB weights: for eps, beta^2 / (2 post_var alpha
    (1-acp)); for v, ones; t=0 copied from t=1."""
    if parameterization == "v":
        return torch.ones_like(sched.betas)
    alphas = 1.0 - sched.betas
    w = sched.betas**2 / (
        2.0 * sched.posterior_variance * alphas * (1.0 - sched.alphas_cumprod)
    )
    w[0] = w[1]
    return w
