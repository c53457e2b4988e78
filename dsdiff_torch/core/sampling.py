"""Reverse-diffusion samplers: classifier-free guidance, ancestral DDPM,
DDIM and its inversion, DPM-Solver++(2M), PLMS and dynamic thresholding.

Port of the JAX package's ``core/sampling.py``. The JAX package compiles
each chain into one ``lax.scan``; here it is a Python loop over steps, one
denoiser call each (PLMS calls it twice at its first step). Per-step
coefficients come from [T] tables computed on the host in float64 and
stored as float32 tensors, as in the JAX package, and the per-step scalar
arithmetic stays in float32 on the device.

A stochastic loop draws its per-step noise from ``generator``, or takes it
in order from ``noise`` (one tensor per step), so that a test can replay
another framework's draws.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from . import process
from .schedules import DiffusionSchedule

__all__ = [
    "DenoiseFn",
    "cfg_wrap",
    "p_sample_loop",
    "ddim_sample_loop",
    "dpmpp_2m_sample_loop",
    "ddim_reverse_loop",
    "plms_sample_loop",
    "dynamic_threshold",
    "make_sampler",
]

# denoise_fn(x_t [B,H,W,C], t_model [B] float) -> raw model output
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def cfg_wrap(
    cond_fn: DenoiseFn, uncond_fn: DenoiseFn, guidance_scale: float
) -> DenoiseFn:
    """Classifier-free guidance: eps = u + s * (c - u)."""

    def fn(x, t):
        c = cond_fn(x, t)
        u = uncond_fn(x, t)
        return u + guidance_scale * (c - u)

    return fn


def _steps(x: torch.Tensor, t: int) -> torch.Tensor:
    """Step index ``t`` for every batch element of ``x``."""
    return torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)


def _model_pred(sched, denoise_fn, x, tb, parameterization, learn_sigma,
                clip_denoised, variance_type="fixed_small"):
    """One denoiser call -> the p_mean_variance moments at steps ``tb``."""
    out = denoise_fn(x, process.model_timestep(sched, tb))
    return process.p_mean_variance(
        sched, out, x, tb, parameterization, learn_sigma, clip_denoised,
        variance_type=variance_type,
    )


def _f32_tables(sched: DiffusionSchedule, *tables):
    dev = sched.betas.device
    return tuple(torch.as_tensor(np.asarray(x, np.float32), device=dev)
                 for x in tables)


def _acp64(table: torch.Tensor) -> np.ndarray:
    return table.cpu().numpy().astype(np.float64)


def _noise_source(generator, noise, what: str):
    """``draw(i, x)``: the noise of step ``i``, shaped like ``x``."""
    if generator is None and noise is None:
        raise ValueError(f"{what} needs a generator or a list of noise tensors")

    def draw(i, x):
        if noise is not None:
            return noise[i]
        return torch.randn(x.shape, generator=generator, dtype=x.dtype,
                           device=x.device)

    return draw


def p_sample_loop(
    sched: DiffusionSchedule,
    denoise_fn: DenoiseFn,
    x_T: torch.Tensor,
    generator: torch.Generator | None = None,
    parameterization: str = "eps",
    learn_sigma: bool = False,
    clip_denoised: bool = True,
    collect_x0: bool = False,
    variance_type: str = "fixed_small",
    guidance_fn: DenoiseFn | None = None,
    noise: Sequence[torch.Tensor] | None = None,
):
    """Ancestral DDPM sampling: ``x = mean + [t != 0] * exp(logvar / 2) * z``
    at every step of ``sched``, from its last to step 0.

    ``guidance_fn(x, t_model) -> grad log p(y|x)`` enables classifier
    guidance: ``mean += variance * grad``. Noise is drawn at every step
    (step 0's is multiplied by zero), so ``noise`` holds one tensor per step.
    Returns x_0, or ``(x_0, x0s)`` with ``collect_x0``.
    """
    T = sched.num_timesteps
    draw = _noise_source(generator, noise, "ancestral sampling")
    x = x_T
    x0s = []
    for i in range(T):
        t = T - 1 - i
        tb = _steps(x, t)
        pmv = _model_pred(
            sched, denoise_fn, x, tb, parameterization, learn_sigma,
            clip_denoised, variance_type,
        )
        mean = pmv.mean
        if guidance_fn is not None:
            grad = guidance_fn(x, process.model_timestep(sched, tb))
            mean = mean + pmv.variance * grad
        z = draw(i, x)
        if collect_x0:
            x0s.append(pmv.pred_x0)
        x = mean + float(t != 0) * torch.exp(0.5 * pmv.log_variance) * z
    return (x, torch.stack(x0s)) if collect_x0 else x


def _ddim_tables(sched: DiffusionSchedule, eta: float):
    """Per-step DDIM coefficients over the (already re-spaced) schedule."""
    acp = _acp64(sched.alphas_cumprod)
    acp_prev = _acp64(sched.alphas_cumprod_prev)
    sigma = eta * np.sqrt((1 - acp_prev) / (1 - acp)) * np.sqrt(1 - acp / acp_prev)
    dir_coef = np.sqrt(np.clip(1.0 - acp_prev - sigma**2, 0.0, None))
    return _f32_tables(sched, np.sqrt(acp_prev), dir_coef, sigma)


def ddim_sample_loop(
    sched: DiffusionSchedule,
    denoise_fn: DenoiseFn,
    x_T: torch.Tensor,
    generator: torch.Generator | None = None,
    parameterization: str = "eps",
    learn_sigma: bool = False,
    clip_denoised: bool = True,
    eta: float = 0.0,
    collect_x0: bool = False,
    noise: Sequence[torch.Tensor] | None = None,
    guidance_fn: DenoiseFn | None = None,
):
    """DDIM (eq. 12) over a re-spaced schedule (``schedules.respace``).

    ``eta > 0`` adds per-step noise, drawn from ``generator`` or taken in
    order from ``noise`` (one tensor per step, for tests).
    ``guidance_fn(x, t_model) -> grad log p(y|x)`` applies classifier
    guidance as the score: ``eps' = eps - sqrt(1 - acp_t) * grad``, with
    pred_x0 re-derived from eps' (and clipped with ``clip_denoised``). Build
    the gradient with ``models.encoder_unet.classifier_gradient``.
    Returns x_0, or ``(x_0, x0s)`` with ``collect_x0`` where x0s stacks the
    per-step pred_x0 as [T, ...].
    """
    T = sched.num_timesteps
    sqrt_acp_prev, dir_coef, sigma_t = _ddim_tables(sched, eta)
    stochastic = eta != 0.0
    draw = _noise_source(generator, noise, "eta > 0") if stochastic else None
    x = x_T
    x0s = []
    for i in range(T):
        t = T - 1 - i
        tb = _steps(x, t)
        pmv = _model_pred(
            sched, denoise_fn, x, tb, parameterization, learn_sigma,
            clip_denoised,
        )
        if guidance_fn is not None:
            grad = guidance_fn(x, process.model_timestep(sched, tb))
            eps = pmv.eps - torch.sqrt(1.0 - sched.alphas_cumprod[t]) * grad
            pred_x0 = process.predict_x0_from_eps(sched, x, tb, eps)
            if clip_denoised:
                pred_x0 = pred_x0.clamp(-1.0, 1.0)
            pmv = pmv._replace(eps=eps, pred_x0=pred_x0)
        eps_used = pmv.eps
        if clip_denoised:
            # eps re-derived from the CLIPPED pred_x0, so the update stays
            # consistent where the clip binds
            eps_used = process.predict_eps_from_x0(sched, x, tb, pmv.pred_x0)
        x_next = sqrt_acp_prev[t] * pmv.pred_x0 + dir_coef[t] * eps_used
        if stochastic:
            x_next = x_next + float(t != 0) * sigma_t[t] * draw(i, x)
        if collect_x0:
            x0s.append(pmv.pred_x0)
        x = x_next
    return (x, torch.stack(x0s)) if collect_x0 else x


def ddim_reverse_loop(
    sched: DiffusionSchedule,
    denoise_fn: DenoiseFn,
    x_0: torch.Tensor,
    parameterization: str = "eps",
    learn_sigma: bool = False,
    clip_denoised: bool = False,
):
    """Deterministic DDIM inversion x_0 -> x_T: at each step, from 0 up, eps
    is re-applied with the *next* alpha bar."""
    acp_next = sched.alphas_cumprod_next
    x = x_0
    for t in range(sched.num_timesteps):
        pmv = _model_pred(
            sched, denoise_fn, x, _steps(x, t), parameterization,
            learn_sigma, clip_denoised,
        )
        x = (
            torch.sqrt(acp_next[t]) * pmv.pred_x0
            + torch.sqrt(1.0 - acp_next[t]) * pmv.eps
        )
    return x


def _dpmpp_tables(sched: DiffusionSchedule):
    """alpha/sigma/lambda tables over the re-spaced steps, ordered from
    t=T-1 down to t=0 as the loop visits them, plus h[i] = lam[i+1] - lam[i]
    per update step."""
    acp_vis = _acp64(sched.alphas_cumprod)[::-1]
    alpha = np.sqrt(acp_vis)
    sigma = np.sqrt(1.0 - acp_vis)
    lam = np.log(alpha) - np.log(sigma)
    return _f32_tables(sched, alpha, sigma, lam, np.diff(lam))


def dpmpp_2m_sample_loop(
    sched: DiffusionSchedule,
    denoise_fn: DenoiseFn,
    x_T: torch.Tensor,
    parameterization: str = "eps",
    learn_sigma: bool = False,
    clip_denoised: bool = True,
):
    """DPM-Solver++(2M), data-prediction multistep order 2 (Lu et al. 2022):

        r_i = h_{i-1} / h_i
        D_i = (1 + 1/(2 r_i)) x0_i - 1/(2 r_i) x0_{i-1}
        x_{i+1} = (sigma_{i+1}/sigma_i) x_i - alpha_{i+1} (e^{-h_i} - 1) D_i

    The first step is first order (D_0 = x0_0). The last visit (t = 0) has
    no further step: T-1 updates, then a plain denoise to pred_x0. T model
    calls for T steps.
    """
    T = sched.num_timesteps
    alpha_v, sigma_v, _, h_v = _dpmpp_tables(sched)
    x = x_T
    prev_x0 = None
    prev_h = torch.ones((), device=x.device)
    for i in range(T - 1):
        # visit i is schedule index t = T-1-i; the update moves to t-1
        pmv = _model_pred(
            sched, denoise_fn, x, _steps(x, T - 1 - i), parameterization,
            learn_sigma, clip_denoised,
        )
        x0 = pmv.pred_x0
        h = h_v[i]
        if i == 0:
            D = x0
        else:
            r = prev_h / h
            D = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * prev_x0
        x = (sigma_v[i + 1] / sigma_v[i]) * x - alpha_v[i + 1] * (
            torch.exp(-h) - 1.0
        ) * D
        prev_x0, prev_h = x0, h
    pmv = _model_pred(
        sched, denoise_fn, x, _steps(x, 0), parameterization, learn_sigma,
        clip_denoised,
    )
    return pmv.pred_x0


def dynamic_threshold(x0: torch.Tensor, ratio: float = 0.995,
                      max_value: float = 1.0) -> torch.Tensor:
    """Imagen-style dynamic thresholding of the x0 prediction: per sample
    s = max(quantile(|x0|, ratio), max_value) (linear interpolation, f32);
    clip to [-s, s] and rescale to ``max_value``. Use as ``denoised_fn``
    with clip_denoised=False."""
    B = x0.shape[0]
    flat = x0.float().abs().reshape(B, -1)
    s = torch.quantile(flat, ratio, dim=1)
    s = torch.clamp(s, min=max_value).reshape(B, *([1] * (x0.ndim - 1)))
    return torch.clamp(x0, -s, s) / s * max_value


def plms_sample_loop(
    sched: DiffusionSchedule,
    denoise_fn: DenoiseFn,
    x_T: torch.Tensor,
    parameterization: str = "eps",
    learn_sigma: bool = False,
    clip_denoised: bool = True,
):
    """PLMS (pseudo linear multistep, Liu et al. 2022): 4th-order
    Adams-Bashforth over eps predictions, with the pseudo-improved-Euler
    first step (a second model call at the guessed next point) and 2nd /
    3rd-order formulas while the history fills. T + 1 model calls for T
    steps. The history starts as copies of the first step's first eps,
    count 1."""
    T = sched.num_timesteps
    sqrt_acp_prev, dir_coef, _ = _ddim_tables(sched, eta=0.0)

    def x_prev_from_eps(x, t, eps):
        """DDIM eta=0 update using a given eps."""
        tb = _steps(x, t)
        x0 = process.predict_x0_from_eps(sched, x, tb, eps)
        if clip_denoised:
            x0 = torch.clamp(x0, -1.0, 1.0)
            eps = process.predict_eps_from_x0(sched, x, tb, x0)
        return sqrt_acp_prev[t] * x0 + dir_coef[t] * eps

    def eps_at(x, t):
        return _model_pred(sched, denoise_fn, x, _steps(x, t),
                           parameterization, learn_sigma, clip_denoised).eps

    # first step: pseudo improved Euler
    t0 = T - 1
    e_t = eps_at(x_T, t0)
    x_prev_guess = x_prev_from_eps(x_T, t0, e_t)
    e_t_next = eps_at(x_prev_guess, max(t0 - 1, 0))
    x = x_prev_from_eps(x_T, t0, (e_t + e_t_next) / 2.0)
    hist = [e_t, e_t, e_t]  # most recent first
    n = 1
    for t in range(T - 2, -1, -1):
        e_t = eps_at(x, t)
        if n >= 3:
            e_prime = (55.0 * e_t - 59.0 * hist[0] + 37.0 * hist[1]
                       - 9.0 * hist[2]) / 24.0
        elif n == 2:
            e_prime = (23.0 * e_t - 16.0 * hist[0] + 5.0 * hist[1]) / 12.0
        else:
            e_prime = (3.0 * e_t - hist[0]) / 2.0
        x = x_prev_from_eps(x, t, e_prime)
        hist = [e_t, hist[0], hist[1]]
        n = min(n + 1, 3)
    return x


# keyed like ``sampler_setting.sampler``
SAMPLERS = {
    "ddim": ddim_sample_loop,
    "plms": plms_sample_loop,
    "dpm++": dpmpp_2m_sample_loop,
    "dpm_solver++": dpmpp_2m_sample_loop,
    "ancestral": p_sample_loop,
    "ddpm": p_sample_loop,
}


def make_sampler(name: str):
    """Sampler registry keyed like ``sampler_setting.sampler``
    ('ddim' | 'plms' | 'dpm++' | 'ancestral'/'ddpm')."""
    if name not in SAMPLERS:
        raise ValueError(f"unknown sampler '{name}' (have {sorted(SAMPLERS)})")
    return SAMPLERS[name]
