"""Reverse-diffusion samplers: classifier-free guidance and DDIM.

Port of the JAX package's ``core/sampling.py:43-202``. The JAX package compiles the
chain into one ``lax.scan``; here it is a Python loop over steps, one
denoiser call each. Per-step coefficients come from [T] tables computed on
the host in float64 and stored as float32 tensors, as in the JAX package.
The other samplers come with a later slice (ROADMAP A12).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from . import process
from .schedules import DiffusionSchedule

__all__ = ["DenoiseFn", "cfg_wrap", "ddim_sample_loop"]

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


def _model_pred(sched, denoise_fn, x, tb, parameterization, learn_sigma,
                clip_denoised):
    """One denoiser call -> the p_mean_variance moments at steps ``tb``."""
    out = denoise_fn(x, process.model_timestep(sched, tb))
    return process.p_mean_variance(
        sched, out, x, tb, parameterization, learn_sigma, clip_denoised
    )


def _ddim_tables(sched: DiffusionSchedule, eta: float):
    """Per-step DDIM coefficients over the (already re-spaced) schedule."""
    acp = sched.alphas_cumprod.cpu().numpy().astype(np.float64)
    acp_prev = sched.alphas_cumprod_prev.cpu().numpy().astype(np.float64)
    sigma = eta * np.sqrt((1 - acp_prev) / (1 - acp)) * np.sqrt(1 - acp / acp_prev)
    dir_coef = np.sqrt(np.clip(1.0 - acp_prev - sigma**2, 0.0, None))
    dev = sched.betas.device

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return f32(np.sqrt(acp_prev)), f32(dir_coef), f32(sigma)


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
):
    """DDIM (eq. 12) over a re-spaced schedule (``schedules.respace``).

    ``eta > 0`` adds per-step noise, drawn from ``generator`` or taken in
    order from ``noise`` (one tensor per step, for tests).
    Classifier guidance (``guidance_fn``) comes with ROADMAP A17.
    Returns x_0, or ``(x_0, x0s)`` with ``collect_x0`` where x0s stacks the
    per-step pred_x0 as [T, ...].
    """
    T = sched.num_timesteps
    sqrt_acp_prev, dir_coef, sigma_t = _ddim_tables(sched, eta)
    stochastic = eta != 0.0
    if stochastic and generator is None and noise is None:
        raise ValueError("eta > 0 needs a generator or a list of noise tensors")
    x = x_T
    x0s = []
    for i in range(T):
        t = T - 1 - i
        tb = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        pmv = _model_pred(
            sched, denoise_fn, x, tb, parameterization, learn_sigma,
            clip_denoised,
        )
        eps_used = pmv.eps
        if clip_denoised:
            # eps re-derived from the CLIPPED pred_x0, so the update stays
            # consistent where the clip binds
            eps_used = process.predict_eps_from_x0(sched, x, tb, pmv.pred_x0)
        x_next = sqrt_acp_prev[t] * pmv.pred_x0 + dir_coef[t] * eps_used
        if stochastic:
            if noise is not None:
                z = noise[i]
            else:
                z = torch.randn(x.shape, generator=generator,
                                dtype=x.dtype, device=x.device)
            x_next = x_next + float(t != 0) * sigma_t[t] * z
        if collect_x0:
            x0s.append(pmv.pred_x0)
        x = x_next
    return (x, torch.stack(x0s)) if collect_x0 else x
