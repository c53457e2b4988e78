"""Palette/SR3-style gamma-conditioned diffusion.

Port of the JAX package's ``core/palette.py``: the model is conditioned on
the noise level gamma_t = prod(alpha) instead of the timestep index, with
separate train and test schedules; ``q_sample`` and the posterior over the
gamma tables; the ancestral loop and DDIM over a uniform or quadratic
subsequence of the test schedule. The JAX package compiles each loop into
one ``lax.scan``; here it is a Python loop, one denoiser call a step.

The denoiser signature is ``model_fn(x_with_cond, gamma [B]) -> eps``; the
condition comes FIRST in the channel stack (``[y_cond, y_t]``), unlike the
other pipelines. Tables are built in float64 numpy and stored as float32
tensors, as in the JAX package. The loops start from ``y_T`` (drawn from
``generator`` when not given) and take their per-step noise from
``generator`` or, in order, from ``noise`` (one tensor per step).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from .schedules import make_beta_schedule

__all__ = [
    "GammaSchedule",
    "q_sample",
    "training_loss",
    "p_sample_loop",
    "ddim_sample_loop",
]


class GammaSchedule(NamedTuple):
    """The gamma tables, [T] float32 tensors on one device."""

    betas: torch.Tensor
    gammas: torch.Tensor
    gammas_prev: torch.Tensor
    sqrt_recip_gammas: torch.Tensor
    sqrt_recipm1_gammas: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @classmethod
    def create(cls, schedule: str = "linear", n_timestep: int = 2000,
               linear_start: float = 1e-6, linear_end: float = 0.01,
               device="cpu") -> "GammaSchedule":
        betas = make_beta_schedule(schedule, n_timestep, linear_start,
                                   linear_end)
        alphas = 1.0 - betas
        gammas = np.cumprod(alphas)
        gammas_prev = np.append(1.0, gammas[:-1])
        post_var = betas * (1.0 - gammas_prev) / (1.0 - gammas)
        dev = resolve_device(device)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        return cls(
            betas=f32(betas),
            gammas=f32(gammas),
            gammas_prev=f32(gammas_prev),
            sqrt_recip_gammas=f32(np.sqrt(1.0 / gammas)),
            sqrt_recipm1_gammas=f32(np.sqrt(1.0 / gammas - 1.0)),
            posterior_log_variance_clipped=f32(
                np.log(np.maximum(post_var, 1e-20))),
            posterior_mean_coef1=f32(
                betas * np.sqrt(gammas_prev) / (1.0 - gammas)),
            posterior_mean_coef2=f32(
                (1.0 - gammas_prev) * np.sqrt(alphas) / (1.0 - gammas)),
        )


def _per_row(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape(-1, *([1] * (ndim - 1)))


def q_sample(gamma: torch.Tensor, y0: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """y_t = sqrt(gamma) y0 + sqrt(1 - gamma) eps, gamma [B]."""
    g = _per_row(gamma, y0.ndim)
    return torch.sqrt(g) * y0 + torch.sqrt(1.0 - g) * noise


def training_loss(sched: GammaSchedule, model_fn: Callable, y0: torch.Tensor,
                  y_cond: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """The gamma-conditioned eps MSE at steps ``t`` [B]; an inpainting
    ``mask`` mixes the known region back in and weights the loss."""
    gamma = sched.gammas[t]
    y_noisy = q_sample(gamma, y0, noise)
    if mask is not None:
        y_in = y_noisy * mask + (1.0 - mask) * y0
        pred = model_fn(torch.cat([y_cond, y_in], dim=-1), gamma)
        return ((mask * (noise - pred)) ** 2).mean()
    pred = model_fn(torch.cat([y_cond, y_noisy], dim=-1), gamma)
    return ((noise - pred) ** 2).mean()


def _predict_x0(sched: GammaSchedule, y_t: torch.Tensor, t: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
    r = _per_row(sched.sqrt_recip_gammas[t], y_t.ndim)
    rm1 = _per_row(sched.sqrt_recipm1_gammas[t], y_t.ndim)
    return r * y_t - rm1 * noise


def _start(y_cond, generator, y_T):
    if y_T is not None:
        return y_T
    return torch.randn(y_cond.shape[:-1] + (1,), generator=generator,
                       dtype=torch.float32, device=y_cond.device)


def _draw(generator, noise, i: int, y: torch.Tensor) -> torch.Tensor:
    if noise is not None:
        return noise[i]
    if generator is None:
        raise ValueError("palette sampling needs a generator or a list of "
                         "noise tensors")
    return torch.randn(y.shape, generator=generator, dtype=y.dtype,
                       device=y.device)


def p_sample_loop(sched: GammaSchedule, model_fn: Callable,
                  y_cond: torch.Tensor,
                  generator: torch.Generator | None = None,
                  clip_denoised: bool = True,
                  y_T: torch.Tensor | None = None,
                  noise: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
    """The ancestral reverse loop over every step of ``sched``: noise is
    drawn at every step (step 0's multiplied by zero), so ``noise`` holds
    ``num_timesteps`` tensors."""
    T = sched.num_timesteps
    y = _start(y_cond, generator, y_T)
    for i in range(T):
        t = T - 1 - i
        tb = torch.full((y.shape[0],), t, dtype=torch.int64, device=y.device)
        eps = model_fn(torch.cat([y_cond, y], dim=-1), sched.gammas[tb])
        x0 = _predict_x0(sched, y, tb, eps)
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
        c1 = _per_row(sched.posterior_mean_coef1[tb], y.ndim)
        c2 = _per_row(sched.posterior_mean_coef2[tb], y.ndim)
        logvar = _per_row(sched.posterior_log_variance_clipped[tb], y.ndim)
        z = _draw(generator, noise, i, y)
        y = c1 * x0 + c2 * y + float(t != 0) * torch.exp(0.5 * logvar) * z
    return y


def ddim_steps_of(num_timesteps: int, ddim_steps: int,
                  method: str = "uniform") -> tuple[np.ndarray, np.ndarray]:
    """The DDIM subsequence of a ``num_timesteps`` schedule and each step's
    previous index, with the reference's +1 shift."""
    T = num_timesteps
    if method == "uniform":
        seq = np.arange(0, T, T // ddim_steps)
    elif method == "quad":
        seq = (np.linspace(0, np.sqrt(T * 0.8), ddim_steps) ** 2).astype(int)
    else:
        raise ValueError(f"unknown ddim discretization '{method}'")
    seq = np.clip(seq + 1, 0, T - 1)
    return seq, np.append([0], seq[:-1])


def ddim_sample_loop(sched: GammaSchedule, model_fn: Callable,
                     y_cond: torch.Tensor,
                     generator: torch.Generator | None = None,
                     ddim_steps: int = 50, eta: float = 0.0,
                     method: str = "uniform", clip_denoised: bool = True,
                     y_T: torch.Tensor | None = None,
                     noise: Sequence[torch.Tensor] | None = None
                     ) -> torch.Tensor:
    """DDIM over a subsequence of ``sched`` (uniform or quadratic), from
    its last step down. With ``eta > 0`` each step adds ``sigma * z``
    (``noise`` holds ``ddim_steps`` tensors); ``eta == 0`` draws nothing."""
    seq, prev_seq = ddim_steps_of(sched.num_timesteps, ddim_steps, method)
    gammas = sched.gammas.cpu().numpy()
    dev = y_cond.device
    g_t = torch.as_tensor(gammas[seq], device=dev)
    g_prev = torch.as_tensor(gammas[prev_seq], device=dev)
    y = _start(y_cond, generator, y_T)
    B = y.shape[0]
    # ddim_steps steps from entry ddim_steps - 1 down, as the JAX package
    # (where T is not a multiple of ddim_steps, seq has entries past them)
    for i in range(ddim_steps):
        idx = ddim_steps - 1 - i
        g, gp = g_t[idx], g_prev[idx]
        eps = model_fn(torch.cat([y_cond, y], dim=-1), g.expand(B))
        x0 = (y - torch.sqrt(1.0 - g) * eps) / torch.sqrt(g)
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
        sigma = eta * torch.sqrt((1 - gp) / (1 - g) * (1 - g / gp))
        dir_xt = torch.sqrt((1.0 - gp - sigma**2).clamp(min=0.0)) * eps
        y = torch.sqrt(gp) * x0 + dir_xt
        if eta != 0.0:
            y = y + sigma * _draw(generator, noise, i, y)
    return y
