"""Diffusion noise schedules and timestep re-spacing.

Port of the JAX package's ``core/schedules.py``. The tables are built in float64
numpy on the host, exactly as there, then stored as float32 tensors on the
device, so both packages hold bit-identical tables.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = [
    "make_beta_schedule",
    "DiffusionSchedule",
    "space_timesteps",
    "respace",
]


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
    max_beta: float = 0.999,
) -> np.ndarray:
    """Return the beta table for a named schedule, float64, shape [T].

    ``linear`` is the LDM sqrt-space interpolation, ``scaled_linear`` the
    OpenAI linear with the 1000/T scaling, ``cosine`` the Nichol-Dhariwal
    alpha-bar cosine; also ``sqrt_linear`` and ``sqrt``.
    """
    if schedule == "linear":
        betas = (
            np.linspace(
                linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64
            )
            ** 2
        )
    elif schedule == "scaled_linear":
        scale = 1000.0 / n_timestep
        betas = np.linspace(
            scale * 0.0001, scale * 0.02, n_timestep, dtype=np.float64
        )
        # beta passes 1 for T < ~21; clamp as the cosine branch does
        betas = np.clip(betas, 0.0, max_beta)
    elif schedule == "cosine":
        def alpha_bar(t):
            return math.cos((t + cosine_s) / (1 + cosine_s) * math.pi / 2) ** 2

        betas = []
        for i in range(n_timestep):
            t1 = i / n_timestep
            t2 = (i + 1) / n_timestep
            betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
        betas = np.asarray(betas, dtype=np.float64)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = (
            np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
        )
    else:
        raise ValueError(f"unknown beta schedule '{schedule}'")
    assert betas.shape == (n_timestep,)
    return betas


class DiffusionSchedule(NamedTuple):
    """All derived q/p tables, shape [T] each (float32 on the device).

    ``timestep_map`` maps re-spaced indices back to model timesteps (identity
    for a full schedule); the model is called with
    ``timestep_map[t] * rescale_factor``.
    """

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    timestep_map: torch.Tensor  # int64 [T]
    rescale_factor: torch.Tensor  # f32 scalar

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @classmethod
    def create(
        cls,
        betas: np.ndarray,
        timestep_map: np.ndarray | None = None,
        rescale_timesteps: bool = False,
        original_num_steps: int | None = None,
        device: str | torch.device = "cuda",
    ) -> "DiffusionSchedule":
        dev = resolve_device(device)
        betas = np.asarray(betas, dtype=np.float64)
        T = betas.shape[0]
        alphas = 1.0 - betas
        acp = np.cumprod(alphas, axis=0)
        acp_prev = np.append(1.0, acp[:-1])
        acp_next = np.append(acp[1:], 0.0)
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        # log-variance clipped at t=0; a single-step schedule has no t=1 to
        # borrow from, so floor it instead
        if T > 1:
            post_logvar = np.log(np.append(post_var[1], post_var[1:]))
        else:
            post_logvar = np.log(np.maximum(post_var, 1e-20))
        if timestep_map is None:
            timestep_map = np.arange(T)
        orig = original_num_steps if original_num_steps is not None else T
        rescale = (1000.0 / orig) if rescale_timesteps else 1.0

        def f32(x):
            return torch.as_tensor(
                np.asarray(x, np.float32), dtype=torch.float32, device=dev
            )

        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(acp),
            alphas_cumprod_prev=f32(acp_prev),
            alphas_cumprod_next=f32(acp_next),
            sqrt_alphas_cumprod=f32(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
            log_one_minus_alphas_cumprod=f32(np.log(1.0 - acp)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
            posterior_variance=f32(post_var),
            posterior_log_variance_clipped=f32(post_logvar),
            posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=f32(
                (1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)
            ),
            timestep_map=torch.as_tensor(
                np.asarray(timestep_map), dtype=torch.int64, device=dev
            ),
            rescale_factor=f32(rescale),
        )


def space_timesteps(num_timesteps: int, section_counts: str | Sequence[int]):
    """Pick a subsequence of original timesteps to retain: ``"ddimN"``
    (fixed-stride DDIM spacing) or comma-separated per-section counts
    (``"20"``, ``"10,15,25"``). Returns a sorted python list."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim") :])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return sorted(range(0, num_timesteps, i))
            raise ValueError(
                f"cannot create exactly {desired_count} steps with an integer stride"
            )
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        if section_count <= 1:
            frac_stride = 1
        else:
            frac_stride = (size - 1) / (section_count - 1)
        cur_idx = 0.0
        taken_steps = []
        for _ in range(section_count):
            taken_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        all_steps += taken_steps
        start_idx += size
    return sorted(all_steps)


def respace(
    full_betas: np.ndarray,
    use_timesteps: Sequence[int],
    rescale_timesteps: bool = False,
    device: str | torch.device = "cuda",
) -> DiffusionSchedule:
    """The re-spaced schedule over ``use_timesteps``: the retained steps'
    cumulative alpha products are kept and new betas solved from
    consecutive ratios."""
    full_betas = np.asarray(full_betas, dtype=np.float64)
    acp = np.cumprod(1.0 - full_betas)
    use = sorted(int(t) for t in use_timesteps)
    last_alpha_cumprod = 1.0
    new_betas = []
    for t in use:
        new_betas.append(1.0 - acp[t] / last_alpha_cumprod)
        last_alpha_cumprod = acp[t]
    return DiffusionSchedule.create(
        np.asarray(new_betas),
        timestep_map=np.asarray(use),
        rescale_timesteps=rescale_timesteps,
        original_num_steps=full_betas.shape[0],
        device=device,
    )
