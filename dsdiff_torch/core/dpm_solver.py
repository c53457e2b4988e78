"""DPM-Solver / DPM-Solver++ in continuous time.

Port of the JAX package's ``core/dpm_solver.py``: the discrete-beta VP noise
schedule with continuous-time interpolation, the model wrapper, singlestep
orders 1-3, multistep orders 1-3, the adaptive-step controller, and the
``dpm_solver_sample_loop`` entry with the reference trainers' defaults.
Both algorithm types: 'dpmsolver' (noise prediction) and 'dpmsolver++'
(data prediction).

- The schedule tables and every per-step scalar (times, lambdas, step
  sizes) are float32 tensors on the device, as in the JAX package; the
  step grids are built in numpy float64 on the host.
- Where the JAX package compiles a ``lax.scan``, this is a Python loop; the
  adaptive controller (a ``lax.while_loop`` there) is a Python ``while``
  that reads the current time back from the device each turn.

Updates follow Lu et al., "DPM-Solver" (NeurIPS 2022) and "DPM-Solver++"
(arXiv 2211.01095), eqs. as cited at each function.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .sampling import dynamic_threshold
from .schedules import DiffusionSchedule

__all__ = [
    "NoiseScheduleVP",
    "wrap_model",
    "sample",
    "dpm_solver_sample_loop",
]


# jnp.interp's threshold for a flat segment of float32 knots
_FLAT_DX = float(np.spacing(np.finfo(np.float32).eps))


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``np.interp``: piecewise-linear through (xp, fp), xp ascending,
    clamped to fp[0] / fp[-1] outside [xp[0], xp[-1]]."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.numel() - 1)
    dx = xp[i] - xp[i - 1]
    flat = dx.abs() <= _FLAT_DX
    slope = (x - xp[i - 1]) / torch.where(flat, torch.ones_like(dx), dx)
    f = torch.where(flat, fp[i - 1], fp[i - 1] + slope * (fp[i] - fp[i - 1]))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class NoiseScheduleVP(NamedTuple):
    """Discrete-beta VP schedule with continuous-time interpolation.

    ``t_np`` / ``log_alpha_np`` are host float64 copies for the step-grid
    construction; the tensors are float32 on the device."""

    t_array: torch.Tensor          # [T], (i+1)/T
    log_alpha_array: torch.Tensor  # [T], 0.5*log(alphas_cumprod)
    total_N: int
    t_np: np.ndarray
    log_alpha_np: np.ndarray

    @classmethod
    def from_betas(cls, betas, device: str | torch.device = "cpu",
                   ) -> "NoiseScheduleVP":
        betas = np.asarray(betas, dtype=np.float64)
        T = betas.shape[0]
        log_alpha = 0.5 * np.cumsum(np.log(1.0 - betas))
        t_array = np.arange(1, T + 1, dtype=np.float64) / T

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return cls(
            t_array=f32(t_array),
            log_alpha_array=f32(log_alpha),
            total_N=T,
            t_np=t_array,
            log_alpha_np=log_alpha,
        )

    @property
    def t_0(self) -> float:
        return 1.0 / self.total_N

    @property
    def t_T(self) -> float:
        return 1.0

    def time(self, t: float) -> torch.Tensor:
        """``t`` as a float32 scalar on the schedule's device."""
        return torch.tensor(t, dtype=torch.float32,
                            device=self.t_array.device)

    def marginal_log_mean_coeff(self, t):
        return _interp(t, self.t_array, self.log_alpha_array)

    def marginal_alpha(self, t):
        return torch.exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t):
        return torch.sqrt(1.0 - torch.exp(2.0 * self.marginal_log_mean_coeff(t)))

    def marginal_lambda(self, t):
        log_a = self.marginal_log_mean_coeff(t)
        return log_a - 0.5 * torch.log1p(-torch.exp(2.0 * log_a))

    def inverse_lambda(self, lam):
        # lambda decreases with t: interp over the reversed (ascending) table
        log_a = self.log_alpha_array
        lam_arr = log_a - 0.5 * torch.log1p(-torch.exp(2.0 * log_a))
        return _interp(lam, lam_arr.flip(0), self.t_array.flip(0))


def wrap_model(
    denoise_fn: Callable,
    ns: NoiseScheduleVP,
    parameterization: str = "eps",
    learn_sigma: bool = False,
    rescale_factor: float = 1.0,
    clip_denoised: bool = False,
    denoised_fn: Callable | None = None,
    algorithm_type: str = "dpmsolver++",
):
    """Continuous-time model function ``fn(x, t)``, t a float32 scalar
    tensor in (0, 1].

    ``denoise_fn(x, t_model)`` is the discrete-step denoiser; it is given
    ``(t*N - 1) * rescale_factor`` as a [B] float32 tensor. Returns the data
    prediction x0(x, t) for 'dpmsolver++' or the noise prediction eps(x, t)
    for 'dpmsolver'. A learned-sigma variance half is dropped;
    ``denoised_fn`` applies before the clip.
    """
    N = ns.total_N

    def fn(x, t):
        t_model = (t * N - 1.0) * rescale_factor
        out = denoise_fn(x, t_model.to(torch.float32).repeat(x.shape[0]))
        if isinstance(out, tuple):
            out = out[0]
        if learn_sigma:
            out = out[..., : out.shape[-1] // 2]
        alpha_t = ns.marginal_alpha(t)
        sigma_t = ns.marginal_std(t)
        if parameterization == "eps":
            x0 = (x - sigma_t * out) / alpha_t
        elif parameterization == "x0":
            x0 = out
        elif parameterization == "v":
            x0 = alpha_t * x - sigma_t * out
        else:
            raise ValueError(f"unknown parameterization {parameterization}")
        if denoised_fn is not None:
            x0 = denoised_fn(x0)
        if clip_denoised:
            x0 = torch.clamp(x0, -1.0, 1.0)
        if algorithm_type == "dpmsolver++":
            return x0
        return (x - alpha_t * x0) / sigma_t  # corrected eps

    return fn


# --------------------------------------------------------------------- steps
def _np_tables(ns: NoiseScheduleVP):
    """Host float64 copies of the time and lambda tables."""
    log_a = ns.log_alpha_np
    return ns.t_np, log_a - 0.5 * np.log1p(-np.exp(2.0 * log_a))


def _np_lambda(ns: NoiseScheduleVP, t):
    ta, lam = _np_tables(ns)
    return np.interp(t, ta, lam)


def _np_inverse_lambda(ns: NoiseScheduleVP, x):
    ta, lam = _np_tables(ns)
    return np.interp(x, lam[::-1], ta[::-1])


def _get_time_steps(ns: NoiseScheduleVP, skip_type: str, t_T: float,
                    t_0: float, N: int) -> np.ndarray:
    """N+1 fine timesteps from t_T to t_0, host float64."""
    if skip_type == "logSNR":
        lams = np.linspace(_np_lambda(ns, t_T), _np_lambda(ns, t_0), N + 1)
        return _np_inverse_lambda(ns, lams)
    if skip_type == "time_uniform":
        return np.linspace(t_T, t_0, N + 1)
    if skip_type == "time_quadratic":
        return np.linspace(t_T ** 0.5, t_0 ** 0.5, N + 1) ** 2
    raise ValueError(f"unsupported skip_type {skip_type}")


def _orders_for_singlestep(steps: int, order: int) -> list[int]:
    """Group sizes for singlestep: ``steps`` model calls in groups of
    ``order``, the remainder in lower-order groups at the end."""
    if order == 3:
        K = steps // 3 + 1
        if steps % 3 == 0:
            return [3] * (K - 2) + [2, 1]
        if steps % 3 == 1:
            return [3] * (K - 1) + [1]
        return [3] * (K - 1) + [2]
    if order == 2:
        if steps % 2 == 0:
            return [2] * (steps // 2)
        return [2] * (steps // 2) + [1]
    if order == 1:
        return [1] * steps
    raise ValueError(f"order must be 1..3, got {order}")


# ------------------------------------------------------------------- updates
# Each update advances x from time s to time t (< s). ``fn`` is the wrapped
# model (x0-pred for ++, eps-pred otherwise). Intermediate times s1/s2 are
# explicit so fixed-step methods can place them on the fine grid;
# ``m_s`` / ``m_s1`` optionally reuse a precomputed model value.

def _update1(ns, fn, x, s, t, plusplus: bool, m_s=None):
    """First order (= DDIM). DPM-Solver eq. (3.7) / ++ eq. (4.1)."""
    m_s = fn(x, s) if m_s is None else m_s
    lam_s, lam_t = ns.marginal_lambda(s), ns.marginal_lambda(t)
    h = lam_t - lam_s
    if plusplus:
        sigma_s, sigma_t = ns.marginal_std(s), ns.marginal_std(t)
        alpha_t = ns.marginal_alpha(t)
        return (sigma_t / sigma_s) * x - alpha_t * torch.expm1(-h) * m_s
    log_a_s = ns.marginal_log_mean_coeff(s)
    log_a_t = ns.marginal_log_mean_coeff(t)
    sigma_t = ns.marginal_std(t)
    return torch.exp(log_a_t - log_a_s) * x - sigma_t * torch.expm1(h) * m_s


def _update2(ns, fn, x, s, t, plusplus: bool, s1=None, m_s=None, m_s1=None):
    """Singlestep second order (midpoint r1=0.5 unless s1 given).
    DPM-Solver-2 eq. (3.11) / ++(2S) eq. (4.4), solver_type 'dpmsolver'."""
    lam_s, lam_t = ns.marginal_lambda(s), ns.marginal_lambda(t)
    h = lam_t - lam_s
    if s1 is None:
        s1 = ns.inverse_lambda(lam_s + 0.5 * h)
    lam_s1 = ns.marginal_lambda(s1)
    r1 = (lam_s1 - lam_s) / h
    m_s = fn(x, s) if m_s is None else m_s
    if plusplus:
        sig_s, sig_s1, sig_t = (
            ns.marginal_std(s), ns.marginal_std(s1), ns.marginal_std(t)
        )
        a_s1, a_t = ns.marginal_alpha(s1), ns.marginal_alpha(t)
        if m_s1 is None:
            x_s1 = (sig_s1 / sig_s) * x - a_s1 * torch.expm1(-r1 * h) * m_s
            m_s1 = fn(x_s1, s1)
        phi_1 = torch.expm1(-h)
        return (
            (sig_t / sig_s) * x
            - a_t * phi_1 * m_s
            - (0.5 / r1) * a_t * phi_1 * (m_s1 - m_s)
        )
    la_s, la_s1, la_t = (
        ns.marginal_log_mean_coeff(s),
        ns.marginal_log_mean_coeff(s1),
        ns.marginal_log_mean_coeff(t),
    )
    sig_s1, sig_t = ns.marginal_std(s1), ns.marginal_std(t)
    if m_s1 is None:
        x_s1 = torch.exp(la_s1 - la_s) * x - sig_s1 * torch.expm1(r1 * h) * m_s
        m_s1 = fn(x_s1, s1)
    phi_1 = torch.expm1(h)
    return (
        torch.exp(la_t - la_s) * x
        - sig_t * phi_1 * m_s
        - (0.5 / r1) * sig_t * phi_1 * (m_s1 - m_s)
    )


def _update3(ns, fn, x, s, t, plusplus: bool, s1=None, s2=None, m_s=None,
             m_s1=None):
    """Singlestep third order (r1=1/3, r2=2/3 unless s1/s2 given).
    DPM-Solver-3 eq. (3.14) / ++(3S)."""
    lam_s, lam_t = ns.marginal_lambda(s), ns.marginal_lambda(t)
    h = lam_t - lam_s
    if s1 is None:
        s1 = ns.inverse_lambda(lam_s + h / 3.0)
    if s2 is None:
        s2 = ns.inverse_lambda(lam_s + 2.0 * h / 3.0)
    lam_s1, lam_s2 = ns.marginal_lambda(s1), ns.marginal_lambda(s2)
    r1 = (lam_s1 - lam_s) / h
    r2 = (lam_s2 - lam_s) / h
    m_s = fn(x, s) if m_s is None else m_s
    if plusplus:
        sig_s, sig_s1, sig_s2, sig_t = (
            ns.marginal_std(s), ns.marginal_std(s1),
            ns.marginal_std(s2), ns.marginal_std(t),
        )
        a_s1, a_s2, a_t = (
            ns.marginal_alpha(s1), ns.marginal_alpha(s2),
            ns.marginal_alpha(t),
        )
        phi_11 = torch.expm1(-r1 * h)
        phi_12 = torch.expm1(-r2 * h)
        phi_1 = torch.expm1(-h)
        phi_22 = phi_12 / (r2 * h) + 1.0
        phi_2 = phi_1 / h + 1.0
        if m_s1 is None:
            x_s1 = (sig_s1 / sig_s) * x - a_s1 * phi_11 * m_s
            m_s1 = fn(x_s1, s1)
        x_s2 = (
            (sig_s2 / sig_s) * x
            - a_s2 * phi_12 * m_s
            + (r2 / r1) * a_s2 * phi_22 * (m_s1 - m_s)
        )
        m_s2 = fn(x_s2, s2)
        return (
            (sig_t / sig_s) * x
            - a_t * phi_1 * m_s
            + (1.0 / r2) * a_t * phi_2 * (m_s2 - m_s)
        )
    la_s, la_s1, la_s2, la_t = (
        ns.marginal_log_mean_coeff(s),
        ns.marginal_log_mean_coeff(s1),
        ns.marginal_log_mean_coeff(s2),
        ns.marginal_log_mean_coeff(t),
    )
    sig_s1, sig_s2, sig_t = (
        ns.marginal_std(s1), ns.marginal_std(s2), ns.marginal_std(t)
    )
    phi_11 = torch.expm1(r1 * h)
    phi_12 = torch.expm1(r2 * h)
    phi_1 = torch.expm1(h)
    phi_22 = phi_12 / (r2 * h) - 1.0
    phi_2 = phi_1 / h - 1.0
    if m_s1 is None:
        x_s1 = torch.exp(la_s1 - la_s) * x - sig_s1 * phi_11 * m_s
        m_s1 = fn(x_s1, s1)
    x_s2 = (
        torch.exp(la_s2 - la_s) * x
        - sig_s2 * phi_12 * m_s
        - (r2 / r1) * sig_s2 * phi_22 * (m_s1 - m_s)
    )
    m_s2 = fn(x_s2, s2)
    return (
        torch.exp(la_t - la_s) * x
        - sig_t * phi_1 * m_s
        - (1.0 / r2) * sig_t * phi_2 * (m_s2 - m_s)
    )


def _singlestep_group(ns, fn, x, times, order: int, plusplus: bool):
    """One singlestep group: times = (s, [s1, [s2,]] t)."""
    if order == 1:
        return _update1(ns, fn, x, times[0], times[-1], plusplus)
    if order == 2:
        return _update2(ns, fn, x, times[0], times[-1], plusplus,
                        s1=times[1])
    return _update3(ns, fn, x, times[0], times[-1], plusplus,
                    s1=times[1], s2=times[2])


def _device_times(ns: NoiseScheduleVP, times) -> torch.Tensor:
    return torch.as_tensor(np.asarray(times, np.float32),
                           device=ns.t_array.device)


def _sample_singlestep(ns, fn, x, skip_type: str, t_T: float, t_0: float,
                       steps: int, order: int, plusplus: bool,
                       fixed: bool = False):
    """Fixed singlestep: outer group boundaries per
    ``_orders_for_singlestep`` (or ``steps // order`` uniform groups for
    'singlestep_fixed'), intermediate times re-gridded inside each group by
    the same skip_type. One model call per unit of order."""
    if fixed:
        orders = [order] * (steps // order)
        outer = _get_time_steps(ns, skip_type, t_T, t_0, len(orders))
    elif skip_type == "logSNR":
        orders = _orders_for_singlestep(steps, order)
        outer = _get_time_steps(ns, skip_type, t_T, t_0, len(orders))
    else:
        orders = _orders_for_singlestep(steps, order)
        fine = _get_time_steps(ns, skip_type, t_T, t_0, steps)
        outer = fine[np.cumsum([0] + orders)]
    for i, k in enumerate(orders):
        inner = _get_time_steps(ns, skip_type, float(outer[i]),
                                float(outer[i + 1]), k)  # s, [s1, [s2,]] t
        x = _singlestep_group(ns, fn, x, _device_times(ns, inner), k,
                              plusplus)
    return x


def _multistep_update(ns, x, m0, m1, m2, lam_im1, lam_im2, s, t, eff: int,
                      plusplus: bool):
    """One multistep update from time s to t with effective order ``eff``,
    given the two previous model values and lambdas (multistep first /
    second / third update, solver_type 'dpmsolver')."""
    lam_s, lam_t = ns.marginal_lambda(s), ns.marginal_lambda(t)
    h = lam_t - lam_s
    sig_s, sig_t = ns.marginal_std(s), ns.marginal_std(t)
    if plusplus:
        a_t = ns.marginal_alpha(t)
        phi_1 = torch.expm1(-h)
        base = (sig_t / sig_s) * x - a_t * phi_1 * m0
        coef, sign = a_t, 1.0
    else:
        la_s = ns.marginal_log_mean_coeff(s)
        la_t = ns.marginal_log_mean_coeff(t)
        phi_1 = torch.expm1(h)
        base = torch.exp(la_t - la_s) * x - sig_t * phi_1 * m0
        coef, sign = sig_t, -1.0
    if eff < 2:
        return base

    def safe(r):
        return torch.where(r.abs() < 1e-12, torch.ones_like(r), r)

    r0 = (lam_s - lam_im1) / h
    d1_0 = (m0 - m1) / safe(r0)
    if eff < 3:
        return base - 0.5 * (coef * phi_1) * d1_0
    r1 = (lam_im1 - lam_im2) / h
    d1_1 = (m1 - m2) / safe(r1)
    d1 = d1_0 + (r0 / safe(r0 + r1)) * (d1_0 - d1_1)
    d2 = (d1_0 - d1_1) / safe(r0 + r1)
    # ++: phi_2 = phi_1/h + 1; noise prediction: phi_2 = phi_1/h - 1
    phi_2 = phi_1 / h + sign
    phi_3 = phi_2 / h - 0.5
    return base + sign * (coef * phi_2) * d1 - (coef * phi_3) * d2


def _sample_multistep(ns, fn, x, fine_ts: np.ndarray, order: int,
                      plusplus: bool, lower_order_final: bool = True):
    """Multistep orders 1-3: the order ramps 1->2->3 as the history fills
    and, with ``lower_order_final`` and steps < 10, ramps back down at the
    final steps. The model value after the final update is never computed:
    ``steps`` model calls for ``steps`` updates."""
    steps = len(fine_ts) - 1
    ts = _device_times(ns, fine_ts)
    lam = ns.marginal_lambda(ts)
    ramp_down = lower_order_final and steps < 10
    m0 = fn(x, ts[0])
    m1 = m2 = torch.zeros_like(m0)
    for i in range(steps):
        eff = min(order, i + 1)
        if ramp_down:
            eff = min(eff, steps - i)
        x = _multistep_update(
            ns, x, m0, m1, m2, lam[max(i - 1, 0)], lam[max(i - 2, 0)],
            ts[i], ts[i + 1], eff, plusplus,
        )
        if i < steps - 1:
            m0, m1, m2 = fn(x, ts[i + 1]), m0, m1
    return x


def _adaptive_error(x_higher, x_lower, x_prev, atol: float, rtol: float):
    """Embedded-pair error norm for the adaptive controller: per-sample RMS
    over the non-batch axes, gated on the WORST sample of the batch, so one
    far-off sample cannot hide behind an easy rest of the batch."""
    delta = torch.clamp(
        rtol * torch.maximum(x_lower.abs(), x_prev.abs()), min=atol
    )
    sq = ((x_higher - x_lower) / delta) ** 2
    per_sample = torch.sqrt(sq.reshape(sq.shape[0], -1).mean(dim=1))
    return per_sample.max()


def _sample_adaptive(ns, fn, x, t_T: float, t_0: float, order: int,
                     plusplus: bool, h_init: float = 0.05,
                     atol: float = 0.0078, rtol: float = 0.05,
                     theta: float = 0.9, max_nfe: int = 2000):
    """Adaptive step-size solver: the embedded (1, 2) pair for order 2 and
    the (2, 3) pair for order 3; a step is accepted when the local error
    estimate is at most 1, and the step size is scaled by
    theta * E^(-1/order). Each turn reads the current time back to the host
    to decide whether to go on; it stops at ``max_nfe`` model calls."""
    if order not in (2, 3):
        raise ValueError("adaptive solver supports order 2 or 3")
    lam_0 = ns.marginal_lambda(ns.time(t_0))
    x_prev = x
    t_cur = ns.time(t_T)
    h_cur = ns.time(h_init)
    nfe = 0
    while bool(t_cur > t_0 + 1e-5) and nfe < max_nfe:
        s = t_cur
        lam_s = ns.marginal_lambda(s)
        h = torch.minimum(h_cur, lam_0 - lam_s)
        t = ns.inverse_lambda(lam_s + h)
        m_s = fn(x, s)
        if order == 2:
            # embedded pair: order 1 / order 2 at r1 = 0.5
            x_lower = _update1(ns, fn, x, s, t, plusplus, m_s=m_s)
            x_higher = _update2(ns, fn, x, s, t, plusplus, m_s=m_s)
            nfe += 2
        else:
            # order 2 at r1 = 1/3 shares m_s and m_s1 with the order-3 update
            h_ = ns.marginal_lambda(t) - lam_s
            s1 = ns.inverse_lambda(lam_s + h_ / 3.0)
            if plusplus:
                sig_s, sig_s1 = ns.marginal_std(s), ns.marginal_std(s1)
                a_s1 = ns.marginal_alpha(s1)
                x_s1 = (sig_s1 / sig_s) * x \
                    - a_s1 * torch.expm1(-h_ / 3.0) * m_s
            else:
                la_s = ns.marginal_log_mean_coeff(s)
                la_s1 = ns.marginal_log_mean_coeff(s1)
                sig_s1 = ns.marginal_std(s1)
                x_s1 = torch.exp(la_s1 - la_s) * x \
                    - sig_s1 * torch.expm1(h_ / 3.0) * m_s
            m_s1 = fn(x_s1, s1)
            x_lower = _update2(ns, fn, x, s, t, plusplus, s1=s1, m_s=m_s,
                               m_s1=m_s1)
            x_higher = _update3(ns, fn, x, s, t, plusplus, s1=s1,
                                m_s=m_s, m_s1=m_s1)
            nfe += 3
        err = _adaptive_error(x_higher, x_lower, x_prev, atol, rtol)
        accept = err <= 1.0
        x = torch.where(accept, x_higher, x)
        x_prev = torch.where(accept, x_lower, x_prev)
        t_cur = torch.where(accept, t, s)
        h_cur = torch.minimum(
            theta * h * torch.clamp(err, min=1e-10) ** (-1.0 / order),
            lam_0 - ns.marginal_lambda(t_cur),
        )
    return x


def sample(
    sched: DiffusionSchedule,
    denoise_fn: Callable,
    x_T: torch.Tensor,
    steps: int = 20,
    order: int = 2,
    method: str = "multistep",
    skip_type: str = "time_uniform",
    algorithm_type: str = "dpmsolver++",
    parameterization: str = "eps",
    learn_sigma: bool = False,
    clip_denoised: bool = False,
    denoised_fn: Callable | None = None,
    lower_order_final: bool = True,
    denoise_to_zero: bool = False,
    t_start: float | None = None,
    t_end: float | None = None,
    atol: float = 0.0078,
    rtol: float = 0.05,
):
    """DPM-Solver sampling.

    ``sched`` must be the FULL (un-respaced) schedule: the solver chooses
    its own timesteps. ``denoise_fn(x, t_model[B])`` is the standard
    denoiser closure. ``method``: 'singlestep' | 'singlestep_fixed' |
    'multistep' | 'adaptive'.
    """
    tm = sched.timestep_map.cpu().numpy()
    if tm[0] != 0 or tm[-1] != sched.num_timesteps - 1:
        raise ValueError(
            "dpm_solver needs the full schedule (respacing is internal)"
        )
    ns = NoiseScheduleVP.from_betas(sched.betas.cpu().numpy(),
                                    device=sched.betas.device)
    plusplus = algorithm_type == "dpmsolver++"
    fn = wrap_model(
        denoise_fn, ns, parameterization, learn_sigma,
        rescale_factor=float(sched.rescale_factor),
        clip_denoised=clip_denoised, denoised_fn=denoised_fn,
        algorithm_type=algorithm_type,
    )
    t_T = ns.t_T if t_start is None else t_start
    t_0 = ns.t_0 if t_end is None else t_end
    x = x_T
    if method in ("singlestep", "singlestep_fixed"):
        x = _sample_singlestep(
            ns, fn, x, skip_type, t_T, t_0, steps, order, plusplus,
            fixed=(method == "singlestep_fixed"),
        )
    elif method == "multistep":
        fine = _get_time_steps(ns, skip_type, t_T, t_0, steps)
        x = _sample_multistep(ns, fn, x, fine, order, plusplus,
                              lower_order_final=lower_order_final)
    elif method in ("adaptive", "adaptive_order"):
        x = _sample_adaptive(ns, fn, x, t_T, t_0, order, plusplus,
                             atol=atol, rtol=rtol)
    else:
        raise ValueError(f"unknown method {method}")
    if denoise_to_zero:
        # final first-order step to t ~ 0
        x = _update1(ns, fn, x, ns.time(t_0),
                     ns.time(1.0 / (10 * ns.total_N)), plusplus)
    return x


def dpm_solver_sample_loop(
    sched: DiffusionSchedule,
    denoise_fn: Callable,
    x_T: torch.Tensor,
    steps: int | None = None,
    parameterization: str = "eps",
    learn_sigma: bool = False,
    clip_denoised: bool = False,
    **overrides,
):
    """The solver entry with the reference trainers' defaults: DPM-Solver++
    multistep order 2, logSNR spacing, dynamic thresholding,
    lower_order_final=False."""
    cfg = dict(
        order=2, skip_type="logSNR", method="multistep",
        algorithm_type="dpmsolver++", lower_order_final=False,
        denoised_fn=dynamic_threshold,
    )
    cfg.update(overrides)
    return sample(
        sched, denoise_fn, x_T,
        steps=steps if steps is not None else sched.num_timesteps,
        parameterization=parameterization, learn_sigma=learn_sigma,
        clip_denoised=clip_denoised, **cfg,
    )
