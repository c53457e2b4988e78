"""The reference diffusion math: schedules, the DDIM step, the training
objective and the disentangle losses.

A frozen copy of the port's ``core/schedules.py``, ``core/process.py``,
``core/losses.py``, ``core/sampling.py`` (DDIM) and the objective of
``train/step.py train_loss``, for the settings the benchmark's
configurations use: the OpenAI 'linear' schedule (``scaled_linear``), eps
or v parameterisation, learned-range sigma, the Charbonnier loss with the
frozen-mean VB term, and the 'ds' (euclidean C-S + S-A-L) or 'disc'
(com/dist) disentangle loss. Tables are built in float64 and held as
float32, as the port holds them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

OPENAI_SCHEDULE_MODES = ("ds_diff_gaussian", "ds_diff_split", "disc_diff", "dit")


def betas_for(trainer: dict) -> np.ndarray:
    T = int(trainer.get("diffusion_steps", 1000))
    schedule = trainer.get("noise_schedule", "linear")
    if schedule == "linear" and trainer.get("net_mode") in OPENAI_SCHEDULE_MODES:
        scale = 1000.0 / T
        return np.clip(np.linspace(scale * 1e-4, scale * 2e-2, T,
                                   dtype=np.float64), 0.0, 0.999)
    if schedule == "linear":
        lo = float(trainer.get("linear_start", 1e-4))
        hi = float(trainer.get("linear_end", 2e-2))
        return np.linspace(lo ** 0.5, hi ** 0.5, T, dtype=np.float64) ** 2
    raise ValueError(f"no reference for noise_schedule '{schedule}'")


def spaced_steps(T: int, count: int) -> list[int]:
    """``space_timesteps(T, str(count))``: one section of ``count`` steps."""
    if count <= 1:
        return [0]
    stride = (T - 1) / (count - 1)
    return sorted(round(i * stride) for i in range(count))


class Schedule:
    """The [T] tables of one (possibly re-spaced) schedule, f32 on
    ``device``."""

    def __init__(self, betas: np.ndarray, timestep_map, device):
        betas = np.asarray(betas, np.float64)
        acp = np.cumprod(1.0 - betas)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        post_logvar = np.log(np.append(post_var[1], post_var[1:]))

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        self.T = len(betas)
        self.betas = f32(betas)
        self.acp = f32(acp)
        self.acp_prev = f32(acp_prev)
        self.sqrt_acp = f32(np.sqrt(acp))
        self.sqrt_1m_acp = f32(np.sqrt(1.0 - acp))
        self.sqrt_recip_acp = f32(np.sqrt(1.0 / acp))
        self.sqrt_recipm1_acp = f32(np.sqrt(1.0 / acp - 1.0))
        self.post_logvar = f32(post_logvar)
        self.coef1 = f32(betas * np.sqrt(acp_prev) / (1.0 - acp))
        self.coef2 = f32((1.0 - acp_prev) * np.sqrt(1.0 - betas) / (1.0 - acp))
        self.timestep_map = torch.as_tensor(np.asarray(timestep_map),
                                            dtype=torch.int64, device=device)
        # the DDIM (eta 0) coefficients, from the f32 tables read back in f64
        ap = self.acp_prev.cpu().numpy().astype(np.float64)
        self.ddim_sqrt_acp_prev = f32(np.sqrt(ap))
        self.ddim_dir = f32(np.sqrt(np.clip(1.0 - ap, 0.0, None)))

    @classmethod
    def full(cls, trainer: dict, device) -> "Schedule":
        betas = betas_for(trainer)
        return cls(betas, np.arange(len(betas)), device)

    @classmethod
    def respaced(cls, trainer: dict, steps: int, device) -> "Schedule":
        full = betas_for(trainer)
        acp = np.cumprod(1.0 - full)
        use = spaced_steps(len(full), steps)
        last, new = 1.0, []
        for t in use:
            new.append(1.0 - acp[t] / last)
            last = acp[t]
        return cls(np.asarray(new), use, device)

    def model_t(self, t: torch.Tensor) -> torch.Tensor:
        return self.timestep_map[t].float()


def _ex(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    out = table[t].float()
    return out.reshape(out.shape[0], *([1] * (ndim - 1)))


def pred_x0(s: Schedule, x, t, pred, param: str):
    nd = x.ndim
    if param == "v":
        return _ex(s.sqrt_acp, t, nd) * x - _ex(s.sqrt_1m_acp, t, nd) * pred
    if param == "eps":
        return (_ex(s.sqrt_recip_acp, t, nd) * x
                - _ex(s.sqrt_recipm1_acp, t, nd) * pred)
    raise ValueError(f"no reference for parameterization '{param}'")


def eps_from_x0(s: Schedule, x, t, x0):
    nd = x.ndim
    return (_ex(s.sqrt_recip_acp, t, nd) * x - x0) / _ex(s.sqrt_recipm1_acp, t, nd)


def ddim_step(s: Schedule, out, x, i: int, param: str, clip: bool = True):
    """x at chain step ``i`` (re-spaced index ``T - 1 - i``) and the raw
    model output there -> the next x of DDIM with eta 0."""
    t = s.T - 1 - i
    tb = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
    x0 = pred_x0(s, x, tb, out[..., :x.shape[-1]], param)
    if clip:
        x0 = x0.clamp(-1.0, 1.0)
    eps = eps_from_x0(s, x, tb, x0)
    return s.ddim_sqrt_acp_prev[t] * x0 + s.ddim_dir[t] * eps


def step_timestep(s: Schedule, x, i: int) -> torch.Tensor:
    """The model timestep of chain step ``i`` for every row of ``x``."""
    t = torch.full((x.shape[0],), s.T - 1 - i, dtype=torch.int64,
                   device=x.device)
    return s.model_t(t)


# ---- the training objective

def mean_flat(x):
    return x.mean(dim=tuple(range(1, x.ndim)))


def normal_kl(m1, lv1, m2, lv2):
    return 0.5 * (-1.0 + lv2 - lv1 + torch.exp(lv1 - lv2)
                  + ((m1 - m2) ** 2) * torch.exp(-lv2))


def _cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * x ** 3)))


def discretized_ll(x, means, log_scales):
    cx = x - means
    inv = torch.exp(-log_scales)
    cdf_plus = _cdf(inv * (cx + 1.0 / 255.0))
    cdf_min = _cdf(inv * (cx - 1.0 / 255.0))
    log_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_1m_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    delta = cdf_plus - cdf_min
    return torch.where(x < -0.999, log_plus, torch.where(
        x > 0.999, log_1m_min, torch.log(torch.clamp(delta, min=1e-12))))


def _posterior_mean(s: Schedule, x0, xt, t):
    nd = x0.ndim
    return _ex(s.coef1, t, nd) * x0 + _ex(s.coef2, t, nd) * xt


def vb_bits(s: Schedule, out, x0, xt, t, param: str):
    C = x0.shape[-1]
    nd = x0.ndim
    pred, var_values = out[..., :C], out[..., C:]
    min_log = _ex(s.post_logvar, t, nd)
    max_log = torch.log(_ex(s.betas, t, nd))
    frac = (var_values + 1.0) / 2.0
    log_var = frac * max_log + (1.0 - frac) * min_log
    x0_hat = pred_x0(s, xt, t, pred, param).clamp(-1.0, 1.0)
    mean = _posterior_mean(s, x0_hat, xt, t)
    true_mean = _posterior_mean(s, x0, xt, t)
    kl = mean_flat(normal_kl(true_mean, _ex(s.post_logvar, t, nd), mean,
                             log_var)) / math.log(2.0)
    nll = mean_flat(-discretized_ll(x0, mean, 0.5 * log_var)) / math.log(2.0)
    return torch.where(t == 0, nll, kl)


def _flatten_views(f):
    b, n = f.shape[0], f.shape[1]
    return f.reshape(b, n, -1).transpose(0, 1).reshape(n * b, -1)


def euclidean_loss(features, labels):
    lab = labels.transpose(0, 1).reshape(-1)[:, None]
    f = _flatten_views(features)
    D = f.shape[1]
    sq = (f ** 2).sum(dim=1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (f @ f.T), min=0.0)
    dist = torch.sqrt(d2 + 1e-12) / D
    same = (lab == lab.T).float()
    eye = torch.eye(f.shape[0], dtype=torch.float32, device=f.device)
    return (dist * same * (1.0 - eye)).sum() / (
        (dist * (1.0 - same)).sum() + 1e-12)


def ds_disentangle(features):
    """C-S + S-A-L in 'eu' mode over DSUNet's stream-major features."""
    def bm(x):
        return x.movedim(0, 1)

    content, style = bm(features["content"]), bm(features["style"])
    anatomy, lesion = bm(features["anatomy"]), bm(features["lesion"])
    B = content.shape[0]
    dev = content.device
    bidx = torch.arange(B, device=dev)
    c_lab = bidx[:, None].expand(B, content.shape[1])
    s_lab = (-1 - torch.arange(style.shape[1], device=dev))[None, :].expand(
        B, style.shape[1])
    cs = euclidean_loss(torch.cat([content, style], 1),
                        torch.cat([c_lab, s_lab], 1))
    a_lab = (2 * bidx)[:, None].expand(B, anatomy.shape[1])
    l_lab = (2 * bidx + 1)[:, None].expand(B, lesion.shape[1])
    sal = euclidean_loss(torch.cat([style, anatomy, lesion], 1),
                         torch.cat([s_lab, a_lab, l_lab], 1))
    return cs + sal


def disc_disentangle(features):
    com, dist = features["common"], features["distinct"]
    n = com.shape[0]

    def pair_mse(x):
        total, count = 0.0, 0
        for i in range(n):
            for j in range(i + 1, n):
                total = total + ((x[i] - x[j]) ** 2).mean()
                count += 1
        return total / max(count, 1)

    return pair_mse(com) / (pair_mse(dist) + 1e-8)


def train_objective(trainer: dict, s: Schedule, model, x0, cond, t, noise):
    """The port's train step objective on one batch, uniform weights:
    mean(Charbonnier + VB) + contrast_lambda * disentangle."""
    param = trainer.get("parameterization", "v")
    nd = x0.ndim
    xt = _ex(s.sqrt_acp, t, nd) * x0 + _ex(s.sqrt_1m_acp, t, nd) * noise
    out, feats = model(torch.cat([xt, cond], dim=-1), s.model_t(t))
    C = x0.shape[-1]
    pred = out[..., :C]
    per = torch.zeros(x0.shape[0], device=x0.device)
    if trainer.get("learn_sigma", False):
        frozen = torch.cat([pred.detach(), out[..., C:]], dim=-1)
        per = per + vb_bits(s, frozen, x0, xt, t, param) * (s.T / 1000.0)
    target = noise if param == "eps" else (
        _ex(s.sqrt_acp, t, nd) * noise - _ex(s.sqrt_1m_acp, t, nd) * x0)
    per = per + mean_flat(torch.sqrt((pred - target) ** 2 + 1e-6))
    loss = per.sum() / x0.shape[0]
    mode = trainer.get("disentangle_distance", "eu")
    if mode:
        if mode != "eu":
            raise ValueError(f"no reference for disentangle mode '{mode}'")
        lam = float(trainer.get("contrast_lambda", 0.5))
        if trainer.get("net_mode") == "disc_diff":
            loss = loss + lam * disc_disentangle(feats)
        else:
            loss = loss + lam * ds_disentangle(feats)
    return loss
