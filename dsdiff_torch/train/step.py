"""Task knobs, the train step, the sample function and validation metrics.

Port of the JAX package's ``train/step.py``: ``TaskConfig``, ``_denoiser``,
``make_train_step`` (with the 'ds' and 'disc' disentangle losses),
``make_sample_fn`` with every sampler (and split-input sampling: the
denoiser applied to overlapping tiles in one batched call,
``core.patching``) and ``make_val_metrics``; and the Palette pipeline's
train step and sampler (``make_palette_train_step``,
``make_palette_sample_fn``, the JAX trainer's ``_setup_palette_steps``).

The train step is eager: one forward through ``training_losses`` and the
disentangle losses, one backward, then the optimizer and EMA update in
place (``state.TrainState``). bf16 compute happens inside the model; the
master parameters, loss and optimizer state stay f32, as in the JAX
package. Random draws come from an explicit ``torch.Generator``; ``t`` and
``noise`` may be given instead, so that a test can replay another
framework's draws. The ResBlocks' dropout masks come from the same
generator (``models.layers.dropout_generator``).

Under a mesh (``parallel.mesh``) a step computes what one process computes
on the global batch: each rank holds its rows of it (``batch``), takes its
rows of one draw of t, noise and condition dropout for the global batch
(given ``t`` and ``noise`` are global), and its objective is its part of
the global one, so that the gradients summed over the ranks are the global
gradients: its rows' weighted loss over the global batch size, plus the
disentangle losses on the feature views gathered from every rank
(``parallel.dist.gather_rows``, whose backward sums the ranks' gradients)
over the number of ranks. Those losses mix samples (a ratio of sums over
every pair of views, labels tied across the batch), so a mean of per-rank
losses would be another loss. The schedule sampler is updated from the
gathered per-sample losses; metrics are the global ones. A rank's dropout
masks come from its own generator, seeded from the step's and its rank.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..core import losses as L
from ..core import dpm_solver, palette, patching, process, sampling
from ..core.schedules import DiffusionSchedule
from ..eval.metrics import ssim
from ..models.layers import dropout_generator
from ..parallel import dist as pdist
from . import schedule_sampler as ss
from .state import TrainState, global_norm

__all__ = ["TaskConfig", "train_loss", "make_train_step", "draw_x_T",
           "run_sampler_loop", "make_sample_fn", "make_val_metrics",
           "make_palette_train_step", "make_palette_sample_fn"]


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


# the feature views each disentangle loss reads, stream-major [n, B, ...]
_FEATURE_VIEWS = {"ds": ("content", "style", "anatomy", "lesion"),
                  "disc": ("common", "distinct")}


def _distributed(mesh) -> bool:
    return mesh is not None and mesh.distributed


def train_loss(task: TaskConfig, sched: DiffusionSchedule, model: nn.Module,
               x0: torch.Tensor, cond: torch.Tensor, t: torch.Tensor,
               noise: torch.Tensor, weights: torch.Tensor, mesh=None):
    """The train step's objective: ``mean(weights * training_losses)`` plus
    ``disen_lambda * (C-S + S-A-L)`` for 'ds' features or ``disen_lambda *
    com/dist`` for 'disc' features. Returns (loss, per-element loss [B],
    metrics dict of 0-d tensors). Under a distributed ``mesh`` the inputs
    are this rank's rows and the loss is its part of the global objective
    (the module docstring); the metrics are global."""
    ranks = mesh.world if _distributed(mesh) else 1
    n_total = x0.shape[0] * ranks
    terms, feats = process.training_losses(
        sched, _denoiser(model, cond), x0, t, noise,
        parameterization=task.parameterization,
        loss_type=task.loss_type,
        learn_sigma=task.learn_sigma,
        vlb_weight=task.vlb_weight,
        elbo_weight=task.elbo_lambda,
    )
    loss = (weights * terms["loss"]).sum() / n_total
    sums = {"loss_simple": terms["mse"].sum() / n_total}
    if "vb" in terms:
        sums["loss_vlb"] = terms["vb"].sum() / n_total
    if ranks > 1:  # the global means: every rank's part summed
        parts = torch.stack([loss] + list(sums.values())).detach()
        dist.all_reduce(parts)
        main = parts[0]
        metrics = dict(zip(sums, parts[1:]))
    else:
        main = loss
        metrics = sums
    if task.feature_kind in _FEATURE_VIEWS and feats is not None:
        if _distributed(mesh):
            feats = {k: pdist.gather_rows(feats[k], 1)
                     for k in _FEATURE_VIEWS[task.feature_kind]}
        if task.feature_kind == "ds":
            cs, sal, _ = L.ds_disentangle_losses(
                feats, task.disentangle_mode, task.disen_temperature
            )
            disen = cs + sal
            metrics["loss_disen_cs"] = cs
            metrics["loss_disen_sal"] = sal
        else:
            disen = L.disc_disentangle_loss(feats)
            metrics["loss_disen"] = disen
        # the same global value on every rank, whose gradients the ranks sum
        loss = loss + task.disen_lambda * disen / ranks
        main = main + task.disen_lambda * disen
    metrics["loss"] = main
    return loss, terms["loss"], metrics


def make_train_step(task: TaskConfig, sched: DiffusionSchedule,
                    mesh=None) -> Callable:
    """Returns ``step(state, sampler_state, batch, generator=None, t=None,
    noise=None) -> (state, sampler_state, metrics)``.

    ``batch`` holds NHWC ``target`` [B, H, W, C] and ``image`` (the
    condition): under a distributed ``mesh``, this rank's rows of the global
    batch, whose ``t`` and ``noise`` (drawn or given) are global. ``state``
    is updated in place and returned; ``metrics`` are 0-d f32 tensors:
    loss, loss_simple, loss_vlb (learned sigma), loss_disen_cs and
    loss_disen_sal ('ds' features), loss_disen ('disc' features), and
    grad_norm, the global norm of the gradients before any clipping.
    """
    if task.feature_kind not in (None, "ds", "disc"):
        raise ValueError(f"unknown feature kind '{task.feature_kind}'")

    def step(state: TrainState, sampler_state: ss.SamplerState, batch: dict,
             generator: torch.Generator | None = None,
             t: torch.Tensor | None = None,
             noise: torch.Tensor | None = None):
        x0 = batch["target"]
        cond = batch["image"]
        B = x0.shape[0]
        lo, hi, n_total = 0, B, B
        if _distributed(mesh):
            n_total = B * mesh.world
            lo, hi = mesh.local_rows(n_total)
        t, weights = ss.sample_t(sampler_state, n_total, generator, t)
        t, weights = t.to(x0.device), weights.to(x0.device)
        if noise is None:
            noise = torch.randn((n_total,) + x0.shape[1:], generator=generator,
                                dtype=x0.dtype, device=x0.device)
        noise = noise.to(x0.device)
        if task.cond_dropout > 0:
            keep = torch.rand((n_total, 1, 1, 1), generator=generator,
                              device=cond.device) >= task.cond_dropout
            cond = cond * keep[lo:hi].to(cond.dtype)

        metrics, per_elem = _optimizer_step(
            state, lambda model: train_loss(
                task, sched, model, x0, cond, t[lo:hi], noise[lo:hi],
                weights[lo:hi], mesh), generator, mesh)
        per_elem = per_elem.detach()
        if _distributed(mesh) and sampler_state.kind != "uniform":
            per_elem = pdist.all_gather_rows(per_elem)
        sampler_state = ss.update_state(sampler_state, t, per_elem)
        return state, sampler_state, metrics

    return step


def _rank_generator(generator: torch.Generator | None, mesh):
    """The generator of this rank's dropout draws: the step's own for one
    process, else one seeded from the step's seed and the rank."""
    if generator is None or not _distributed(mesh) or mesh.world == 1:
        return generator
    words = np.random.SeedSequence([generator.initial_seed(), mesh.rank]
                                   ).generate_state(2)
    return torch.Generator(device=generator.device).manual_seed(
        int(words[0]) << 32 | int(words[1]))


def _optimizer_step(state: TrainState, objective: Callable,
                    generator: torch.Generator | None,
                    mesh=None) -> tuple[dict, object]:
    """One optimizer step on ``objective(model) -> (loss, aux, metrics)``:
    the model in training mode with its dropout draws bound to
    ``generator``, backward, the gradients summed over the ranks of a
    distributed ``mesh`` (one all-reduce of them all), grad_norm, then the
    optimizer and EMA update of ``state``. Returns (the metrics, detached
    f32; aux)."""
    model = state.model
    model.train()
    model.zero_grad(set_to_none=True)
    with dropout_generator(model, _rank_generator(generator, mesh)):
        loss, aux, metrics = objective(model)
        loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in state.params]
    if _distributed(mesh):
        flat = torch._utils._flatten_dense_tensors(grads)
        dist.all_reduce(flat)
        grads = list(torch._utils._unflatten_dense_tensors(flat, grads))
        del flat
    metrics["grad_norm"] = global_norm(grads)
    state.apply_gradients(grads)
    del grads
    model.zero_grad(set_to_none=True)  # free them before the next step
    return {k: v.detach().float() for k, v in metrics.items()}, aux


def make_palette_train_step(sched: palette.GammaSchedule,
                            mesh=None) -> Callable:
    """The Palette pipeline's step over the train ``GammaSchedule``: the
    same signature and state as ``make_train_step``'s. ``t`` is uniform over
    the schedule; the model sees ``[cond, y_t]`` and ``gamma * 1000`` as its
    timestep and the loss is the eps MSE. The sampler state passes through
    unchanged. Metrics: loss, loss_simple (the same), grad_norm. Under a
    distributed ``mesh`` the batch is this rank's rows of the global batch,
    whose ``t`` and ``noise`` (drawn or given) are global; each rank's loss
    is its rows' share of the global mean, so the summed gradients are the
    global mean's, and the metrics are the global means."""

    def step(state: TrainState, sampler_state, batch: dict,
             generator: torch.Generator | None = None,
             t: torch.Tensor | None = None,
             noise: torch.Tensor | None = None):
        x0 = batch["target"]
        B = x0.shape[0]
        lo, hi, n_total = 0, B, B
        if _distributed(mesh):
            n_total = B * mesh.world
            lo, hi = mesh.local_rows(n_total)
        if t is None:
            t = torch.randint(0, sched.num_timesteps, (n_total,),
                              generator=generator, device=x0.device)
        if noise is None:
            noise = torch.randn((n_total,) + x0.shape[1:], generator=generator,
                                dtype=x0.dtype, device=x0.device)
        t, noise = t.to(x0.device)[lo:hi], noise.to(x0.device)[lo:hi]

        def objective(model):
            loss = palette.training_loss(
                sched, lambda x, g: model(x, g * 1000.0), x0, batch["image"],
                t, noise) * (B / n_total)
            if n_total == B:
                return loss, None, {"loss": loss, "loss_simple": loss}
            main = loss.detach().clone()
            dist.all_reduce(main)
            return loss, None, {"loss": main, "loss_simple": main}

        metrics, _ = _optimizer_step(state, objective, generator, mesh)
        return state, sampler_state, metrics

    return step


def make_palette_sample_fn(model: nn.Module, sched: palette.GammaSchedule,
                           sampler: str = "ddim", ddim_steps: int = 50,
                           eta: float = 0.0,
                           clip_denoised: bool = True) -> Callable:
    """Returns ``fn(cond, generator=None, x_T=None, noise=None) -> samples
    [B, H, W, 1]`` over the test ``GammaSchedule``: DDIM with ``eta`` for
    'ddim', the ancestral loop over every step for any other name. ``x_T``
    and the per-step ``noise`` are drawn from ``generator`` unless given."""

    def denoise(x, gamma):
        return model(x, gamma * 1000.0)

    @torch.inference_mode()
    def fn(cond: torch.Tensor, generator: torch.Generator | None = None,
           x_T: torch.Tensor | None = None,
           noise: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
        if sampler == "ddim":
            return palette.ddim_sample_loop(
                sched, denoise, cond, generator, ddim_steps=ddim_steps,
                eta=eta, clip_denoised=clip_denoised, y_T=x_T, noise=noise)
        return palette.p_sample_loop(sched, denoise, cond, generator,
                                     clip_denoised=clip_denoised, y_T=x_T,
                                     noise=noise)

    return fn


def draw_x_T(cond: torch.Tensor, out_channels: int,
             generator: torch.Generator | None) -> torch.Tensor:
    """The chain's starting noise [B, H, W, out_channels] for ``cond``."""
    B, H, W, _ = cond.shape
    return torch.randn((B, H, W, out_channels), generator=generator,
                       dtype=torch.float32, device=cond.device)


def run_sampler_loop(loop: Callable, sched: DiffusionSchedule,
                     denoise: Callable, x_T: torch.Tensor, task: TaskConfig,
                     eta: float, clip_denoised: bool,
                     generator: torch.Generator | None, noise):
    """Call ``loop`` (one of ``core.sampling``'s over a re-spaced ``sched``)
    with the task's knobs and, of the noise source, ``eta`` and the task's
    ``variance_type``, those that its signature takes."""
    kw = dict(
        parameterization=task.parameterization,
        learn_sigma=task.learn_sigma,
        clip_denoised=clip_denoised,
    )
    optional = dict(generator=generator, noise=noise, eta=eta,
                    variance_type=task.variance_type)
    takes = inspect.signature(loop).parameters
    kw.update({k: v for k, v in optional.items() if k in takes})
    return loop(sched, denoise, x_T, **kw)


# split_input_params keys that shape the tiles' weighting
_WEIGHT_KEYS = ("clip_min_weight", "clip_max_weight", "tie_braker",
                "clip_min_tie_weight", "clip_max_tie_weight")


def make_sample_fn(
    model: nn.Module,
    sched: DiffusionSchedule,
    task: TaskConfig,
    sampler: str = "ddim",
    eta: float = 0.0,
    clip_denoised: bool = True,
    out_channels: int = 1,
    full_sched: DiffusionSchedule | None = None,
    sample_steps: int | None = None,
    solver_options: dict | None = None,
    patch_params: dict | None = None,
) -> Callable:
    """Returns ``fn(cond, generator=None, x_T=None, noise=None) -> samples
    [B, H, W, C]``.

    ``sched`` is already re-spaced to the inference step count. ``x_T`` is
    drawn from ``generator`` unless given; the per-step noise of a
    stochastic sampler (``ddim`` with ``eta > 0``, ``ancestral``) is drawn
    from ``generator`` too, or taken from the list ``noise``.

    ``sampler``: 'ddim' | 'dpm++' / 'dpm_solver++' (DPM-Solver++(2M) over
    ``sched``) | 'plms' | 'ancestral' / 'ddpm' | 'dpm' / 'dpm_solver' /
    'dpm_singlestep' / 'dpm_adaptive'. The last four are the DPM-Solver
    family (``core.dpm_solver``): they need ``full_sched`` (the un-respaced
    schedule; the solver makes its own grid) and ``sample_steps``, never
    clip, and take ``solver_options`` (order, method, skip_type,
    algorithm_type, ...).

    ``patch_params`` (the run config's ``split_input_params``: ``ks``,
    ``stride``, and the weighting's ``clip_min_weight``,
    ``clip_max_weight``, ``tie_braker``, ``clip_min_tie_weight``,
    ``clip_max_tie_weight``) makes every denoiser call one model call over
    the overlapping ``ks`` tiles of x and the condition, refolded
    (``core.patching.patched_apply``).
    """
    if patch_params:
        ks = tuple(patch_params.get("ks", (64, 64)))
        stride = tuple(patch_params.get("stride", ks))
        wparams = {k: patch_params[k] for k in _WEIGHT_KEYS
                   if k in patch_params}
    dpm_family = ("dpm", "dpm_solver", "dpm_singlestep", "dpm_adaptive")
    # raises ValueError for an unknown name
    loop = None if sampler in dpm_family else sampling.make_sampler(sampler)

    @torch.inference_mode()
    def fn(cond: torch.Tensor, generator: torch.Generator | None = None,
           x_T: torch.Tensor | None = None,
           noise: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
        if x_T is None:
            x_T = draw_x_T(cond, out_channels, generator)

        def make_denoise(c):
            # x and c tile by tile when patched: the model sees them joined
            raw = _denoiser(model, None if patch_params else c)

            def denoise(x, t_model):
                out = raw(x, t_model)
                # feature models (DSUNet) yield (out, features)
                return out[0] if isinstance(out, tuple) else out

            if patch_params:
                return lambda x, t_model: patching.patched_apply(
                    denoise, x, t_model, ks, stride, cond=c, **wparams)
            return denoise

        denoise = make_denoise(cond)
        if task.cfg_scale != 1.0:
            denoise = sampling.cfg_wrap(
                denoise, make_denoise(torch.zeros_like(cond)), task.cfg_scale
            )
        if loop is None:
            opts = dict(solver_options or {})
            if sampler == "dpm_singlestep":
                opts.setdefault("method", "singlestep")
                opts.setdefault("order", 3)
                opts.setdefault("skip_type", "time_uniform")
                opts.setdefault("denoised_fn", None)
            elif sampler == "dpm_adaptive":
                opts.setdefault("method", "adaptive")
                opts.setdefault("order", 3)
                opts.setdefault("denoised_fn", None)
            return dpm_solver.dpm_solver_sample_loop(
                full_sched if full_sched is not None else sched,
                denoise, x_T, steps=sample_steps,
                parameterization=task.parameterization,
                learn_sigma=task.learn_sigma,
                clip_denoised=False, **opts,
            )
        return run_sampler_loop(loop, sched, denoise, x_T, task, eta,
                                clip_denoised, generator, noise)

    return fn


def make_val_metrics() -> Callable:
    """Returns ``fn(pred, target, valid=None) -> {ssim, mae, psnr}``: per
    slice SSIM, MAE and PSNR over data range 2.0 (images in [-1, 1]),
    averaged with the ``valid`` [B] weights (all ones when None)."""

    @torch.no_grad()
    def fn(pred: torch.Tensor, target: torch.Tensor,
           valid: torch.Tensor | None = None) -> dict:
        p = pred[..., 0]
        t = target[..., 0]
        ssim_v = ssim(t, p, data_range=2.0)
        mae = (p - t).abs().mean(dim=(1, 2))
        mse = ((p - t) ** 2).mean(dim=(1, 2))
        psnr = 10.0 * torch.log10(4.0 / torch.clamp(mse, min=1e-12))
        w = (torch.ones(p.shape[0], device=p.device) if valid is None
             else valid.to(p.device).float())
        denom = torch.clamp(w.sum(), min=1.0)
        return {
            "ssim": (ssim_v * w).sum() / denom,
            "mae": (mae * w).sum() / denom,
            "psnr": (psnr * w).sum() / denom,
        }

    return fn
