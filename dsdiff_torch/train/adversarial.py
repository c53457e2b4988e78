"""Adversarial disentanglement: a stream discriminator on the content
features.

Port of the JAX package's ``train/adversarial.py``. A discriminator
classifies which condition stream (a / al / l) a DSUNet bottleneck content
feature came from; the diffusion model takes an extra term that pushes its
content features toward stream invariance (cross-entropy against the
uniform target), beside the DS disentangle losses.

``make_adversarial_steps`` returns ``(model_step, disc_step)``. Both are
eager and update their ``TrainState`` in place. Every draw is an argument
or comes from the step's generator, as in ``train.step``: ``t`` uniform in
[0, T) (not from the schedule sampler), the noise, and in ``model_step``
the model's dropout masks (``models.layers.dropout_generator``), so that a
test can replay another framework's draws.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..core import losses as L
from ..core import process
from ..core.schedules import DiffusionSchedule
from ..models.layers import Conv, Dense, SpectralNormConv, dropout_generator
from . import schedule_sampler as ss
from .state import TrainState
from .step import TaskConfig, _denoiser

__all__ = ["ContentDiscriminator", "AdvConfig", "make_adversarial_steps"]

# Flax's GroupNorm epsilon (torch's default is 1e-5)
_NORM_EPS = 1e-6


class ContentDiscriminator(nn.Module):
    """Content features [N, h, w, in_channels] (NHWC) -> stream logits
    [N, n_streams], in f32: three stride-2 3x3 convs (spectrally normalised
    with ``use_spectral_norm``), each followed by GroupNorm(min(32, ch),
    eps 1e-6) and leaky-ReLU 0.2, widths ``base_channels`` doubling; the
    spatial mean; a Dense (``out``)."""

    def __init__(self, in_channels: int, n_streams: int = 3,
                 base_channels: int = 64, use_spectral_norm: bool = True):
        super().__init__()
        ch_in, ch = in_channels, base_channels
        for i in range(3):
            conv = (SpectralNormConv(ch_in, ch, 3, stride=2, padding=1)
                    if use_spectral_norm
                    else Conv(ch_in, ch, 3, stride=2, padding=1))
            self.add_module(f"conv{i}", conv)
            self.add_module(f"norm{i}",
                            nn.GroupNorm(min(32, ch), ch, eps=_NORM_EPS))
            ch_in, ch = ch, 2 * ch
        self.out = Dense(ch_in, n_streams)

    def forward(self, f: torch.Tensor) -> torch.Tensor:
        h = f.permute(0, 3, 1, 2).float()
        for i in range(3):
            h = getattr(self, f"conv{i}")(h)
            h = F.leaky_relu(getattr(self, f"norm{i}")(h), 0.2)
        return self.out(h.mean(dim=(2, 3)))


@dataclasses.dataclass(frozen=True)
class AdvConfig:
    adv_lambda: float = 0.1
    disc_start: int = 0


def _stream_batch(content: torch.Tensor) -> torch.Tensor:
    """[k, B, h, w, c] -> [k*B, h, w, c], stream-major."""
    return content.reshape((-1,) + content.shape[2:])


def make_adversarial_steps(task: TaskConfig, sched: DiffusionSchedule,
                           adv: AdvConfig = AdvConfig()):
    """Returns ``(model_step, disc_step)``.

    - ``model_step(state, sampler_state, disc_state, batch, generator=None,
      t=None, noise=None) -> (state, sampler_state, metrics)``: the mean
      diffusion loss, ``disen_lambda`` times the DS disentangle losses
      (C-S + S-A-L), and from ``state.step >= disc_start`` on ``adv_lambda``
      times the uniform-target cross-entropy of the discriminator's logits
      on the content features; the discriminator's parameters are constants
      there. The schedule sampler records the per-element loss. Metrics:
      loss, loss_simple, loss_adv, loss_disen_cs, loss_disen_sal.
    - ``disc_step(disc_state, model_state, batch, generator=None, t=None,
      noise=None) -> (disc_state, metrics)``: the model in eval mode under
      no grad gives the content features; the discriminator takes a step
      on their stream labels. Metrics: disc_ce, disc_acc.

    ``batch`` holds NHWC ``target`` and ``image`` (the conditions); ``t``
    and ``noise`` are drawn from ``generator`` (in that order) unless
    given. The models are DS feature models (``feats["content"]`` [3, B,
    h, w, c]).
    """

    def draws(x0, generator, t, noise):
        if t is None:
            t = torch.randint(0, sched.num_timesteps, (x0.shape[0],),
                              generator=generator, device=x0.device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator,
                                dtype=x0.dtype, device=x0.device)
        return t.to(x0.device), noise.to(x0.device)

    def content_features(model, batch, t, noise):
        """(loss terms, features) of ``training_losses`` on the batch."""
        return process.training_losses(
            sched, _denoiser(model, batch["image"]), batch["target"], t,
            noise, parameterization=task.parameterization,
            loss_type=task.loss_type, learn_sigma=task.learn_sigma,
        )

    def model_step(state: TrainState, sampler_state: ss.SamplerState,
                   disc_state: TrainState, batch: dict,
                   generator: torch.Generator | None = None,
                   t: torch.Tensor | None = None,
                   noise: torch.Tensor | None = None):
        t, noise = draws(batch["target"], generator, t, noise)
        model, disc = state.model, disc_state.model
        disc_params = {n: p.detach() for n, p in disc.named_parameters()}
        model.train()
        with dropout_generator(model, generator):
            terms, feats = content_features(model, batch, t, noise)
            loss = terms["loss"].mean()
            cs, sal, _ = L.ds_disentangle_losses(
                feats, task.disentangle_mode, task.disen_temperature)
            loss = loss + task.disen_lambda * (cs + sal)
            logits = functional_call(disc, disc_params,
                                     (_stream_batch(feats["content"]),))
            adv_loss = -torch.log_softmax(logits, dim=-1).mean()
            gate = 1.0 if state.step >= adv.disc_start else 0.0
            loss = loss + gate * adv.adv_lambda * adv_loss
            grads = torch.autograd.grad(loss, state.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(state.params, grads)]
        state.apply_gradients(grads)
        del grads
        sampler_state = ss.update_state(sampler_state, t,
                                        terms["loss"].detach())
        metrics = {"loss": loss, "loss_simple": terms["mse"].mean(),
                   "loss_adv": adv_loss, "loss_disen_cs": cs,
                   "loss_disen_sal": sal}
        return state, sampler_state, {k: v.detach().float()
                                      for k, v in metrics.items()}

    def disc_step(disc_state: TrainState, model_state: TrainState,
                  batch: dict, generator: torch.Generator | None = None,
                  t: torch.Tensor | None = None,
                  noise: torch.Tensor | None = None):
        t, noise = draws(batch["target"], generator, t, noise)
        model = model_state.model
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                _, feats = content_features(model, batch, t, noise)
        finally:
            model.train(was_training)
        content = feats["content"]
        k, B = content.shape[:2]
        labels = torch.arange(k, device=content.device).repeat_interleave(B)
        logits = disc_state.model(_stream_batch(content))
        ce = F.cross_entropy(logits, labels)
        disc_state.apply_gradients(
            torch.autograd.grad(ce, disc_state.params))
        acc = (logits.argmax(dim=-1) == labels).float().mean()
        return disc_state, {"disc_ce": ce.detach().float(),
                            "disc_acc": acc.detach()}

    return model_step, disc_step
