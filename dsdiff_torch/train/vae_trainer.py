"""KL-VAE GAN training: the two-optimizer loop as two step functions.

Port of the JAX package's ``train/vae_trainer.py`` (the reference's
AutoencoderKL manual optimisation and LPIPSWithDiscriminator):

- AE step: L1 reconstruction + the weighted perceptual term per image, the
  NLL ``mean(rec / exp(logvar) + logvar)`` with a learned scalar logvar,
  the KL weight, and the generator loss ``-mean(D(rec))`` times the
  adaptive weight ``||d nll / d W|| / (||d g / d W|| + 1e-4)`` over the
  decoder's ``conv_out`` kernel W, clipped to [0, 1e4], times
  ``disc_weight``, with no gradient through it, from step ``disc_start``
  on. The JAX package pulls both gradients through
  one VJP of a re-run reconstruction; here they are two
  ``torch.autograd.grad`` calls on the step's own graph, which give the
  same values (the norms do not see the kernel's layout).
- Disc step: hinge (or vanilla) loss on the real and the detached
  reconstructed logits, from ``disc_state.step + 1 >= disc_start`` on.

The VAE's parameters take AdamW through their ``TrainState``; ``logvar``
moves by plain SGD at 1e-4. ``decoder_only`` zeroes the encoder's gradients
(AdamW still runs on them, as in JAX). Each step's posterior noise is an
argument, or drawn from a generator, so a test can replay JAX's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models.discriminator import (PatchDiscriminator, hinge_d_loss,
                                    vanilla_d_loss)
from ..models.vae import AutoencoderKL
from .state import TrainState

__all__ = ["VaeGanConfig", "make_vae_steps"]


@dataclasses.dataclass(frozen=True)
class VaeGanConfig:
    kl_weight: float = 1e-6
    perceptual_weight: float = 1.0
    disc_start: int = 50001
    disc_weight: float = 0.5
    disc_loss: str = "hinge"  # hinge | vanilla
    decoder_only: bool = False  # finetune the decoder only


def make_vae_steps(vae: AutoencoderKL, disc: PatchDiscriminator,
                   cfg: VaeGanConfig, perceptual_fn: Callable | None = None):
    """Returns (ae_step, disc_step) over ``vae`` and ``disc``.

    - ``ae_step(vae_state, logvar, batch, noise=None, generator=None)``
      updates the VAE's train state in place and returns (the new logvar,
      metrics);
    - ``disc_step(disc_state, batch, noise=None, generator=None)`` updates
      the discriminator's and returns its metrics.

    ``batch``: ``{"image": [B, H, W, C]}`` in [-1, 1]; ``noise``: the
    posterior's standard normal draw [B, h, w, embed_dim]. Metrics are 0-d
    f32 tensors.
    """
    d_loss_fn = hinge_d_loss if cfg.disc_loss == "hinge" else vanilla_d_loss
    last = vae.decoder.conv_out.weight
    use_perceptual = perceptual_fn is not None and cfg.perceptual_weight > 0

    def ae_step(vae_state: TrainState, logvar: torch.Tensor, batch: dict,
                noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        x = batch["image"]
        lv = logvar.detach().clone().requires_grad_(True)
        rec, post = vae(x, noise, generator=generator)
        rec_l = torch.mean(torch.abs(x - rec), dim=(1, 2, 3))
        if use_perceptual:
            rec_l = rec_l + cfg.perceptual_weight * perceptual_fn(x, rec)
        nll = torch.mean(rec_l / torch.exp(lv) + lv)
        kl = torch.mean(post.kl().float())
        g_loss = -torch.mean(disc(rec))

        # the adaptive weight over the decoder's out-conv kernel
        (nll_grad,) = torch.autograd.grad(nll, last, retain_graph=True)
        (g_grad,) = torch.autograd.grad(g_loss, last, retain_graph=True)
        d_weight = (torch.linalg.vector_norm(nll_grad)
                    / (torch.linalg.vector_norm(g_grad) + 1e-4))
        d_weight = torch.clamp(d_weight, 0.0, 1e4).detach() * cfg.disc_weight
        gate = 1.0 if vae_state.step >= cfg.disc_start else 0.0
        loss = nll + cfg.kl_weight * kl + gate * d_weight * g_loss
        *grads, lv_grad = torch.autograd.grad(loss, vae_state.params + [lv])
        if cfg.decoder_only:
            grads = [torch.zeros_like(g) if "encoder" in name.split(".") else g
                     for name, g in zip(vae_state.names, grads)]
        vae_state.apply_gradients(grads)
        metrics = {
            "ae_loss": loss, "nll": nll, "kl": kl, "g_loss": g_loss,
            "d_weight": d_weight, "logvar": logvar,
            "rec_loss": torch.mean(torch.abs(x - rec)),
        }
        metrics = {k: v.detach().float() for k, v in metrics.items()}
        return (logvar - 1e-4 * lv_grad).detach(), metrics

    def disc_step(disc_state: TrainState, batch: dict,
                  noise: torch.Tensor | None = None,
                  generator: torch.Generator | None = None):
        x = batch["image"]
        with torch.no_grad():
            rec, _ = vae(x, noise, generator=generator)
        logits_real = disc(x)
        logits_fake = disc(rec)
        gate = 1.0 if disc_state.step + 1 >= cfg.disc_start else 0.0
        loss = gate * d_loss_fn(logits_real, logits_fake)
        grads = torch.autograd.grad(loss, disc_state.params)
        disc_state.apply_gradients(grads)
        return {"disc_loss": loss.detach(),
                "logits_real": torch.mean(logits_real).detach(),
                "logits_fake": torch.mean(logits_fake).detach()}

    return ae_step, disc_step
