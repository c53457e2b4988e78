"""The reference optimizer: optax-style AdamW with its learning-rate
schedule, and the EMA of the parameters.

A frozen copy of the port's ``train/state.py`` update (no clip, no
accumulation: the benchmark's configurations set neither): the k-th update
bias-corrects with k in f32 and uses the rate ``cosine_lr(k - 1)``; the EMA
decays with ``min(ema_rate, (1 + t) / (10 + t))``, t the updates before it.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def cosine_lr(trainer: dict, steps_per_epoch: int = 1000):
    """The trainer's rate schedule without a data loader (1000 steps an
    epoch): linear warmup over ``lr_warm_epoch`` epochs, then cosine decay
    from ``lr`` to ``lr_low`` over the rest of ``num_epochs``."""
    base = float(trainer.get("lr", 1e-4))
    total = int(trainer.get("num_epochs", 250)) * steps_per_epoch
    warm = int(trainer.get("lr_warm_epoch", 0)) * steps_per_epoch
    alpha = float(trainer.get("lr_low", 1e-7)) / base
    decay = max(total - warm, 1)

    def lr(count: int) -> float:
        if warm > 0 and count < warm:
            return base * count / warm
        c = min(count - warm, decay)
        return base * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / decay))
                       + alpha)

    return lr


class AdamWEma:
    """AdamW (eps 1e-8, decoupled weight decay) and the f32 EMA over a list
    of parameters, updated in place."""

    def __init__(self, params, trainer: dict):
        if trainer.get("grad_clip") or int(trainer.get("accum_steps", 1)) > 1:
            raise ValueError("the reference has no clip and no accumulation")
        self.params = list(params)
        self.lr = cosine_lr(trainer)
        self.b1 = float(trainer.get("beta1", 0.9))
        self.b2 = float(trainer.get("beta2", 0.999))
        self.wd = float(trainer.get("weight_decay", 0.0))
        self.ema_rate = float(trainer.get("ema_rate", 0.9999))
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.ema = [p.detach().clone() for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        lr = self.lr(self.count)
        t = np.float32(self.count)
        self.count += 1
        bc1 = float(1.0 - np.float32(self.b1) ** np.float32(self.count))
        bc2 = float(1.0 - np.float32(self.b2) ** np.float32(self.count))
        decay = float(min(np.float32(self.ema_rate),
                          (np.float32(1.0) + t) / (np.float32(10.0) + t)))
        for p, g, mu, nu, ema in zip(self.params, grads, self.mu, self.nu,
                                     self.ema):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (mu / bc1) / ((nu / bc2).sqrt() + 1e-8)
            if self.wd:
                upd = upd + self.wd * p
            p.add_(upd, alpha=-lr)
            ema.mul_(decay).add_(p, alpha=1.0 - decay)
