"""Train state: f32 master parameters, AdamW moments and the EMA.

Port of the JAX package's ``train/state.py``. The JAX ``TrainState`` is an
immutable pytree that ``apply_gradients`` replaces; here ``TrainState``
updates the model's parameters, the moments and the EMA in place (with
``torch._foreach_*`` ops over the parameter list), which keeps one copy of
each in device memory.

- ``AdamW`` is ``optax.adamw`` (eps 1e-8, decoupled weight decay) with
  optax's indexing: the k-th update (k from 1) bias-corrects with k and uses
  the learning rate ``schedule(k - 1)``; an optional global-norm clip comes
  first, as ``optax.clip_by_global_norm`` in the JAX chain.
- ``cosine_lr`` is the optax linear warmup joined to the cosine decay.
- The EMA decays with ``min(ema_decay, (1 + t) / (10 + t))`` where t is the
  step count before the update, and is kept in f32.
- Gradient accumulation (``accum_steps`` k > 1) has ``optax.MultiSteps``
  semantics: the running mean ``acc + (g - acc) / (n + 1)`` of k
  micro-gradients, then one clip-and-AdamW update on every k-th call and
  none on the others. As in the JAX package's ``TrainState``, the EMA
  update and ``step`` run on every call.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

__all__ = ["TrainState", "AdamW", "make_optimizer", "cosine_lr", "ema_decay_at"]

Schedule = Callable[[int], float]


def cosine_lr(base_lr: float, total_steps: int, warmup_steps: int = 0,
              min_lr: float = 1e-6) -> Schedule:
    """Per-step learning rate: a linear warmup from 0 over ``warmup_steps``,
    then cosine decay to ``min_lr`` over the remaining steps (optax's
    ``linear_schedule`` joined to ``cosine_decay_schedule``)."""
    decay_steps = max(total_steps - warmup_steps, 1)
    alpha = min_lr / base_lr

    def schedule(count: int) -> float:
        if warmup_steps > 0 and count < warmup_steps:
            return base_lr * count / warmup_steps
        c = min(count - warmup_steps, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip)?, adamw(lr, b1, b2,
    eps=1e-8, weight_decay))`` over a fixed list of parameters, updated in
    place. ``lr`` is a number or a schedule of the update count. With
    ``accum_steps`` k > 1 it is ``optax.MultiSteps(chain, k)``: ``step``
    folds the gradients into their running mean ``acc`` and updates the
    parameters with it on every k-th call only."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float | Schedule,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_clip: float | None = None,
                 accum_steps: int = 1):
        self.params = list(params)
        self.lr = lr if callable(lr) else (lambda count, v=float(lr): v)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0  # updates applied
        self.accum_steps = int(accum_steps)
        # MultiSteps' accumulator and its position in the cycle
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.accum_steps > 1 else [])
        self.mini_step = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> bool:
        """Take one call's gradients; returns whether the parameters were
        updated (always, unless accumulating)."""
        grads = list(grads)
        if self.accum_steps > 1:
            # Welford's running mean, as optax.MultiSteps(use_grad_mean)
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, diff)
            del diff
            self.mini_step = (self.mini_step + 1) % self.accum_steps
            if self.mini_step:
                return False
            self._update(self.acc)
            torch._foreach_zero_(self.acc)
            return True
        self._update(grads)
        return True

    def _update(self, grads: list) -> None:
        if self.grad_clip:
            norm = global_norm(grads)
            # optax: g where norm < max_norm, else g / norm * max_norm
            factor = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                 self.grad_clip / norm)
            grads = torch._foreach_mul(grads, factor)
        lr = self.lr(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g² + b2 nu
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        # bias correction in f32, as optax computes decay**count
        bc1 = float(1.0 - np.float32(b1) ** np.float32(self.count))
        bc2 = float(1.0 - np.float32(b2) ** np.float32(self.count))
        mu_hat = torch._foreach_div(self.mu, bc1)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, f32, as a 0-d tensor."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def make_optimizer(params: Sequence[torch.Tensor], lr: float | Schedule = 1e-4,
                   weight_decay: float = 0.0, betas: tuple = (0.9, 0.999),
                   grad_clip: float | None = None,
                   accum_steps: int = 1) -> AdamW:
    """AdamW with optional global-norm clipping and gradient accumulation
    over ``accum_steps`` calls, as the JAX package's ``make_optimizer``."""
    return AdamW(params, lr, b1=betas[0], b2=betas[1],
                 weight_decay=weight_decay, grad_clip=grad_clip,
                 accum_steps=accum_steps)


def ema_decay_at(step: int, ema_decay: float) -> float:
    """min(ema_decay, (1 + t) / (10 + t)) in f32, t the step before the
    update."""
    t = np.float32(step)
    return float(min(np.float32(ema_decay),
                     (np.float32(1.0) + t) / (np.float32(10.0) + t)))


class TrainState:
    """The model's f32 parameters (updated in place), the optimizer and the
    f32 EMA of the parameters, in ``model.named_parameters()`` order.

    ``step`` counts ``apply_gradients`` calls (applied updates, unless
    accumulating); ``version`` changes whenever the parameters or the EMA
    change, so a serving copy knows when to refresh.
    """

    def __init__(self, model: nn.Module, tx_factory: Callable[[list], AdamW],
                 ema_decay: float = 0.9999):
        self.model = model
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.tx_factory = tx_factory
        self.ema_decay = ema_decay
        self.version = 0
        self.reset()

    @torch.no_grad()
    def reset(self) -> None:
        """Start over from the model's current parameters: step 0, zero
        moments, EMA = parameters (the JAX ``TrainState.create``)."""
        self.step = 0
        self.tx = self.tx_factory(self.params)
        self.ema = [p.detach().float().clone() for p in self.params]
        self.version += 1

    @torch.no_grad()
    def load(self, params: dict, ema: dict, mu: dict, nu: dict, count: int,
             step: int, acc: dict | None = None, mini_step: int = 0) -> None:
        """Continue from a saved state: parameters, EMA and AdamW moments as
        ``{name: tensor}`` over every parameter name, optax's update
        ``count``, the step counter and, when accumulating, the gradient
        accumulator and its ``mini_step``."""
        self.model.load_state_dict(params)
        pairs = [(ema, self.ema), (mu, self.tx.mu), (nu, self.tx.nu)]
        if self.tx.accum_steps > 1 and acc is not None:
            pairs.append((acc, self.tx.acc))
        for values, dst in pairs:
            for name, d in zip(self.names, dst):
                d.copy_(values[name])
        self.tx.count = int(count)
        self.tx.mini_step = int(mini_step)
        self.step = int(step)
        self.version += 1

    def state_dict(self) -> dict:
        """Everything ``load`` takes, as tensors on their device."""
        names = self.names
        out = {
            "params": dict(zip(names, (p.detach() for p in self.params))),
            "ema": dict(zip(names, self.ema)),
            "mu": dict(zip(names, self.tx.mu)),
            "nu": dict(zip(names, self.tx.nu)),
            "count": self.tx.count,
            "step": self.step,
            "mini_step": self.tx.mini_step,
        }
        if self.tx.accum_steps > 1:
            out["acc"] = dict(zip(names, self.tx.acc))
        return out

    @torch.no_grad()
    def apply_gradients(self, grads: Sequence[torch.Tensor]) -> None:
        self.tx.step(grads)
        decay = ema_decay_at(self.step, self.ema_decay)
        torch._foreach_mul_(self.ema, decay)
        torch._foreach_add_(self.ema, self.params, alpha=1.0 - decay)
        self.step += 1
        self.version += 1

    def ema_state_dict(self) -> dict[str, torch.Tensor]:
        return dict(zip(self.names, self.ema))
