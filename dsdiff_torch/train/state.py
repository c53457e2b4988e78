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
- Under a mesh (``parallel.mesh``) with a sharding plan, a split leaf's f32
  master copy, EMA, moments and accumulator hold only this rank's shard
  (its part of the leaf's split axis over the ``fsdp`` ranks); the
  optimizer updates the shard from the same part of the summed gradient,
  the global-norm clip sums the shards' squares over the ``fsdp`` ranks,
  and the model's parameter is gathered whole again from the shards.
  ``state_dict`` and ``ema_state_dict`` gather whole leaves; ``load``
  takes whole leaves and keeps this rank's shards.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
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
        # the clip's norm of a list of gradients (a sharded state's sums
        # its shards over the ranks)
        self.norm_fn = global_norm
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
            norm = self.norm_fn(grads)
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
    change, so a serving copy knows when to refresh. With a ``mesh`` and a
    ``plan`` ({name: axis or None}, ``parallel.mesh.param_sharding``) the
    leaves the plan splits are held as shards (``master``).
    """

    def __init__(self, model: nn.Module, tx_factory: Callable[[list], AdamW],
                 ema_decay: float = 0.9999, mesh=None,
                 plan: dict | None = None):
        self.model = model
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.tx_factory = tx_factory
        self.ema_decay = ema_decay
        self.mesh = mesh
        plan = plan or {}
        self.axes = [plan.get(n) if mesh is not None and mesh.n_fsdp > 1
                     else None for n in self.names]
        self.version = 0
        self.reset()

    def _shard(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole leaf ``i`` (a view; the tensor itself
        for a leaf that is not split)."""
        ax = self.axes[i]
        if ax is None:
            return t
        size = t.shape[ax] // self.mesh.n_fsdp
        return t.narrow(ax, self.mesh.fsdp_index * size, size)

    def _whole(self, i: int, shard: torch.Tensor) -> torch.Tensor:
        """Leaf ``i`` gathered whole from every ``fsdp`` rank's shard."""
        ax = self.axes[i]
        if ax is None:
            return shard
        shard = shard.contiguous()
        parts = [torch.empty_like(shard) for _ in range(self.mesh.n_fsdp)]
        dist.all_gather(parts, shard, group=self.mesh.fsdp_group)
        return torch.cat(parts, dim=ax)

    def _norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """Global norm of gradients given as this rank's shards: the split
        leaves' sums of squares are summed over the ``fsdp`` ranks."""
        split = [g.float() for g, ax in zip(grads, self.axes) if ax is not None]
        whole = [g.float() for g, ax in zip(grads, self.axes) if ax is None]
        zero = torch.zeros((), device=grads[0].device)
        sq_split = sum(((g * g).sum() for g in split), zero)
        dist.all_reduce(sq_split, group=self.mesh.fsdp_group)
        return torch.sqrt(sq_split + sum(((g * g).sum() for g in whole), zero))

    @property
    def sharded(self) -> bool:
        return any(ax is not None for ax in self.axes)

    @torch.no_grad()
    def reset(self) -> None:
        """Start over from the model's current parameters: step 0, zero
        moments, EMA = parameters (the JAX ``TrainState.create``)."""
        self.step = 0
        # f32 master parameters: the model's own, or this rank's shards
        self.master = [p if ax is None else self._shard(i, p.detach()).clone()
                       for i, (p, ax) in enumerate(zip(self.params, self.axes))]
        self.tx = self.tx_factory(self.master)
        if self.sharded:
            self.tx.norm_fn = self._norm
        self.ema = [m.detach().float().clone() for m in self.master]
        self.version += 1

    def local_nbytes(self) -> int:
        """Bytes of the state this rank holds: master parameters, EMA and
        both moments (shards of split leaves, whole leaves otherwise)."""
        return sum(t.numel() * t.element_size()
                   for group in (self.master, self.ema, self.tx.mu, self.tx.nu)
                   for t in group)

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
        if self.sharded:
            pairs.append((params, self.master))
        for values, dst in pairs:
            for i, (name, d) in enumerate(zip(self.names, dst)):
                if d is not self.params[i]:
                    d.copy_(self._shard(i, values[name].to(d.device)))
        self.tx.count = int(count)
        self.tx.mini_step = int(mini_step)
        self.step = int(step)
        self.version += 1

    def _gathered(self, shards: Sequence[torch.Tensor]) -> dict:
        return {n: self._whole(i, t)
                for i, (n, t) in enumerate(zip(self.names, shards))}

    @torch.no_grad()
    def state_dict(self) -> dict:
        """Everything ``load`` takes, as whole tensors on their device (a
        collective over the ``fsdp`` ranks when the state is sharded)."""
        out = {
            "params": dict(zip(self.names, (p.detach() for p in self.params))),
            "ema": self._gathered(self.ema),
            "mu": self._gathered(self.tx.mu),
            "nu": self._gathered(self.tx.nu),
            "count": self.tx.count,
            "step": self.step,
            "mini_step": self.tx.mini_step,
        }
        if self.tx.accum_steps > 1:
            out["acc"] = self._gathered(self.tx.acc)
        return out

    @torch.no_grad()
    def apply_gradients(self, grads: Sequence[torch.Tensor]) -> None:
        """One update from whole gradients (summed over the ranks under a
        mesh): each shard takes its part."""
        updated = self.tx.step([self._shard(i, g) for i, g in enumerate(grads)])
        if updated and self.sharded:
            for i, (p, m) in enumerate(zip(self.params, self.master)):
                if m is not p:
                    p.copy_(self._whole(i, m))
        decay = ema_decay_at(self.step, self.ema_decay)
        torch._foreach_mul_(self.ema, decay)
        torch._foreach_add_(self.ema, self.master, alpha=1.0 - decay)
        self.step += 1
        self.version += 1

    @torch.no_grad()
    def ema_state_dict(self) -> dict[str, torch.Tensor]:
        """The whole EMA by parameter name (gathered when sharded)."""
        return self._gathered(self.ema)
