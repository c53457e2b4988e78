"""Timestep schedule samplers: uniform and loss-second-moment importance.

Port of the JAX package's ``train/schedule_sampler.py``:

- ``uniform``: t ~ U[0, T), weights 1.
- ``loss-second-moment``: a [T, history] loss buffer; once every t holds a
  full history, t is drawn with probability proportional to sqrt(E[loss²])
  with a uniform floor of 0.001, and weighted 1/(T p_t).

The state is plain tensors; ``update_state`` returns a new state.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "SamplerState",
    "uniform_init",
    "loss2_init",
    "make_schedule_sampler",
    "sample_t",
    "update_state",
]

_UNIFORM_PROB = 0.001  # uniform floor of the loss-second-moment pmf


@dataclasses.dataclass(frozen=True)
class SamplerState:
    kind: str
    loss_history: torch.Tensor  # [T, history] f32
    loss_counts: torch.Tensor  # [T] int32

    @property
    def history_per_term(self) -> int:
        return self.loss_history.shape[1]


def _init(kind: str, num_timesteps: int, history: int, device):
    return SamplerState(
        kind,
        torch.zeros((num_timesteps, history), dtype=torch.float32, device=device),
        torch.zeros((num_timesteps,), dtype=torch.int32, device=device),
    )


def uniform_init(num_timesteps: int, device="cpu") -> SamplerState:
    return _init("uniform", num_timesteps, 1, device)


def loss2_init(num_timesteps: int, history: int = 10, device="cpu") -> SamplerState:
    return _init("loss-second-moment", num_timesteps, history, device)


def make_schedule_sampler(name: str, num_timesteps: int,
                          device="cpu") -> SamplerState:
    if name == "uniform":
        return uniform_init(num_timesteps, device)
    if name == "loss-second-moment":
        return loss2_init(num_timesteps, device=device)
    raise ValueError(f"unknown schedule sampler: {name}")


def _weights(state: SamplerState) -> torch.Tensor:
    """Sampling pmf over t, [T] f32."""
    T = state.loss_history.shape[0]
    warmed = bool((state.loss_counts == state.history_per_term).all())
    w = torch.sqrt((state.loss_history**2).mean(dim=-1))
    w_sum = w.sum()
    if warmed and w_sum > 0:
        return (w / torch.clamp(w_sum, min=1e-12) * (1 - _UNIFORM_PROB)
                + _UNIFORM_PROB / T)
    return torch.full((T,), 1.0 / T, dtype=torch.float32, device=w.device)


def sample_t(state: SamplerState, batch: int,
             generator: torch.Generator | None = None,
             t: torch.Tensor | None = None):
    """(t [batch] int64, weights [batch] f32). ``t`` is drawn from
    ``generator`` unless given; the weights follow from it either way."""
    T = state.loss_history.shape[0]
    dev = state.loss_history.device
    if state.kind == "uniform":
        if t is None:
            t = torch.randint(0, T, (batch,), generator=generator, device=dev)
        return t, torch.ones((batch,), dtype=torch.float32, device=t.device)
    p = _weights(state)
    if t is None:
        t = torch.multinomial(p, batch, replacement=True, generator=generator)
    return t, 1.0 / (T * p[t.to(p.device)]).to(t.device)


def update_state(state: SamplerState, t: torch.Tensor,
                 losses: torch.Tensor) -> SamplerState:
    """Record per-element losses into the [T, history] ring buffer: each
    element, in batch order, shifts its t's full history left by one and
    appends, or fills the next free slot. Duplicate t in a batch are taken
    one after the other, as the JAX package's scan does."""
    if state.kind == "uniform":
        return state
    hist = state.loss_history.clone()
    H = hist.shape[1]
    counts = state.loss_counts.tolist()
    losses = losses.detach().float().to(hist.device)
    for i, ti in enumerate(t.tolist()):
        if counts[ti] == H:
            hist[ti] = torch.cat([hist[ti, 1:], losses[i:i + 1]])
        else:
            hist[ti, counts[ti]] = losses[i]
            counts[ti] += 1
    return SamplerState(
        state.kind, hist,
        torch.tensor(counts, dtype=torch.int32, device=hist.device),
    )
