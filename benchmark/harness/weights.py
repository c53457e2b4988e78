"""Seeded random weights, made on the device in one draw.

One ``torch.randn`` of every parameter's elements together, from a
generator on the run's device, in sorted-name order; each leaf's slice is
then scaled in place: weights (two or more dims) ``N(0, 1/fan_in)``,
norm scales ``1 + N(0, 0.01)``, every other leaf (biases) ``N(0, 0.01)``.
No layer is left at its zero initialisation, so a random model's output
depends on every layer. The program and the reference have the same
parameter names and shapes, so the same seed gives both the same values.
"""
from __future__ import annotations

import torch


def values(named_shapes, seed: int, device) -> dict:
    """{name: f32 tensor} for ``named_shapes`` ((name, shape) pairs)."""
    leaves = sorted((n, tuple(s)) for n, s in named_shapes)
    total = sum(_numel(s) for _, s in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for name, shape in leaves:
        n = _numel(shape)
        leaf = flat[offset:offset + n].view(shape)
        offset += n
        if len(shape) >= 2:
            leaf.mul_(1.0 / (n // shape[0]) ** 0.5)
        elif name.endswith("norm.weight"):
            leaf.mul_(0.1).add_(1.0)
        else:
            leaf.mul_(0.1)
        out[name] = leaf
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


@torch.no_grad()
def fill(module: torch.nn.Module, seed: int) -> None:
    """Write the seeded values into every parameter of ``module``."""
    params = dict(module.named_parameters())
    device = next(iter(params.values())).device
    vals = values([(n, p.shape) for n, p in params.items()], seed, device)
    for name, p in params.items():
        p.copy_(vals[name])
