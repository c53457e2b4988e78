"""The ('data', 'fsdp') mesh over the ranks and the ZeRO sharding plan.

Port of the JAX package's ``parallel/mesh.py``. The ranks form a
``n_data x n_fsdp`` grid in row-major order (rank = d * n_fsdp + f), as
``make_mesh`` reshapes the devices there. Every rank computes on its own
rows of the global batch; the gradients are summed over all ranks. The
train state (f32 master parameters, EMA, AdamW moments) follows the JAX
plan (``param_sharding``): a leaf of at least ``min_size_to_shard``
elements is split over the ``fsdp`` ranks on its largest axis that
``n_fsdp`` divides (the largest in the Flax layout of the leaf, which the
axis is then mapped from: a conv kernel HWIO, a Dense kernel [in, out]);
every other leaf is whole on every rank. The model's own parameters stay
whole on every rank: they are the working copy the forward reads, gathered
from the shards after each update.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from . import dist as pdist

__all__ = [
    "Mesh",
    "make_mesh",
    "local_mesh",
    "flax_axes",
    "plan_sharding",
    "param_sharding",
    "state_sharding",
    "sharded_byte_fraction",
    "shard_batch",
]


@dataclasses.dataclass
class Mesh:
    """``shape`` {'data': n, 'fsdp': m} over ``world`` ranks (the whole
    process group); this rank's ``rank`` and ``fsdp_group``, the ranks that
    share its data index. ``distributed`` is False for a mesh of this
    process alone, whose collectives are skipped."""

    n_data: int
    n_fsdp: int
    rank: int = 0
    fsdp_group: object = None
    distributed: bool = False

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "fsdp": self.n_fsdp}

    @property
    def world(self) -> int:
        return self.n_data * self.n_fsdp

    @property
    def fsdp_index(self) -> int:
        return self.rank % self.n_fsdp

    def local_rows(self, n: int) -> tuple[int, int]:
        """This rank's rows ``(lo, hi)`` of a global batch of ``n``."""
        if n % self.world:
            raise ValueError(f"batch {n} does not split over {self.world} "
                             "ranks")
        per = n // self.world
        return self.rank * per, (self.rank + 1) * per


def make_mesh(n_data: int | None = None, n_fsdp: int = 1) -> Mesh:
    """A ('data', 'fsdp') mesh over every rank of the process group
    (``n_data`` defaults to world / ``n_fsdp``: pure data parallelism by
    default). Needs the process group (``dist.initialize``) unless the
    world is one process."""
    world = pdist.process_count()
    if n_data is None:
        n_data = world // n_fsdp
    if n_data * n_fsdp != world:
        raise ValueError(f"mesh {n_data}x{n_fsdp} != {world} ranks")
    if not dist.is_initialized():
        return Mesh(n_data, n_fsdp)
    rank = dist.get_rank()
    fsdp_group = None
    for d in range(n_data):  # every rank makes every group, in order
        ranks = [d * n_fsdp + f for f in range(n_fsdp)]
        group = dist.new_group(ranks)
        if rank in ranks:
            fsdp_group = group
    return Mesh(n_data, n_fsdp, rank, fsdp_group, True)


def local_mesh() -> Mesh:
    """A 1 x 1 mesh of this process alone (no collectives)."""
    return Mesh(1, 1)


def flax_axes(module: nn.Module, leaf: str, ndim: int) -> tuple:
    """For each axis of a parameter, the axis of its Flax leaf: a conv
    weight OIHW is the kernel HWIO, a Dense weight [out, in] the kernel
    [in, out], with a leading stream axis kept (the layouts of
    ``utils.flax_bridge``); anything else keeps its axes."""
    if leaf == "weight" and isinstance(module, (nn.Linear, nn.Conv2d)):
        return {2: (1, 0), 3: (0, 2, 1), 4: (3, 2, 0, 1),
                5: (0, 4, 3, 1, 2)}.get(ndim, tuple(range(ndim)))
    return tuple(range(ndim))


def _jax_axis(shape, n_fsdp: int, min_size: int):
    """The JAX rule on a Flax-layout shape: the largest axis ``n_fsdp``
    divides (the first of equals), or None."""
    if n_fsdp == 1 or int(np.prod(shape)) < min_size:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i], reverse=True)
    for ax in order:
        if shape[ax] % n_fsdp == 0:
            return ax
    return None


def plan_sharding(model: nn.Module, n_fsdp: int,
                  min_size_to_shard: int = 2**18) -> dict:
    """``{parameter name: the axis it is split on over 'fsdp', or None}``
    by the JAX package's ``param_sharding`` rule, read in the Flax layout."""
    plan = {}
    for mod_name, mod in model.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            axes = flax_axes(mod, leaf, p.ndim)
            flax_shape = [0] * p.ndim
            for k, a in enumerate(axes):
                flax_shape[a] = p.shape[k]
            ax = _jax_axis(flax_shape, n_fsdp, min_size_to_shard)
            plan[name] = None if ax is None else axes.index(ax)
    return {n: plan[n] for n, _ in model.named_parameters()}


def param_sharding(mesh: Mesh, model: nn.Module,
                   min_size_to_shard: int = 2**18) -> dict:
    """``plan_sharding`` over the mesh's ``fsdp`` axis."""
    return plan_sharding(model, mesh.n_fsdp, min_size_to_shard)


def state_sharding(mesh: Mesh, model: nn.Module,
                   min_size_to_shard: int = 2**18) -> dict:
    """The plan of the whole train state: the master parameters, the EMA
    and both AdamW moments of a parameter are split as the parameter is
    (``param_sharding``); the counters are whole."""
    plan = param_sharding(mesh, model, min_size_to_shard)
    return {group: plan for group in ("params", "ema", "mu", "nu")}


def sharded_byte_fraction(tensors: Mapping[str, torch.Tensor],
                          plan: Mapping[str, int | None]) -> float:
    """The share of the bytes of ``tensors`` in leaves ``plan`` splits."""
    total = shard = 0
    for name, t in tensors.items():
        nb = t.numel() * t.element_size()
        total += nb
        if plan.get(name) is not None:
            shard += nb
    return shard / max(total, 1)


def shard_batch(mesh: Mesh, batch: Mapping, device) -> dict:
    """A host batch of this rank's rows (as ``BatchLoader`` yields them) as
    tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()
            if isinstance(v, np.ndarray) or np.isscalar(v)}
