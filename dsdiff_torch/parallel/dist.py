"""Process-group start-up and host-side collectives.

Port of the JAX package's ``parallel/dist.py`` over ``torch.distributed``:
``initialize`` joins the process group that a launcher describes
(torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` and
``LOCAL_RANK``) or that the caller names (``init_method``, e.g. a
``file://`` store, with ``world_size`` and ``rank``): NCCL when the rank
trains on a card (the default), gloo when it asks for the CPU. One process
with no launcher is a no-op. ``gather_rows`` is the differentiable all-gather the train step puts before
a loss that mixes samples: its backward sums every rank's gradient of the
gathered tensor and keeps this rank's rows.
"""
from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

__all__ = [
    "initialize",
    "is_main",
    "process_index",
    "process_count",
    "local_rank",
    "sync_hosts",
    "all_gather_host",
    "all_gather_rows",
    "gather_rows",
]

log = logging.getLogger(__name__)


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None,
               device: str | torch.device | None = None) -> None:
    """Join the process group, once. Without ``init_method`` it is read from
    the environment a launcher sets (``env://``), and with ``WORLD_SIZE``
    unset or 1 nothing happens. ``backend`` defaults to NCCL for a CUDA
    ``device`` (the default, which raises without a card), gloo for
    ``device="cpu"``; under NCCL the rank's card is ``cuda:LOCAL_RANK``."""
    if dist.is_initialized():
        return
    if init_method is None:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return
        init_method = "env://"
    if backend is None:
        dev = resolve_device(device)
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    kw = {}
    if world_size is not None:
        kw.update(world_size=int(world_size), rank=int(rank))
    dist.init_process_group(backend, init_method=init_method, **kw)
    log.info("torch.distributed (%s): rank %d of %d", backend,
             dist.get_rank(), dist.get_world_size())


def is_main() -> bool:
    return process_index() == 0


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's card on its host (torchrun's ``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def sync_hosts(tag: str = "barrier") -> None:
    """A barrier over every process (no-op for one)."""
    if process_count() > 1:
        dist.barrier()


def all_gather_host(value: np.ndarray) -> np.ndarray:
    """A small host array from every process, stacked on a new leading
    axis in rank order."""
    value = np.asarray(value)
    if not dist.is_initialized():
        return value[None]
    out = [None] * process_count()
    dist.all_gather_object(out, value)
    return np.stack(out)


def all_gather_rows(tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's ``tensor`` (equal shapes) concatenated on dim 0 in rank
    order; not differentiable."""
    parts = [torch.empty_like(tensor) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, tensor.contiguous())
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.size = dim, x.shape[dim]
        return all_gather_rows(x.movedim(dim, 0)).movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad)
        start = dist.get_rank() * ctx.size
        return grad.narrow(ctx.dim, start, ctx.size), None


def gather_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated on ``dim`` in rank order, with
    autograd: the gradient of this rank's part is the sum over the ranks of
    the gradient each computed for it."""
    return _GatherRows.apply(x, dim)
