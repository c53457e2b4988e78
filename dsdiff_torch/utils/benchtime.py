"""Timing of one op by a data-dependent chain.

Port of the JAX package's ``utils/benchtime.py``. ``chain_time`` runs the
op ``length`` times, each call consuming the previous output, so that
calls cannot overlap or be served from a cache, and times the chain: with
CUDA events for a tensor on a card, with the host clock and a synchronise
on the CPU. ``fetch_scalar`` forces a result to completion by reading one
element of it.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

__all__ = ["fetch_scalar", "chain_time"]


def _first_tensor(out) -> torch.Tensor:
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    return _first_tensor(out[0])


def fetch_scalar(out) -> float:
    """The first element of ``out``'s first tensor, as a float: waits for it
    and everything it depends on."""
    return float(_first_tensor(out).reshape(-1)[0].item())


def chain_time(fn: Callable, x0: torch.Tensor, length: int = 10,
               couple: Callable | None = None, repeats: int = 2) -> float:
    """Seconds per ``fn`` call, best of ``repeats`` chains of ``length``.

    ``fn(x) -> y`` is the op under test; ``couple(x, y) -> x_next`` feeds
    the output into the next call's input (default ``x + 1e-6 * y``, which
    needs matching shapes). One chain runs first to warm up."""
    if couple is None:
        def couple(x, y):
            return x + 1e-6 * y.to(x.dtype)

    def chain(x):
        for _ in range(length):
            x = couple(x, fn(x))
        return x

    on_card = x0.is_cuda
    with torch.no_grad():
        fetch_scalar(chain(x0))  # warm-up
        best = float("inf")
        for r in range(repeats):
            xi = x0 * (1.0 + (r + 1) * 1e-6)
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                chain(xi)
                end.record()
                end.synchronize()
                seconds = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                fetch_scalar(chain(xi))
                seconds = time.perf_counter() - t0
            best = min(best, seconds / length)
    return best
